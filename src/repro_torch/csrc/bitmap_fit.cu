// bitmap_fit: per-node feasibility of a demand of m atoms against the node's
// free-atom bitmap words.
//
// Replaces the TPU kernel src/repro/kernels/bitmap_fit/kernel.py
// (bitmap_fit_pallas, body _fit_kernel, helpers _popcount and _shr128).
//
// Dispersed demand (contig == 0): popcount >= m. Contiguous demand: the
// shift-AND run-doubling of _fit_kernel, with the same step count
// (bit_length(32 W - 1)) and the same clamp of each shift to 32, so the result
// is the TPU kernel's bit for bit. m == 0 is always feasible.
//
// Bound: bytes. Per node it reads W words + mass + contig and writes one
// int32 (13 B + 4 W); the integer work is a few dozen operations. Design: one
// thread per node, the W words in registers, __popc for the count and a
// funnel shift for the cross-word carry. Consecutive threads read
// consecutive rows, so the loads coalesce.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxWords = 8;  // up to 256 atoms per node
constexpr int kThreads = 256;

// Logical right shift of the 64-bit pair (nxt:cur) by t in [0, 32], low word,
// as _shr128 computes it word by word. __funnelshift_r masks its shift to
// 0..31: t == 0 gives cur as wanted, but t == 32 would give cur as well,
// where _shr128 gives the next word, so that edge is taken apart here.
__device__ __forceinline__ uint32_t shr_pair(uint32_t cur, uint32_t nxt, int t) {
  if (t >= 32) return nxt;
  return __funnelshift_r(cur, nxt, t);
}

__global__ void bitmap_fit_kernel(const uint32_t* __restrict__ words,
                                  const int32_t* __restrict__ mass,
                                  const uint8_t* __restrict__ contig,
                                  int32_t* __restrict__ out, int n, int w,
                                  int n_steps) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int m = mass[i];
  uint32_t b[kMaxWords];
  int pc = 0;
#pragma unroll
  for (int k = 0; k < kMaxWords; ++k) {
    b[k] = k < w ? words[(size_t)i * w + k] : 0u;
    pc += __popc(b[k]);
  }
  int ok;
  if (contig[i] == 0) {
    ok = pc >= m;
  } else {
    int rem = max(m - 1, 0);
    int s = 1;
    for (int step = 0; step < n_steps; ++step) {
      const int t = min(min(s, rem), 32);
      uint32_t sh[kMaxWords];
#pragma unroll
      for (int k = 0; k < kMaxWords; ++k) {
        const uint32_t nxt = (k + 1 < w) ? b[k + 1] : 0u;
        sh[k] = k < w ? shr_pair(b[k], nxt, t) : 0u;
      }
#pragma unroll
      for (int k = 0; k < kMaxWords; ++k) b[k] &= sh[k];
      rem -= t;
      s *= 2;
    }
    uint32_t any = 0;
#pragma unroll
    for (int k = 0; k < kMaxWords; ++k) any |= b[k];
    ok = (any != 0u && m > 0) || m == 0;
  }
  out[i] = ok;
}

}  // namespace

// words (n, w) int32 bit patterns, mass (n,) int32, contig (n,) bool,
// out (n,) int32. Grid and block come from the caller's launch plan
// (kernels/bitmap_fit/plan.py); a block other than kThreads is refused.
// Launches on `stream` and returns cudaGetLastError().
extern "C" int bitmap_fit_launch(const void* words, const void* mass,
                                 const void* contig, void* out, int n, int w,
                                 int grid, int block, void* stream) {
  if (n <= 0) return 0;
  if (w < 1 || w > kMaxWords) return (int)cudaErrorInvalidValue;
  if (block != kThreads || grid < 1) return (int)cudaErrorInvalidConfiguration;
  const int bits = 32 * w - 1;
  const int n_steps = max(1, 32 - __builtin_clz(bits));  // bit_length(32 w - 1)
  bitmap_fit_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)words, (const int32_t*)mass, (const uint8_t*)contig,
      (int32_t*)out, n, w, n_steps);
  return (int)cudaGetLastError();
}

// Compiled attributes of kernel k (0: bitmap_fit_kernel): out[0] static
// shared bytes, out[1] registers a thread, out[2] maxThreadsPerBlock.
extern "C" int bitmap_fit_attrs(int k, int* out) {
  if (k != 0) return (int)cudaErrorInvalidValue;
  cudaFuncAttributes a;
  const cudaError_t e = cudaFuncGetAttributes(&a, bitmap_fit_kernel);
  out[0] = (int)a.sharedSizeBytes;
  out[1] = a.numRegs;
  out[2] = a.maxThreadsPerBlock;
  return (int)e;
}
