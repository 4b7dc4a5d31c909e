// utility_topk: fused DA utility scoring + candidate argmax.
//
// Replaces the TPU kernel src/repro/kernels/utility_topk/kernel.py
// (utility_topk_pallas, body _score_kernel).
//
// For each probe row of K candidates:
//   score = log2(1 + max(S, 0)) - gamma * log2(1 + max(H, 0)) + eps,
// set to -3e38 where the candidate is infeasible; returns the first index of
// the row maximum (strict >, so ties keep the lowest index, as jnp.argmax)
// and the maximum.
//
// Exactness: the engine compares this kernel's best score with the launchpad
// score that PyTorch's own elementwise CUDA ops compute (da.address,
// prefer_here). So the score is formed with the same operations in the same
// order: IEEE log2f (not __log2f), every add and multiply rounded on its own
// (__fadd_rn / __fsub_rn / __fmul_rn, and the library is built with
// --fmad=false), so nothing is contracted into a fused multiply-add.
//
// Bound: bytes. Per row it reads 3 K floats + K bool flags and writes one
// int32 and one float; the two log2f per candidate are cheap beside that.
// Design: one thread per probe row, the K candidates in a loop; rows are
// K * 4 bytes apart, so a warp reads a contiguous span of 32 rows.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr float kNeg = -3.0e38f;

__global__ void utility_topk_kernel(const float* __restrict__ s,
                                    const float* __restrict__ h,
                                    const float* __restrict__ eps,
                                    const uint8_t* __restrict__ feas,
                                    float gamma, int32_t* __restrict__ best,
                                    float* __restrict__ val, int p, int k) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= p) return;
  const size_t row = (size_t)i * k;
  int bi = 0;
  float bv = kNeg;
  for (int j = 0; j < k; ++j) {
    const float ls = log2f(__fadd_rn(1.0f, fmaxf(s[row + j], 0.0f)));
    const float lh = log2f(__fadd_rn(1.0f, fmaxf(h[row + j], 0.0f)));
    float sc = __fadd_rn(__fsub_rn(ls, __fmul_rn(gamma, lh)), eps[row + j]);
    if (feas[row + j] == 0) sc = kNeg;
    if (j == 0 || sc > bv) {
      bv = sc;
      bi = j;
    }
  }
  best[i] = bi;
  val[i] = bv;
}

}  // namespace

// s, h, eps (p, k) float32, feas (p, k) bool -> best (p,) int32, val (p,)
// float32. Grid and block come from the caller's launch plan
// (kernels/utility_topk/plan.py); a block other than kThreads is refused.
// Launches on `stream` and returns cudaGetLastError().
extern "C" int utility_topk_launch(const void* s, const void* h,
                                   const void* eps, const void* feas,
                                   float gamma, void* best, void* val, int p,
                                   int k, int grid, int block, void* stream) {
  if (p <= 0) return 0;
  if (k < 1) return (int)cudaErrorInvalidValue;
  if (block != kThreads || grid < 1) return (int)cudaErrorInvalidConfiguration;
  utility_topk_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      (const float*)s, (const float*)h, (const float*)eps,
      (const uint8_t*)feas, gamma, (int32_t*)best, (float*)val, p, k);
  return (int)cudaGetLastError();
}

// Compiled attributes of kernel k (0: utility_topk_kernel): out[0] static
// shared bytes, out[1] registers a thread, out[2] maxThreadsPerBlock.
extern "C" int utility_topk_attrs(int k, int* out) {
  if (k != 0) return (int)cudaErrorInvalidValue;
  cudaFuncAttributes a;
  const cudaError_t e = cudaFuncGetAttributes(&a, utility_topk_kernel);
  out[0] = (int)a.sharedSizeBytes;
  out[1] = a.numRegs;
  out[2] = a.maxThreadsPerBlock;
  return (int)e;
}
