// zone_aggregate: per-zone masked mean slack and total heat.
//
// Replaces the TPU kernel src/repro/kernels/zone_aggregate/kernel.py
// (zone_aggregate_pallas, body _agg_kernel).
//
// For each zone row of the (Z, M) gathered tiles:
//   zs = sum(S * m) / max(sum(m), 1),   zh = sum(H * m).
//
// Bound: bytes (3 Z M floats in, 2 Z out). Z is small (20 zones at the
// paper's Exp5 geometry), so the card is far from full either way. Design:
// one block per zone row; each thread strides the row and keeps three partial
// sums, then a shared-memory tree folds them in a fixed order, so the result
// does not change from run to run. The order differs from PyTorch's CPU sum,
// which is why the plain version is held to rtol 1e-5, not bit equality.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;

__global__ void zone_aggregate_kernel(const float* __restrict__ s,
                                      const float* __restrict__ h,
                                      const float* __restrict__ mask,
                                      float* __restrict__ zs,
                                      float* __restrict__ zh, int z, int m) {
  __shared__ float acc_s[kThreads], acc_h[kThreads], acc_m[kThreads];
  if (blockIdx.x >= z) return;  // a block past the last zone row (whole block)
  const size_t row = (size_t)blockIdx.x * m;
  float a = 0.0f, b = 0.0f, c = 0.0f;
  for (int j = threadIdx.x; j < m; j += kThreads) {
    const float mk = mask[row + j];
    a = __fadd_rn(a, __fmul_rn(s[row + j], mk));
    b = __fadd_rn(b, __fmul_rn(h[row + j], mk));
    c = __fadd_rn(c, mk);
  }
  acc_s[threadIdx.x] = a;
  acc_h[threadIdx.x] = b;
  acc_m[threadIdx.x] = c;
  __syncthreads();
  for (int half = kThreads / 2; half > 0; half /= 2) {
    if (threadIdx.x < half) {
      acc_s[threadIdx.x] = __fadd_rn(acc_s[threadIdx.x], acc_s[threadIdx.x + half]);
      acc_h[threadIdx.x] = __fadd_rn(acc_h[threadIdx.x], acc_h[threadIdx.x + half]);
      acc_m[threadIdx.x] = __fadd_rn(acc_m[threadIdx.x], acc_m[threadIdx.x + half]);
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    zs[blockIdx.x] = __fdiv_rn(acc_s[0], fmaxf(acc_m[0], 1.0f));
    zh[blockIdx.x] = acc_h[0];
  }
}

}  // namespace

// s, h, mask (z, m) float32 -> zs, zh (z,) float32. Grid (one block per
// zone row) and block come from the caller's launch plan
// (kernels/zone_aggregate/plan.py); a block other than kThreads is refused.
// Launches on `stream` and returns cudaGetLastError().
extern "C" int zone_aggregate_launch(const void* s, const void* h,
                                     const void* mask, void* zs, void* zh,
                                     int z, int m, int grid, int block,
                                     void* stream) {
  if (z <= 0) return 0;
  if (block != kThreads || grid < 1) return (int)cudaErrorInvalidConfiguration;
  zone_aggregate_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      (const float*)s, (const float*)h, (const float*)mask, (float*)zs,
      (float*)zh, z, m);
  return (int)cudaGetLastError();
}

// Compiled attributes of kernel k (0: zone_aggregate_kernel): out[0] static
// shared bytes, out[1] registers a thread, out[2] maxThreadsPerBlock.
extern "C" int zone_aggregate_attrs(int k, int* out) {
  if (k != 0) return (int)cudaErrorInvalidValue;
  cudaFuncAttributes a;
  const cudaError_t e = cudaFuncGetAttributes(&a, zone_aggregate_kernel);
  out[0] = (int)a.sharedSizeBytes;
  out[1] = a.numRegs;
  out[2] = a.maxThreadsPerBlock;
  return (int)e;
}
