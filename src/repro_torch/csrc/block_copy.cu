// block_copy: a float32 copy that runs whatever launch plan it is given.
//
// Replaces the TPU kernels of tests/fixtures/analysis/bad_blockspec_tail.py
// (tail_dropping_grid :29, index_map_overshoot :44, vmem_over_budget :59, one
// body _copy_kernel): the static analyzer's known-bad test data, a copy of
// (1024,) float32 under three deliberately wrong grids / BlockSpecs.
//
// As in the TPU fixture, the kernel is correct and the faults live in the
// plans (kernels/block_copy/plan.py; the bad ones in
// tests/fixtures/torch_analysis/bad_launch_tail.py): block b stages input
// block (b + in_block_offset) whole in dynamic shared memory, as a BlockSpec
// stages a block in VMEM, then writes it to output block b. Nothing is
// guarded: a block of the plan that lies past the array is read or written
// there, which is what the analyzer's LC302 and the guard bands of
// chip_smoke.py catch. A Pallas index map that leaves the array is clamped
// by the TPU (dynamic_slice); here it is not.
//
// The output elements no block of the plan writes, [grid * B, n), are NaN,
// as under the plan interpreter: the grid's threads fill them stride-wise in
// the same launch (no block's write overlaps that range), so a call is one
// kernel whatever the plan.
//
// Bound: bytes (each element read once and written once, no arithmetic).
// Design: 256 threads a block stride the block's elements, so neighbouring
// threads touch neighbouring addresses on both sides of the staging; where
// the block is a whole number of 16-byte vectors and both arrays are 16-byte
// aligned, each step moves a float4 (a 4 KiB block is one step a thread).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kDefaultSmem = 48 * 1024;  // above it only after opting in

__global__ void block_copy_kernel(const float* __restrict__ x,
                                  float* __restrict__ out, int block_elems,
                                  int in_block_offset, long long n, int vec) {
  extern __shared__ float4 stage[];
  const long long in0 = (long long)((int)blockIdx.x + in_block_offset) * block_elems;
  const long long out0 = (long long)blockIdx.x * block_elems;
  if (vec) {
    const int q = block_elems / 4;
    const float4* src = reinterpret_cast<const float4*>(x + in0);
    float4* dst = reinterpret_cast<float4*>(out + out0);
    for (int j = threadIdx.x; j < q; j += blockDim.x) stage[j] = src[j];
    __syncthreads();
    for (int j = threadIdx.x; j < q; j += blockDim.x) dst[j] = stage[j];
  } else {
    float* s = reinterpret_cast<float*>(stage);
    for (int j = threadIdx.x; j < block_elems; j += blockDim.x) s[j] = x[in0 + j];
    __syncthreads();
    for (int j = threadIdx.x; j < block_elems; j += blockDim.x) out[out0 + j] = s[j];
  }
  // the elements no block writes
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)gridDim.x * block_elems + blockIdx.x * blockDim.x + threadIdx.x;
       i < n; i += stride)
    out[i] = __int_as_float(0x7fc00000);  // NaN, as torch.full(nan)
}

}  // namespace

// x float32, out (n,) float32. Grid, block, the elements of a block, the
// input block offset and the dynamic shared memory (one staged block) come
// from the launch plan; a block other than kThreads, or staging of another
// size than one block, is refused. Launches on `stream` and returns
// cudaGetLastError().
extern "C" int block_copy_launch(const void* x, void* out, int block_elems,
                                 int in_block_offset, long long n, int grid, int block,
                                 int dynamic_smem, void* stream) {
  if (block != kThreads || grid < 1) return (int)cudaErrorInvalidConfiguration;
  if (block_elems < 1 || n < 0 || dynamic_smem != block_elems * (int)sizeof(float))
    return (int)cudaErrorInvalidValue;
  if (dynamic_smem > kDefaultSmem) {
    const cudaError_t e = cudaFuncSetAttribute(
        block_copy_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, dynamic_smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int vec = block_elems % 4 == 0 && (((uintptr_t)x | (uintptr_t)out) & 15) == 0;
  block_copy_kernel<<<grid, block, dynamic_smem, (cudaStream_t)stream>>>(
      (const float*)x, (float*)out, block_elems, in_block_offset, n, vec);
  return (int)cudaGetLastError();
}

// Compiled attributes of kernel k (0: block_copy_kernel): out[0] static
// shared bytes, out[1] registers a thread, out[2] maxThreadsPerBlock.
extern "C" int block_copy_attrs(int k, int* out) {
  if (k != 0) return (int)cudaErrorInvalidValue;
  cudaFuncAttributes a;
  const cudaError_t e = cudaFuncGetAttributes(&a, block_copy_kernel);
  out[0] = (int)a.sharedSizeBytes;
  out[1] = a.numRegs;
  out[2] = a.maxThreadsPerBlock;
  return (int)e;
}
