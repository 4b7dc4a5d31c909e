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
// Bound: bytes (each element read once and written once, no arithmetic).
// Design: 256 threads a block stride the block's elements, so neighbouring
// threads touch neighbouring addresses on both sides of the staging.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kDefaultSmem = 48 * 1024;  // above it only after opting in

__global__ void block_copy_kernel(const float* __restrict__ x,
                                  float* __restrict__ out, int block_elems,
                                  int in_block_offset) {
  extern __shared__ float stage[];
  const long long in0 = (long long)((int)blockIdx.x + in_block_offset) * block_elems;
  const long long out0 = (long long)blockIdx.x * block_elems;
  for (int j = threadIdx.x; j < block_elems; j += blockDim.x) stage[j] = x[in0 + j];
  __syncthreads();
  for (int j = threadIdx.x; j < block_elems; j += blockDim.x) out[out0 + j] = stage[j];
}

}  // namespace

// x, out float32. Grid, block, the elements of a block, the input block
// offset and the dynamic shared memory (one staged block) come from the
// launch plan; a block other than kThreads, or staging of another size than
// one block, is refused. Launches on `stream` and returns cudaGetLastError().
extern "C" int block_copy_launch(const void* x, void* out, int block_elems,
                                 int in_block_offset, int grid, int block,
                                 int dynamic_smem, void* stream) {
  if (block != kThreads || grid < 1) return (int)cudaErrorInvalidConfiguration;
  if (block_elems < 1 || dynamic_smem != block_elems * (int)sizeof(float))
    return (int)cudaErrorInvalidValue;
  if (dynamic_smem > kDefaultSmem) {
    const cudaError_t e = cudaFuncSetAttribute(
        block_copy_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, dynamic_smem);
    if (e != cudaSuccess) return (int)e;
  }
  block_copy_kernel<<<grid, block, dynamic_smem, (cudaStream_t)stream>>>(
      (const float*)x, (float*)out, block_elems, in_block_offset);
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
