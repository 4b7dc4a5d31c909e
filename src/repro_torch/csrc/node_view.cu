// node_view: each node's free-atom count and longest run of free atoms, read
// from its packed free words; the true node view of every tick
// (core/zhaf.py build_view, parallel/engine_mesh.py MeshPlane.build_view) in
// one launch.
//
// Replaces no TPU kernel: the JAX package builds the view in plain jnp
// (src/repro/core/zhaf.py build_view: unpack_bits, a sum and max_run's
// cummax scan over the unpacked bit plane), which XLA fuses. Added because
// the port's plain version of that chain is a handful of launches over an
// (N, A) plane, its with-indices cummax scan alone 0.63 ms a tick on an
// H100 at Exp7's 65 536 nodes (a third of the tick), for 0.5 MB of words.
//
// For each row of W int32 words (bit k of word w is atom 32 w + k, 1 = free;
// bits at or above `atoms` count as occupied):
//   s   = number of free atoms,
//   run = length of the longest run of free atoms, across word boundaries,
// both written as float32 (exact integers).
//
// Bound: bytes (4 W in and 8 out a row: 1 MiB at Exp7, 0.31 us at 3.35
// TB/s); a launch's few microseconds are the time. Design: a thread a row,
// 256 a block, no shared memory. The thread walks its row's words once,
// carrying the free run that reaches the top of the word before: __popc
// counts; a word of all ones extends the run; otherwise the word's trailing
// ones close the carried run, a shift-AND loop (x &= x >> 1 until x is 0)
// gives the longest run inside it, and its leading ones start the next.
//
// Batched entry (node_view_batched_launch, the lockstep engine's seed axis):
// grid (ceil(n / 256), B), block row blockIdx.y on seed blockIdx.y's n rows.
// Bound: B times the bytes above.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ int longest_ones(uint32_t x) {
  int k = 0;
  for (; x != 0u; ++k) x &= x >> 1;
  return k;
}

__global__ void __launch_bounds__(kThreads)
node_view_kernel(const int32_t* __restrict__ words, float* __restrict__ s_out,
                 float* __restrict__ run_out, int n, int w, int atoms) {
  const int row = blockIdx.x * kThreads + threadIdx.x;
  if (row >= n) return;
  const size_t r = (size_t)blockIdx.y * n + row;  // seed blockIdx.y's rows
  const uint32_t* x = reinterpret_cast<const uint32_t*>(words) + r * w;
  int count = 0, best = 0, run = 0;  // run: the free atoms atop the words read so far
  for (int j = 0; j < w; ++j) {
    const int valid = min(max(atoms - 32 * j, 0), 32);  // atoms of this word
    const uint32_t mask = valid == 32 ? 0xffffffffu : (1u << valid) - 1u;
    const uint32_t b = __ldg(x + j) & mask;
    count += __popc(b);
    if (b == 0xffffffffu) {
      run += 32;
      continue;
    }
    best = max(best, run + __ffs((int)~b) - 1);  // the carried run and the trailing ones
    best = max(best, longest_ones(b));
    run = __clz((int)~b);  // the leading ones start the next run
  }
  best = max(best, run);
  s_out[r] = (float)count;
  run_out[r] = (float)best;
}

}  // namespace

extern "C" int node_view_batched_launch(const void* words, void* s, void* run, int n, int w,
                                        int atoms, int grid, int block, int seeds,
                                        void* stream);

// words (n, w) int32 -> s, run (n,) float32; atoms in [1, 32 w]. Grid and
// block come from the caller's launch plan (kernels/node_view/plan.py): a
// block of kThreads, a thread for every row, else refused. Launches on
// `stream` and returns cudaGetLastError().
extern "C" int node_view_launch(const void* words, void* s, void* run, int n, int w, int atoms,
                                int grid, int block, void* stream) {
  return node_view_batched_launch(words, s, run, n, w, atoms, grid, block, 1, stream);
}

// node_view_launch over `seeds` seeds in one launch: words (seeds, n, w) ->
// s, run (seeds, n). grid and block are one seed's; the launch's grid is
// (grid, seeds).
extern "C" int node_view_batched_launch(const void* words, void* s, void* run, int n, int w,
                                        int atoms, int grid, int block, int seeds,
                                        void* stream) {
  if (n <= 0) return 0;
  if (w < 1 || atoms < 1 || atoms > 32 * w || seeds < 1 || seeds > 65535)
    return (int)cudaErrorInvalidValue;
  if (block != kThreads || grid < 1 || (long long)grid * kThreads < n)
    return (int)cudaErrorInvalidConfiguration;
  node_view_kernel<<<dim3(grid, seeds), kThreads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)words, (float*)s, (float*)run, n, w, atoms);
  return (int)cudaGetLastError();
}

// Compiled attributes of kernel k (0: node_view_kernel): out[0] static
// shared bytes, out[1] registers a thread, out[2] maxThreadsPerBlock.
extern "C" int node_view_attrs(int k, int* out) {
  if (k != 0) return (int)cudaErrorInvalidValue;
  cudaFuncAttributes a;
  const cudaError_t e = cudaFuncGetAttributes(&a, node_view_kernel);
  out[0] = (int)a.sharedSizeBytes;
  out[1] = a.numRegs;
  out[2] = a.maxThreadsPerBlock;
  return (int)e;
}
