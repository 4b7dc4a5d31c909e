// zone_aggregate: per-zone masked mean slack and total heat, gathered from
// the node vectors by the zone member index; on the flat tick the whole TEG
// refresh (the gather, the reduction and the refresh-tick select) in one
// launch.
//
// Replaces the TPU kernel src/repro/kernels/zone_aggregate/kernel.py
// (zone_aggregate_pallas, body _agg_kernel), and the gathers and selects
// around it (repro/core/teg.py refresh, repro/core/zhaf.py zone_gather).
//
// For each zone row z of the (Z, M) member index and mask:
//   zs = sum(S[member] * m) / max(sum(m), 1),   zh = sum(H[member] * m).
// With the refresh select (t given): on a tick with t % every != 0 the old
// table (zs_old, zh_old) is copied instead and nothing is gathered. Two
// entries share the one kernel body: zone_aggregate_members over the node
// vectors (N,) and a member index, and the TPU kernel's own function,
// zone_aggregate, over (Z, M) gathered tiles, where a null member index
// means the identity over the flattened tiles.
//
// Bound: bytes (member and mask of the Z M slots, S and H of the members
// once each, 2 Z out), but Z is small (20 zones of 301 at the paper's Exp5
// geometry): a few microseconds of launch are the time. Design: a warp a
// zone row, ceil(Z / 32) CTAs of up to 32 warps (one CTA at Exp5). Each lane
// strides the row and keeps three partial sums; a fixed-order
// __shfl_xor_sync fold joins them, so there is no shared memory and no
// block barrier, and the sums do not change from run to run. The order
// differs from PyTorch's CPU sum, which is why the plain version is held to
// rtol 1e-5, not bit equality.
//
// Batched entry (zone_aggregate_batched_launch, the lockstep engine's seed
// axis): grid (ceil(Z / 32), B), block row blockIdx.y on seed blockIdx.y's
// node vectors (n a seed), members, mask, tick and tables; the body is the
// one above with the seed's offsets added. Bound: B times the bytes above.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 1024;  // 32 warps: 32 zone rows a CTA
constexpr unsigned kFull = 0xffffffffu;

__global__ void __launch_bounds__(kMaxThreads)
zone_aggregate_kernel(const float* __restrict__ s, const float* __restrict__ h,
                      const int32_t* __restrict__ member,
                      const float* __restrict__ mask,
                      const int32_t* __restrict__ t, int every,
                      const float* __restrict__ zs_old,
                      const float* __restrict__ zh_old, float* __restrict__ zs,
                      float* __restrict__ zh, int z, int m, int n) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (row >= z) return;  // a warp past the last zone row (the whole warp)
  // seed blockIdx.y's vectors (y = 0: the unbatched call)
  const size_t cz = (size_t)blockIdx.y * z, czm = cz * m, cn = (size_t)blockIdx.y * n;
  s += cn;
  h += cn;
  if (member != nullptr) member += czm;
  mask += czm;
  if (t != nullptr) {
    t += blockIdx.y;
    zs_old += cz;
    zh_old += cz;
  }
  zs += cz;
  zh += cz;
  // x mod every == 0 under C's and Python's sign rules alike
  if (t != nullptr && *t % every != 0) {  // not a refresh tick: keep the table
    if (lane == 0) {
      zs[row] = zs_old[row];
      zh[row] = zh_old[row];
    }
    return;
  }
  const size_t base = (size_t)row * m;
  float a = 0.0f, b = 0.0f, c = 0.0f;
  for (int j = lane; j < m; j += 32) {
    const float mk = mask[base + j];
    const size_t src = member != nullptr ? (size_t)member[base + j] : base + j;
    a = __fadd_rn(a, __fmul_rn(s[src], mk));
    b = __fadd_rn(b, __fmul_rn(h[src], mk));
    c = __fadd_rn(c, mk);
  }
  for (int off = 16; off > 0; off >>= 1) {
    a = __fadd_rn(a, __shfl_xor_sync(kFull, a, off));
    b = __fadd_rn(b, __shfl_xor_sync(kFull, b, off));
    c = __fadd_rn(c, __shfl_xor_sync(kFull, c, off));
  }
  if (lane == 0) {
    zs[row] = __fdiv_rn(a, fmaxf(c, 1.0f));
    zh[row] = b;
  }
}

}  // namespace

// s, h: the node vectors (member given) or the (z, m) tiles (member null);
// member (z, m) int32 or null; mask (z, m) float32; t a device int32
// scalar or null (no refresh select; then every, zs_old, zh_old are not
// read) -> zs, zh (z,) float32. Grid and block come from the caller's launch
// plan (kernels/zone_aggregate/plan.py): whole warps, at most kMaxThreads,
// a warp for every zone row, else refused. Launches on `stream` and returns
// cudaGetLastError().
extern "C" int zone_aggregate_batched_launch(const void* s, const void* h,
                                             const void* member, const void* mask,
                                             const void* t, int every,
                                             const void* zs_old, const void* zh_old,
                                             void* zs, void* zh, int z, int m, int n,
                                             int grid, int block, int seeds, void* stream);

extern "C" int zone_aggregate_launch(const void* s, const void* h,
                                     const void* member, const void* mask,
                                     const void* t, int every,
                                     const void* zs_old, const void* zh_old,
                                     void* zs, void* zh, int z, int m, int grid,
                                     int block, void* stream) {
  return zone_aggregate_batched_launch(s, h, member, mask, t, every, zs_old, zh_old, zs, zh, z,
                                       m, 0, grid, block, 1, stream);
}

// zone_aggregate_launch over `seeds` seeds in one launch: s, h (seeds, n),
// member and mask (seeds, z, m), t (seeds,) with zs_old, zh_old (seeds, z)
// or null -> zs, zh (seeds, z). grid and block are one seed's; the launch's
// grid is (grid, seeds).
extern "C" int zone_aggregate_batched_launch(const void* s, const void* h,
                                             const void* member, const void* mask,
                                             const void* t, int every,
                                             const void* zs_old, const void* zh_old,
                                             void* zs, void* zh, int z, int m, int n,
                                             int grid, int block, int seeds, void* stream) {
  if (z <= 0) return 0;
  if (m < 0 || n < 0 || seeds < 1 || seeds > 65535 || (t != nullptr && every < 1))
    return (int)cudaErrorInvalidValue;
  if (block < 32 || block > kMaxThreads || block % 32 != 0 || grid < 1 ||
      (long long)grid * (block / 32) < z)
    return (int)cudaErrorInvalidConfiguration;
  zone_aggregate_kernel<<<dim3(grid, seeds), block, 0, (cudaStream_t)stream>>>(
      (const float*)s, (const float*)h, (const int32_t*)member,
      (const float*)mask, (const int32_t*)t, every, (const float*)zs_old,
      (const float*)zh_old, (float*)zs, (float*)zh, z, m, n);
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
