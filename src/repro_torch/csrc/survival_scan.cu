// survival_scan: the fused per-tick Airlock survival decision, as one
// thread-block cluster launch.
//
// Replaces the TPU kernel src/repro/kernels/survival_scan/kernel.py
// (survival_scan_pallas, body _scan_kernel, grid (5, P/512)).
//
// It computes what survival_scan_ref computes, bit for bit:
//   * pressure[n] = base[n] + the effective memory of every slot held on n,
//     added in probe-slot order (resident: mem; suspended or migrating:
//     mem * residual);
//   * the victim of each node over the watermark: the lexicographic maximum
//     of (tier, score, slot) over its resident slots, score -ev under
//     Airlock and mem under kernel OOM (no tier), none if that score is not
//     finite;
//   * the victim mask, then the resume / react / expire masks.
// alloc_node lies in [-1, N): -1 is no node.
//
// Bound: bytes. The inputs are 8 columns of P (29 B a slot) plus base, the
// outputs pressure and four P-byte masks; a few operations a slot. At the
// Exp5 shapes (N = 5000, P = 65 536) that is 0.000658 ms at 3.35 TB/s.
//
// Design. The TPU kernel carries its node accumulators across a sequential
// grid. Here one cluster of 16 CTAs (the H100's non-portable maximum; 1024
// threads each) does all of it in one launch, and its phases are separated
// by three cluster barriers (barrier.cluster, release / acquire) instead of
// kernel boundaries, after a start handshake (no CTA reaches another's
// shared memory before all have started): no per-call init pass, no
// dependent launches. Node n
// belongs to CTA n / nb of the cluster (nb = ceil(N / 16)) and, within it,
// to warp (l ^ l >> 5) % 32 of its index l there: its pressure and victim
// key sit in that CTA's shared memory, and only that warp updates them (the
// swizzle spreads one warp's nodes over all 32 banks). CTA c holds the slots
// [c * 1024 * steps, (c + 1) * 1024 * steps); warp w of it a contiguous run
// of 32 * steps of them, one step of 32 consecutive slots (one lane each) at
// a time, so (CTA, warp, step, lane) order is slot order. A thread keeps its
// slots' node and effective memory, and their state flags, in registers
// from the one read of the columns to the end.
//
//   0. entries: every slot with a node and non-zero effective memory, and
//      every resident slot with a node, is an entry of its node's (CTA,
//      warp) bin (16 * 32 bins). A stable counting sort puts each bin's
//      entries, in slot order, into one run of the global scratch `ent`
//      (node, value, victim key: 16 B): counts per (warp, bin) by shared
//      atomics, an exclusive scan over warps, each CTA's counts pushed into
//      every CTA's shared memory (distributed shared memory), then scans
//      over CTAs and bins; ranks inside a step from __match_any_sync and
//      the lanes below.
//   1. pressure and victim key: each warp walks its own bin's run, a window
//      of 32 entries at a time, grouped by node (__match_any_sync). The
//      lowest lane of each node's group adds the group's values in lane
//      order to the node's accumulator with __fadd_rn, and takes the
//      maximum of the group's keys. No other warp
//      touches those nodes and the run is in slot order, so each node's
//      sum runs from base in slot order, as the reference's scatter-add
//      does. Values of exactly zero are left out: adding +0.0 to the
//      running sum changes nothing. mem * residual is __fmul_rn, and the
//      build keeps --fmad=false. A node's candidates are all its resident
//      slots or none (the watermark test is on the node), so the maximum
//      needs no second walk. A key packs tier 15 | score 32 | slot 17 bits
//      (high to low), so one maximum compares tier, score and slot at once,
//      in place of three passes of maxima. The score's -0.0 is made +0.0
//      first (the reference's `sc == best` holds them equal, so the higher
//      slot wins), NaN goes above +inf (amax propagates it), and a winner
//      whose score is not finite is no victim. The tier field holds
//      workload classes 0 <= tier < 2^15; kernel OOM puts 0 there.
//      P <= 2^17. No atomics: a 64-bit atomicMax or red.max on shared
//      memory did not keep the maximum on the H100 when tried on the card.
//   2. the masks: each node's mask word (global scratch `info`) holds its
//      victim's slot and whether its pressure is under `safe`; one read of
//      it a slot gives the victim mask and the transition masks as the
//      reference.
//
// Shared memory a CTA: 12 B a node of its range plus the (warp, bin) count
// table (64 KiB) and every CTA's counts (32 KiB); 158 KiB at Exp7's 65 536
// nodes. The launch plan (kernels/survival_scan/plan.py) refuses shapes past
// the 227 KiB a block may use and P past 2^17.
//
// Batched entry (survival_scan_batched_launch, the lockstep engine's seed
// axis): B clusters in one launch, cluster b on seed b's columns, base, t,
// outputs and its own stride of scratch; the body is the one above with the
// seed's offsets added to its addressing, so no barrier or shared memory
// spans two seeds. The card holds a few 16-CTA clusters at once
// (cudaOccupancyMaxActiveClusters, printed by chip_smoke.py); the others
// wait for a free GPC and run in later waves. Bound: B times the bytes above.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kEmpty = 0;
constexpr int kRunning = 6;
constexpr int kSuspended = 7;
constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxSteps = 8;  // slots a thread holds
constexpr int kMaxCluster = 16;
constexpr int kSlotBits = 17;
constexpr int kTierBits = 64 - 32 - kSlotBits;
constexpr unsigned long long kSlotMask = (1ull << kSlotBits) - 1;
constexpr uint32_t kTierMask = (1u << kTierBits) - 1;

struct Inputs {
  const int32_t* st;
  const int32_t* node;
  const float* mem;
  const float* ev;
  const int32_t* tier;
  const uint8_t* mig;
  const int32_t* stick;
  const int32_t* sdl;
  const float* base;
  const int32_t* t;
};

struct Outputs {
  float* pressure;
  uint8_t* victim;
  uint8_t* resume;
  uint8_t* react;
  uint8_t* expire;
};

struct Params {
  int p, n, airlock, t_susp, t_surv, steps;
  unsigned long long magic;  // ceil(2^32 / nb): n / nb == (n * magic) >> 32 here
  float residual, watermark, safe;
};

// byte offsets of the dynamic shared memory of one CTA, for n nodes over a
// cluster of `cluster` CTAs
struct Layout {
  int nb, bins;
  size_t key, skey, press, sval, hist, tots, boff, own, wsum, bytes;
};

__host__ __device__ inline Layout layout(int n, int cluster) {
  Layout L;
  L.nb = (n + cluster - 1) / cluster;
  L.bins = cluster * kWarps;
  size_t at = 0;
  L.key = at;    at += 8 * (size_t)L.nb;              // u64 victim key per node
  L.skey = at;   at += 8 * kThreads;                  // u64 a window's keys, per warp
  L.press = at;  at += 4 * (size_t)L.nb;              // f32 pressure per node
  L.sval = at;   at += 4 * kThreads;                  // f32 a window's values, per warp
  L.hist = at;   at += 4 * (size_t)kWarps * L.bins;   // i32 [warp][bin] counts
  L.tots = at;   at += 4 * (size_t)cluster * L.bins;  // i32 [CTA][bin] counts
  L.boff = at;   at += 4 * (size_t)L.bins;            // i32 this CTA's offset per bin
  L.own = at;    at += 4 * 2 * kWarps;                // i32 run [start, end) of own bins
  L.wsum = at;   at += 4 * kWarps;                    // i32 warp sums of the bin scan
  L.bytes = at;
  return L;
}

// the bin of a node, by its loc (owner CTA << 16 | index l in it): the CTA,
// and the warp (l ^ l >> 5) % 32, so that one warp's nodes fall in all the
// banks of shared memory
__device__ __forceinline__ int bin_of(int loc) {
  const int l = loc & 0xffff;
  return (loc >> 16) * kWarps + ((l ^ (l >> 5)) & (kWarps - 1));
}

#ifdef SURVIVAL_SCAN_PHASES
// Built with -DSURVIVAL_SCAN_PHASES (python -m repro_torch.kernel_bench
// --phases): thread 0 of each CTA stamps clock64() when the CTA has ended a
// phase, and survival_scan_phases copies the stamps out.
__device__ unsigned long long g_phase[kMaxCluster * 8];
#define PHASE(i)                                                      \
  do {                                                                \
    __syncthreads();                                                  \
    if (threadIdx.x == 0) g_phase[rank * 8 + (i)] = clock64();        \
  } while (0)
#else
#define PHASE(i)
#endif

// order-preserving float -> u32, with -0.0 == +0.0 and NaN above +inf
__device__ __forceinline__ uint32_t enc_score(float f) {
  if (isnan(f)) return 0xffffffffu;
  const uint32_t u = __float_as_uint(f == 0.0f ? 0.0f : f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// the score a key carries is finite
__device__ __forceinline__ bool key_finite(unsigned long long k) {
  const uint32_t e = (uint32_t)(k >> kSlotBits);
  return isfinite(__uint_as_float((e & 0x80000000u) ? (e & 0x7fffffffu) : ~e));
}

// seed b's columns, base and tick, and its outputs (b = 0: the unbatched call)
__device__ __forceinline__ void seed_offsets(Inputs& in, Outputs& out, int b, int p, int n) {
  const size_t cp = (size_t)b * p, cn = (size_t)b * n;
  in.st += cp;
  in.node += cp;
  in.mem += cp;
  in.ev += cp;
  in.tier += cp;
  in.mig += cp;
  in.stick += cp;
  in.sdl += cp;
  in.base += cn;
  in.t += b;
  out.pressure += cn;
  out.victim += cp;
  out.resume += cp;
  out.react += cp;
  out.expire += cp;
}

// one cluster a seed: cluster b (blockIdx.x / cluster size) on seed b, its
// scratch `stride` int32 words after seed b - 1's
__global__ void __launch_bounds__(kThreads, 1)
survival_cluster_kernel(Inputs in, Outputs out, Params pr, int* __restrict__ scratch,
                        long long stride) {
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ __align__(16) unsigned char smem[];
  const int ncta = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int seed = (int)(blockIdx.x / (unsigned)ncta);
  seed_offsets(in, out, seed, pr.p, pr.n);
  int4* __restrict__ ent = (int4*)(scratch + seed * stride);
  int* __restrict__ info = scratch + seed * stride + 4 * (size_t)pr.p;
  const Layout L = layout(pr.n, ncta);
  unsigned long long* key = (unsigned long long*)(smem + L.key);
  float* press = (float*)(smem + L.press);
  int* hist = (int*)(smem + L.hist);
  int* tots = (int*)(smem + L.tots);
  int* boff = (int*)(smem + L.boff);
  int* own = (int*)(smem + L.own);
  unsigned long long* skey = (unsigned long long*)(smem + L.skey);
  float* sval = (float*)(smem + L.sval);
  int* wsum = (int*)(smem + L.wsum);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nb = L.nb, bins = L.bins, node0 = rank * nb, steps = pr.steps;
  const unsigned below = (1u << lane) - 1;
  // every CTA of the cluster has started before any reaches another's shared
  // memory: arrive now, wait before the first remote store
  asm volatile("barrier.cluster.arrive.relaxed.aligned;" ::: "memory");
  PHASE(0);

  for (int i = tid; i < nb; i += kThreads) {
    key[i] = 0;
    press[i] = node0 + i < pr.n ? in.base[node0 + i] : 0.0f;
  }
  for (int i = tid; i < kWarps * bins; i += kThreads) hist[i] = 0;

  // the one read of st, node, mig and mem: slot of step k is first + 32 k.
  // loc: owner CTA << 16 | node's index in it, -1 without a node
  const int first = (rank * kWarps + warp) * 32 * steps + lane;
  int loc[kMaxSteps];
  float val[kMaxSteps];
  uint32_t run = 0, susp = 0, empty = 0, mig = 0;  // bit k: the slot of step k
#pragma unroll
  for (int k = 0; k < kMaxSteps; ++k) {
    loc[k] = -1;
    val[k] = 0.0f;
    const int p = first + 32 * k;
    if (k < steps && p < pr.p) {
      const int st = in.st[p];
      const int nd = in.node[p];
      const bool mg = in.mig[p] != 0;
      const float m = in.mem[p];
      float v = 0.0f;
      if (st == kRunning) v = m;
      else if (st == kSuspended || (mg && nd >= 0)) v = __fmul_rn(m, pr.residual);
      if (nd >= 0 && nd < pr.n) {
        const int o = (int)(((unsigned long long)nd * pr.magic) >> 32);
        loc[k] = (o << 16) | (nd - o * nb);
      }
      val[k] = v;
      run |= (uint32_t)(st == kRunning) << k;
      susp |= (uint32_t)(st == kSuspended) << k;
      empty |= (uint32_t)(st == kEmpty) << k;
      mig |= (uint32_t)mg << k;
    }
  }
  __syncthreads();

  // -- 0a. count the entries per (warp, bin) ---------------------------------
#pragma unroll
  for (int k = 0; k < kMaxSteps; ++k) {
    if (k >= steps) break;
    if (loc[k] >= 0 && (val[k] != 0.0f || ((run >> k) & 1u)))
      atomicAdd(&hist[warp * bins + bin_of(loc[k])], 1);
  }
  __syncthreads();
  // exclusive scan over warps, per bin; this CTA's count per bin, pushed
  // into every CTA's table
  asm volatile("barrier.cluster.wait.aligned;" ::: "memory");
  for (int b = tid; b < bins; b += kThreads) {
    int sum = 0;
    for (int w = 0; w < kWarps; ++w) {
      const int c = hist[w * bins + b];
      hist[w * bins + b] = sum;
      sum += c;
    }
    for (int c = 0; c < ncta; ++c) cluster.map_shared_rank(tots, c)[rank * bins + b] = sum;
  }
  PHASE(1);
  cluster.sync();  // every CTA's counts are in every table
  PHASE(2);

  // -- 0b. offsets: over CTAs, then an exclusive scan over bins --------------
  int all = 0, lower = 0;  // bin tid: entries in the cluster, in lower CTAs
  if (tid < bins) {
    for (int c = 0; c < ncta; ++c) {
      const int v = tots[c * bins + tid];
      if (c < rank) lower += v;
      all += v;
    }
  }
  int incl = all;
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, incl, d);
    if (lane >= d) incl += y;
  }
  if (lane == 31) wsum[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const int w = wsum[lane];
    int x = w;
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, x, d);
      if (lane >= d) x += y;
    }
    wsum[lane] = x - w;
  }
  __syncthreads();
  if (tid < bins) {
    const int start = wsum[warp] + incl - all;  // first position of bin tid
    boff[tid] = start + lower;
    if (tid / kWarps == rank) {
      own[tid % kWarps] = start;
      own[kWarps + tid % kWarps] = start + all;
    }
  }
  __syncthreads();

  // -- 0c. place the entries, stable: (CTA, warp, step, lane) order ----------
  // ev and tier of a resident slot (Airlock), read one step ahead
  float ev_next = 0.0f;
  int tier_next = 0;
  if (pr.airlock && steps > 0 && (run & 1u) && loc[0] >= 0) {
    ev_next = in.ev[first];
    tier_next = in.tier[first];
  }
#pragma unroll
  for (int k = 0; k < kMaxSteps; ++k) {
    if (k >= steps) break;
    const int p = first + 32 * k;
    const bool resident = (run >> k) & 1u;
    const bool entry = loc[k] >= 0 && (val[k] != 0.0f || resident);
    const float ev = ev_next;
    const int tier = tier_next;
    if (k + 1 < kMaxSteps && k + 1 < steps && pr.airlock && ((run >> (k + 1)) & 1u) &&
        loc[k + 1] >= 0) {
      ev_next = in.ev[p + 32];
      tier_next = in.tier[p + 32];
    }
    unsigned long long kk = 0;  // the victim key of a resident slot
    if (entry && resident) {
      const float score = pr.airlock ? -ev : val[k];  // val is mem when resident
      const uint32_t tf = pr.airlock ? ((uint32_t)tier & kTierMask) : 0u;
      kk = ((unsigned long long)tf << (32 + kSlotBits)) |
           ((unsigned long long)enc_score(score) << kSlotBits) | (unsigned long long)p;
    }
    const int b = entry ? bin_of(loc[k]) : -1;
    const unsigned peers = __match_any_sync(0xffffffffu, b);
    if (entry) {
      const int pos = boff[b] + hist[warp * bins + b] + __popc(peers & below);
      ent[pos] = make_int4(loc[k] & 0xffff, __float_as_int(val[k]), (int)(uint32_t)kk,
                           (int)(uint32_t)(kk >> 32));
    }
    __syncwarp();
    if (entry && (peers & below) == 0) hist[warp * bins + b] += __popc(peers);
    __syncwarp();
  }
  PHASE(3);
  cluster.sync();  // every entry is in place (release / acquire, cluster scope)
  PHASE(4);

  // -- 1. each warp folds its bin's run into its nodes, in slot order, and
  // takes the maximum of its resident entries' keys: a node's candidates
  // are all its resident slots or none (the watermark test is the node's)
  // (entries were written by other SMs: read from L2, one window ahead)
  const int lo = own[warp], hi = own[kWarps + warp];
  int4 next = lo + lane < hi ? __ldcg(ent + lo + lane) : make_int4(0, 0, 0, 0);
  for (int i0 = lo; i0 < hi; i0 += 32) {
    const int4 e = next;
    if (i0 + 32 + lane < hi) next = __ldcg(ent + i0 + 32 + lane);
    const bool in_run = i0 + lane < hi;
    const unsigned peers = __match_any_sync(0xffffffffu, in_run ? e.x : -1);
    sval[tid] = __int_as_float(e.y);
    skey[tid] = ((unsigned long long)(uint32_t)e.w << 32) | (uint32_t)e.z;
    __syncwarp();
    if (in_run && (peers & below) == 0) {
      float acc = press[e.x];
      unsigned long long best = key[e.x];
      for (unsigned m = peers; m; m &= m - 1) {
        const int j = warp * 32 + __ffs(m) - 1;
        if (sval[j] != 0.0f) acc = __fadd_rn(acc, sval[j]);
        best = skey[j] > best ? skey[j] : best;
      }
      press[e.x] = acc;
      key[e.x] = best;
    }
    __syncwarp();
  }
  __syncthreads();
  // each node's mask word, in global memory: its victim's slot + 1 (0: none)
  // << 1 | pressure under `safe`
  for (int i = tid; i < nb && node0 + i < pr.n; i += kThreads) {
    const float pn = press[i];
    const unsigned long long k = key[i];
    const int vslot = pn > pr.watermark && k != 0 && key_finite(k) ? (int)(k & kSlotMask) : -1;
    info[node0 + i] = ((vslot + 1) << 1) | (pn < pr.safe);
    out.pressure[node0 + i] = pn;
  }
  PHASE(5);
  cluster.sync();  // every mask word is final; no shared memory is read after
  PHASE(6);

  // -- 2. the masks ----------------------------------------------------------
  int word[kMaxSteps], stick[kMaxSteps], sdl[kMaxSteps];
#pragma unroll
  for (int k = 0; k < kMaxSteps; ++k) {
    const int p = first + 32 * k;
    word[k] = stick[k] = sdl[k] = 0;
    if (k < steps && loc[k] >= 0 && (((run | susp) >> k) & 1u))  // victim or glass
      word[k] = __ldcg(info + (loc[k] >> 16) * nb + (loc[k] & 0xffff));
    if (k < steps && p < pr.p && pr.airlock) {
      stick[k] = in.stick[p];
      sdl[k] = in.sdl[p];
    }
  }
  const int t = pr.airlock ? *in.t : 0;
#pragma unroll
  for (int k = 0; k < kMaxSteps; ++k) {
    if (k >= steps) break;
    const int p = first + 32 * k;
    if (p >= pr.p) continue;
    const bool victim = (word[k] >> 1) - 1 == p;
    out.victim[p] = victim;
    if (!pr.airlock) {
      out.resume[p] = 0;
      out.react[p] = 0;
      out.expire[p] = 0;
      continue;
    }
    const bool mig_rc = ((mig >> k) & 1u) && !victim;
    const bool glass = (victim || ((susp >> k) & 1u)) && !mig_rc;  // st_rc == SUSPENDED
    const bool resume = glass && (word[k] & 1);  // a slot without a node has word 0
    const int stick_rc = victim ? t : stick[k];
    const bool react = glass && !resume && (t - stick_rc) > pr.t_susp;
    const int deadline = react ? t + pr.t_surv : sdl[k];
    // st_rc neither EMPTY nor RUNNING
    const bool live = victim || (!((empty >> k) & 1u) && !((run >> k) & 1u));
    out.resume[p] = resume;
    out.react[p] = react;
    out.expire[p] = (mig_rc || react) && t > deadline && live;
  }
  PHASE(7);
}

int g_smem_set = 0;       // the kernel's max dynamic shared memory, as set
bool g_nonportable = false;

// the launcher's attributes: dynamic shared memory up to `smem`, and
// clusters past 8 CTAs when `nonportable`
cudaError_t set_attributes(int smem, int nonportable) {
  cudaError_t e = cudaSuccess;
  if (smem > g_smem_set) {
    e = cudaFuncSetAttribute(survival_cluster_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    g_smem_set = smem;
  }
  if (nonportable && !g_nonportable) {
    e = cudaFuncSetAttribute(survival_cluster_kernel,
                             cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e != cudaSuccess) return e;
    g_nonportable = true;
  }
  return e;
}

cudaLaunchConfig_t config(int grid, int block, int cluster, int smem, cudaStream_t s,
                          cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid, 1, 1);
  cfg.blockDim = dim3(block, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

}  // namespace

// Bytes of dynamic shared memory one CTA needs for n nodes over a cluster.
extern "C" int survival_scan_smem_bytes(int n, int cluster) {
  return (int)layout(n, cluster).bytes;
}

// Number of int32 words of global scratch: the 16-byte entries, then one
// mask word per node.
extern "C" int survival_scan_scratch_words(int p, int n) {
  return 4 * p + n;
}

// Words between two seeds' scratch in a batched launch: a seed's words
// rounded up to whole 16-byte entries, so that every seed's entries are
// aligned.
extern "C" int survival_scan_scratch_stride(int p, int n) {
  return 4 * p + (n + 3) / 4 * 4;
}

namespace {

// The checks and the launch of both entries: `seeds` clusters, scratch
// `stride` words a seed
int launch_scan(const Inputs& in, const Outputs& out, void* scratch, int p, int n, int airlock,
                float residual, float watermark, float safe, int t_susp, int t_surv, int grid,
                int block, int cluster, int nonportable, int smem, int steps, int seeds,
                long long stride, void* stream) {
  if (n <= 0 || p < 0 || p > (1 << kSlotBits) || seeds < 1) return (int)cudaErrorInvalidValue;
  if (block != kThreads || cluster < 1 || cluster > kMaxCluster || grid != cluster ||
      (cluster > 8 && !nonportable))
    return (int)cudaErrorInvalidConfiguration;
  const long long per = (long long)cluster * kThreads;
  if (steps != (int)((p + per - 1) / per) || steps > kMaxSteps) return (int)cudaErrorInvalidValue;
  if (smem != (int)layout(n, cluster).bytes) return (int)cudaErrorInvalidValue;
  cudaError_t e = set_attributes(smem, nonportable);
  if (e != cudaSuccess) return (int)e;
  const int nb = layout(n, cluster).nb;
  Params pr{p, n, airlock, t_susp, t_surv, steps, ((1ull << 32) + nb - 1) / nb, residual,
            watermark, safe};
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg =
      config(grid * seeds, block, cluster, smem, (cudaStream_t)stream, attr);
  e = cudaLaunchKernelEx(&cfg, survival_cluster_kernel, in, out, pr, (int*)scratch, stride);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

Inputs inputs(const void* st, const void* node, const void* mem, const void* ev,
              const void* tier, const void* mig, const void* stick, const void* sdl,
              const void* base, const void* t) {
  return Inputs{(const int32_t*)st, (const int32_t*)node, (const float*)mem,
                (const float*)ev, (const int32_t*)tier, (const uint8_t*)mig,
                (const int32_t*)stick, (const int32_t*)sdl, (const float*)base,
                (const int32_t*)t};
}

}  // namespace

// Columns (p,): st, node (alloc_node), tier, stick (susp_tick), sdl
// (surv_deadline) int32; mem, ev float32; mig bool. base (n,) float32; t a
// 0-d int32 on the device. Outputs: pressure (n,) float32; victim, resume,
// react, expire (p,) bool. The launch plan (kernels/survival_scan/plan.py)
// gives the grid (one cluster: grid == cluster), the block, the cluster size
// and whether it is past the portable 8, the dynamic shared memory and the
// slots a thread holds (steps); the launcher refuses any of them other than
// what this source computes for (p, n), and a scratch smaller than
// survival_scan_scratch_words. Launches on `stream` (capturable in a CUDA
// graph) and returns the launch's error, else cudaGetLastError().
extern "C" int survival_scan_launch(
    const void* st, const void* node, const void* mem, const void* ev,
    const void* tier, const void* mig, const void* stick, const void* sdl,
    const void* base, const void* t, void* pressure, void* victim,
    void* resume, void* react, void* expire, void* scratch, int p, int n,
    int airlock, float residual, float watermark, float safe, int t_susp,
    int t_surv, int grid, int block, int cluster, int nonportable, int smem,
    int steps, int scratch_words, void* stream) {
  if (n > 0 && p >= 0 && scratch_words < survival_scan_scratch_words(p, n))
    return (int)cudaErrorInvalidValue;
  const Outputs out{(float*)pressure, (uint8_t*)victim, (uint8_t*)resume, (uint8_t*)react,
                    (uint8_t*)expire};
  return launch_scan(inputs(st, node, mem, ev, tier, mig, stick, sdl, base, t), out, scratch, p,
                     n, airlock, residual, watermark, safe, t_susp, t_surv, grid, block, cluster,
                     nonportable, smem, steps, 1, 0, stream);
}

// survival_scan_launch over `seeds` seeds in one launch: every column
// (seeds, p), base (seeds, n), t (seeds,), the outputs with the same leading
// axis, and survival_scan_scratch_stride(p, n) words of scratch a seed.
// grid, block, cluster, smem and steps are one seed's, as the unbatched
// launcher takes them; the launch has grid * seeds CTAs.
extern "C" int survival_scan_batched_launch(
    const void* st, const void* node, const void* mem, const void* ev,
    const void* tier, const void* mig, const void* stick, const void* sdl,
    const void* base, const void* t, void* pressure, void* victim,
    void* resume, void* react, void* expire, void* scratch, int p, int n,
    int airlock, float residual, float watermark, float safe, int t_susp,
    int t_surv, int grid, int block, int cluster, int nonportable, int smem,
    int steps, int seeds, int scratch_words, void* stream) {
  const long long stride = n > 0 && p >= 0 ? survival_scan_scratch_stride(p, n) : 0;
  if (seeds < 1 || scratch_words < (long long)seeds * stride) return (int)cudaErrorInvalidValue;
  const Outputs out{(float*)pressure, (uint8_t*)victim, (uint8_t*)resume, (uint8_t*)react,
                    (uint8_t*)expire};
  return launch_scan(inputs(st, node, mem, ev, tier, mig, stick, sdl, base, t), out, scratch, p,
                     n, airlock, residual, watermark, safe, t_susp, t_surv, grid, block, cluster,
                     nonportable, smem, steps, seeds, stride, stream);
}

#ifdef SURVIVAL_SCAN_PHASES
// The phase stamps of the last launch: out[16 * 8], CTA-major.
extern "C" int survival_scan_phases(unsigned long long* out) {
  return (int)cudaMemcpyFromSymbol(out, g_phase, sizeof(g_phase));
}
#endif

// Compiled attributes of kernel k (0: survival_cluster_kernel): out[0]
// static shared bytes, out[1] registers a thread, out[2] maxThreadsPerBlock.
extern "C" int survival_scan_attrs(int k, int* out) {
  if (k != 0) return (int)cudaErrorInvalidValue;
  cudaFuncAttributes a;
  const cudaError_t e = cudaFuncGetAttributes(&a, (const void*)survival_cluster_kernel);
  out[0] = (int)a.sharedSizeBytes;
  out[1] = a.numRegs;
  out[2] = a.maxThreadsPerBlock;
  return (int)e;
}

// The cluster launch as the card takes it, with the launcher's attributes
// set: out[0] clusters of `cluster` CTAs with `smem` bytes each that can be
// resident at once (cudaOccupancyMaxActiveClusters; 0: it cannot launch),
// out[1] the kernel's max dynamic shared memory, out[2] its
// nonPortableClusterSizeAllowed.
extern "C" int survival_scan_cluster_occupancy(int cluster, int smem, int nonportable, int* out) {
  cudaError_t e = set_attributes(smem, nonportable);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = config(cluster, kThreads, cluster, smem, 0, attr);
  int count = 0;
  e = cudaOccupancyMaxActiveClusters(&count, survival_cluster_kernel, &cfg);
  if (e != cudaSuccess) return (int)e;
  cudaFuncAttributes a;
  e = cudaFuncGetAttributes(&a, (const void*)survival_cluster_kernel);
  out[0] = count;
  out[1] = a.maxDynamicSharedSizeBytes;
  out[2] = a.nonPortableClusterSizeAllowed;
  return (int)e;
}
