// utility_topk: fused DA utility scoring + candidate argmax; on the flat and
// the sharded tick the whole DA addressing step in one launch.
//
// Replaces the TPU kernel src/repro/kernels/utility_topk/kernel.py
// (utility_topk_pallas, body _score_kernel), and the plain ops around it in
// repro/core/da.py address and repro/core/zhaf.py project.
//
// The TPU kernel's function (utility_topk_kernel, entry utility_topk): for
// each probe row of K candidates
//   score = log2(1 + max(S, 0)) - gamma * log2(1 + max(H, 0)) + eps,
// set to -3e38 where the candidate is infeasible; returns the first index of
// the row maximum and the maximum, as torch.max over a row (a NaN is the
// maximum, the first one wins; else ties keep the lowest index).
//
// The addressing step (utility_topk_address_kernel, entry
// utility_topk_address), for each slot with st == ADDRESSING, in order:
//  1. the K - 1 in-zone candidates zstart[zone] + floor(cand_u * max(zcount,
//     1)), clamped to [0, N - 1]; candidate 0 is here = max(node, 0);
//  2. zhaf.project of candidates 1.. (S, H projected tau ms ahead by their
//     derivatives, clamped at 0; degraded by 2^(-over / halflife) once the
//     report is older than degrade_after), candidate 0 the true view;
//  3. feasibility: run >= mass for a contiguous demand, else S >= mass;
//  4. the score and argmax above (the same __device__ functions);
//  5. the launchpad kept unless the best beats its score by more than
//     stay_margin, then stay (QUEUED) / bounce (BOUNCING, one hop, to the
//     target's zone) / nothing if no candidate is feasible; patience less
//     eval_cost (and bounce_cost); below fastfail_floor the probe
//     dissipates (SUSPENDED if migrating, else EMPTY).
// Any other slot is copied through. The counts (active, bounced and not
// failed, failed) are integer sums, exact in any order: each warp adds its
// counts into the seed's accumulator, and the seed's last CTA to finish
// moves them into the counts output (below), so no memset precedes the
// launch.
//
// Exactness: the plain version on the CPU (kernels/utility_topk/ref.py) is
// the reference, and every float op is rounded on its own as it rounds it
// (__fadd_rn / __fsub_rn / __fmul_rn / __fdiv_rn; the library is built with
// --fmad=false, so nothing is contracted into a fused multiply-add). The
// degrade exponent -over / halflife is a true division (__fdiv_rn), as the
// CPU divides by a Python scalar; PyTorch's CUDA ops would multiply by the
// reciprocal instead. max(x, 0) keeps a NaN, as torch.clamp does (fmaxf
// would not). log2f and exp2f are CUDA's (1 and 2 ulp), the CPU's are
// Sleef's or libm's: an ulp apart at most, which can flip an argmax or the
// launchpad's margin only at a near-tie. The launchpad's score is candidate
// 0's score itself, formed once.
//
// Bound: bytes. Every slot reads st and, to copy them through, node, zone,
// timer and patience, and writes the five; an addressing slot also reads
// mass, contig, migrating, its K - 1 + K draws and its candidates' entries
// of the node vectors (L2-resident: 5000 x 4 B each at Exp5). Design: a
// thread a slot, a warp 32 slots; a warp with no addressing slot
// (__ballot_sync) only copies. A slot's loads for a chunk of kChunk
// candidates are issued before its arithmetic (the chunk loop is unrolled,
// the candidates live in registers). A candidate whose report is within
// degrade_after (every one on the Exp5 and Exp7 ticks) skips the exp2f and
// the two divisions of the degrade, whose factor is then exactly 1; the
// time left is the launch and one lane's chain of dependent loads and
// log2f calls per addressing slot.
//
// Seed axis (the lockstep engine's batch): grid (ceil(P / 256), B), seed
// blockIdx.y on its own columns, draws, zones, nodes and tick; an unbatched
// call is B = 1. Counts: the accumulators live in g_acc_pool, zero when the
// module loads, 4 words a seed (the three counts and a ticket of finished
// CTAs) at the word offset the caller passes. Each warp adds into them; the
// seed's last CTA to take a ticket (after a __threadfence) moves the counts
// into the seed's output row and sets all four words back to zero, so a
// launch that ends leaves its region as it found it. Two launches that run
// at once must use two regions: the caller (kernels/utility_topk/ops.py,
// accumulator) gives each stream, and each captured CUDA graph, a region of
// its own. Bound: B times the bytes above.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = 8;  // candidates whose loads a slot issues together
constexpr float kNeg = -3.0e38f;
constexpr unsigned kFull = 0xffffffffu;
// state machine codes (repro_torch/core/state.py)
constexpr int32_t kEmpty = 0, kAddressing = 2, kBouncing = 3, kQueued = 4,
                  kSuspended = 7;

// max(x, 0) as torch.clamp(x, min=0): a NaN stays NaN
__device__ __forceinline__ float clamp0(float x) { return x < 0.0f ? 0.0f : x; }

__device__ __forceinline__ float log2p1(float x) {
  return log2f(__fadd_rn(1.0f, clamp0(x)));
}

// log2(1 + S) - gamma * log2(1 + H) + eps, each op rounded on its own
__device__ __forceinline__ float utility_score(float s, float h, float eps,
                                               float gamma) {
  return __fadd_rn(__fsub_rn(log2p1(s), __fmul_rn(gamma, log2p1(h))), eps);
}

// Does candidate j's score `sc` replace the best so far `bv` (torch.max over
// a row, scanned left to right: the first NaN wins, else a strictly larger)?
__device__ __forceinline__ bool takes_best(int j, float sc, float bv) {
  return j == 0 || (!isnan(bv) && (isnan(sc) || sc > bv));
}

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
    float sc = utility_score(s[row + j], h[row + j], eps[row + j], gamma);
    if (feas[row + j] == 0) sc = kNeg;  // a select, not a branch around the score
    if (takes_best(j, sc, bv)) {
      bv = sc;
      bi = j;
    }
  }
  best[i] = bi;
  val[i] = bv;
}

struct AddressArgs {
  // probe columns (P,)
  const int32_t* st;
  const int32_t* node;
  const int32_t* zone;
  const int32_t* timer;
  const float* patience;
  const uint8_t* migrating;
  const int32_t* mass;
  const uint8_t* contig;
  const float* cand_u;    // (P, K - 1)
  const float* addr_eps;  // (P, K)
  // zones (Z,)
  const int32_t* zstart;
  const int32_t* zcount;
  // nodes (N,)
  const int32_t* zone_id;
  const float* rep_s;
  const float* rep_h;
  const float* rep_run;
  const int32_t* rep_t;
  const float* ds;
  const float* dh;
  const float* s_true;
  const float* h_true;
  const float* run_true;
  const int32_t* t;  // the tick, a device scalar
  // outputs
  int32_t* st_o;
  int32_t* node_o;
  int32_t* zone_o;
  int32_t* timer_o;
  float* patience_o;
  int32_t* counts;  // (3,): op_eval, op_bounce, fastfail
  int p, k, n, projection;
  float gamma, sigma, margin, eval_cost, bounce_cost, floor_, tau, dt, after,
      halflife;
};

// slot i's addressing step; returns its warp's counts (active, bounced and
// not failed, failed), the same in every lane, all 0 when the warp has no
// addressing slot (it only copies)
__device__ __forceinline__ uint3 address_slot(const AddressArgs& a, int i) {
  const bool in = i < a.p;
  const int32_t st = in ? a.st[i] : kEmpty;
  const bool active = st == kAddressing;
  if (__ballot_sync(kFull, active) == 0) {  // no addressing slot in the warp
    if (in) {
      a.st_o[i] = st;
      a.node_o[i] = a.node[i];
      a.zone_o[i] = a.zone[i];
      a.timer_o[i] = a.timer[i];
      a.patience_o[i] = a.patience[i];
    }
    return make_uint3(0u, 0u, 0u);  // the whole warp
  }
  const int32_t node = in ? a.node[i] : 0;
  const int32_t zone = in ? a.zone[i] : 0;
  int32_t timer = in ? a.timer[i] : 0;
  float patience = in ? a.patience[i] : 0.0f;
  int32_t st_o = st, node_o = node, zone_o = zone;
  bool bounce = false, ff = false;
  if (active) {
    const bool migrating = a.migrating[i] != 0;
    const bool contig = a.contig[i] != 0;
    const float mass_f = (float)a.mass[i];
    const int32_t t = *a.t;
    const int32_t zstart = a.zstart[zone];
    const float zc = (float)max(a.zcount[zone], 1);
    const int32_t here = max(node, 0);
    // a halflife of 0 or NaN makes even 2^(-0 / halflife) NaN
    const bool halflife_ok = a.halflife != 0.0f && !isnan(a.halflife);
    const size_t urow = (size_t)i * (a.k - 1), erow = (size_t)i * a.k;
    int32_t bc = here;  // the best candidate's node
    float bv = kNeg, score0 = kNeg;
    bool any_feas = false, feas0 = false;
    for (int j0 = 0; j0 < a.k; j0 += kChunk) {
      int c[kChunk];
      float e[kChunk], rs[kChunk], rh[kChunk], rr[kChunk], ds[kChunk], dh[kChunk];
      int32_t rt[kChunk];
#pragma unroll
      for (int jj = 0; jj < kChunk; ++jj) {
        const int j = j0 + jj;
        c[jj] = here;
        if (j > 0 && j < a.k) {
          const float u = a.cand_u[urow + j - 1];
          const int32_t off = (int32_t)floorf(__fmul_rn(u, zc));
          c[jj] = min(max(zstart + off, 0), a.n - 1);
        }
      }
#pragma unroll
      for (int jj = 0; jj < kChunk; ++jj) {
        const int j = j0 + jj;
        if (j >= a.k) continue;
        e[jj] = a.addr_eps[erow + j];
        if (j == 0) {  // the node the DA stands on: its TRUE state
          rs[jj] = a.s_true[here];
          rh[jj] = a.h_true[here];
          rr[jj] = a.run_true[here];
        } else {
          rs[jj] = a.rep_s[c[jj]];
          rh[jj] = a.rep_h[c[jj]];
          rr[jj] = a.rep_run[c[jj]];
          rt[jj] = a.rep_t[c[jj]];
          if (a.projection) {
            ds[jj] = a.ds[c[jj]];
            dh[jj] = a.dh[c[jj]];
          }
        }
      }
#pragma unroll
      for (int jj = 0; jj < kChunk; ++jj) {
        const int j = j0 + jj;
        if (j >= a.k) continue;
        float se = rs[jj], he = rh[jj], re = rr[jj];
        if (j > 0) {  // zhaf.project
          if (a.projection) {
            se = clamp0(__fadd_rn(se, __fmul_rn(a.tau, ds[jj])));
            he = clamp0(__fadd_rn(he, __fmul_rn(a.tau, dh[jj])));
          }
          // t - rep_t wraps as int32 does on the CPU
          const float age =
              __fmul_rn((float)(int32_t)((uint32_t)t - (uint32_t)rt[jj]), a.dt);
          const float over = clamp0(__fsub_rn(age, a.after));
          // a report within degrade_after: 2^(-0 / halflife) is 1 exactly and
          // x * 1, x / max(1, 1e-6) are x, so the degrade is skipped
          if (!(over == 0.0f && halflife_ok)) {
            const float factor = exp2f(__fdiv_rn(-over, a.halflife));
            se = __fmul_rn(se, factor);
            he = __fdiv_rn(he, factor < 1e-6f ? 1e-6f : factor);
            re = __fmul_rn(re, factor);
          }
        }
        const bool feas = contig ? re >= mass_f : se >= mass_f;
        float sc = utility_score(se, he, __fmul_rn(a.sigma, e[jj]), a.gamma);
        if (!feas) sc = kNeg;  // a select, not a branch around the score
        if (j == 0) {
          feas0 = feas;
          score0 = sc;
        }
        any_feas |= feas;
        if (takes_best(j, sc, bv)) {
          bv = sc;
          bc = c[jj];
        }
      }
    }
    const bool prefer_here = feas0 && bv <= __fadd_rn(score0, a.margin);
    const int32_t target = prefer_here ? here : bc;
    const bool stay = any_feas && target == node;
    bounce = any_feas && target != node;
    patience = __fsub_rn(patience, a.eval_cost);
    if (bounce) patience = __fsub_rn(patience, a.bounce_cost);
    if (stay) st_o = kQueued;
    if (bounce) {
      st_o = kBouncing;
      node_o = target;
      timer = 1;  // single hop
      zone_o = a.zone_id[target];
    }
    ff = patience < a.floor_;  // Fast-Fail
    if (ff) st_o = migrating ? kSuspended : kEmpty;
  }
  if (in) {
    a.st_o[i] = st_o;
    a.node_o[i] = node_o;
    a.zone_o[i] = zone_o;
    a.timer_o[i] = timer;
    a.patience_o[i] = patience;
  }
  return make_uint3(__popc(__ballot_sync(kFull, active)),
                    __popc(__ballot_sync(kFull, bounce && !ff)), __popc(__ballot_sync(kFull, ff)));
}

constexpr int kAccPoolWords = 1 << 18;  // the pool of count accumulators
__device__ int g_acc_pool[kAccPoolWords];

// grid (ceil(p / kThreads), seeds): seed blockIdx.y's addressing step, z
// zones a seed; its count accumulators at g_acc_pool + acc + 4 * seed
__global__ void __launch_bounds__(kThreads)
utility_topk_address_kernel(AddressArgs a, int z, int acc) {
  const int b = blockIdx.y;
  const size_t cp = (size_t)b * a.p, cn = (size_t)b * a.n, cz = (size_t)b * z;
  a.st += cp;
  a.node += cp;
  a.zone += cp;
  a.timer += cp;
  a.patience += cp;
  a.migrating += cp;
  a.mass += cp;
  a.contig += cp;
  a.cand_u += cp * (a.k - 1);
  a.addr_eps += cp * a.k;
  a.zstart += cz;
  a.zcount += cz;
  a.zone_id += cn;
  a.rep_s += cn;
  a.rep_h += cn;
  a.rep_run += cn;
  a.rep_t += cn;
  a.ds += cn;
  a.dh += cn;
  a.s_true += cn;
  a.h_true += cn;
  a.run_true += cn;
  a.t += b;
  a.st_o += cp;
  a.node_o += cp;
  a.zone_o += cp;
  a.timer_o += cp;
  a.patience_o += cp;
  int* const sums = g_acc_pool + acc + 4 * b;  // three counts, then the ticket
  const uint3 c = address_slot(a, blockIdx.x * blockDim.x + threadIdx.x);
  if ((threadIdx.x & 31) == 0 && c.x) {  // a warp with an addressing slot
    atomicAdd(&sums[0], (int)c.x);
    if (c.y) atomicAdd(&sums[1], (int)c.y);
    if (c.z) atomicAdd(&sums[2], (int)c.z);
  }
  __threadfence();  // this thread's adds are seen before its CTA's ticket
  __syncthreads();
  if (threadIdx.x == 0 && atomicAdd((unsigned*)&sums[3], 1u) == gridDim.x - 1) {
    __threadfence();  // the seed's last CTA: every other CTA's adds are in
    for (int j = 0; j < 3; ++j) a.counts[3 * (size_t)b + j] = atomicExch(&sums[j], 0);
    atomicExch(&sums[3], 0);
  }
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

namespace {

// The launchers' arguments: ptrs the 23 inputs in the order of AddressArgs
// (st ... t), then the outputs st, node, zone, timer, patience and counts;
// ints p, k, n, projection; floats the ten scalars
AddressArgs address_args(void* const* ptrs, const int* ints, const float* floats) {
  AddressArgs a;
  const void* const* src = (const void* const*)ptrs;
  a.st = (const int32_t*)src[0];
  a.node = (const int32_t*)src[1];
  a.zone = (const int32_t*)src[2];
  a.timer = (const int32_t*)src[3];
  a.patience = (const float*)src[4];
  a.migrating = (const uint8_t*)src[5];
  a.mass = (const int32_t*)src[6];
  a.contig = (const uint8_t*)src[7];
  a.cand_u = (const float*)src[8];
  a.addr_eps = (const float*)src[9];
  a.zstart = (const int32_t*)src[10];
  a.zcount = (const int32_t*)src[11];
  a.zone_id = (const int32_t*)src[12];
  a.rep_s = (const float*)src[13];
  a.rep_h = (const float*)src[14];
  a.rep_run = (const float*)src[15];
  a.rep_t = (const int32_t*)src[16];
  a.ds = (const float*)src[17];
  a.dh = (const float*)src[18];
  a.s_true = (const float*)src[19];
  a.h_true = (const float*)src[20];
  a.run_true = (const float*)src[21];
  a.t = (const int32_t*)src[22];
  a.st_o = (int32_t*)ptrs[23];
  a.node_o = (int32_t*)ptrs[24];
  a.zone_o = (int32_t*)ptrs[25];
  a.timer_o = (int32_t*)ptrs[26];
  a.patience_o = (float*)ptrs[27];
  a.counts = (int32_t*)ptrs[28];
  a.p = ints[0];
  a.k = ints[1];
  a.n = ints[2];
  a.projection = ints[3];
  a.gamma = floats[0];
  a.sigma = floats[1];
  a.margin = floats[2];
  a.eval_cost = floats[3];
  a.bounce_cost = floats[4];
  a.floor_ = floats[5];
  a.tau = floats[6];
  a.dt = floats[7];
  a.after = floats[8];
  a.halflife = floats[9];
  return a;
}

}  // namespace

// The addressing step over `seeds` seeds. ptrs: the 23 inputs in the order
// of AddressArgs (st ... t), then the outputs st, node, zone, timer,
// patience and counts (3,) int32 a seed, every one with a leading seed axis
// (the zones' (seeds, z), the tick (seeds,)). ints: p, k, n, projection
// (0/1), z, and the word offset of the seeds' count accumulators in
// g_acc_pool (4 words a seed); floats: gamma, sigma, stay_margin,
// eval_cost, bounce_cost, fastfail_floor, tau, dt_ms, degrade_after_ms,
// degrade_halflife_ms. grid and block are one seed's, from the caller's
// launch plan; the launch's grid is (grid, seeds). A block other than
// kThreads, a grid short of p slots, or accumulators past the pool are
// refused. Returns cudaGetLastError().
extern "C" int utility_topk_address_batched_launch(void* const* ptrs, const int* ints,
                                                   const float* floats, int grid, int block,
                                                   int seeds, void* stream) {
  AddressArgs a = address_args(ptrs, ints, floats);
  const int z = ints[4], acc = ints[5];
  if (a.p <= 0 || seeds < 1 || seeds > 65535 || z < 0 || a.k < 1 || a.n < 1 || acc < 0 ||
      (long long)acc + 4LL * seeds > kAccPoolWords)
    return (int)cudaErrorInvalidValue;
  if (block != kThreads || grid < 1 || (long long)grid * block < a.p)
    return (int)cudaErrorInvalidConfiguration;
  utility_topk_address_kernel<<<dim3(grid, seeds), block, 0, (cudaStream_t)stream>>>(a, z, acc);
  return (int)cudaGetLastError();
}

// utility_topk_address_batched_launch of one seed: the inputs and outputs
// without the seed axis (counts (3,)).
extern "C" int utility_topk_address_launch(void* const* ptrs, const int* ints,
                                           const float* floats, int grid, int block,
                                           void* stream) {
  return utility_topk_address_batched_launch(ptrs, ints, floats, grid, block, 1, stream);
}

// The id of the CUDA graph capture under way on `stream`, 0 when none.
extern "C" int utility_topk_capture_id(void* stream, unsigned long long* id) {
  cudaStreamCaptureStatus status;
  unsigned long long i = 0;
  const cudaError_t e = cudaStreamGetCaptureInfo((cudaStream_t)stream, &status, &i);
  *id = status == cudaStreamCaptureStatusActive ? i : 0;
  return (int)e;
}

// Compiled attributes of kernel k (0: utility_topk_kernel, 1:
// utility_topk_address_kernel):
// out[0] static shared bytes, out[1] registers a thread, out[2]
// maxThreadsPerBlock.
extern "C" int utility_topk_attrs(int k, int* out) {
  cudaFuncAttributes a;
  cudaError_t e;
  if (k == 0)
    e = cudaFuncGetAttributes(&a, utility_topk_kernel);
  else if (k == 1)
    e = cudaFuncGetAttributes(&a, utility_topk_address_kernel);
  else
    return (int)cudaErrorInvalidValue;
  out[0] = (int)a.sharedSizeBytes;
  out[1] = a.numRegs;
  out[2] = a.maxThreadsPerBlock;
  return (int)e;
}
