// survival_scan: the fused per-tick Airlock survival decision.
//
// Replaces the TPU kernel src/repro/kernels/survival_scan/kernel.py
// (survival_scan_pallas, body _scan_kernel, grid (5, P/512)).
//
// Five dependent phases over the probe table (P slots) and N node
// accumulators:
//   0. pressure[n] = base[n] + the effective memory of every slot held on n,
//      added in probe-slot order (resident: mem; suspended or migrating:
//      mem * residual);
//   1. (Airlock) the worst (highest) tier among each over-watermark node's
//      resident candidates;
//   2. the best score per node: -ev under Airlock, mem under kernel OOM;
//   3. the highest slot among each node's top scorers;
//   4. the victim mask, then the resume / react / expire masks.
//
// The TPU kernel carries its node accumulators across a sequential grid. On
// Hopper blocks run in no order, so each phase is its own launch on the
// stream, and the launch boundary is the barrier between phases.
//
// Exactness of phase 0: the sum must run per node in slot order, starting
// from base, as the reference scatter-add does; a float atomicAdd would
// reorder it, and `pressure > watermark` would then flip victims. So phase 0
// is a bucket sort by node: count per node (integer atomics), an exclusive
// scan of the counts, placement of (slot, value) pairs into each node's
// bucket (atomics give the pairs in any order), then one thread per node sorts
// its bucket by slot and folds it from base with __fadd_rn. Slots whose
// effective memory is exactly zero are left out: adding +0.0 to the
// non-negative running sum changes nothing. mem * residual is __fmul_rn.
// Phases 1-3 are maxima, which do not depend on order: integer atomicMax,
// with an order-preserving float -> int encoding for the score.
//
// Bound: bytes. The inputs are 8 columns of P (29 B a slot) plus base, the
// outputs pressure and four P-byte masks; every phase is a few operations a
// slot. The launch count (up to 9) and the per-node fold (one thread per node,
// serial over its bucket) set the time at this size, not the bytes.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kEmpty = 0;
constexpr int kRunning = 6;
constexpr int kSuspended = 7;
constexpr int kThreads = 256;
constexpr int kScanThreads = 1024;

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

struct Scratch {
  int32_t* cnt;    // (N) entries per node
  int32_t* cur;    // (N) placement cursor per node
  int32_t* off;    // (N + 1) exclusive offsets of the buckets
  int32_t* btier;  // (N) worst candidate tier
  int32_t* bscore; // (N) encoded best score
  int32_t* bslot;  // (N) highest top-scoring slot
  int32_t* eslot;  // (P) bucket entries: slot
  float* eval;     // (P) bucket entries: effective memory
};

struct Params {
  int p, n, airlock, t_susp, t_surv;
  float residual, watermark, safe;
};

// order-preserving float <-> int32 encoding, for integer atomicMax
__device__ __forceinline__ int32_t enc(float f) {
  const int32_t i = __float_as_int(f);
  return i >= 0 ? i : i ^ 0x7fffffff;
}
__device__ __forceinline__ float dec(int32_t k) {
  return __int_as_float(k >= 0 ? k : k ^ 0x7fffffff);
}

__device__ __forceinline__ float mem_eff(const Inputs& in, int p, float residual) {
  const int st = in.st[p];
  const bool valid = in.node[p] >= 0;
  if (st == kRunning) return in.mem[p];
  if (st == kSuspended || (in.mig[p] != 0 && valid)) return __fmul_rn(in.mem[p], residual);
  return 0.0f;
}

__global__ void init_kernel(Scratch sc, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  sc.cnt[i] = 0;
  sc.cur[i] = 0;
  sc.btier[i] = -1;
  sc.bscore[i] = enc(-INFINITY);
  sc.bslot[i] = -1;
}

__global__ void count_kernel(Inputs in, Scratch sc, Params pr) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= pr.p) return;
  const int node = in.node[p];
  if (node < 0 || mem_eff(in, p, pr.residual) == 0.0f) return;
  atomicAdd(&sc.cnt[node], 1);
}

// exclusive scan of cnt[0..n) into off[0..n], one block
__global__ void scan_kernel(Scratch sc, int n) {
  __shared__ int32_t part[kScanThreads];
  const int per = (n + kScanThreads - 1) / kScanThreads;
  const int lo = min(threadIdx.x * per, n);
  const int hi = min(lo + per, n);
  int32_t sum = 0;
  for (int i = lo; i < hi; ++i) sum += sc.cnt[i];
  part[threadIdx.x] = sum;
  __syncthreads();
  for (int d = 1; d < kScanThreads; d *= 2) {  // Hillis-Steele inclusive scan
    const int32_t v = threadIdx.x >= d ? part[threadIdx.x - d] : 0;
    __syncthreads();
    part[threadIdx.x] += v;
    __syncthreads();
  }
  int32_t run = part[threadIdx.x] - sum;  // exclusive prefix of this chunk
  for (int i = lo; i < hi; ++i) {
    sc.off[i] = run;
    run += sc.cnt[i];
  }
  if (threadIdx.x == kScanThreads - 1) sc.off[n] = part[kScanThreads - 1];
}

__global__ void place_kernel(Inputs in, Scratch sc, Params pr) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= pr.p) return;
  const int node = in.node[p];
  if (node < 0) return;
  const float v = mem_eff(in, p, pr.residual);
  if (v == 0.0f) return;
  const int pos = sc.off[node] + atomicAdd(&sc.cur[node], 1);
  sc.eslot[pos] = p;
  sc.eval[pos] = v;
}

// one thread per node: sort the bucket by slot, fold it from base in order
__global__ void fold_kernel(Inputs in, Scratch sc, float* __restrict__ pressure, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int lo = sc.off[i], hi = sc.off[i + 1];
  for (int a = lo + 1; a < hi; ++a) {  // insertion sort, buckets are short
    const int32_t ks = sc.eslot[a];
    const float kv = sc.eval[a];
    int b = a - 1;
    while (b >= lo && sc.eslot[b] > ks) {
      sc.eslot[b + 1] = sc.eslot[b];
      sc.eval[b + 1] = sc.eval[b];
      --b;
    }
    sc.eslot[b + 1] = ks;
    sc.eval[b + 1] = kv;
  }
  float acc = in.base[i];
  for (int e = lo; e < hi; ++e) acc = __fadd_rn(acc, sc.eval[e]);
  pressure[i] = acc;
}

// resident slot on a node over the watermark (phases 1-4 share it)
__device__ __forceinline__ bool pre_candidate(const Inputs& in, const float* pressure,
                                              const Params& pr, int p, int* node_out) {
  const int node = in.node[p];
  *node_out = node;
  return node >= 0 && in.st[p] == kRunning && pressure[node] > pr.watermark;
}

__device__ __forceinline__ bool candidate(const Inputs& in, const Scratch& sc,
                                          const float* pressure, const Params& pr,
                                          int p, int* node, float* score) {
  if (!pre_candidate(in, pressure, pr, p, node)) return false;
  if (pr.airlock && in.tier[p] != sc.btier[*node]) return false;
  *score = pr.airlock ? -in.ev[p] : in.mem[p];
  return true;
}

__global__ void tier_kernel(Inputs in, Scratch sc, const float* __restrict__ pressure, Params pr) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= pr.p) return;
  int node;
  if (pre_candidate(in, pressure, pr, p, &node)) atomicMax(&sc.btier[node], in.tier[p]);
}

__global__ void score_kernel(Inputs in, Scratch sc, const float* __restrict__ pressure, Params pr) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= pr.p) return;
  int node;
  float score;
  if (candidate(in, sc, pressure, pr, p, &node, &score)) atomicMax(&sc.bscore[node], enc(score));
}

__device__ __forceinline__ bool topper(const Inputs& in, const Scratch& sc,
                                       const float* pressure, const Params& pr,
                                       int p, int* node) {
  float score;
  if (!candidate(in, sc, pressure, pr, p, node, &score)) return false;
  return score == dec(sc.bscore[*node]) && isfinite(score);
}

__global__ void slot_kernel(Inputs in, Scratch sc, const float* __restrict__ pressure, Params pr) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= pr.p) return;
  int node;
  if (topper(in, sc, pressure, pr, p, &node)) atomicMax(&sc.bslot[node], p);
}

__global__ void mask_kernel(Inputs in, Scratch sc, const float* __restrict__ pressure,
                            Params pr, uint8_t* __restrict__ victim_out,
                            uint8_t* __restrict__ resume_out,
                            uint8_t* __restrict__ react_out,
                            uint8_t* __restrict__ expire_out) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= pr.p) return;
  int node;
  const bool victim = topper(in, sc, pressure, pr, p, &node) && sc.bslot[node] == p;
  victim_out[p] = victim;
  if (!pr.airlock) {
    resume_out[p] = 0;
    react_out[p] = 0;
    expire_out[p] = 0;
    return;
  }
  const int t = *in.t;
  node = in.node[p];
  const bool valid = node >= 0;
  const int node_c = min(max(node, 0), pr.n - 1);
  const int st_rc = victim ? kSuspended : in.st[p];
  const bool mig_rc = in.mig[p] != 0 && !victim;
  const int stick_rc = victim ? t : in.stick[p];
  const bool node_ok = pressure[node_c] < pr.safe;
  const bool glass = st_rc == kSuspended && !mig_rc;
  const bool resume = glass && node_ok && valid;
  const bool react = glass && !resume && (t - stick_rc) > pr.t_susp;
  const int deadline = react ? t + pr.t_surv : in.sdl[p];
  const bool expire = (mig_rc || react) && t > deadline && st_rc != kEmpty && st_rc != kRunning;
  resume_out[p] = resume;
  react_out[p] = react;
  expire_out[p] = expire;
}

}  // namespace

// Number of int32 words of scratch the eight carve-outs need for (p, n).
extern "C" int survival_scan_scratch_words(int p, int n) {
  return 6 * n + 1 + 2 * p;
}

// Columns (p,): st, node (alloc_node), tier, stick (susp_tick), sdl
// (surv_deadline) int32; mem, ev float32; mig bool. base (n,) float32; t a
// 0-d int32 on the device. Outputs: pressure (n,) float32; victim, resume,
// react, expire (p,) bool. The launch plan (kernels/survival_scan/plan.py)
// gives grid and block of each of the nine slots (init, count, scan, place,
// fold, tier, score, slot, mask; grid 0: not launched) and the offsets of
// the eight scratch carve-outs (cnt, cur, off, btier, bscore, bslot, eslot,
// eval) inside the `scratch_words` words the caller allocated. A block other
// than the compiled one, or a carve-out outside the scratch, is refused.
// Launches on `stream` and returns cudaGetLastError().
extern "C" int survival_scan_launch(
    const void* st, const void* node, const void* mem, const void* ev,
    const void* tier, const void* mig, const void* stick, const void* sdl,
    const void* base, const void* t, void* pressure, void* victim,
    void* resume, void* react, void* expire, void* scratch, int p, int n,
    int airlock, float residual, float watermark, float safe, int t_susp,
    int t_surv, const int* grids, const int* blocks, const int* carve,
    int scratch_words, void* stream) {
  if (n <= 0 || p < 0) return (int)cudaErrorInvalidValue;
  if (scratch_words < survival_scan_scratch_words(p, n)) return (int)cudaErrorInvalidValue;
  const int lens[8] = {n, n, n + 1, n, n, n, p, p};
  for (int k = 0; k < 8; ++k) {
    if (carve[k] < 0 || carve[k] > scratch_words - lens[k]) return (int)cudaErrorInvalidValue;
  }
  const int want[9] = {kThreads, kThreads, kScanThreads, kThreads, kThreads,
                       kThreads, kThreads, kThreads, kThreads};
  for (int k = 0; k < 9; ++k) {
    if (grids[k] < 0 || (grids[k] > 0 && blocks[k] != want[k]))
      return (int)cudaErrorInvalidConfiguration;
  }
  cudaStream_t s = (cudaStream_t)stream;
  Inputs in{(const int32_t*)st, (const int32_t*)node, (const float*)mem,
            (const float*)ev, (const int32_t*)tier, (const uint8_t*)mig,
            (const int32_t*)stick, (const int32_t*)sdl, (const float*)base,
            (const int32_t*)t};
  int32_t* w = (int32_t*)scratch;
  Scratch sc{w + carve[0], w + carve[1], w + carve[2], w + carve[3],
             w + carve[4], w + carve[5], w + carve[6], (float*)(w + carve[7])};
  Params pr{p, n, airlock, t_susp, t_surv, residual, watermark, safe};
  float* press = (float*)pressure;

  if (grids[0]) init_kernel<<<grids[0], blocks[0], 0, s>>>(sc, n);
  if (grids[1]) count_kernel<<<grids[1], blocks[1], 0, s>>>(in, sc, pr);
  if (grids[2]) scan_kernel<<<grids[2], blocks[2], 0, s>>>(sc, n);
  if (grids[3]) place_kernel<<<grids[3], blocks[3], 0, s>>>(in, sc, pr);
  if (grids[4]) fold_kernel<<<grids[4], blocks[4], 0, s>>>(in, sc, press, n);
  if (grids[5]) tier_kernel<<<grids[5], blocks[5], 0, s>>>(in, sc, press, pr);
  if (grids[6]) score_kernel<<<grids[6], blocks[6], 0, s>>>(in, sc, press, pr);
  if (grids[7]) slot_kernel<<<grids[7], blocks[7], 0, s>>>(in, sc, press, pr);
  if (grids[8])
    mask_kernel<<<grids[8], blocks[8], 0, s>>>(in, sc, press, pr, (uint8_t*)victim,
                                               (uint8_t*)resume, (uint8_t*)react,
                                               (uint8_t*)expire);
  return (int)cudaGetLastError();
}

// Compiled attributes of kernel k in the slot order above: out[0] static
// shared bytes, out[1] registers a thread, out[2] maxThreadsPerBlock.
extern "C" int survival_scan_attrs(int k, int* out) {
  const void* fns[9] = {(const void*)init_kernel, (const void*)count_kernel,
                        (const void*)scan_kernel, (const void*)place_kernel,
                        (const void*)fold_kernel, (const void*)tier_kernel,
                        (const void*)score_kernel, (const void*)slot_kernel,
                        (const void*)mask_kernel};
  if (k < 0 || k >= 9) return (int)cudaErrorInvalidValue;
  cudaFuncAttributes a;
  const cudaError_t e = cudaFuncGetAttributes(&a, fns[k]);
  out[0] = (int)a.sharedSizeBytes;
  out[1] = a.numRegs;
  out[2] = a.maxThreadsPerBlock;
  return (int)e;
}
