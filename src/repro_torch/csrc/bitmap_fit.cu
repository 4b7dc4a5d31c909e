// bitmap_fit: per-node feasibility of a demand of m atoms against the node's
// free-atom bitmap words, and bitmap_fit_rounds: every arbitration round of
// a tick (election, feasibility and allocation) in one launch.
//
// Replaces the TPU kernel src/repro/kernels/bitmap_fit/kernel.py
// (bitmap_fit_pallas, body _fit_kernel, helpers _popcount and _shr128).
//
// The fit test (fit_words). Dispersed demand (contig == 0): popcount >= m.
// Contiguous demand: the shift-AND run-doubling of _fit_kernel, with the
// same step count (bit_length(32 W - 1)) and the same clamp of each shift to
// 32, so the result is the TPU kernel's bit for bit. m == 0 is always
// feasible.
//
// bitmap_fit_kernel: one thread per node, the W words in registers, __popc
// for the count and a funnel shift for the cross-word carry. Bound: bytes
// (13 B + 4 W a node; a few dozen integer operations).
//
// bitmap_fit_rounds_kernel computes what R calls of the arbiter's one round
// compute (bitmap_fit_rounds_ref): in round r each node elects the queued
// probe (st == QUEUED, node not throttled) of the largest (ev, slot), none if
// that ev is not finite; the winner's demand must pass the fit test on the
// node's words after its earlier rounds and find atoms under the allocation
// policy; the atoms it takes leave the words. A winner leaves the queue
// whether it is admitted or not, and nothing else changes between rounds,
// so round r's winner is the r-th largest (ev, slot) queued on the node at
// the start, while every earlier round elected someone: the rounds are
// independent across nodes.
//
// Design: one cluster of 16 CTAs of 512 threads (barrier.cluster between
// phases, no dependent launches). CTA c owns the probe slots [c * pc,
// (c + 1) * pc) and the nodes [c * nb, (c + 1) * nb).
//   0. each CTA sets its nodes' R key slots (global scratch, slot r of node
//      n at r * N + n) to 0 and the per-probe outputs of its slots to
//      (round -1, not admitted);
//   1. every queued probe inserts its key (order-preserving ev bits << 32 |
//      slot; -0.0 is made +0.0, NaN goes above +inf) into its node's R
//      slots by a cascade of 64-bit atomicMax in global memory: the value
//      that loses at slot r goes on to slot r + 1. Each slot keeps the
//      maximum of what reaches it and passes the rest on, so whatever the
//      order of the atomics, slot r ends with the (r + 1)-th largest key of
//      the node: the result does not depend on the order. A -inf ev never
//      wins and is not inserted. A cascade waits on each atomic's old value,
//      so each warp first gathers the keys of its queued probes (8 steps of
//      32 slots, __ballot_sync, 32 KiB of shared memory a CTA) and its lanes
//      then run the cascades side by side;
//   2. one thread per node reads its first key: no winner at all if it is
//      empty or not finite (a queued +inf or NaN blocks its node, as the
//      reference's scatter-max gives NaN or +inf there), else round r's
//      winner is slot r's key. Its other keys and words, then the winners'
//      demands, are loaded together; the R fit-and-allocate steps run on
//      the words in registers, and each round's winner, feasibility and
//      taken words, and the winners' round and admission, are written.
// Allocation (alloc_class), on the A atoms of the words held as ceil(W / 2)
// 64-bit registers (one instantiation of the kernel for each): "best" takes
// a dispersed demand from the shortest free runs first, lowest index on
// ties (alloc_dispersed_bestfit: the m smallest keys tot * (A + 1) + idx),
// and a contiguous one as the first m atoms of the shortest run of length
// >= m, earliest on ties; "first" takes the lowest m free atoms, or the
// first m atoms of the earliest run of length >= m. A contiguous m <= 0 and
// a demand past the free atoms are infeasible. The allocation walks the
// node's free runs (__ffsll on the runs' first and last atoms), so its cost
// grows with the runs: on the Exp5 and Exp7 ticks a node that reaches the
// allocation has 1 to 7 of them (repro_torch.profile_tick and
// repro_torch.kernel_bench --rounds count them).
//
// Bound of the rounds: bytes. The probe columns st, node, ev read once (mass
// and contig at the winners only), the node words and throttled flags once,
// the outputs written once.
//
// bitmap_fit_rounds_blocked_kernel is the same body on one rank's zone
// block of the zone-sharded engine (the redesign of the TPU package's
// zone-blocked entry bitmap_fit_blocked, src/repro/kernels/bitmap_fit/ops.py,
// which ran the fit test alone, one launch a round): the (Zb, M) slots of
// the block take the place of the nodes. A slot's node is member[slot], its
// words are read through it, and a padding slot (mask 0) elects no one.
// Phase 1 keys a probe by local[node] (node -> its slot in this block, -1
// for a node of another rank: the probe is skipped), while the key's low 32
// bits stay the global probe slot, so the election order is the flat
// kernel's. Each node lies in exactly one rank's block and the rounds are
// independent across nodes, so no rank needs another's nodes; the outputs
// are (R, Zb, M) in the blocked layout, and no per-probe output is written
// (a rank does not own every probe). Bound: bytes, as above, with local of
// each queued probe's node and member and mask of each slot with a winner.
//
// bitmap_fit_rounds_batched_launch (the lockstep engine's seed axis) runs
// the flat rounds of B seeds in one launch of bitmap_fit_rounds_kernel: B
// clusters, cluster b on seed b's columns, words, flags, outputs and keys
// (offsets added to the same body's addressing; no barrier spans two
// seeds). Clusters past what the card holds at once run in later waves.
// Bound: B times the bytes above.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxWords = 8;  // up to 256 atoms per node
constexpr int kThreads = 256;
constexpr int kRoundThreads = 512;
constexpr int kRoundWarps = kRoundThreads / 32;
constexpr int kChunk = 8;      // steps of 32 slots a warp gathers before its cascades
constexpr int kMaxRounds = 8;  // arbitration rounds a launch runs
constexpr int kMaxCluster = 16;
constexpr int kQueued = 4;  // core/state.py QUEUED

// Logical right shift of the 64-bit pair (nxt:cur) by t in [0, 32], low word,
// as _shr128 computes it word by word. __funnelshift_r masks its shift to
// 0..31: t == 0 gives cur as wanted, but t == 32 would give cur as well,
// where _shr128 gives the next word, so that edge is taken apart here.
__device__ __forceinline__ uint32_t shr_pair(uint32_t cur, uint32_t nxt, int t) {
  if (t >= 32) return nxt;
  return __funnelshift_r(cur, nxt, t);
}

// The fit test of _fit_kernel on the w <= K words of b (all 32 w bits).
template <int K>
__device__ __forceinline__ bool fit_words(const uint32_t (&b)[K], int w, int m, bool contig,
                                          int n_steps) {
  if (!contig) {
    int pc = 0;
#pragma unroll
    for (int k = 0; k < K; ++k) pc += k < w ? __popc(b[k]) : 0;
    return pc >= m;
  }
  uint32_t c[K];
#pragma unroll
  for (int k = 0; k < K; ++k) c[k] = k < w ? b[k] : 0u;
  int rem = max(m - 1, 0);
  int s = 1;
  for (int step = 0; step < n_steps; ++step) {
    const int t = min(min(s, rem), 32);
    uint32_t sh[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const uint32_t nxt = (k + 1 < w) ? c[k + 1] : 0u;
      sh[k] = k < w ? shr_pair(c[k], nxt, t) : 0u;
    }
#pragma unroll
    for (int k = 0; k < K; ++k) c[k] &= sh[k];
    rem -= t;
    s *= 2;
  }
  uint32_t any = 0;
#pragma unroll
  for (int k = 0; k < K; ++k) any |= c[k];
  return (any != 0u && m > 0) || m == 0;
}

// ---- allocation on the atoms of one node, held as NW 64-bit words in
// registers (atom 64 k + i is bit i of word k): a[] the free atoms (bits
// past A cleared), t[] the taken ones (zeroed by the caller); the free runs
// are walked, one __ffsll for each end. ------------------------------------

__device__ __forceinline__ uint64_t low_mask(int n) {  // bits [0, n), n clamped to [0, 64]
  return n >= 64 ? ~0ull : (n <= 0 ? 0ull : (1ull << n) - 1ull);
}

template <int NW>
__device__ __forceinline__ int popcount(const uint64_t (&x)[NW]) {
  int c = 0;
#pragma unroll
  for (int k = 0; k < NW; ++k) c += __popcll((long long)x[k]);
  return c;
}

template <int NW>
__device__ __forceinline__ int lowest_set(const uint64_t (&x)[NW]) {  // -1 if none
  int at = -1;
#pragma unroll
  for (int k = NW - 1; k >= 0; --k)
    if (x[k]) at = 64 * k + __ffsll((long long)x[k]) - 1;
  return at;
}

template <int NW>
__device__ __forceinline__ void clear_lowest(uint64_t (&x)[NW]) {
  bool done = false;
#pragma unroll
  for (int k = 0; k < NW; ++k) {
    const bool hit = !done && x[k] != 0ull;
    if (hit) x[k] &= x[k] - 1ull;
    done = done || hit;
  }
}

// s: the first atom of each free run, e: the last
template <int NW>
__device__ __forceinline__ void run_marks(const uint64_t (&a)[NW], uint64_t (&s)[NW],
                                          uint64_t (&e)[NW]) {
#pragma unroll
  for (int k = 0; k < NW; ++k) {
    const uint64_t below = k > 0 ? a[k - 1] >> 63 : 0ull;
    const uint64_t above = k + 1 < NW ? a[k + 1] << 63 : 0ull;
    s[k] = a[k] & ~((a[k] << 1) | below);
    e[k] = a[k] & ~((a[k] >> 1) | above);
  }
}

// f(lo, hi) for each free run [lo, hi), lowest first, while f returns true
template <int NW, class F>
__device__ __forceinline__ void for_runs(const uint64_t (&s0)[NW], const uint64_t (&e0)[NW],
                                         F&& f) {
  uint64_t s[NW], e[NW];
#pragma unroll
  for (int k = 0; k < NW; ++k) {
    s[k] = s0[k];
    e[k] = e0[k];
  }
  for (int lo = lowest_set(s); lo >= 0; lo = lowest_set(s)) {
    if (!f(lo, lowest_set(e) + 1)) return;
    clear_lowest(s);
    clear_lowest(e);
  }
}

// the lowest n set bits of one word (n < popcount(x)): below the (n+1)-th
__device__ __forceinline__ uint64_t lowest_bits(uint64_t x, int n) {
  int pos = 0;
#pragma unroll
  for (int half = 32; half >= 1; half >>= 1) {  // binary search on popcounts
    const int c = __popcll((long long)(x & low_mask(pos + half)));
    if (c <= n) pos += half;
  }
  return x & low_mask(pos);
}

// t |= the lowest n set bits of x
template <int NW>
__device__ __forceinline__ void take_lowest(const uint64_t (&x)[NW], int n, uint64_t (&t)[NW]) {
#pragma unroll
  for (int k = 0; k < NW; ++k) {
    const int c = __popcll((long long)x[k]);
    t[k] |= n >= c ? x[k] : (n > 0 ? lowest_bits(x[k], n) : 0ull);
    n -= min(n, c);
  }
}

template <int NW>
__device__ __forceinline__ void set_range(uint64_t (&t)[NW], int lo, int hi) {
#pragma unroll
  for (int k = 0; k < NW; ++k) t[k] |= low_mask(hi - 64 * k) & ~low_mask(lo - 64 * k);
}

// the first m atoms of the earliest free run of length >= m ("first"), or
// of the shortest such run, earliest on ties ("best")
template <int NW>
__device__ bool alloc_contiguous(const uint64_t (&s)[NW], const uint64_t (&e)[NW], int m,
                                 bool best, uint64_t (&t)[NW]) {
  if (m <= 0 || m > 64 * NW) return false;
  int at = -1, len_at = 0;
  for_runs(s, e, [&](int lo, int hi) {
    if (hi - lo >= m && (at < 0 || hi - lo < len_at)) {
      at = lo;
      len_at = hi - lo;
      return best && len_at > m;
    }
    return true;
  });
  if (at < 0) return false;
  set_range(t, at, at + m);
  return true;
}

// the m free atoms of the least (run length, index), 0 < m <= the free
// atoms: the least L whose runs of length <= L hold m atoms (L over the
// distinct run lengths, ascending), then every run shorter than L and the
// lowest atoms of the runs of length L
template <int NW>
__device__ void alloc_dispersed_best(const uint64_t (&s)[NW], const uint64_t (&e)[NW], int m,
                                     uint64_t (&t)[NW]) {
  int below = 0, prev = 0, L = 0;
  for (;;) {
    int at_len = 0;
    L = 0x7fffffff;
    for_runs(s, e, [&](int lo, int hi) {
      const int len = hi - lo;
      if (len > prev && len < L) {
        L = len;
        at_len = len;
      } else if (len == L) {
        at_len += len;
      }
      return true;
    });
    if (below + at_len >= m) break;
    below += at_len;
    prev = L;
  }
  int rem = m - below;
  for_runs(s, e, [&](int lo, int hi) {
    const int len = hi - lo;
    if (len < L) {
      set_range(t, lo, hi);
    } else if (len == L && rem > 0) {
      const int k = min(rem, len);
      set_range(t, lo, lo + k);
      rem -= k;
    }
    return true;
  });
}

// alloc_for_class for a demand of m atoms; t zeroed on entry
template <int NW>
__device__ bool alloc_class(const uint64_t (&a)[NW], int m, bool contig, bool best,
                            uint64_t (&t)[NW]) {
  uint64_t s[NW], e[NW];
  run_marks(a, s, e);
  if (contig) return alloc_contiguous(s, e, m, best, t);
  if (popcount(a) < m) return false;
  if (m <= 0) return true;
  if (best) alloc_dispersed_best(s, e, m, t);
  else take_lowest(a, m, t);  // the lowest m free atoms
  return true;
}

// ---- the rounds: keys and the two per-item bodies -------------------------

// order-preserving float -> u32, with -0.0 == +0.0 and NaN above +inf
__device__ __forceinline__ uint32_t enc_ev(float f) {
  if (isnan(f)) return 0xffffffffu;
  const uint32_t u = __float_as_uint(f == 0.0f ? 0.0f : f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// the ev a key carries is finite: enc(-inf) < e < enc(+inf)
__device__ __forceinline__ bool key_finite(unsigned long long k) {
  const uint32_t e = (uint32_t)(k >> 32);
  return e > 0x007fffffu && e < 0xff800000u;
}

struct RoundsIn {
  const int32_t* st;
  const int32_t* node;
  const float* ev;
  const int32_t* mass;
  const uint8_t* contig;
  const uint32_t* words;      // (nodes, w)
  const uint8_t* throttled;   // (nodes,)
  const int32_t* member;      // blocked: (n,) the node of each slot
  const float* mask;          // blocked: (n,) slot validity
  const int32_t* local;       // blocked: (nodes,) node -> slot, -1 off the block
};

struct RoundsOut {
  int32_t* winner;  // (R, n) slot, -1: none
  uint8_t* feas;    // (R, n)
  uint32_t* alloc;  // (R, n, w) taken words
  int32_t* round;   // flat: (p,) the round a probe won, -1: none
  uint8_t* admit;   // flat: (p,)
};

// n: the election's rows (the nodes, or the block's slots), nodes: the rows
// of words and throttled
struct RoundsParams {
  int p, n, nodes, w, atoms, rounds, best, n_steps, per_p, per_n;
};

// a key into its node's R slots: a cascade of atomicMax, the loser of slot
// r going on to slot r + 1 (slot r of node nd at keys[r * n + nd])
__device__ __forceinline__ void insert_key(unsigned long long* keys, int n, int rounds, int nd,
                                           unsigned long long v) {
  for (int r = 0; r < rounds && v != 0ull; ++r) {
    const unsigned long long old = atomicMax(keys + (size_t)r * n + nd, v);
    v = old < v ? old : v;
  }
}

// row nd's R rounds from its keys (slot r of row nd at keys[r * n + nd]);
// NW 64-bit words hold its w <= 2 NW words. Blocked: row nd is a slot of the
// zone block, its node member[nd]; a padding slot elects no one
template <int NW, bool Blocked>
__device__ __forceinline__ void node_rounds(const RoundsIn& in, const RoundsOut& out,
                                            const RoundsParams& pr, int nd,
                                            const unsigned long long* keys) {
  const int w = pr.w, n = pr.n, R = pr.rounds;
  unsigned long long key[kMaxRounds];
  key[0] = R > 0 ? __ldcg(keys + nd) : 0ull;
  // a node whose first key is not finite elects no one
  bool open = key[0] != 0ull && key_finite(key[0]);
  if (Blocked && open) open = in.mask[nd] > 0.0f;
  if (!open) {
    for (int r = 0; r < R; ++r) {
      const size_t at = (size_t)r * n + nd;
      out.winner[at] = -1;
      out.feas[at] = 0;
      for (int j = 0; j < w; ++j) out.alloc[at * w + j] = 0u;
    }
    return;
  }
  // the loads of a node with a winner, issued together: its other keys and
  // its words, then each winner's demand
  uint32_t b[2 * NW];
  int m[kMaxRounds];
  bool c[kMaxRounds];
#pragma unroll
  for (int r = 1; r < kMaxRounds; ++r) key[r] = r < R ? __ldcg(keys + (size_t)r * n + nd) : 0ull;
  const size_t row = Blocked ? (size_t)in.member[nd] : (size_t)nd;
#pragma unroll
  for (int j = 0; j < 2 * NW; ++j) b[j] = j < w ? in.words[row * w + j] : 0u;
#pragma unroll
  for (int r = 0; r < kMaxRounds; ++r) {  // below a finite key: finite or empty
    const int slot = (int)(uint32_t)key[r];
    m[r] = key[r] != 0ull ? in.mass[slot] : 0;
    c[r] = key[r] != 0ull && in.contig[slot] != 0;
  }
#pragma unroll
  for (int r = 0; r < kMaxRounds; ++r) {
    if (r >= R) break;
    const bool live = key[r] != 0ull;
    const int slot = live ? (int)(uint32_t)key[r] : -1;
    uint32_t taken[2 * NW];
    bool feas = false;
    if (live) {
      uint64_t a[NW], t[NW];
#pragma unroll
      for (int q = 0; q < NW; ++q) {
        a[q] = (b[2 * q] | ((uint64_t)b[2 * q + 1] << 32)) & low_mask(pr.atoms - 64 * q);
        t[q] = 0ull;
      }
      feas = fit_words(b, w, m[r], c[r], pr.n_steps) && alloc_class(a, m[r], c[r], pr.best != 0, t);
#pragma unroll
      for (int j = 0; j < 2 * NW; ++j) {
        taken[j] = feas ? (uint32_t)(t[j / 2] >> (32 * (j & 1))) : 0u;
        b[j] &= ~taken[j];
      }
      if (!Blocked) {
        out.round[slot] = r;
        out.admit[slot] = feas;
      }
    } else {
#pragma unroll
      for (int j = 0; j < 2 * NW; ++j) taken[j] = 0u;
    }
    const size_t at = (size_t)r * n + nd;
    out.winner[at] = slot;
    out.feas[at] = feas;
#pragma unroll
    for (int j = 0; j < 2 * NW; ++j)
      if (j < w) out.alloc[at * w + j] = taken[j];
  }
}

__global__ void bitmap_fit_kernel(const uint32_t* __restrict__ words,
                                  const int32_t* __restrict__ mass,
                                  const uint8_t* __restrict__ contig,
                                  int32_t* __restrict__ out, int n, int w,
                                  int n_steps) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  uint32_t b[kMaxWords];
#pragma unroll
  for (int k = 0; k < kMaxWords; ++k) b[k] = k < w ? words[(size_t)i * w + k] : 0u;
  out[i] = fit_words(b, w, mass[i], contig[i] != 0, n_steps);
}

// The rounds of both kernels, one cluster. Blocked: the election's rows are
// the zone block's slots, a probe's row is local[node] (skipped if -1), and
// no per-probe output is written
template <int NW, bool Blocked>
__device__ __forceinline__ void rounds_body(const RoundsIn& in, const RoundsOut& out,
                                            const RoundsParams& pr,
                                            unsigned long long* __restrict__ keys,
                                            unsigned long long (*queue)[kChunk * 32]) {
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n0 = rank * pr.per_n, n1 = min(pr.n, n0 + pr.per_n);
  const int p0 = rank * pr.per_p, p1 = min(pr.p, p0 + pr.per_p);
  // 0. own key slots to 0 (released by the arrive), own probes' defaults
  for (int r = 0; r < pr.rounds; ++r)
    for (int i = n0 + tid; i < n1; i += kRoundThreads) keys[(size_t)r * pr.n + i] = 0ull;
  asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
  if (!Blocked) {
    for (int i = p0 + tid; i < p1; i += kRoundThreads) {
      out.round[i] = -1;
      out.admit[i] = 0;
    }
  }
  asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
  // 1. every queued probe into its node's slots. Each warp gathers the keys
  // of its queued probes, kChunk steps of 32 slots at a time, in shared
  // memory, then its lanes run the cascades side by side
  const unsigned below = (1u << lane) - 1u;
  for (int c0 = p0 + warp * 32; c0 < p1; c0 += kChunk * kRoundThreads) {
    // the chunk's loads, each kind issued for all its steps at once
    int nd[kChunk];
    float f[kChunk];
    bool q[kChunk];
#pragma unroll
    for (int k = 0; k < kChunk; ++k) {
      const int i = c0 + k * kRoundThreads + lane;
      q[k] = i < p1 && in.st[i] == kQueued;
    }
#pragma unroll
    for (int k = 0; k < kChunk; ++k) {
      const int i = c0 + k * kRoundThreads + lane;
      nd[k] = q[k] ? in.node[i] : -1;
      f[k] = q[k] ? in.ev[i] : 0.0f;
      q[k] = q[k] && nd[k] >= 0 && nd[k] < pr.nodes && f[k] != -INFINITY;
    }
#pragma unroll
    for (int k = 0; k < kChunk; ++k) q[k] = q[k] && !in.throttled[nd[k]];
    if (Blocked) {
#pragma unroll
      for (int k = 0; k < kChunk; ++k) q[k] = q[k] && in.local[nd[k]] >= 0;
    }
    int count = 0;
#pragma unroll
    for (int k = 0; k < kChunk; ++k) {
      const unsigned hit = __ballot_sync(0xffffffffu, q[k]);
      if (q[k])
        queue[warp][count + __popc(hit & below)] =
            ((unsigned long long)enc_ev(f[k]) << 32) | (uint32_t)(c0 + k * kRoundThreads + lane);
      count += __popc(hit);
    }
    __syncwarp();
    for (int j = lane; j < count; j += 32) {
      const unsigned long long v = queue[warp][j];
      const int nd = in.node[(uint32_t)v];
      insert_key(keys, pr.n, pr.rounds, Blocked ? in.local[nd] : nd, v);
    }
    __syncwarp();
  }
  cluster.sync();  // every key is in place (release / acquire, cluster scope)
  // 2. the rounds, row by row
  for (int nd = n0 + tid; nd < n1; nd += kRoundThreads)
    node_rounds<NW, Blocked>(in, out, pr, nd, keys);
}

// seed b's columns, words, flags and outputs (b = 0: the unbatched call);
// returns the offset of its keys
__device__ __forceinline__ size_t rounds_seed_offsets(RoundsIn& in, RoundsOut& out,
                                                      const RoundsParams& pr, int b) {
  const size_t cp = (size_t)b * pr.p, cn = (size_t)b * pr.nodes, rn = (size_t)b * pr.rounds * pr.n;
  in.st += cp;
  in.node += cp;
  in.ev += cp;
  in.mass += cp;
  in.contig += cp;
  in.words += cn * pr.w;
  in.throttled += cn;
  out.winner += rn;
  out.feas += rn;
  out.alloc += rn * pr.w;
  out.round += cp;
  out.admit += cp;
  return rn;
}

// one cluster a seed: cluster b (blockIdx.x / cluster size) on seed b
template <int NW>
__global__ void __launch_bounds__(kRoundThreads, 1)
bitmap_fit_rounds_kernel(RoundsIn in, RoundsOut out, RoundsParams pr,
                         unsigned long long* __restrict__ keys) {
  __shared__ unsigned long long queue[kRoundWarps][kChunk * 32];
  const int seed = (int)(blockIdx.x / cg::this_cluster().num_blocks());
  const size_t at = rounds_seed_offsets(in, out, pr, seed);
  rounds_body<NW, false>(in, out, pr, keys + at, queue);
}

template <int NW>
__global__ void __launch_bounds__(kRoundThreads, 1)
bitmap_fit_rounds_blocked_kernel(RoundsIn in, RoundsOut out, RoundsParams pr,
                                 unsigned long long* __restrict__ keys) {
  __shared__ unsigned long long queue[kRoundWarps][kChunk * 32];
  rounds_body<NW, true>(in, out, pr, keys, queue);
}

// the rounds kernels for w words a node: NW = ceil(w / 2) 64-bit words;
// [0] the flat kernel, [1] the blocked one
using RoundsKernel = void (*)(RoundsIn, RoundsOut, RoundsParams, unsigned long long*);
constexpr int kMaxNW = kMaxWords / 2;
const RoundsKernel kRoundsKernels[2][kMaxNW] = {
    {bitmap_fit_rounds_kernel<1>, bitmap_fit_rounds_kernel<2>, bitmap_fit_rounds_kernel<3>,
     bitmap_fit_rounds_kernel<4>},
    {bitmap_fit_rounds_blocked_kernel<1>, bitmap_fit_rounds_blocked_kernel<2>,
     bitmap_fit_rounds_blocked_kernel<3>, bitmap_fit_rounds_blocked_kernel<4>}};
bool g_rounds_nonportable[2][kMaxNW] = {};

cudaError_t set_rounds_attributes(int blocked, int nw, int nonportable) {
  if (!nonportable || g_rounds_nonportable[blocked][nw - 1]) return cudaSuccess;
  const cudaError_t e = cudaFuncSetAttribute(
      kRoundsKernels[blocked][nw - 1], cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (e == cudaSuccess) g_rounds_nonportable[blocked][nw - 1] = true;
  return e;
}

cudaLaunchConfig_t rounds_config(int grid, int block, int cluster, cudaStream_t s,
                                 cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid, 1, 1);
  cfg.blockDim = dim3(block, 1, 1);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = s;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

int steps_of(int w) {
  const int bits = 32 * w - 1;
  return max(1, 32 - __builtin_clz(bits));  // bit_length(32 w - 1)
}

// The checks and the cluster launch of the rounds entries: n election rows
// (nodes or slots), one cluster a seed (the blocked entry: one seed);
// refuses any geometry other than what this source computes and a scratch
// smaller than 2 n R words a seed
int launch_rounds(int blocked, const RoundsIn& in, const RoundsOut& out, int p, int n, int nodes,
                  int w, int atoms, int rounds, int best, int grid, int block, int cluster,
                  int nonportable, int per_p, int per_n, int seeds, int scratch_words,
                  void* scratch, void* stream) {
  if (n <= 0 || nodes <= 0 || p < 0 || rounds < 0 || rounds > kMaxRounds)
    return (int)cudaErrorInvalidValue;
  if (w < 1 || w > kMaxWords || atoms < 1 || atoms > 32 * w) return (int)cudaErrorInvalidValue;
  if (seeds < 1 || (blocked && seeds != 1)) return (int)cudaErrorInvalidValue;
  if (scratch_words < 2LL * n * rounds * seeds) return (int)cudaErrorInvalidValue;
  if (block != kRoundThreads || cluster < 1 || cluster > kMaxCluster || grid != cluster ||
      (cluster > 8 && !nonportable))
    return (int)cudaErrorInvalidConfiguration;
  if (per_p != (p + grid - 1) / grid || per_n != (n + grid - 1) / grid)
    return (int)cudaErrorInvalidValue;
  const int nw = (w + 1) / 2;
  cudaError_t e = set_rounds_attributes(blocked, nw, nonportable);
  if (e != cudaSuccess) return (int)e;
  RoundsParams pr{p, n, nodes, w, atoms, rounds, best != 0, steps_of(w), per_p, per_n};
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg =
      rounds_config(grid * seeds, block, cluster, (cudaStream_t)stream, attr);
  e = cudaLaunchKernelEx(&cfg, kRoundsKernels[blocked][nw - 1], in, out, pr,
                         (unsigned long long*)scratch);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
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
  bitmap_fit_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)words, (const int32_t*)mass, (const uint8_t*)contig,
      (int32_t*)out, n, w, steps_of(w));
  return (int)cudaGetLastError();
}

// Int32 words of scratch bitmap_fit_rounds needs: R 64-bit keys a node.
extern "C" int bitmap_fit_rounds_scratch_words(int n, int rounds) {
  return 2 * n * rounds;
}

// Columns (p,): st, node, mass int32; ev float32; contig bool. words (n, w)
// int32 bit patterns, throttled (n,) bool. Outputs: winner (rounds, n)
// int32, feas (rounds, n) bool, alloc (rounds, n, w) int32, round (p,)
// int32, admit (p,) bool. `best`: the "best" allocation policy, else
// "first". The launch plan (kernels/bitmap_fit/plan.py) gives the grid (one
// cluster: grid == cluster), the block, whether the cluster is past the
// portable 8, and the probe slots and nodes of a CTA; the launcher refuses
// any of them other than what this source computes, and a scratch smaller
// than bitmap_fit_rounds_scratch_words. Launches on `stream` (capturable in
// a CUDA graph) and returns the launch's error, else cudaGetLastError().
extern "C" int bitmap_fit_rounds_launch(
    const void* st, const void* node, const void* ev, const void* mass, const void* contig,
    const void* words, const void* throttled, void* winner, void* feas, void* alloc,
    void* round, void* admit, void* scratch, int p, int n, int w, int atoms, int rounds,
    int best, int grid, int block, int cluster, int nonportable, int per_p, int per_n,
    int scratch_words, void* stream) {
  RoundsIn in{(const int32_t*)st, (const int32_t*)node, (const float*)ev,
              (const int32_t*)mass, (const uint8_t*)contig, (const uint32_t*)words,
              (const uint8_t*)throttled, nullptr, nullptr, nullptr};
  RoundsOut out{(int32_t*)winner, (uint8_t*)feas, (uint32_t*)alloc, (int32_t*)round,
                (uint8_t*)admit};
  return launch_rounds(0, in, out, p, n, n, w, atoms, rounds, best, grid, block, cluster,
                       nonportable, per_p, per_n, 1, scratch_words, scratch, stream);
}

// bitmap_fit_rounds_launch over `seeds` seeds in one launch: every column
// (seeds, p), words (seeds, n, w), throttled (seeds, n), the outputs with the
// same leading axis, and bitmap_fit_rounds_scratch_words(n, rounds) words of
// scratch a seed. grid, block, cluster and the CTA's shares are one seed's,
// as the unbatched launcher takes them; the launch has grid * seeds CTAs.
extern "C" int bitmap_fit_rounds_batched_launch(
    const void* st, const void* node, const void* ev, const void* mass, const void* contig,
    const void* words, const void* throttled, void* winner, void* feas, void* alloc,
    void* round, void* admit, void* scratch, int p, int n, int w, int atoms, int rounds,
    int best, int grid, int block, int cluster, int nonportable, int per_p, int per_n,
    int seeds, int scratch_words, void* stream) {
  RoundsIn in{(const int32_t*)st, (const int32_t*)node, (const float*)ev,
              (const int32_t*)mass, (const uint8_t*)contig, (const uint32_t*)words,
              (const uint8_t*)throttled, nullptr, nullptr, nullptr};
  RoundsOut out{(int32_t*)winner, (uint8_t*)feas, (uint32_t*)alloc, (int32_t*)round,
                (uint8_t*)admit};
  return launch_rounds(0, in, out, p, n, n, w, atoms, rounds, best, grid, block, cluster,
                       nonportable, per_p, per_n, seeds, scratch_words, scratch, stream);
}

// The rounds on one rank's zone block of `slots` = Zb * M slots. Columns
// (p,) as bitmap_fit_rounds'; words (nodes, w) int32 bit patterns and
// throttled (nodes,) bool, replicated; member (slots,) int32 the node of each
// slot, mask (slots,) float32 its validity, local (nodes,) int32 node -> its
// slot in this block (-1: another rank's). Outputs winner (rounds, slots)
// int32 (the global probe slot), feas (rounds, slots) bool, alloc (rounds,
// slots, w) int32. The plan's geometry is checked as for
// bitmap_fit_rounds_launch, with the slots a CTA in place of the nodes;
// scratch: bitmap_fit_rounds_scratch_words(slots, rounds).
extern "C" int bitmap_fit_rounds_blocked_launch(
    const void* st, const void* node, const void* ev, const void* mass, const void* contig,
    const void* words, const void* throttled, const void* member, const void* mask,
    const void* local, void* winner, void* feas, void* alloc, void* scratch, int p, int nodes,
    int slots, int w, int atoms, int rounds, int best, int grid, int block, int cluster,
    int nonportable, int per_p, int per_n, int scratch_words, void* stream) {
  RoundsIn in{(const int32_t*)st, (const int32_t*)node, (const float*)ev,
              (const int32_t*)mass, (const uint8_t*)contig, (const uint32_t*)words,
              (const uint8_t*)throttled, (const int32_t*)member, (const float*)mask,
              (const int32_t*)local};
  RoundsOut out{(int32_t*)winner, (uint8_t*)feas, (uint32_t*)alloc, nullptr, nullptr};
  return launch_rounds(1, in, out, p, slots, nodes, w, atoms, rounds, best, grid, block, cluster,
                       nonportable, per_p, per_n, 1, scratch_words, scratch, stream);
}

// Compiled attributes of kernel k (0: bitmap_fit_kernel; 1 to 4:
// bitmap_fit_rounds_kernel<k>, for 2 k - 1 and 2 k words a node; 5 to 8:
// bitmap_fit_rounds_blocked_kernel<k - 4>): out[0] static shared bytes,
// out[1] registers a thread, out[2] maxThreadsPerBlock.
extern "C" int bitmap_fit_attrs(int k, int* out) {
  if (k < 0 || k > 2 * kMaxNW) return (int)cudaErrorInvalidValue;
  cudaFuncAttributes a;
  const cudaError_t e =
      k == 0 ? cudaFuncGetAttributes(&a, bitmap_fit_kernel)
             : cudaFuncGetAttributes(&a, kRoundsKernels[(k - 1) / kMaxNW][(k - 1) % kMaxNW]);
  out[0] = (int)a.sharedSizeBytes;
  out[1] = a.numRegs;
  out[2] = a.maxThreadsPerBlock;
  return (int)e;
}

// The cluster launch of the rounds (blocked: of the zone-blocked rounds) for
// w words a node as the card takes it, with the launcher's attributes set:
// out[0] clusters of `cluster` CTAs that can be resident at once
// (cudaOccupancyMaxActiveClusters; 0: it cannot launch), out[1] the kernel's
// nonPortableClusterSizeAllowed.
extern "C" int bitmap_fit_rounds_cluster_occupancy(int w, int cluster, int nonportable,
                                                   int blocked, int* out) {
  if (w < 1 || w > kMaxWords || blocked < 0 || blocked > 1) return (int)cudaErrorInvalidValue;
  const int nw = (w + 1) / 2;
  cudaError_t e = set_rounds_attributes(blocked, nw, nonportable);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = rounds_config(cluster, kRoundThreads, cluster, 0, attr);
  int count = 0;
  e = cudaOccupancyMaxActiveClusters(&count, (const void*)kRoundsKernels[blocked][nw - 1], &cfg);
  if (e != cudaSuccess) return (int)e;
  cudaFuncAttributes a;
  e = cudaFuncGetAttributes(&a, kRoundsKernels[blocked][nw - 1]);
  out[0] = count;
  out[1] = a.nonPortableClusterSizeAllowed;
  return (int)e;
}
