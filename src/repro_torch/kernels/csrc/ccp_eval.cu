// MPDP filter/evaluate kernels for NVIDIA Hopper (sm_90a).
//
// One thread per lane, replacing the Pallas TPU kernels of
// src/repro/kernels/ccp_eval.py.  Five entry points read one query's
// (nmax,) adjacency table (the solo engine's filter and DPSUB evaluate run
// connectivity_kernel<ranked> and ccp_eval_dpsub_kernel; the others are
// off its main path):
//
//   ccp_eval_kernel       <- ccp_eval_kernel      (ccp_eval.py:65)
//                            DPSUB lane: lb = pdep(sub, S), rb = S & ~lb, ccp
//   ccp_eval_dpsub_kernel <- ccp_eval_kernel      (ccp_eval.py:65) with the
//                            DPSUB lane decode of the reference's
//                            _eval_dpsub_chunk (core/engine.py:179-188):
//                            S = all_sets[clamp(level_off + set_idx)], then
//                            as ccp_eval_kernel
//   connectivity_kernel   <- connectivity_kernel  (ccp_eval.py:81)
//     <given>                filter lane: is G[S] connected, S in memory
//     <ranked>               with the unrank of the reference's
//                            _filter_chunk (core/engine.py:72-85): S is the
//                            colex rank rank0 + t of the k-subsets, unranked
//                            in registers; writes S and conn
//   grow_pair_kernel      <- grow_pair_kernel     (ccp_eval.py:88)
//                            MPDP-general split: S_left = grow(lb) in S & ~rb,
//                            S_right = S & ~S_left
//
// Ten read the stacked (bcap, nmax) table at each lane's query row (the
// batched engine, and on a one-row table the solo tree and general
// evaluates; the set-given bconnectivity, bccp_eval, btree_eval and
// bgeneral_eval are off the main path):
//
//   bconnectivity_kernel  <- bconnectivity_kernel (ccp_eval.py:133)
//                            per (query, set) lane: is G_q[S] connected
//   bconnectivity_span_kernel
//                         <- bconnectivity_kernel (ccp_eval.py:133) with the
//                            batched unrank of the reference's
//                            _bfilter_chunk (core/batch.py:110-127): lane t
//                            finds its query q by a binary search of the
//                            per-query rank prefix foff, unranks colex rank
//                            t - foff[q] in registers, writes S, conn, q
//   bccp_eval_kernel      <- bccp_eval_kernel     (ccp_eval.py:142)
//                            DPSUB lane: lb = pdep(sub, S), rb = S & ~lb, ccp
//   bccp_eval_decode_kernel
//                         <- bccp_eval_kernel     (ccp_eval.py:142) with the
//                            batched DPSUB lane decode of the reference's
//                            _beval_dpsub_chunk (core/batch.py:145-152):
//                            (query, set, subset) from the chunk's offset
//                            tables (a shift and a mask where the tree
//                            decode divides), the clamped set gather, then
//                            as bccp_eval_kernel; writes lb, rb, ccp, q and
//                            the lane's segment (the batched DPSUB
//                            evaluate)
//   btree_eval_kernel     <- btree_eval_kernel    (ccp_eval.py:159)
//                            MPDP:Tree lane: S_left = grow(u) in S minus edge
//                            (u, v); edge_in = both endpoints in S
//   btree_eval_decode_kernel
//                         <- btree_eval_kernel    (ccp_eval.py:159) with the
//                            MPDP:Tree lane decode of the reference's
//                            _beval_tree_chunk (core/batch.py:202-214):
//                            (query, set, edge) from the chunk's offset
//                            tables, the clamped set gather, then as
//                            btree_eval_kernel; writes S, S_left, edge_in,
//                            q and the lane's segment (the typed tree
//                            evaluates, batched and solo)
//   bgeneral_eval_kernel  <- bgeneral_eval_kernel (ccp_eval.py:184)
//                            MPDP-general lane: lb = pdep(r, block),
//                            ccp(lb, block & ~lb), S_left = grow(lb) in
//                            S & ~rb
//   bgeneral_eval_decode_kernel
//                         <- bgeneral_eval_kernel (ccp_eval.py:184) and
//                            grow_pair_kernel (ccp_eval.py:88) with the
//                            MPDP-general lane decode of the reference's
//                            _beval_general_chunk (core/batch.py:259-283)
//                            and _eval_general_chunk (core/engine.py:
//                            253-268): the lane's pair by a binary search
//                            of the chunk's offset row, its (set, block,
//                            query), then as bgeneral_eval_kernel; writes
//                            S, S_left, enum_ok, ccp, q and the pair (the
//                            typed general evaluates, batched and solo)
//   btree_eval_prune_kernel, bgeneral_eval_prune_kernel
//                         <- the two decode kernels above with the epilogue
//                            of the reference's chunk bodies: the memo
//                            gathers, cost.join_cost, the per-segment
//                            minimum and the per-query counts; write one
//                            key a segment and two counts a query (the
//                            inner-join tree and general evaluates, batched
//                            and solo)
//
// Two more replace no Pallas kernel.  One is the reference's jitted XLA
// phase A (src/repro/core/blocks.py:236, vmapped over a chunk of sets),
// which the port had run as about 1,900-4,500 eager torch ops a (query,
// level); the other the host's fold and memo scatter of a level's chunk
// results (the reference's _commit_best, src/repro/core/batch.py:659, and
// _commit_level, src/repro/core/engine.py:457):
//
//   phase_a_blocks_kernel <- blocks_chunk (core/blocks.py:236) and the
//                            (set, block) compaction of np_pairs_for_sets
//                            (core/blocks.py:274): one thread a set, its
//                            blocks left-justified in a fixed-width row
//   commit_keys_kernel    <- the level commit after the two prune kernels
//                            folded a level's chunks into one key buffer:
//                            one thread a run of keys of one memo entry,
//                            the run's maximum written to the memo
//
// What bounds them on this card.  A lane reads 4-16 bytes and writes 4-12
// (int32 in and out, each once); the int32 work per lane is a handful of
// set-bit walks of at most nmax (<= 30) steps, each a find-first-set, a
// shared-memory load and an OR: a few hundred int32 operations per lane at
// most, typically under a hundred.  At the main path's 32768 lanes a call
// moves about 0.3-0.9 MB and does 0.5-3 million int32 operations, so both
// the byte bound (3.35 TB/s) and the int32 bound are well under a
// microsecond: a call is bound by launch latency and by the serial
// dependency chain of one lane's walks, not by bytes or ALU.  The ranked
// connectivity form reads no lanes at all and writes 8 bytes a lane; its
// unrank adds up to nmax dependent steps (a shared-memory load of C(v, kk),
// a compare, a subtract) a lane, so over a whole level (5.2 M ranks at
// nmax 30) it is bound by int32 operations.
//
// What the design does about it.
//   * One thread per lane, coalesced int32 loads and stores; the kernel
//     masks the ragged edge itself (no padding to tiles).
//   * Each block copies the adjacency table (one (nmax,) row of at most
//     120 bytes, or the (bcap, nmax) stack, under 4 KB) into shared memory
//     once; a lane reads its row directly.  This replaces the TPU's SMEM
//     scalar prefetch, its static nmax-step select-OR loop
//     (_neighbors_smem) and its nb x nmax row select (_select_adj_rows).
//   * Set walks visit only the set bits (__ffs), and grow() is a frontier
//     BFS that stops at its fixed point instead of running nmax fixed
//     sweeps.  The fixed point is the same set, so the bits are the same.
//   * The ccp test short-circuits: empty sides skip the two grows.
//   * The filter unranks in the kernel.  One launch covers a whole level
//     span (up to 2^24 ranks) with a grid-stride loop over a grid of as
//     many 256-thread blocks as are resident on the card at once (occupancy
//     x SM count), so each SM holds its full complement of warps to hide a
//     lane's dependent shared-memory loads, and the (nmax+1)^2 binomial
//     table (<= 3,844 bytes) is staged in shared memory once per block.
//   * The DPSUB evaluate decodes its lanes in the kernel (no index tensors
//     built around it).  Sets vary slowest, so from i >= 5 the 32 lanes of a
//     warp share S and the pdep walk over S's bits takes the same trip count
//     on every lane.
//   * The batched filter and the MPDP:Tree and DPSUB evaluates do the same
//     for a stack of queries: each block stages the per-query offset
//     tables (<= 33 ints each), the (bcap, nmax) adjacency stack and, for
//     the filter, the binomial table in dynamic shared memory, and a lane
//     finds its query by a binary search there (searchsorted(side=
//     "right"), <= 6 steps at bcap 32).  The filter covers a whole level
//     of every query of a flight (<= 411,840 ranks at nmax 16, bcap 32) in
//     one grid-stride launch, as the solo span form does; the tree decode
//     adds one int32 division (floor quotient and modulo) a lane, the
//     DPSUB decode an arithmetic shift and a mask (sets vary slowest, so
//     from i >= 5 a warp's lanes share S except at a query boundary).
//   * The MPDP-general decode searches the chunk's pair-offset row (up to
//     pcap = 16,384 entries, too many to stage per block in 48 KB) in
//     global memory through the read-only cache: <= 15 dependent steps,
//     and the 32 lanes of a warp hold consecutive t, so they walk the same
//     path and each step is one broadcast load that stays in L1 after the
//     first warp of an SM.  The four pair rows are gathered the same way;
//     only the adjacency stack sits in shared memory.
//   * Phase A does a few hundred int32 steps a set at the cyclomatic
//     numbers of real queries (2-3) over at most tens of thousands of sets
//     a level, and moves (1 + width) x 4 bytes a set: bound by launch
//     latency, like the others.  What it removes is host work: one launch
//     a (query, level) in place of the eager ops, the whole level in one
//     grid, the query's adjacency row and edge endpoints staged in shared
//     memory once a block, and the rows read back in one copy.
//   * The fused evaluate epilogue writes 8 bytes a segment and 8 a query in
//     place of 20-24 a lane, and gathers five floats from the memo on a
//     ccp lane only (the memo, at most 8 MB batched, stays in L2); a
//     non-ccp lane skips its grow and its gathers.  Its reduction is a
//     warp shuffle ladder and a few atomics a warp.  What it removes is
//     host work again: the chunk's eager ops.
//
// Plain C interface (bound with ctypes): each rt_* function launches on the
// given stream and returns cudaGetLastError() as an int (0 = success).

#include <cuda_runtime.h>
#include <math_constants.h>

#include <algorithm>

namespace {

constexpr int kThreads = 128;
constexpr int kWideThreads = 256;   // connectivity and ccp_eval_dpsub
constexpr int kNmaxHard = 30;       // widest bitmap the exact engines use
constexpr int kBinomHard = (kNmaxHard + 1) * (kNmaxHard + 1);

// int32 addition that wraps as torch's int32 tensors do (two's complement).
__device__ __forceinline__ int wrap_add(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) + static_cast<unsigned>(b));
}

__device__ __forceinline__ int wrap_sub(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) - static_cast<unsigned>(b));
}

// ------------------------------------------------------------ lane library --

// Lowest set bit (0 for 0), in unsigned arithmetic so INT_MIN is defined.
__device__ __forceinline__ int lsb(int x) {
  unsigned u = static_cast<unsigned>(x);
  return static_cast<int>(u & (~u + 1u));
}

// OR of row[v] over the set bits v < nmax of s.
__device__ __forceinline__ int neighbors(int s, const int* row, int nmask) {
  unsigned m = static_cast<unsigned>(s & nmask);
  int acc = 0;
  while (m) {
    acc |= row[__ffs(m) - 1];
    m &= m - 1;
  }
  return acc;
}

// Vertices of `restrict_` reachable from `src & restrict_` inside it.
__device__ __forceinline__ int grow(int src, int restrict_, const int* row,
                                    int nmask) {
  int cur = src & restrict_;
  int frontier = cur;
  while (frontier) {
    int nb = neighbors(frontier, row, nmask) & restrict_ & ~cur;
    cur |= nb;
    frontier = nb;
  }
  return cur;
}

// neighbors() on the graph with edge (u, v) deleted (ub/vb one-bit masks;
// 0 for padding edges, which delete nothing).
__device__ __forceinline__ int neighbors_excl(int s, const int* row,
                                              int nmask, int ub, int vb) {
  unsigned m = static_cast<unsigned>(s & nmask);
  int acc = 0;
  while (m) {
    int v = __ffs(m) - 1;
    int excl = (((ub >> v) & 1) ? vb : 0) | (((vb >> v) & 1) ? ub : 0);
    acc |= row[v] & ~excl;
    m &= m - 1;
  }
  return acc;
}

__device__ __forceinline__ int grow_excl(int src, int restrict_,
                                         const int* row, int nmask, int ub,
                                         int vb) {
  int cur = src & restrict_;
  int frontier = cur;
  while (frontier) {
    int nb = neighbors_excl(frontier, row, nmask, ub, vb) & restrict_ & ~cur;
    cur |= nb;
    frontier = nb;
  }
  return cur;
}

// Parallel bit deposit: bit k of rank goes to the k-th set bit of mask.
__device__ __forceinline__ int pdep(int rank, int mask, int nmask) {
  unsigned m = static_cast<unsigned>(mask & nmask);
  int out = 0;
  int k = 0;
  while (m) {
    unsigned b = m & (~m + 1u);
    if ((rank >> k) & 1) out |= static_cast<int>(b);
    m ^= b;
    ++k;
  }
  return out;
}

__device__ __forceinline__ bool connected(int s, const int* row, int nmask) {
  return grow(lsb(s), s, row, nmask) == s;
}

// Colex unrank (core/unrank.py): the r-th k-subset of {0..nmax-1}, from
// v = nmax - 1 down, taking v when r >= C(v, kk).  binom is the row-major
// (nmax+1)^2 table.  The loop stops once kk is 0, where the reference's
// remaining steps take nothing.
__device__ __forceinline__ int unrank(int r, int k, const int* binom,
                                      int nmax) {
  int out = 0;
  int kk = k;
  for (int v = nmax - 1; v >= 0 && kk > 0; --v) {
    int c = binom[v * (nmax + 1) + kk];
    if (r >= c) {
      out |= 1 << v;
      r -= c;
      --kk;
    }
  }
  return out;
}

__device__ __forceinline__ int ccp(int lb, int rb, const int* row,
                                   int nmask) {
  if (lb == 0 || rb == 0) return 0;
  if ((neighbors(lb, row, nmask) & rb) == 0) return 0;
  return connected(lb, row, nmask) && connected(rb, row, nmask);
}

// Entries of off[0, n) that are <= t, for a non-decreasing off: the
// reference's searchsorted(off, t, side="right").
__device__ __forceinline__ int upper_bound(const int* off, int n, int t) {
  int lo = 0, hi = n;
  while (lo < hi) {
    int mid = (lo + hi) >> 1;
    if (off[mid] <= t) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// upper_bound() over a table in global memory, read through the read-only
// cache.
__device__ __forceinline__ int upper_bound_ldg(const int* __restrict__ off,
                                               int n, int t) {
  int lo = 0, hi = n;
  while (lo < hi) {
    int mid = (lo + hi) >> 1;
    if (__ldg(off + mid) <= t) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// Owner of lane t: clamp(searchsorted(off, t, side="right") - 1, 0,
// bcap - 1) over the (bcap + 1)-entry prefix off.
__device__ __forceinline__ int lane_query(const int* off, int bcap, int t) {
  return min(max(upper_bound(off, bcap + 1, t) - 1, 0), bcap - 1);
}

// Copy n ints to shared memory (the caller syncs).
__device__ __forceinline__ void stage(int* dst, const int* src, int n) {
  for (int i = threadIdx.x; i < n; i += blockDim.x) dst[i] = src[i];
}

// Stage the (bcap, nmax) table in shared memory; return this lane's row.
__device__ __forceinline__ const int* stage_rows(int* sadj, const int* adj_b,
                                                 int bcap, int nmax,
                                                 const int* qid, int t,
                                                 int L) {
  for (int i = threadIdx.x; i < bcap * nmax; i += blockDim.x) sadj[i] = adj_b[i];
  __syncthreads();
  if (t >= L) return nullptr;
  int q = min(max(qid[t], 0), bcap - 1);
  return sadj + q * nmax;
}

// Stage one query's (nmax,) table in shared memory.
__device__ __forceinline__ void stage_table(int* sadj, const int* adj,
                                            int nmax) {
  for (int i = threadIdx.x; i < nmax; i += blockDim.x) sadj[i] = adj[i];
  __syncthreads();
}

// ------------------------------------------------------- solo-engine kernels --

// Both forms of the filter: the sets given in memory (kRanked false: S_in),
// or the colex ranks rank0 + t of the k-subsets unranked in registers
// (kRanked true: binom, S_out).  Grid-stride over L lanes.
template <bool kRanked>
__global__ void __launch_bounds__(kWideThreads)
connectivity_kernel(const int* __restrict__ S_in, int rank0, int k,
                    const int* __restrict__ binom,
                    const int* __restrict__ adj, int* __restrict__ S_out,
                    int* __restrict__ conn, int L, int nmax) {
  __shared__ int sadj[kNmaxHard];
  __shared__ int sbinom[kRanked ? kBinomHard : 1];
  if constexpr (kRanked) {
    for (int i = threadIdx.x; i < (nmax + 1) * (nmax + 1); i += blockDim.x)
      sbinom[i] = binom[i];
  }
  stage_table(sadj, adj, nmax);          // ends in __syncthreads()
  const int nmask = (1 << nmax) - 1;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long t = static_cast<long long>(blockIdx.x) * blockDim.x
                     + threadIdx.x; t < L; t += stride) {
    int s;
    if constexpr (kRanked) {
      s = unrank(rank0 + static_cast<int>(t), k, sbinom, nmax);
      S_out[t] = s;
    } else {
      s = S_in[t];
    }
    conn[t] = connected(s, sadj, nmask);
  }
}

__global__ void ccp_eval_kernel(const int* __restrict__ S,
                                const int* __restrict__ sub,
                                const int* __restrict__ adj,
                                int* __restrict__ lb_out,
                                int* __restrict__ rb_out,
                                int* __restrict__ ccp_out, int L, int nmax) {
  __shared__ int sadj[kNmaxHard];
  stage_table(sadj, adj, nmax);
  int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= L) return;
  int nmask = (1 << nmax) - 1;
  int s = S[t];
  int lb = pdep(sub[t], s, nmask);
  int rb = s & ~lb;
  lb_out[t] = lb;
  rb_out[t] = rb;
  ccp_out[t] = ccp(lb, rb, sadj, nmask);
}

// DPSUB lane t of a chunk: sub_g = base_sub + t, set_idx = base_set +
// (sub_g >> i), sub = sub_g & (2^i - 1), S = all_sets[clamp(level_off +
// set_idx, 0, n_sets - 1)] (the reference's clamped gather, int32 wrap as
// in torch), then the ccp_eval lane.  Dead lanes of the chunk are decoded
// the same way; the caller masks them.
__global__ void __launch_bounds__(kWideThreads)
ccp_eval_dpsub_kernel(const int* __restrict__ all_sets, int n_sets,
                      int level_off, int base_set, int base_sub, int i,
                      const int* __restrict__ adj, int* __restrict__ lb_out,
                      int* __restrict__ rb_out, int* __restrict__ ccp_out,
                      int L, int nmax) {
  __shared__ int sadj[kNmaxHard];
  stage_table(sadj, adj, nmax);
  int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= L) return;
  int nmask = (1 << nmax) - 1;
  int sub_g = wrap_add(base_sub, t);
  int set_idx = wrap_add(base_set, sub_g >> i);
  int sub = sub_g & ((1 << i) - 1);
  int s = all_sets[min(max(wrap_add(level_off, set_idx), 0), n_sets - 1)];
  int lb = pdep(sub, s, nmask);
  int rb = s & ~lb;
  lb_out[t] = lb;
  rb_out[t] = rb;
  ccp_out[t] = ccp(lb, rb, sadj, nmask);
}

__global__ void grow_pair_kernel(const int* __restrict__ S,
                                 const int* __restrict__ lb_in,
                                 const int* __restrict__ rb_in,
                                 const int* __restrict__ adj,
                                 int* __restrict__ sl_out,
                                 int* __restrict__ sr_out, int L, int nmax) {
  __shared__ int sadj[kNmaxHard];
  stage_table(sadj, adj, nmax);
  int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= L) return;
  int nmask = (1 << nmax) - 1;
  int s = S[t];
  int sl = grow(lb_in[t], s & ~rb_in[t], sadj, nmask);
  sl_out[t] = sl;
  sr_out[t] = s & ~sl;
}

// ----------------------------------------------------------- batched kernels --

__global__ void bconnectivity_kernel(const int* __restrict__ S,
                                     const int* __restrict__ qid,
                                     const int* __restrict__ adj_b,
                                     int* __restrict__ conn, int L, int bcap,
                                     int nmax) {
  extern __shared__ int sadj[];
  int t = blockIdx.x * blockDim.x + threadIdx.x;
  const int* row = stage_rows(sadj, adj_b, bcap, nmax, qid, t, L);
  if (row == nullptr) return;
  int nmask = (1 << nmax) - 1;
  conn[t] = connected(S[t], row, nmask);
}

// The batched filter of one level span: lane t belongs to query q =
// lane_query(foff, t), unranks colex rank max(t - foff[q], 0) of the
// k-subsets, and is live below foff[bcap].  Grid-stride over count lanes.
// Shared memory: foff (bcap + 1), binom ((nmax + 1)^2), adj_b (bcap x nmax).
__global__ void __launch_bounds__(kWideThreads)
bconnectivity_span_kernel(int k, const int* __restrict__ foff, int count,
                          const int* __restrict__ binom,
                          const int* __restrict__ adj_b,
                          int* __restrict__ S_out, int* __restrict__ conn,
                          int* __restrict__ qid_out, int bcap, int nmax) {
  extern __shared__ int smem[];
  int* sfoff = smem;
  int* sbinom = sfoff + bcap + 1;
  int* sadj = sbinom + (nmax + 1) * (nmax + 1);
  stage(sfoff, foff, bcap + 1);
  stage(sbinom, binom, (nmax + 1) * (nmax + 1));
  stage(sadj, adj_b, bcap * nmax);
  __syncthreads();
  const int nmask = (1 << nmax) - 1;
  const int live_end = sfoff[bcap];
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long tl = static_cast<long long>(blockIdx.x) * blockDim.x
                      + threadIdx.x; tl < count; tl += stride) {
    const int t = static_cast<int>(tl);
    const int q = lane_query(sfoff, bcap, t);
    const int s = unrank(max(wrap_sub(t, sfoff[q]), 0), k, sbinom, nmax);
    S_out[t] = s;
    conn[t] = t < live_end && connected(s, sadj + q * nmax, nmask);
    qid_out[t] = q;
  }
}

__global__ void bccp_eval_kernel(const int* __restrict__ S,
                                 const int* __restrict__ sub,
                                 const int* __restrict__ qid,
                                 const int* __restrict__ adj_b,
                                 int* __restrict__ lb_out,
                                 int* __restrict__ rb_out,
                                 int* __restrict__ ccp_out, int L, int bcap,
                                 int nmax) {
  extern __shared__ int sadj[];
  int t = blockIdx.x * blockDim.x + threadIdx.x;
  const int* row = stage_rows(sadj, adj_b, bcap, nmax, qid, t, L);
  if (row == nullptr) return;
  int nmask = (1 << nmax) - 1;
  int s = S[t];
  int lb = pdep(sub[t], s, nmask);
  int rb = s & ~lb;
  lb_out[t] = lb;
  rb_out[t] = rb;
  ccp_out[t] = ccp(lb, rb, row, nmask);
}

// Batched DPSUB chunk lane t: query q = lane_query(eoff, t), local = t -
// eoff[q], set_idx = local >> i (arithmetic, as torch's >> on int32), sub =
// local & (2^i - 1), S = all_sets[clamp(loff[q] + set_idx, 0, n_sets - 1)],
// then the bccp_eval lane on row q; ccp masked by t < eoff[bcap], seg =
// clamp(soff[q] + set_idx - seg0, 0, nseg - 1).  int32 adds wrap as torch's
// do.  Every lane is decoded, dead ones included.  Shared memory: eoff
// (bcap + 1), loff, soff (bcap each), adj_b (bcap x nmax).
__global__ void __launch_bounds__(kWideThreads)
bccp_eval_decode_kernel(const int* __restrict__ all_sets, int n_sets,
                        const int* __restrict__ eoff,
                        const int* __restrict__ loff,
                        const int* __restrict__ soff, int seg0, int i,
                        const int* __restrict__ adj_b,
                        int* __restrict__ lb_out, int* __restrict__ rb_out,
                        int* __restrict__ ccp_out, int* __restrict__ qid_out,
                        int* __restrict__ seg_out, int L, int bcap, int nmax,
                        int nseg) {
  extern __shared__ int smem[];
  int* seoff = smem;
  int* sloff = seoff + bcap + 1;
  int* ssoff = sloff + bcap;
  int* sadj = ssoff + bcap;
  stage(seoff, eoff, bcap + 1);
  stage(sloff, loff, bcap);
  stage(ssoff, soff, bcap);
  stage(sadj, adj_b, bcap * nmax);
  __syncthreads();
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= L) return;
  const int nmask = (1 << nmax) - 1;
  const int q = lane_query(seoff, bcap, t);
  const int local = wrap_sub(t, seoff[q]);
  const int set_idx = local >> i;
  const int sub = local & ((1 << i) - 1);
  const int s = all_sets[min(max(wrap_add(sloff[q], set_idx), 0), n_sets - 1)];
  const int lb = pdep(sub, s, nmask);
  const int rb = s & ~lb;
  lb_out[t] = lb;
  rb_out[t] = rb;
  ccp_out[t] = t < seoff[bcap] && ccp(lb, rb, sadj + q * nmax, nmask);
  qid_out[t] = q;
  seg_out[t] = min(max(wrap_sub(wrap_add(ssoff[q], set_idx), seg0), 0),
                   nseg - 1);
}

__global__ void btree_eval_kernel(const int* __restrict__ S,
                                  const int* __restrict__ ub_in,
                                  const int* __restrict__ vb_in,
                                  const int* __restrict__ qid,
                                  const int* __restrict__ adj_b,
                                  int* __restrict__ sl_out,
                                  int* __restrict__ in_out, int L, int bcap,
                                  int nmax) {
  extern __shared__ int sadj[];
  int t = blockIdx.x * blockDim.x + threadIdx.x;
  const int* row = stage_rows(sadj, adj_b, bcap, nmax, qid, t, L);
  if (row == nullptr) return;
  int nmask = (1 << nmax) - 1;
  int s = S[t];
  int ub = ub_in[t];
  int vb = vb_in[t];
  sl_out[t] = grow_excl(ub, s, row, nmask, ub, vb);
  in_out[t] = ((s & ub) != 0) && ((s & vb) != 0);
}

// MPDP:Tree chunk lane t: query q = lane_query(eoff, t), local = t -
// eoff[q], mq = max(m_b[q], 1), set_idx = floor(local / mq), e =
// clamp(local mod mq, 0, emax - 1), S = all_sets[clamp(loff[q] + set_idx,
// 0, n_sets - 1)], (ub, vb) = edge e of query q; edge_in = t < eoff[bcap]
// and both endpoints in S, seg = clamp(soff[q] + set_idx - seg0, 0, nseg -
// 1).  int32 adds wrap as torch's do.  Every lane is decoded, dead ones
// included.  Shared memory (stage_tree): eoff (bcap + 1), loff, soff, m_b
// (bcap each), adj_b (bcap x nmax); the edge tables are read through the
// read-only cache.
struct TreeTables {
  const int* eoff;
  const int* loff;
  const int* soff;
  const int* m;
  const int* adj;
};

struct TreeLane {
  int s, ub, vb, edge_in, q, seg;
};

__device__ __forceinline__ TreeTables stage_tree(int* smem, const int* eoff,
                                                 const int* loff,
                                                 const int* soff,
                                                 const int* m_b,
                                                 const int* adj_b, int bcap,
                                                 int nmax) {
  int* seoff = smem;
  int* sloff = seoff + bcap + 1;
  int* ssoff = sloff + bcap;
  int* sm = ssoff + bcap;
  int* sadj = sm + bcap;
  stage(seoff, eoff, bcap + 1);
  stage(sloff, loff, bcap);
  stage(ssoff, soff, bcap);
  stage(sm, m_b, bcap);
  stage(sadj, adj_b, bcap * nmax);
  __syncthreads();
  return {seoff, sloff, ssoff, sm, sadj};
}

__device__ __forceinline__ TreeLane tree_lane(
    int t, const TreeTables& tb, const int* __restrict__ all_sets, int n_sets,
    int seg0, const int* __restrict__ emu_b, const int* __restrict__ emv_b,
    int emax, int bcap, int nseg) {
  TreeLane ln;
  ln.q = lane_query(tb.eoff, bcap, t);
  const int local = wrap_sub(t, tb.eoff[ln.q]);
  const int mq = max(tb.m[ln.q], 1);
  int set_idx = local / mq;              // floor quotient and modulo (mq > 0)
  int e = local - set_idx * mq;
  if (e < 0) {
    e += mq;
    --set_idx;
  }
  e = min(e, emax - 1);
  ln.s = all_sets[min(max(wrap_add(tb.loff[ln.q], set_idx), 0), n_sets - 1)];
  ln.ub = __ldg(emu_b + ln.q * emax + e);
  ln.vb = __ldg(emv_b + ln.q * emax + e);
  ln.edge_in = t < tb.eoff[bcap] && (ln.s & ln.ub) != 0 && (ln.s & ln.vb) != 0;
  ln.seg = min(max(wrap_sub(wrap_add(tb.soff[ln.q], set_idx), seg0), 0),
               nseg - 1);
  return ln;
}

// The decode of tree_lane, then the btree_eval lane: S_left = grow(ub) in
// S minus edge (u, v).
__global__ void __launch_bounds__(kWideThreads)
btree_eval_decode_kernel(const int* __restrict__ all_sets, int n_sets,
                         const int* __restrict__ eoff,
                         const int* __restrict__ loff,
                         const int* __restrict__ soff, int seg0,
                         const int* __restrict__ m_b,
                         const int* __restrict__ emu_b,
                         const int* __restrict__ emv_b, int emax,
                         const int* __restrict__ adj_b,
                         int* __restrict__ S_out, int* __restrict__ sl_out,
                         int* __restrict__ in_out, int* __restrict__ qid_out,
                         int* __restrict__ seg_out, int L, int bcap, int nmax,
                         int nseg) {
  extern __shared__ int smem[];
  const TreeTables tb = stage_tree(smem, eoff, loff, soff, m_b, adj_b, bcap,
                                   nmax);
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= L) return;
  const int nmask = (1 << nmax) - 1;
  const TreeLane ln = tree_lane(t, tb, all_sets, n_sets, seg0, emu_b, emv_b,
                                emax, bcap, nseg);
  S_out[t] = ln.s;
  sl_out[t] = grow_excl(ln.ub, ln.s, tb.adj + ln.q * nmax, nmask, ln.ub,
                        ln.vb);
  in_out[t] = ln.edge_in;
  qid_out[t] = ln.q;
  seg_out[t] = ln.seg;
}

__global__ void bgeneral_eval_kernel(const int* __restrict__ S,
                                     const int* __restrict__ block,
                                     const int* __restrict__ r,
                                     const int* __restrict__ qid,
                                     const int* __restrict__ adj_b,
                                     int* __restrict__ lb_out,
                                     int* __restrict__ sl_out,
                                     int* __restrict__ ccp_out, int L,
                                     int bcap, int nmax) {
  extern __shared__ int sadj[];
  int t = blockIdx.x * blockDim.x + threadIdx.x;
  const int* row = stage_rows(sadj, adj_b, bcap, nmax, qid, t, L);
  if (row == nullptr) return;
  int nmask = (1 << nmax) - 1;
  int s = S[t];
  int blk = block[t];
  int lb = pdep(r[t], blk, nmask);
  int rb = blk & ~lb;
  lb_out[t] = lb;
  sl_out[t] = grow(lb, s & ~rb, row, nmask);
  ccp_out[t] = ccp(lb, rb, row, nmask);
}

// MPDP-general chunk lane t over the int32[4, pcap] pair table (rows set,
// block, query, chunk-local lane offset; the offset row non-decreasing):
// p = clamp(upper_bound(off, pcap, t) - 1, 0, n_pairs - 1), r = t - off[p]
// (int32 wrap), q = clamp(query[p], 0, bcap - 1), lb = pdep(r, block[p]),
// rb = block[p] & ~lb; enum_ok = t < lane_count && lb && rb, ccp = enum_ok
// && ccp(lb, rb) on row q of the staged adjacency stack.  Every lane is
// decoded, dead ones included.  The pair table is read through the
// read-only cache.
struct GeneralLane {
  int s, lb, rb, enum_ok, ccp, q, p;
};

__device__ __forceinline__ GeneralLane general_lane(
    int t, const int* __restrict__ pairs, int pcap, int n_pairs,
    int lane_count, const int* sadj, int bcap, int nmax) {
  const int nmask = (1 << nmax) - 1;
  const int* off = pairs + 3 * pcap;
  GeneralLane ln;
  ln.p = min(max(upper_bound_ldg(off, pcap, t) - 1, 0), n_pairs - 1);
  const int r = wrap_sub(t, __ldg(off + ln.p));
  ln.s = __ldg(pairs + ln.p);
  const int blk = __ldg(pairs + pcap + ln.p);
  ln.q = min(max(__ldg(pairs + 2 * pcap + ln.p), 0), bcap - 1);
  ln.lb = pdep(r, blk, nmask);
  ln.rb = blk & ~ln.lb;
  ln.enum_ok = t < lane_count && ln.lb != 0 && ln.rb != 0;
  ln.ccp = ln.enum_ok && ccp(ln.lb, ln.rb, sadj + ln.q * nmax, nmask);
  return ln;
}

// The decode of general_lane, then S_left = grow(lb) in set[p] & ~rb.
// Shared memory: adj_b (bcap x nmax).
__global__ void __launch_bounds__(kWideThreads)
bgeneral_eval_decode_kernel(const int* __restrict__ pairs, int pcap,
                            int n_pairs, int lane_count,
                            const int* __restrict__ adj_b,
                            int* __restrict__ S_out, int* __restrict__ sl_out,
                            int* __restrict__ enum_out,
                            int* __restrict__ ccp_out,
                            int* __restrict__ qid_out,
                            int* __restrict__ p_out, int L, int bcap,
                            int nmax) {
  extern __shared__ int sadj[];
  stage(sadj, adj_b, bcap * nmax);
  __syncthreads();
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= L) return;
  const int nmask = (1 << nmax) - 1;
  const GeneralLane ln = general_lane(t, pairs, pcap, n_pairs, lane_count,
                                      sadj, bcap, nmax);
  S_out[t] = ln.s;
  sl_out[t] = grow(ln.lb, ln.s & ~ln.rb, sadj + ln.q * nmax, nmask);
  enum_out[t] = ln.enum_ok;
  ccp_out[t] = ln.ccp;
  qid_out[t] = ln.q;
  p_out[t] = ln.p;
}

// ------------------------------------------- fused evaluate epilogue --

// The MPDP:Tree and MPDP-general evaluates of inner-join flights end in
// the epilogue of their chunk bodies (core/chunks._lane_cost, _prune and
// _segment_sum), which torch runs as about
// 73 eager ops a chunk.  btree_eval_prune_kernel and
// bgeneral_eval_prune_kernel build the lanes as the two decode kernels do
// and run that epilogue in registers, so that a chunk is one launch and
// one copy:
//   1. the memo gathers at (q << nmax) | x for x = S_left, S_right, S,
//      each index clamped into the memo as kernels/ref.take clamps;
//   2. cost.join_cost and the split's cost (cl + cr) + jc, INF off the ccp
//      mask, in torch's order of operations with every operation rounded
//      on its own (__fmul_rn, __fadd_rn: no contraction into an FMA), the
//      constants the float32 values torch gives its scalars: torch runs
//      each operation as its own kernel, so the costs are its bits;
//   3. _prune's per-segment minimum (ties to the larger left bitmap, a lane
//      of INF cost offering left 0, an empty segment (INF, INT32_MIN)) as
//      the maximum of one 64-bit key a lane (prune_key): a segmented
//      maximum over each warp's runs of equal segment (segments are
//      contiguous in lane order), then one atomicMax a run.  A maximum does
//      not depend on the order of the blocks;
//   4. the per-query enumerated and ccp counts (_segment_sum), one
//      atomicAdd of a popcount a query and warp: integer sums, exact.
// Output, both the caller's and both folded into, never overwritten:
// keys uint64[nseg] (atomicMax) and counts uint64[2 * bcap] (atomicAdd;
// enumerated, then ccp).  A chunk's own zeroed buffer is one target
// (kernels/ops.unpack_pruned reads it back); a level's key buffer at the
// chunk's first segment and a flight's counts are the other
// (core/chunks.DeviceFold), which commit_keys_kernel commits.  As the
// maximum does not depend on the order of the chunks either, both give
// the same keys.  A split costs (cl + cr) + jc with jc >= +0, so a zero
// cost is always +0.0 and every zero packs alike.

constexpr float kLog2Cap = static_cast<float>(100.0);       // cost.LOG2_CAP
constexpr float kHashBuild = static_cast<float>(1.8);       // C_HASH_BUILD
constexpr float kHashProbe = static_cast<float>(0.55);      // C_HASH_PROBE
constexpr float kMerge = static_cast<float>(0.4);           // C_MERGE
constexpr float kSort = static_cast<float>(0.25);           // C_SORT
constexpr float kNl = static_cast<float>(0.02);             // C_NL
constexpr float kTup = static_cast<float>(0.05);            // C_TUP

__device__ __forceinline__ float rows_from_log2(float rl2) {
  return exp2f(fminf(rl2, kLog2Cap));
}

// cost.join_cost on one lane, operation for operation.
__device__ __forceinline__ float join_cost(float l2, float r2, float o2) {
  const float rl = rows_from_log2(l2);
  const float rr = rows_from_log2(r2);
  const float tup = __fmul_rn(kTup, rows_from_log2(o2));
  const float hj = __fadd_rn(__fadd_rn(__fmul_rn(kHashBuild, fminf(rl, rr)),
                                       __fmul_rn(kHashProbe, fmaxf(rl, rr))),
                             tup);
  const float mj = __fadd_rn(
      __fadd_rn(__fmul_rn(kSort, __fadd_rn(__fmul_rn(rl, fmaxf(l2, 1.0f)),
                                           __fmul_rn(rr, fmaxf(r2, 1.0f)))),
                __fmul_rn(kMerge, __fadd_rn(rl, rr))),
      tup);
  const float nl = __fadd_rn(__fmul_rn(kNl, rows_from_log2(__fadd_rn(l2, r2))),
                             tup);
  return fminf(hj, fminf(mj, nl));
}

__device__ __forceinline__ float memo_at(const float* __restrict__ memo,
                                         int size, int idx) {
  return memo[min(max(idx, 0), size - 1)];
}

// The cost of splitting S into (S_left, S & ~S_left) for query q.
__device__ __forceinline__ float split_cost(int s, int sl, int q, int nmax,
                                            const float* __restrict__ cost,
                                            const float* __restrict__ rows,
                                            int size) {
  const int base = q << nmax;
  const int sr = s & ~sl;
  const float cl = memo_at(cost, size, base | sl);
  const float cr = memo_at(cost, size, base | sr);
  const float jc = join_cost(memo_at(rows, size, base | sl),
                             memo_at(rows, size, base | sr),
                             memo_at(rows, size, base | s));
  return __fadd_rn(__fadd_rn(cl, cr), jc);
}

// The lane's place in _prune's order, larger better: 0x7F800000 - the
// cost's bits (costs are >= 0, so their bits order as they do) in the high
// word, the left bitmap with its sign bit flipped in the low word.  A lane
// of INF cost offers left 0; the key 0 of an empty segment reads back as
// (INF, INT32_MIN).
__device__ __forceinline__ unsigned long long prune_key(float cost,
                                                        int left) {
  const unsigned hi = 0x7F800000u - __float_as_uint(cost);
  const unsigned lo =
      static_cast<unsigned>(cost < CUDART_INF_F ? left : 0) ^ 0x80000000u;
  return (static_cast<unsigned long long>(hi) << 32) | lo;
}

// Fold the warp's keys into keys[seg]: a segmented maximum down each run of
// equal seg (a lane takes the lane `off` above it where the two share a
// segment, so a run's first lane ends with the run's maximum), then one
// atomicMax a run.  Lanes past the chunk pass seg = -1.  Every lane of the
// warp takes part.
__device__ __forceinline__ void prune_warp(unsigned long long* keys, int nseg,
                                           int seg, unsigned long long key) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const unsigned long long k = __shfl_down_sync(0xffffffffu, key, off);
    const int s = __shfl_down_sync(0xffffffffu, seg, off);
    if (lane + off < 32 && s == seg && k > key) key = k;
  }
  const int prev = __shfl_up_sync(0xffffffffu, seg, 1);
  if ((lane == 0 || prev != seg) && seg >= 0 && seg < nseg && key != 0)
    atomicMax(keys + seg, key);
}

// Add the warp's enumerated (a) and ccp (b) lanes of each query q into
// counts[q] and counts[bcap + q], 64-bit so that a flight's sums do not
// wrap.  Lanes past the chunk pass q = -1.
__device__ __forceinline__ void count_warp(unsigned long long* counts,
                                           int bcap, int q, bool a, bool b) {
  const unsigned same = __match_any_sync(0xffffffffu, q);
  const unsigned na = __popc(__ballot_sync(0xffffffffu, a) & same);
  const unsigned nb = __popc(__ballot_sync(0xffffffffu, b) & same);
  if (q >= 0 && static_cast<int>(threadIdx.x & 31) == __ffs(same) - 1) {
    if (na) atomicAdd(counts + q, static_cast<unsigned long long>(na));
    if (nb) atomicAdd(counts + bcap + q, static_cast<unsigned long long>(nb));
  }
}

// btree_eval_decode_kernel's lanes, then the epilogue: every edge_in lane
// is a ccp pair (Theorem 3), so both counts count edge_in.  Shared memory
// as btree_eval_decode_kernel's.
__global__ void __launch_bounds__(kWideThreads)
btree_eval_prune_kernel(const int* __restrict__ all_sets, int n_sets,
                        const int* __restrict__ eoff,
                        const int* __restrict__ loff,
                        const int* __restrict__ soff, int seg0,
                        const int* __restrict__ m_b,
                        const int* __restrict__ emu_b,
                        const int* __restrict__ emv_b, int emax,
                        const int* __restrict__ adj_b,
                        const float* __restrict__ memo_cost,
                        const float* __restrict__ memo_rows, int memo_size,
                        unsigned long long* __restrict__ keys,
                        unsigned long long* __restrict__ counts, int L,
                        int bcap, int nmax, int nseg) {
  extern __shared__ int smem[];
  const TreeTables tb = stage_tree(smem, eoff, loff, soff, m_b, adj_b, bcap,
                                   nmax);
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  int seg = -1, q = -1;
  bool in = false;
  unsigned long long key = 0;
  if (t < L) {
    const TreeLane ln = tree_lane(t, tb, all_sets, n_sets, seg0, emu_b, emv_b,
                                  emax, bcap, nseg);
    float cost = CUDART_INF_F;
    int sl = 0;
    if (ln.edge_in) {
      sl = grow_excl(ln.ub, ln.s, tb.adj + ln.q * nmax, (1 << nmax) - 1,
                     ln.ub, ln.vb);
      cost = split_cost(ln.s, sl, ln.q, nmax, memo_cost, memo_rows,
                        memo_size);
    }
    key = prune_key(cost, sl);
    seg = ln.seg;
    q = ln.q;
    in = ln.edge_in;
  }
  prune_warp(keys, nseg, seg, key);
  count_warp(counts, bcap, q, in, in);
}

// bgeneral_eval_decode_kernel's lanes, then the epilogue, one segment a
// pair (nseg = pcap).  Shared memory: adj_b (bcap x nmax).
__global__ void __launch_bounds__(kWideThreads)
bgeneral_eval_prune_kernel(const int* __restrict__ pairs, int pcap,
                           int n_pairs, int lane_count,
                           const int* __restrict__ adj_b,
                           const float* __restrict__ memo_cost,
                           const float* __restrict__ memo_rows,
                           int memo_size,
                           unsigned long long* __restrict__ keys,
                           unsigned long long* __restrict__ counts, int L,
                           int bcap, int nmax) {
  extern __shared__ int sadj[];
  stage(sadj, adj_b, bcap * nmax);
  __syncthreads();
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  int seg = -1, q = -1;
  bool en = false, cc = false;
  unsigned long long key = 0;
  if (t < L) {
    const GeneralLane ln = general_lane(t, pairs, pcap, n_pairs, lane_count,
                                        sadj, bcap, nmax);
    float cost = CUDART_INF_F;
    int sl = 0;
    if (ln.ccp) {
      sl = grow(ln.lb, ln.s & ~ln.rb, sadj + ln.q * nmax, (1 << nmax) - 1);
      cost = split_cost(ln.s, sl, ln.q, nmax, memo_cost, memo_rows,
                        memo_size);
    }
    key = prune_key(cost, sl);
    seg = ln.p;
    q = ln.q;
    en = ln.enum_ok;
    cc = ln.ccp;
  }
  prune_warp(keys, pcap, seg, key);
  count_warp(counts, bcap, q, en, cc);
}

// The commit of a level whose chunks folded into one key buffer
// (core/chunks.DeviceFold), in place of the host's fetch, merge and memo
// scatter: key t belongs to memo entry idx[t], and the keys of one entry
// are consecutive (a contiguous level: one key a set; an MPDP-general
// level: one a (set, block) pair, the pairs sorted by set).  The first
// thread of each run takes the run's largest key (the cheapest split,
// ties to the larger left bitmap) and, where its cost is finite, writes
// the cost and the left bitmap at idx[t]; an index outside the memo is
// dropped, as the host's scatter drops it.
__global__ void __launch_bounds__(kWideThreads)
commit_keys_kernel(const unsigned long long* __restrict__ keys,
                   const int* __restrict__ idx, int n,
                   float* __restrict__ memo_cost, int* __restrict__ memo_left,
                   int memo_size) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= n) return;
  const int i = idx[t];
  if (t > 0 && idx[t - 1] == i) return;
  unsigned long long key = keys[t];
  for (int u = t + 1; u < n && idx[u] == i; ++u) {
    const unsigned long long k = keys[u];
    if (k > key) key = k;
  }
  const float cost = __uint_as_float(
      0x7F800000u - static_cast<unsigned>(key >> 32));
  if (!isfinite(cost) || i < 0 || i >= memo_size) return;
  memo_cost[i] = cost;
  memo_left[i] = static_cast<int>(static_cast<unsigned>(key) ^ 0x80000000u);
}

// ------------------------------------------------------- phase A (blocks) --

// Phase A of MPDP-general: the blocks of G[S] for each set S of one query,
// as the port's plain blocks_chunk computes them (kernels/ref.py), one
// thread a set, every step on bitmaps and per-thread arrays:
//   1. the BFS tree from lsb(S): a vertex found in round d takes depth
//      d + 1 and, as parent, its lowest-index neighbour in the frontier;
//      unreached vertices keep parent -1 and depth kUnreached;
//   2. the edges of G[S] that are not tree edges, in edge-array order, into
//      the first eff_cap slots (later ones are dropped);
//   3. one fundamental cycle a slot by the LCA walk (the deeper end steps
//      to its parent, both on a tie, at most 2 nmax steps; stopping once
//      the ends meet gives the same bitmap);
//   4. the cycles merged in rounds, each reading the previous round's slots,
//      a slot taking every slot that shares >= 2 vertices with it, until no
//      slot changes; then the duplicates of earlier slots zeroed;
//   5. the bridges: each tree edge (v, parent[v]) that no cycle of step 3
//      covers, by ascending v.
// Row t of out (width ints) gets set t's merged blocks in slot order, then
// its bridges, zero after (at most eff_cap + popcount(S) - 1 of them; a
// narrower row keeps the first width).  Edges with a dead or out-of-range
// endpoint are staged as -1 and belong to no set.  Shared memory: adj
// (nmax) and the edge endpoints (2 x emax).
constexpr int kCycHard = 24;         // fundamental-cycle slots (cyc_cap)
constexpr int kUnreached = 1 << 20;  // depth of a vertex the BFS never finds

__global__ void __launch_bounds__(kThreads)
phase_a_blocks_kernel(const int* __restrict__ sets,
                      const int* __restrict__ adj,
                      const int* __restrict__ eu_idx,
                      const int* __restrict__ ev_idx,
                      const unsigned char* __restrict__ edge_live,
                      int* __restrict__ out, int n_sets, int nmax, int emax,
                      int eff_cap, int width) {
  extern __shared__ int smem[];
  int* sadj = smem;
  int* seu = sadj + nmax;
  int* sev = seu + emax;
  stage(sadj, adj, nmax);
  for (int e = threadIdx.x; e < emax; e += blockDim.x) {
    const int u = eu_idx[e], v = ev_idx[e];
    const bool ok = edge_live[e] && u >= 0 && u < nmax && v >= 0 && v < nmax;
    seu[e] = ok ? u : -1;
    sev[e] = ok ? v : -1;
  }
  __syncthreads();
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= n_sets) return;
  const int nmask = (1 << nmax) - 1;
  const int s = sets[t];
  int* row = out + static_cast<long long>(t) * width;

  // 1. BFS tree
  int parent[kNmaxHard], depth[kNmaxHard];
  const int root = lsb(s);
  for (int v = 0; v < nmax; ++v) {
    parent[v] = -1;
    depth[v] = ((root >> v) & 1) ? 0 : kUnreached;
  }
  int visited = root, frontier = root;
  for (int d = 0; d < nmax && frontier; ++d) {
    const int fresh = neighbors(frontier, sadj, nmask) & s & ~visited;
    for (unsigned m = static_cast<unsigned>(fresh); m; m &= m - 1) {
      const int v = __ffs(m) - 1;
      const int pbm = sadj[v] & frontier;
      parent[v] = pbm ? __ffs(pbm) - 1 : 0;
      depth[v] = d + 1;
    }
    visited |= fresh;
    frontier = fresh;
  }

  // 2. non-tree edges of G[S] into slots; 3. their fundamental cycles
  int cyc[kCycHard];
  int nslot = 0;
  for (int e = 0; e < emax && nslot < eff_cap; ++e) {
    const int u = seu[e], v = sev[e];
    if (u < 0 || v < 0 || !((s >> u) & 1) || !((s >> v) & 1)) continue;
    if (parent[u] == v || parent[v] == u) continue;          // a tree edge
    int a = u, b = v, c = 0;
    for (int step = 0; step < 2 * nmax && a != b; ++step) {
      c |= (1 << a) | (1 << b);
      const int da = depth[a], db = depth[b];
      const int na = da >= db ? parent[a] : a;
      const int nb = db >= da ? parent[b] : b;
      a = max(na, 0);
      b = max(nb, 0);
    }
    cyc[nslot++] = c | (1 << a);                              // the LCA
  }

  // 4. merge (Jacobi rounds), then drop duplicates of earlier slots
  int cur[kCycHard], nxt[kCycHard];
  for (int i = 0; i < nslot; ++i) cur[i] = cyc[i];
  for (bool changed = true; changed;) {
    changed = false;
    for (int i = 0; i < nslot; ++i) {
      int x = cur[i];
      if (x) {
        for (int j = 0; j < nslot; ++j) {
          if (cur[j] && __popc(cur[i] & cur[j]) >= 2) x |= cur[j];
        }
      }
      nxt[i] = x;
      changed |= x != cur[i];
    }
    for (int i = 0; i < nslot; ++i) cur[i] = nxt[i];
  }
  int w = 0;
  for (int i = 0; i < nslot; ++i) {
    bool dup = cur[i] == 0;
    for (int j = 0; j < i && !dup; ++j) dup = cur[j] == cur[i];
    if (!dup) {
      if (w < width) row[w] = cur[i];
      ++w;
    }
  }

  // 5. bridges: tree edges no pre-merge cycle covers
  for (int v = 0; v < nmax; ++v) {
    const int p = parent[v];
    if (p < 0 || !((s >> v) & 1)) continue;
    const int pair = (1 << v) | (1 << p);
    bool covered = false;
    for (int k = 0; k < nslot && !covered; ++k) {
      covered = (cyc[k] & pair) == pair;
    }
    if (!covered) {
      if (w < width) row[w] = pair;
      ++w;
    }
  }
  for (; w < width; ++w) row[w] = 0;
}

inline dim3 grid_for(int L) { return dim3((L + kThreads - 1) / kThreads); }

// Grid of a grid-stride kernel: the blocks resident on the card at once
// (occupancy x SM count, read once per device and kernel), or fewer when L
// needs fewer.
struct ResidentGrid {
  int device = -1;
  size_t smem = 0;
  int blocks = 1;
};

inline dim3 grid_stride_for(const void* kernel, ResidentGrid& cache, int L,
                            size_t smem = 0) {
  int dev = 0;
  cudaGetDevice(&dev);
  if (cache.device != dev || cache.smem != smem) {
    int sms = 0, per_sm = 0;
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                  kWideThreads, smem);
    cache.blocks = sms * per_sm > 0 ? sms * per_sm : 1;
    cache.device = dev;
    cache.smem = smem;
  }
  return dim3(std::min(cache.blocks, (L + kWideThreads - 1) / kWideThreads));
}

inline size_t smem_for(int bcap, int nmax) {
  return static_cast<size_t>(bcap) * nmax * sizeof(int);
}

}  // namespace

// ------------------------------------------------------------- C interface --

extern "C" {

const char* rt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

int rt_connectivity(const int* S, const int* adj, int* conn, int L, int nmax,
                    void* stream) {
  static ResidentGrid cache;
  dim3 grid = grid_stride_for(
      reinterpret_cast<const void*>(&connectivity_kernel<false>), cache, L);
  connectivity_kernel<false><<<grid, kWideThreads, 0,
                               static_cast<cudaStream_t>(stream)>>>(
      S, 0, 0, nullptr, adj, nullptr, conn, L, nmax);
  return static_cast<int>(cudaGetLastError());
}

int rt_connectivity_span(int rank0, int k, int count, const int* binom,
                         const int* adj, int* S, int* conn, int nmax,
                         void* stream) {
  static ResidentGrid cache;
  dim3 grid = grid_stride_for(
      reinterpret_cast<const void*>(&connectivity_kernel<true>), cache, count);
  connectivity_kernel<true><<<grid, kWideThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      nullptr, rank0, k, binom, adj, S, conn, count, nmax);
  return static_cast<int>(cudaGetLastError());
}

int rt_ccp_eval(const int* S, const int* sub, const int* adj, int* lb,
                int* rb, int* ccp_out, int L, int nmax, void* stream) {
  ccp_eval_kernel<<<grid_for(L), kThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(S, sub, adj, lb, rb,
                                                         ccp_out, L, nmax);
  return static_cast<int>(cudaGetLastError());
}

int rt_ccp_eval_dpsub(const int* all_sets, int n_sets, int level_off,
                      int base_set, int base_sub, int i, const int* adj,
                      int* lb, int* rb, int* ccp_out, int L, int nmax,
                      void* stream) {
  ccp_eval_dpsub_kernel<<<(L + kWideThreads - 1) / kWideThreads, kWideThreads,
                          0, static_cast<cudaStream_t>(stream)>>>(
      all_sets, n_sets, level_off, base_set, base_sub, i, adj, lb, rb,
      ccp_out, L, nmax);
  return static_cast<int>(cudaGetLastError());
}

int rt_grow_pair(const int* S, const int* lb, const int* rb, const int* adj,
                 int* sl, int* sr, int L, int nmax, void* stream) {
  grow_pair_kernel<<<grid_for(L), kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(S, lb, rb, adj, sl,
                                                          sr, L, nmax);
  return static_cast<int>(cudaGetLastError());
}

int rt_bconnectivity(const int* S, const int* qid, const int* adj_b,
                     int* conn, int L, int bcap, int nmax, void* stream) {
  bconnectivity_kernel<<<grid_for(L), kThreads, smem_for(bcap, nmax),
                         static_cast<cudaStream_t>(stream)>>>(
      S, qid, adj_b, conn, L, bcap, nmax);
  return static_cast<int>(cudaGetLastError());
}

int rt_bconnectivity_span(int k, const int* foff, int count,
                          const int* binom, const int* adj_b, int* S,
                          int* conn, int* qid, int bcap, int nmax,
                          void* stream) {
  static ResidentGrid cache;
  size_t smem = static_cast<size_t>(bcap + 1 + (nmax + 1) * (nmax + 1)
                                    + bcap * nmax) * sizeof(int);
  dim3 grid = grid_stride_for(
      reinterpret_cast<const void*>(&bconnectivity_span_kernel), cache, count,
      smem);
  bconnectivity_span_kernel<<<grid, kWideThreads, smem,
                              static_cast<cudaStream_t>(stream)>>>(
      k, foff, count, binom, adj_b, S, conn, qid, bcap, nmax);
  return static_cast<int>(cudaGetLastError());
}

int rt_bccp_eval(const int* S, const int* sub, const int* qid,
                 const int* adj_b, int* lb, int* rb, int* ccp_out, int L,
                 int bcap, int nmax, void* stream) {
  bccp_eval_kernel<<<grid_for(L), kThreads, smem_for(bcap, nmax),
                     static_cast<cudaStream_t>(stream)>>>(
      S, sub, qid, adj_b, lb, rb, ccp_out, L, bcap, nmax);
  return static_cast<int>(cudaGetLastError());
}

int rt_bccp_eval_decode(const int* all_sets, int n_sets, const int* eoff,
                        const int* loff, const int* soff, int seg0, int i,
                        const int* adj_b, int* lb, int* rb, int* ccp_out,
                        int* qid, int* seg, int L, int bcap, int nmax,
                        int nseg, void* stream) {
  size_t smem = static_cast<size_t>(3 * bcap + 1 + bcap * nmax) * sizeof(int);
  bccp_eval_decode_kernel<<<(L + kWideThreads - 1) / kWideThreads,
                            kWideThreads, smem,
                            static_cast<cudaStream_t>(stream)>>>(
      all_sets, n_sets, eoff, loff, soff, seg0, i, adj_b, lb, rb, ccp_out, qid,
      seg, L, bcap, nmax, nseg);
  return static_cast<int>(cudaGetLastError());
}

int rt_btree_eval(const int* S, const int* ub, const int* vb, const int* qid,
                  const int* adj_b, int* sl, int* edge_in, int L, int bcap,
                  int nmax, void* stream) {
  btree_eval_kernel<<<grid_for(L), kThreads, smem_for(bcap, nmax),
                      static_cast<cudaStream_t>(stream)>>>(
      S, ub, vb, qid, adj_b, sl, edge_in, L, bcap, nmax);
  return static_cast<int>(cudaGetLastError());
}

int rt_btree_eval_decode(const int* all_sets, int n_sets, const int* eoff,
                         const int* loff, const int* soff, int seg0,
                         const int* m_b, const int* emu_b, const int* emv_b,
                         int emax, const int* adj_b, int* S, int* sl,
                         int* edge_in, int* qid, int* seg, int L, int bcap,
                         int nmax, int nseg, void* stream) {
  size_t smem = static_cast<size_t>(4 * bcap + 1 + bcap * nmax) * sizeof(int);
  btree_eval_decode_kernel<<<(L + kWideThreads - 1) / kWideThreads,
                             kWideThreads, smem,
                             static_cast<cudaStream_t>(stream)>>>(
      all_sets, n_sets, eoff, loff, soff, seg0, m_b, emu_b, emv_b, emax, adj_b,
      S, sl, edge_in, qid, seg, L, bcap, nmax, nseg);
  return static_cast<int>(cudaGetLastError());
}

int rt_bgeneral_eval(const int* S, const int* block, const int* r,
                     const int* qid, const int* adj_b, int* lb, int* sl,
                     int* ccp_out, int L, int bcap, int nmax, void* stream) {
  bgeneral_eval_kernel<<<grid_for(L), kThreads, smem_for(bcap, nmax),
                         static_cast<cudaStream_t>(stream)>>>(
      S, block, r, qid, adj_b, lb, sl, ccp_out, L, bcap, nmax);
  return static_cast<int>(cudaGetLastError());
}

int rt_bgeneral_eval_decode(const int* pairs, int pcap, int n_pairs,
                            int lane_count, const int* adj_b, int* S, int* sl,
                            int* enum_ok, int* ccp_out, int* qid, int* p,
                            int L, int bcap, int nmax, void* stream) {
  bgeneral_eval_decode_kernel<<<(L + kWideThreads - 1) / kWideThreads,
                                kWideThreads, smem_for(bcap, nmax),
                                static_cast<cudaStream_t>(stream)>>>(
      pairs, pcap, n_pairs, lane_count, adj_b, S, sl, enum_ok, ccp_out, qid, p,
      L, bcap, nmax);
  return static_cast<int>(cudaGetLastError());
}

int rt_btree_eval_prune(const int* all_sets, int n_sets, const int* eoff,
                        const int* loff, const int* soff, int seg0,
                        const int* m_b, const int* emu_b, const int* emv_b,
                        int emax, const int* adj_b, const float* memo_cost,
                        const float* memo_rows, int memo_size,
                        unsigned long long* keys, unsigned long long* counts,
                        int L, int bcap, int nmax, int nseg, void* stream) {
  size_t smem = static_cast<size_t>(4 * bcap + 1 + bcap * nmax) * sizeof(int);
  btree_eval_prune_kernel<<<(L + kWideThreads - 1) / kWideThreads,
                            kWideThreads, smem,
                            static_cast<cudaStream_t>(stream)>>>(
      all_sets, n_sets, eoff, loff, soff, seg0, m_b, emu_b, emv_b, emax, adj_b,
      memo_cost, memo_rows, memo_size, keys, counts, L, bcap, nmax, nseg);
  return static_cast<int>(cudaGetLastError());
}

int rt_bgeneral_eval_prune(const int* pairs, int pcap, int n_pairs,
                           int lane_count, const int* adj_b,
                           const float* memo_cost, const float* memo_rows,
                           int memo_size, unsigned long long* keys,
                           unsigned long long* counts, int L, int bcap,
                           int nmax, void* stream) {
  bgeneral_eval_prune_kernel<<<(L + kWideThreads - 1) / kWideThreads,
                               kWideThreads, smem_for(bcap, nmax),
                               static_cast<cudaStream_t>(stream)>>>(
      pairs, pcap, n_pairs, lane_count, adj_b, memo_cost, memo_rows,
      memo_size, keys, counts, L, bcap, nmax);
  return static_cast<int>(cudaGetLastError());
}

int rt_commit_keys(const unsigned long long* keys, const int* idx, int n,
                   float* memo_cost, int* memo_left, int memo_size,
                   void* stream) {
  commit_keys_kernel<<<(n + kWideThreads - 1) / kWideThreads, kWideThreads,
                       0, static_cast<cudaStream_t>(stream)>>>(
      keys, idx, n, memo_cost, memo_left, memo_size);
  return static_cast<int>(cudaGetLastError());
}

int rt_phase_a_blocks(const int* sets, const int* adj, const int* eu_idx,
                      const int* ev_idx, const unsigned char* edge_live,
                      int* out, int n_sets, int nmax, int emax, int eff_cap,
                      int width, void* stream) {
  size_t smem = static_cast<size_t>(nmax + 2 * emax) * sizeof(int);
  phase_a_blocks_kernel<<<grid_for(n_sets), kThreads, smem,
                          static_cast<cudaStream_t>(stream)>>>(
      sets, adj, eu_idx, ev_idx, edge_live, out, n_sets, nmax, emax, eff_cap,
      width);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
