// Cost change of every single-item move, and the annealer's whole step,
// batched over annealing chains.
//
// Replaces the Pallas kernel src/repro/kernels/move_eval.py:135
// (move_delta_batch over _move_eval_kernel) and, in anneal_step, the body
// of the JAX annealer's step around it (src/repro/opt/anneal.py:147-186,
// chain_update and body).  Per chain c, item p and bin name b, with
// w = speeds[p], a = assign[p]:
//   d_bins  = (counts[b] == 0) - (counts[a] == 1)
//   now     = prev[p] >= 0 && b != prev[p]
//   was     = prev[p] >= 0 && a != prev[p]
//   d_r     = ((now - was) * w) * (lam / cap)
//   allowed = b != a && (loads[b] + w <= cap || (counts[b] == 0 && w > cap))
//             && (no mask || active[p] > 0)
//   delta   = allowed ? d_bins + d_r : 1e30
// move_delta below computes it; an item's moves take one of four costs
// (bin empty or not, R-score moved or not), which item_moves works out
// once an item and pick selects a move's from, so every kernel here
// agrees by construction.  The products and the sums use the _rn intrinsics so that
// nvcc never contracts them into an FMA: the kernels equal the plain
// PyTorch versions bit for bit.
//
// move_eval_kernel writes the [K, N, M] plane.  Bound on the H100: bytes,
// the plane written once against 3.35 TB/s.  A block covers one contiguous
// run of the flattened plane, several whole chains (about 64 KB) or one
// piece of a wide chain, stages those chains' bins and items once, and
// walks the run with a running (chain, item, bin) counter (no division a
// element), four floats at a time in 16-byte streaming stores.
//
// anneal_step_*_kernel run one anneal step for every chain in place:
// each move's delta, z = -delta / T + g (g the step's Gumbel draw, T read
// on the card from temps[step]), the chain's first maximum of z over the
// N*M moves against the "stay" draw g[N*M], then the move (loads, counts,
// assignment, incremental cost) and the best-so-far state.  The delta
// plane never leaves the chip, so the bound is the state read and written
// once plus the Gumbel block.  An item's moves have one of four costs
// (bin empty or not, R-score moved or not), so the four -cost / T are
// divided once an item, not once a move.  The argmax (largest z, lowest
// index on a tie, NaN above all) is associative and commutative, so any
// reduction tree gives the plain version's bits.  Two layouts, by N*M:
//  - warp layout (N*M <= 8192): a warp a chain, the 8 warps of a block
//    the chains of 8 rows that share one Gumbel row, staged once in
//    shared memory with the chains' bins and items;
//  - cluster layout (wider chains, where chains are few): a cluster of 8
//    blocks a chain, each block an eighth of the moves in tiles whose
//    draws are staged in shared memory; the blocks' best (z, index)
//    pairs meet in the first block through distributed shared memory,
//    and that block applies the move.
#include <algorithm>
#include <climits>
#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr float kBlocked = 1e30f;
constexpr float kBlockedHalf = 5e29f;      // the plain version's MOVE_BLOCKED / 2
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kClusterBlocks = 8;
constexpr int kWarpLayoutMaxMoves = 8192;
constexpr int kTileMoves = 4096;                 // cluster layout: 16 KB of draws
constexpr long long kPlaneBlockElems = 16384;   // ~64 KB of plane a block
constexpr int kSmemDefault = 48 * 1024;
constexpr int kSmemMax = 227 * 1024;

// What the delta reads of one item: its speed, bin, previous bin, and the
// count of its own bin (-1 marks an inactive item: every move blocked).
struct Item {
  float w;
  int a;
  int pv;
  int count_a;
};

__device__ __forceinline__ Item load_item(const int* __restrict__ assign,
                                          const float* __restrict__ speeds,
                                          const int* __restrict__ prev,
                                          const int* __restrict__ active,
                                          const int* __restrict__ counts_c,
                                          long long i, int m) {
  Item it;
  it.w = speeds[i];
  it.a = assign[i];
  it.pv = prev[i];
  // the reference sums the one-hot row of counts: the same integer
  const int ca = (it.a >= 0 && it.a < m) ? counts_c[it.a] : 0;
  it.count_a = (active == nullptr || active[i] > 0) ? ca : -1;
  return it;
}

// the cost change of an allowed move of `it` to a bin that is empty or
// not, and that counts as moved for the R-score or not (`now`): of an
// item's moves only these four values are possible
__device__ __forceinline__ float move_cost(bool empty, bool now,
                                           const Item& it, float lc) {
  const float d_bins = (empty ? 1.0f : 0.0f) - (it.count_a == 1 ? 1.0f : 0.0f);
  const float was = (it.pv >= 0 && it.a != it.pv) ? 1.0f : 0.0f;
  const float d_r = __fmul_rn(__fmul_rn((now ? 1.0f : 0.0f) - was, it.w), lc);
  return __fadd_rn(d_bins, d_r);
}

// An item with the value of each of its four move costs, v[2 empty +
// (b != pv)], worked out once: an inactive item's are all blocked, and a
// non-sticky item's do not depend on b (it never counts as moved).
struct ItemMoves {
  Item it;
  float4 v;
};

__device__ __forceinline__ ItemMoves item_moves(const Item& it, float lc) {
  const bool sticky = it.pv >= 0;
  const bool live = it.count_a >= 0;
  ItemMoves im;
  im.it = it;
  im.v.x = live ? move_cost(false, false, it, lc) : kBlocked;
  im.v.y = live ? move_cost(false, sticky, it, lc) : kBlocked;
  im.v.z = live ? move_cost(true, false, it, lc) : kBlocked;
  im.v.w = live ? move_cost(true, sticky, it, lc) : kBlocked;
  return im;
}

// The move of `im` to bin b, which holds load_b in count_b items: its
// entry of v if the move is allowed, else `blocked`.  Branch-free.
__device__ __forceinline__ float pick(float load_b, int count_b, int b,
                                      const ItemMoves& im, float c,
                                      float blocked) {
  const bool empty = count_b == 0;
  const bool now = b != im.it.pv;
  const float v = empty ? (now ? im.v.w : im.v.z) : (now ? im.v.y : im.v.x);
  const bool allowed = b != im.it.a
      && (__fadd_rn(load_b, im.it.w) <= c || (empty && im.it.w > c));
  return allowed ? v : blocked;
}

// the delta of one (chain, item, bin): every kernel here computes it
// through item_moves and pick, so they agree by construction
__device__ __forceinline__ float move_delta(float load_b, int count_b, int b,
                                            const Item& it, float c,
                                            float lc) {
  return pick(load_b, count_b, b, item_moves(it, lc), c, kBlocked);
}

// ---- the plane ---------------------------------------------------------------

struct PlaneArgs {
  const float* loads;
  const int* counts;
  const int* assign;
  const float* speeds;
  const int* prev;
  const float* lam;
  const float* cap;
  const int* active;
  float* out;
  int k, n, m;
  int chains_per_block;   // > 0: whole chains a block; else pieces
  int splits;             // pieces a chain (pieces mode)
  long long piece;        // elements a piece, a multiple of 4
};

// (chain, item, bin) of an element of a block's run, the chain counted
// from the run's first
struct Pos {
  int c, p, b;
};

// the position of element x of a run that starts at element e0 of the
// plane, in chain c0
__device__ __forceinline__ Pos split_elem(long long e0, long long c0, int x,
                                          long long nm, int m) {
  const long long e = e0 + x;
  const long long c = e / nm;
  const int r = static_cast<int>(e - c * nm);
  Pos q;
  q.c = static_cast<int>(c - c0);
  q.p = r / m;
  q.b = r - q.p * m;
  return q;
}

__device__ __forceinline__ void next_elem(Pos& q, int n, int m) {
  if (++q.b == m) {
    q.b = 0;
    if (++q.p == n) {
      q.p = 0;
      ++q.c;
    }
  }
}

__global__ void __launch_bounds__(kThreads) move_eval_kernel(PlaneArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int n = a.n, m = a.m, tid = threadIdx.x;
  const long long nm = static_cast<long long>(n) * m;
  long long e0, e1;
  if (a.chains_per_block > 0) {
    const long long c = static_cast<long long>(blockIdx.x) * a.chains_per_block;
    e0 = c * nm;
    e1 = min(static_cast<long long>(a.k), c + a.chains_per_block) * nm;
  } else {
    const long long c = blockIdx.x / a.splits;
    const long long s = blockIdx.x % a.splits;
    e0 = c * nm + s * a.piece;
    e1 = c * nm + min(nm, (s + 1) * a.piece);
  }
  // the chains and the items the run touches
  const long long c0 = e0 / nm;
  const int nc = static_cast<int>((e1 - 1) / nm - c0 + 1);
  const long long i_lo = c0 * n + (e0 - c0 * nm) / m;
  const long long c1 = c0 + nc - 1;
  const int n_items = static_cast<int>(c1 * n + (e1 - 1 - c1 * nm) / m
                                       - i_lo + 1);
  const int i_skip = static_cast<int>(i_lo - c0 * n);   // items of c0 before

  ItemMoves* s_item = reinterpret_cast<ItemMoves*>(smem);
  float2* s_bin = reinterpret_cast<float2*>(s_item + n_items);  // (load, count)
  float* s_cap = reinterpret_cast<float*>(s_bin + nc * m);
  for (int x = tid; x < nc * m; x += kThreads) {
    const long long g = c0 * m + x;
    s_bin[x] = make_float2(a.loads[g], __int_as_float(a.counts[g]));
  }
  for (int x = tid; x < n_items; x += kThreads) {
    const long long i = i_lo + x;
    const long long c = i / n;
    s_item[x] = item_moves(load_item(a.assign, a.speeds, a.prev, a.active,
                                     a.counts + c * m, i, m),
                           __fdiv_rn(a.lam[c], a.cap[c]));
  }
  for (int x = tid; x < nc; x += kThreads) s_cap[x] = a.cap[c0 + x];
  __syncthreads();

  auto delta = [&](const Pos& q) {
    const float2 bin = s_bin[q.c * m + q.b];
    return pick(bin.x, __float_as_int(bin.y), q.b,
                s_item[q.c * n + q.p - i_skip], s_cap[q.c], kBlocked);
  };

  // a scalar head up to the first 16-byte boundary, float4 stores, a
  // scalar tail
  const int len = static_cast<int>(e1 - e0);
  const int head = min(len, static_cast<int>((4 - (e0 & 3)) & 3));
  const int nvec = (len - head) / 4;
  const int tail0 = head + 4 * nvec;
  float* out = a.out + e0;
  if (tid < head) out[tid] = delta(split_elem(e0, c0, tid, nm, m));
  if (tid < len - tail0) {
    out[tail0 + tid] = delta(split_elem(e0, c0, tail0 + tid, nm, m));
  }
  if (tid >= nvec) return;
  // the counter advances 4 * kThreads elements an iteration: that stride
  // in (chain, item, bin) digits
  const int stride = 4 * kThreads;
  const int sb = stride % m;
  const int sp = (stride / m) % n;
  const int sc = (stride / m) / n;
  Pos q = split_elem(e0, c0, head + 4 * tid, nm, m);
  for (int v = tid; v < nvec; v += kThreads) {
    // the four elements mostly share one item: read it once, and again
    // only where the bin index wraps
    Pos r = q;
    ItemMoves im = s_item[r.c * n + r.p - i_skip];
    float cap = s_cap[r.c];
    auto at = [&](const Pos& x) {
      const float2 bin = s_bin[x.c * m + x.b];
      return pick(bin.x, __float_as_int(bin.y), x.b, im, cap, kBlocked);
    };
    auto next = [&]() {
      next_elem(r, n, m);
      if (r.b == 0) {
        im = s_item[r.c * n + r.p - i_skip];
        cap = s_cap[r.c];
      }
    };
    float4 o;
    o.x = at(r);
    next();
    o.y = at(r);
    next();
    o.z = at(r);
    next();
    o.w = at(r);
    __stcs(reinterpret_cast<float4*>(out + head + 4 * v), o);
    q.b += sb;
    if (q.b >= m) {
      q.b -= m;
      ++q.p;
    }
    q.p += sp;
    if (q.p >= n) {
      q.p -= n;
      ++q.c;
    }
    q.c += sc;
  }
}

// ---- the anneal step -----------------------------------------------------------

struct StepArgs {
  int* assign;          // i32[C, N]   updated in place
  float* loads;         // f32[C, M]
  int* counts;          // i32[C, M]
  float* cost;          // f32[C]
  float* best_cost;     // f32[C]
  int* best_assign;     // i32[C, N]
  const float* speeds;  // f32[C, N]
  const int* prev;      // i32[C, N]
  const float* lam;     // f32[C]
  const float* cap;     // f32[C]
  const int* active;    // i32[C, N] or null
  const float* gumbel;  // f32[K, N*M + 1]: chain c draws row c % K
  const float* temps;   // f32[steps]
  int step, rows, k_draws, n, m;
};

// the argmax order: larger z first, then the lower index; NaN above all
__device__ __forceinline__ bool ahead(float z, int i, float bz, int bi) {
  return z > bz || (z == bz && i < bi)
         || (isnan(z) && (!isnan(bz) || i < bi));
}

__device__ __forceinline__ void warp_argmax(float& z, int& i) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float oz = __shfl_xor_sync(0xffffffffu, z, off);
    const int oi = __shfl_xor_sync(0xffffffffu, i, off);
    if (ahead(oz, oi, z, i)) {
      z = oz;
      i = oi;
    }
  }
}

// The move the chain takes after its argmax (zmax, zarg), as the plain
// version decides it.  Every caller thread computes the same values.
struct Move {
  bool take;     // the move is made
  bool better;   // the new cost beats the best so far
  int p, b;
  Item it;
  float load_b, cost;
  int count_b;
};

template <typename BinAt, typename ItemAt>
__device__ __forceinline__ Move decide(const StepArgs& s, long long c,
                                       float zmax, int zarg, float g_stay,
                                       float capc, float lc, BinAt bin_at,
                                       ItemAt item_at) {
  const int nm = s.n * s.m;
  Move mv;
  const int choice = zmax >= g_stay ? zarg : nm;
  const int idx = min(choice, nm - 1);
  mv.p = idx / s.m;
  mv.b = idx - mv.p * s.m;
  mv.it = item_at(mv.p);
  const float2 bin = bin_at(mv.b);
  mv.load_b = bin.x;
  mv.count_b = __float_as_int(bin.y);
  const float d = move_delta(mv.load_b, mv.count_b, mv.b, mv.it, capc, lc);
  mv.take = choice < nm && d < kBlockedHalf;
  const float old = s.cost[c];
  mv.cost = mv.take ? __fadd_rn(old, d) : old;
  mv.better = mv.cost < s.best_cost[c];
  return mv;
}

// the single-thread part of applying a move
template <typename BinAt>
__device__ __forceinline__ void apply_move(const StepArgs& s, long long c,
                                           const Move& mv, BinAt bin_at) {
  if (mv.take) {
    const float2 src = bin_at(mv.it.a);
    s.assign[c * s.n + mv.p] = mv.b;
    s.loads[c * s.m + mv.it.a] = __fsub_rn(src.x, mv.it.w);
    s.loads[c * s.m + mv.b] = __fadd_rn(mv.load_b, mv.it.w);
    s.counts[c * s.m + mv.it.a] = __float_as_int(src.y) - 1;
    s.counts[c * s.m + mv.b] = mv.count_b + 1;
    s.cost[c] = mv.cost;
  }
  if (mv.better) s.best_cost[c] = mv.cost;
}

// An item's four move costs as z = -cost / T (an inactive item's are
// the blocked z): the divisions the plain version makes for every move,
// made once an item.  A move's z is pick's (or the blocked z) plus its
// Gumbel draw.
__device__ __forceinline__ ItemMoves item_z(const Item& it, float temp,
                                            float lc) {
  ItemMoves im = item_moves(it, lc);
  im.v.x = __fdiv_rn(-im.v.x, temp);
  im.v.y = __fdiv_rn(-im.v.y, temp);
  im.v.z = __fdiv_rn(-im.v.z, temp);
  im.v.w = __fdiv_rn(-im.v.w, temp);
  return im;
}

// a thread's running argmax over its moves, taken in increasing index
// order: a later move replaces the best only if strictly larger (or the
// first NaN)
__device__ __forceinline__ void take_max(float z, int e, float& bz, int& bi) {
  if (z > bz || (isnan(z) && !isnan(bz))) {
    bz = z;
    bi = e;
  }
}

// A block of the warp layout: the chains of kWarps rows (one a warp) that
// draw Gumbel row kk, which the block stages once.
__global__ void __launch_bounds__(kThreads) anneal_step_warp_kernel(
    StepArgs s) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int n = s.n, m = s.m, nm = n * m;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int kk = blockIdx.y;
  float* s_g = reinterpret_cast<float*>(smem);
  float2* s_bins = reinterpret_cast<float2*>(s_g + ((nm + 4) & ~3));
  ItemMoves* s_items = reinterpret_cast<ItemMoves*>(s_bins + kWarps * m);

  const float* g = s.gumbel + static_cast<long long>(kk) * (nm + 1);
  for (int i = tid; i <= nm; i += kThreads) s_g[i] = g[i];
  const int row = blockIdx.x * kWarps + warp;
  const bool on = row < s.rows;
  const long long c = static_cast<long long>(row) * s.k_draws + kk;
  const float temp = s.temps[s.step];
  float2* bins = s_bins + warp * m;
  ItemMoves* items = s_items + warp * n;
  float capc = 0.0f, lc = 0.0f;
  if (on) {
    capc = s.cap[c];
    lc = __fdiv_rn(s.lam[c], capc);
    for (int b = lane; b < m; b += 32) {
      bins[b] = make_float2(s.loads[c * m + b],
                            __int_as_float(s.counts[c * m + b]));
    }
    for (int p = lane; p < n; p += 32) {
      items[p] = item_z(load_item(s.assign, s.speeds, s.prev, s.active,
                                  s.counts + c * m, c * n + p, m),
                        temp, lc);
    }
  }
  __syncthreads();
  if (!on) return;

  const float zq = __fdiv_rn(-kBlocked, temp);
  float bz = __int_as_float(0xff800000);   // -inf
  int bi = lane < nm ? lane : INT_MAX;
  int p = lane / m, b = lane % m;
  const int sp = 32 / m, sb = 32 % m;
  int have = -1;
  ItemMoves im;
  for (int e = lane; e < nm; e += 32) {
    if (p != have) {   // a lane's item changes every m / 32 moves
      im = items[p];
      have = p;
    }
    const float2 bin = bins[b];
    take_max(__fadd_rn(pick(bin.x, __float_as_int(bin.y), b, im, capc, zq),
                       s_g[e]),
             e, bz, bi);
    b += sb;
    p += sp;
    if (b >= m) {
      b -= m;
      ++p;
    }
  }
  warp_argmax(bz, bi);

  auto bin_at = [&](int x) { return bins[x]; };
  auto item_at = [&](int x) { return items[x].it; };
  const Move mv = decide(s, c, bz, bi, s_g[nm], capc, lc, bin_at, item_at);
  if (lane == 0) apply_move(s, c, mv, bin_at);
  if (mv.better) {
    for (int i = lane; i < n; i += 32) {
      s.best_assign[c * n + i] = (mv.take && i == mv.p) ? mv.b
                                                        : items[i].it.a;
    }
  }
}

struct Best {
  float z;
  int i;
};

// A block of the cluster layout: an eighth of one chain's moves, in tiles
// of kTileMoves whose Gumbel draws and items (with their z) are staged in
// shared memory, so that the draws stream from HBM at full rate.
__global__ void __cluster_dims__(kClusterBlocks, 1, 1)
    __launch_bounds__(kThreads) anneal_step_cluster_kernel(StepArgs s) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* s_g = reinterpret_cast<float*>(smem);                // kTileMoves
  ItemMoves* s_items = reinterpret_cast<ItemMoves*>(s_g + kTileMoves);
  __shared__ Best s_warp[kWarps];
  __shared__ Best s_best;
  cg::cluster_group cluster = cg::this_cluster();
  const unsigned rank = cluster.block_rank();
  const int n = s.n, m = s.m, nm = n * m;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const long long c = blockIdx.x / kClusterBlocks;
  const float* g = s.gumbel + (c % s.k_draws) * (nm + 1LL);
  const float* loads = s.loads + c * m;
  const int* counts = s.counts + c * m;
  auto bin_at = [&](int x) {
    return make_float2(loads[x], __int_as_float(counts[x]));
  };
  auto item_at = [&](int x) {
    return load_item(s.assign, s.speeds, s.prev, s.active, counts,
                     c * n + x, m);
  };

  const float temp = s.temps[s.step];
  const float capc = s.cap[c];
  const float lc = __fdiv_rn(s.lam[c], capc);
  const float zq = __fdiv_rn(-kBlocked, temp);
  const int piece = (nm + kClusterBlocks - 1) / kClusterBlocks;
  const int lo = static_cast<int>(rank) * piece;
  const int hi = min(nm, lo + piece);
  float bz = __int_as_float(0xff800000);   // -inf
  int bi = lo + tid < hi ? lo + tid : INT_MAX;
  for (int t0 = lo; t0 < hi; t0 += kTileMoves) {
    const int t1 = min(hi, t0 + kTileMoves);
    const int p0 = t0 / m, p1 = (t1 - 1) / m;
    for (int i = tid; i < t1 - t0; i += kThreads) s_g[i] = g[t0 + i];
    for (int i = tid; i <= p1 - p0; i += kThreads) {
      s_items[i] = item_z(item_at(p0 + i), temp, lc);
    }
    __syncthreads();
    if (t0 + tid < t1) {
      int p = (t0 + tid) / m, b = (t0 + tid) % m;
      const int sp = kThreads / m, sb = kThreads % m;
      int have = -1;
      ItemMoves im;
      for (int e = t0 + tid; e < t1; e += kThreads) {
        if (p != have) {   // a thread's item changes every m / kThreads moves
          im = s_items[p - p0];
          have = p;
        }
        take_max(__fadd_rn(pick(loads[b], counts[b], b, im, capc, zq),
                           s_g[e - t0]),
                 e, bz, bi);
        b += sb;
        p += sp;
        if (b >= m) {
          b -= m;
          ++p;
        }
      }
    }
    __syncthreads();
  }
  warp_argmax(bz, bi);
  if (lane == 0) s_warp[warp] = Best{bz, bi};
  __syncthreads();
  if (tid == 0) {
    Best best = s_warp[0];
    for (int w = 1; w < kWarps; ++w) {
      if (ahead(s_warp[w].z, s_warp[w].i, best.z, best.i)) best = s_warp[w];
    }
    s_best = best;
  }
  cluster.sync();   // every block's best is in its shared memory
  if (rank == 0 && tid == 0) {
    Best best = s_best;
    for (int r = 1; r < kClusterBlocks; ++r) {
      const Best o = *cluster.map_shared_rank(&s_best, r);
      if (ahead(o.z, o.i, best.z, best.i)) best = o;
    }
    s_warp[0] = best;
  }
  cluster.sync();   // the other blocks' shared memory is read: they may exit
  if (rank != 0) return;

  const Best best = s_warp[0];
  const Move mv = decide(s, c, best.z, best.i, g[nm], capc, lc, bin_at,
                         item_at);
  __syncthreads();   // every thread has read the state the move changes
  if (tid == 0) apply_move(s, c, mv, bin_at);
  if (mv.better) {
    for (int i = tid; i < n; i += kThreads) {
      s.best_assign[c * n + i] = (mv.take && i == mv.p) ? mv.b
                                                        : s.assign[c * n + i];
    }
  }
}

cudaError_t allow_smem(const void* kernel, size_t bytes) {
  if (bytes > static_cast<size_t>(kSmemMax)) return cudaErrorInvalidValue;
  if (bytes <= static_cast<size_t>(kSmemDefault)) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace

extern "C" int move_eval_f32(const float* loads, const int* counts,
                             const int* assign, const float* speeds,
                             const int* prev, const float* lam,
                             const float* cap, const int* active, float* out,
                             int k, int n, int m, cudaStream_t stream) {
  if (k <= 0 || n <= 0 || m <= 0) return static_cast<int>(cudaGetLastError());
  PlaneArgs a{loads, counts, assign, speeds, prev, lam, cap, active, out,
              k, n, m, 0, 1, 0};
  const long long nm = static_cast<long long>(n) * m;
  const size_t chain_bytes = static_cast<size_t>(m) * sizeof(float2)
                             + static_cast<size_t>(n) * sizeof(ItemMoves)
                             + sizeof(float);
  long long blocks;
  size_t smem;
  if (nm <= kPlaneBlockElems) {
    a.chains_per_block = static_cast<int>(
        std::min(static_cast<long long>(k), kPlaneBlockElems / nm));
    blocks = (k + a.chains_per_block - 1) / a.chains_per_block;
    smem = a.chains_per_block * chain_bytes;
  } else {
    a.splits = static_cast<int>((nm + kPlaneBlockElems - 1) / kPlaneBlockElems);
    a.piece = ((nm + a.splits - 1) / a.splits + 3) & ~3LL;
    blocks = static_cast<long long>(k) * a.splits;
    // the chain's bins, the items a piece touches, one chain's constants
    smem = static_cast<size_t>(m) * sizeof(float2)
           + static_cast<size_t>(a.piece / m + 2) * sizeof(ItemMoves)
           + sizeof(float);
  }
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e = allow_smem(reinterpret_cast<const void*>(move_eval_kernel),
                             smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  move_eval_kernel<<<static_cast<unsigned>(blocks), kThreads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int anneal_step_f32(int* assign, float* loads, int* counts,
                               float* cost, float* best_cost,
                               int* best_assign, const float* speeds,
                               const int* prev, const float* lam,
                               const float* cap, const int* active,
                               const float* gumbel, const float* temps,
                               int step, int rows, int k_draws, int n, int m,
                               cudaStream_t stream) {
  if (rows <= 0 || k_draws <= 0 || n <= 0 || m <= 0) {
    return static_cast<int>(cudaGetLastError());
  }
  const long long nm = static_cast<long long>(n) * m;
  if (nm >= INT_MAX - kThreads) return static_cast<int>(cudaErrorInvalidValue);
  StepArgs s{assign, loads, counts, cost, best_cost, best_assign, speeds,
             prev, lam, cap, active, gumbel, temps, step, rows, k_draws, n, m};
  if (nm <= kWarpLayoutMaxMoves) {
    const size_t smem = ((nm + 4) & ~3LL) * sizeof(float)
                        + kWarps * (static_cast<size_t>(m) * sizeof(float2)
                                    + static_cast<size_t>(n) * sizeof(ItemMoves));
    cudaError_t e = allow_smem(
        reinterpret_cast<const void*>(anneal_step_warp_kernel), smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    const dim3 grid((rows + kWarps - 1) / kWarps, k_draws);
    anneal_step_warp_kernel<<<grid, kThreads, smem, stream>>>(s);
  } else {
    const long long blocks = static_cast<long long>(rows) * k_draws
                             * kClusterBlocks;
    if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
    // the draws of a tile, and the items it touches
    const size_t smem = kTileMoves * sizeof(float)
                        + std::min(n, kTileMoves / m + 2) * sizeof(ItemMoves);
    cudaError_t e = allow_smem(
        reinterpret_cast<const void*>(anneal_step_cluster_kernel), smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    anneal_step_cluster_kernel<<<static_cast<unsigned>(blocks), kThreads,
                                 smem, stream>>>(s);
  }
  return static_cast<int>(cudaGetLastError());
}
