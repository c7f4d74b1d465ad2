// Fit-strategy slot selection, and the packers' whole item walk in one
// launch per packing call.
//
// Replaces the Pallas kernel src/repro/kernels/binpack_select.py
// (select_slot_grid over _select_tile_kernel; select_slot_batch wraps it)
// and carries the reference's scans around it into the card:
// src/repro/core/jaxpack.py pack_jax (NF/FF/BF/WF and their Decreasing
// variants) and modified_any_fit_jax (Algorithm 1: MWF/MBF/MWFP/MBFP).
//
// Selection (select_slot_warp), shared by both kernels: over a row's slots
// s < min(k, M), slot s fits iff load + w <= cap;
//   strategy 1 "first": the lowest fitting slot;
//   strategy 2 "best":  the fitting slot of highest load, ties to the lowest;
//   strategy 3 "worst": the fitting slot of lowest load, ties to the lowest.
// It returns M when nothing fits.  One warp runs it: lanes stride across
// the slots (each pass one coalesced 128-byte read), each lane keeps its
// best (load, slot), and a 5-round __shfl_xor_sync butterfly reduces the
// pairs, load first and then the lower slot.
//
// select_slot_kernel: one warp per (stream, instance) row of loads in
// device memory; -1 where active[r] == 0.  Bound: bytes (the loads plane).
//
// pack_rows_kernel: one warp per packing row, the row's whole state in
// dynamic shared memory (loads, names, used-name bitmask, bin_of and
// Algorithm 1's per-item flags, schedule and per-consumer bits), so one
// launch packs every row of a call.  What bounds it on the H100 is
// neither bytes nor operations: the item walk is serial within a row (each
// insert reads the state the previous one wrote), so a call costs the
// latency of n to 3n dependent inserts, each a selection and a few
// shared-memory updates.  Orders that do not depend on the walk (the
// decreasing traversal, consumer keys and ranks, the 2n-entry schedule)
// and the final stage's order (which depends on phase 2's deferrals) are
// stable pairwise ranks, n^2 / 32 compares a lane.
//
// Numerics are the plain version's (repro_torch.core.pack): loads add
// load + w in insertion order, the cumulative consumer key is summed in
// item index order, every compare is an f32 compare; __fadd_rn keeps
// nvcc from contracting an add (the build has no --use_fast_math).
#include <cuda_runtime.h>

namespace {

constexpr int kWarp = 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kSelectThreads = 256;
constexpr int kMaxRowsPerBlock = 8;
constexpr size_t kBlockSmemTarget = 48 * 1024;
constexpr size_t kMaxSmem = 232448;   // H100: dynamic shared memory a block

enum Strategy { kNext = 0, kFirst = 1, kBest = 2, kWorst = 3 };
// per-item flags of a packing row
enum Flag : unsigned char { kAct = 1, kAssigned = 2, kPlaced = 4, kToU = 8 };

// Is (la, sa) preferred to (lb, sb)?  A slot of m stands for "none".
__device__ __forceinline__ bool better(float la, int sa, float lb, int sb,
                                       int strategy, int m) {
  if (sa >= m) return false;
  if (sb >= m) return true;
  if (strategy == kBest && la != lb) return la > lb;
  if (strategy == kWorst && la != lb) return la < lb;
  return sa < sb;
}

// The fit selection over one row's slots [0, min(k, m)), by a whole warp
// (every lane calls it with the same arguments); every lane returns the
// chosen slot, or m when nothing fits.  `loads` may lie in device or in
// shared memory.
__device__ int select_slot_warp(const float* loads, int k, int m, float w,
                                float cap, int strategy, int lane) {
  const int lim = k < m ? k : m;
  float bl = 0.0f;
  int bs = m;
  for (int base = 0; base < lim; base += kWarp) {
    const int s = base + lane;
    if (s < lim) {
      const float ls = loads[s];
      if (__fadd_rn(ls, w) <= cap && better(ls, s, bl, bs, strategy, m)) {
        bl = ls;
        bs = s;
      }
    }
    // first fit: a pass that found a slot holds the lowest one
    if (strategy == kFirst && __any_sync(kFull, bs < m)) break;
  }
  for (int d = kWarp / 2; d > 0; d >>= 1) {
    const float ol = __shfl_xor_sync(kFull, bl, d);
    const int os = __shfl_xor_sync(kFull, bs, d);
    if (better(ol, os, bl, bs, strategy, m)) {
      bl = ol;
      bs = os;
    }
  }
  return bs;
}

__global__ void select_slot_kernel(const float* __restrict__ loads,
                                   const float* __restrict__ w,
                                   const int* __restrict__ k,
                                   const float* __restrict__ cap,
                                   const int* __restrict__ active,
                                   int* __restrict__ out, long long rows,
                                   int m, int strategy) {
  const long long r = static_cast<long long>(blockIdx.x) *
                          (blockDim.x / kWarp) + threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  if (r >= rows) return;                       // the whole warp
  if (active != nullptr && active[r] <= 0) {
    if (lane == 0) out[r] = -1;
    return;
  }
  const int s = select_slot_warp(loads + r * m, k[r], m, w[r], cap[r],
                                 strategy, lane);
  if (lane == 0) out[r] = s;
}

// ---------------------------------------------------------------------------
// the packing kernel
// ---------------------------------------------------------------------------

__host__ __device__ inline int name_words(int n) { return (2 * n + 2 + 31) / 32; }

// Shared-memory bytes of one row (repro_torch.kernels.binpack_select.
// pack_row_bytes mirrors it): 14n + 4 words of per-item, per-slot and
// per-consumer arrays, three name bitmasks, n flag bytes, rounded up to 16.
__host__ __device__ inline size_t pack_row_bytes(int n) {
  const size_t b = 4 * (14 * static_cast<size_t>(n) + 4 + 3 * name_words(n)) +
                   static_cast<size_t>(n);
  return (b + 15) / 16 * 16;
}

struct Row {
  float* sp;          // [n]     speeds
  int* pv;            // [n]     previous name, -1 if none or out of range
  int* bin_of;        // [n]
  float* key;         // [n]     Algorithm 1: the key of the item's consumer
  int* uord;          // [n]     Algorithm 1: the final stage's tie key
  int* order;         // [n]     traversal order / the final stage's order
  int* sched;         // [2n]    Algorithm 1: 2 * item + phase per entry
  float* loads;       // [2n+1]  per creation slot
  int* names;         // [2n+1]
  int* own_slot;      // [2n+2]  Algorithm 1: each consumer's own bin
  unsigned* used;     // name bitmask (bits past 2n+2 set)
  unsigned* fail1;    // Algorithm 1: consumers whose phase 1 failed
  unsigned* own_fail; // Algorithm 1: consumers whose own bin refused
  unsigned char* flags;  // [n]
};

__device__ Row carve(unsigned char* base, int n) {
  Row r;
  const int m = 2 * n + 1;
  const int w = name_words(n);
  float* f = reinterpret_cast<float*>(base);
  r.sp = f;
  r.pv = reinterpret_cast<int*>(f + n);
  r.bin_of = r.pv + n;
  r.key = reinterpret_cast<float*>(r.bin_of + n);
  r.uord = reinterpret_cast<int*>(r.key + n);
  r.order = r.uord + n;
  r.sched = r.order + n;
  r.loads = reinterpret_cast<float*>(r.sched + 2 * n);
  r.names = reinterpret_cast<int*>(r.loads + m);
  r.own_slot = r.names + m;
  r.used = reinterpret_cast<unsigned*>(r.own_slot + 2 * n + 2);
  r.fail1 = r.used + w;
  r.own_fail = r.fail1 + w;
  r.flags = reinterpret_cast<unsigned char*>(r.own_fail + w);
  return r;
}

__device__ __forceinline__ bool get_bit(const unsigned* b, int i) {
  return (b[i >> 5] >> (i & 31)) & 1u;
}

__device__ __forceinline__ void set_bit(unsigned* b, int i) {
  b[i >> 5] |= 1u << (i & 31);
}

// The lowest clear bit of a bitmask of `words` words, by a whole warp: a
// ballot over 32 words a pass, then __ffs of the first word with a clear
// bit.
__device__ int lowest_clear(const unsigned* bits, int words, int lane) {
  for (int base = 0; base < words; base += kWarp) {
    const int wd = base + lane;
    const unsigned clear = wd < words ? ~bits[wd] : 0u;
    const unsigned any = __ballot_sync(kFull, clear != 0u);
    if (any != 0u) {
      const int src = __ffs(any) - 1;
      const unsigned c = __shfl_sync(kFull, clear, src);
      return (base + src) * 32 + __ffs(c) - 1;
    }
  }
  return words * 32;    // unreachable: fewer names are in use than exist
}

__device__ __forceinline__ int warp_sum(int v) {
  for (int d = kWarp / 2; d > 0; d >>= 1) v += __shfl_xor_sync(kFull, v, d);
  return v;
}

// Any-fit insert of item j (core/pack.py _place_or_create): the selected
// open bin, else a new bin named by the Sec. IV-C rule -- the previous
// name if in range and unused, else the lowest unused name.
__device__ void place_or_create(const Row& r, int& k, int m, int words,
                                int j, float w, int prev_name, int strategy,
                                float cap, int lane) {
  int slot;
  bool found;
  if (strategy == kNext) {
    found = k > 0 && __fadd_rn(r.loads[k - 1], w) <= cap;
    slot = found ? k - 1 : k;
  } else {
    const int sel = select_slot_warp(r.loads, k, m, w, cap, strategy, lane);
    found = sel < m;
    slot = found ? sel : k;
  }
  int name;
  if (found) {
    name = r.names[slot];
  } else if (prev_name >= 0 && !get_bit(r.used, prev_name)) {
    name = prev_name;
  } else {
    name = lowest_clear(r.used, words, lane);
  }
  __syncwarp();            // every lane has read the state lane 0 rewrites
  if (lane == 0) {
    r.loads[slot] = __fadd_rn(r.loads[slot], w);
    r.names[slot] = name;
    set_bit(r.used, name);
    r.bin_of[j] = name;
  }
  __syncwarp();
  k += found ? 0 : 1;
}

// Stable non-increasing rank of item i among the items that pass `in`:
// the items of higher speed, and of equal speed and lower tie key `tie`.
template <typename In, typename Tie>
__device__ __forceinline__ int desc_rank(const Row& r, int n, int i, In in,
                                         Tie tie) {
  const float si = r.sp[i];
  int rank = 0;
  for (int j = 0; j < n; ++j) {
    if (!in(j)) continue;
    const float sj = r.sp[j];
    rank += sj > si || (sj == si && tie(j) < tie(i));
  }
  return rank;
}

// Classical any-fit (pack_jax): traversal in index order, or in the
// stable non-increasing order of speeds; returns the bin count.
__device__ int any_fit_walk(const Row& r, int n, int strategy,
                            bool decreasing, bool sticky, float cap,
                            int lane) {
  const int m = n + 1;
  const int words = name_words(n);
  for (int i = lane; i < n; i += kWarp) {
    const int at = decreasing
        ? desc_rank(r, n, i, [](int) { return true; },
                    [](int j) { return j; })
        : i;
    r.order[at] = i;
  }
  __syncwarp();
  int k = 0;
  for (int t = 0; t < n; ++t) {
    const int j = r.order[t];
    if (!(r.flags[j] & kAct)) continue;   // an inactive item is absent
    place_or_create(r, k, m, words, j, r.sp[j], sticky ? r.pv[j] : -1,
                    strategy, cap, lane);
  }
  return k;
}

// Algorithm 1 (modified_any_fit_jax): a 2n-entry schedule (consumers in
// non-increasing key order; for each, phase 1 smallest to biggest into
// open bins, then phase 2 biggest to smallest into its own bin), then a
// decreasing any-fit over the deferred and unassigned items with sticky
// naming.  Returns the bin count.
__device__ int modified_walk(const Row& r, int n, int fit, bool cumulative,
                             float cap, int lane) {
  const int m = 2 * n + 1;
  const int dummy = 2 * n + 1;          // the unassigned items' segment
  const int words = name_words(n);
  for (int i = lane; i < n; i += kWarp) {
    const unsigned char f = r.flags[i];
    const bool assigned = (f & kAct) && r.pv[i] >= 0;
    const bool pending = (f & kAct) && !assigned;
    r.flags[i] = f | (assigned ? kAssigned : 0) | (pending ? kToU : 0);
    r.uord[i] = assigned ? 3 * n : i;
  }
  __syncwarp();
  auto seg = [&](int j) {
    return (r.flags[j] & kAssigned) ? r.pv[j] : dummy;
  };
  // each item's consumer key: the sum (or the max, floored at 0) of its
  // consumer's speeds, in item index order
  for (int i = lane; i < n; i += kWarp) {
    const int ci = seg(i);
    float acc = 0.0f;
    for (int j = 0; j < n; ++j) {
      if (seg(j) != ci) continue;
      const float sj = r.sp[j];
      acc = cumulative ? __fadd_rn(acc, sj) : (sj > acc ? sj : acc);
    }
    r.key[i] = acc;
  }
  __syncwarp();
  // schedule: consumers rank by (key desc, consumer asc); item i's phase-1
  // entry sits at 2G + b1 and its phase-2 entry at 2G + cnt + b2, where G
  // counts the items of earlier consumers, cnt its consumer's items and
  // b1 / b2 the items before it in phase 1 (speed asc, index desc) and
  // phase 2 (speed desc, index asc)
  for (int i = lane; i < n; i += kWarp) {
    const int ci = seg(i);
    const float ki = r.key[i], si = r.sp[i];
    int g = 0, cnt = 0, b1 = 0, b2 = 0;
    for (int j = 0; j < n; ++j) {
      const int cj = seg(j);
      const float sj = r.sp[j];
      if (cj == ci) {
        ++cnt;
        b1 += sj < si || (sj == si && j > i);
        b2 += sj > si || (sj == si && j < i);
      } else {
        const float kj = r.key[j];
        g += kj > ki || (kj == ki && cj < ci);
      }
    }
    r.sched[2 * g + b1] = 2 * i;
    r.sched[2 * g + cnt + b2] = 2 * i + 1;
  }
  __syncwarp();

  int k = 0;
  for (int e = 0; e < 2 * n; ++e) {
    const int ent = r.sched[e];
    const int j = ent >> 1;
    const unsigned char f = r.flags[j];
    if (!(f & kAssigned) || (f & kPlaced)) continue;
    const int c = r.pv[j];
    const float w = r.sp[j];
    if ((ent & 1) == 0) {
      // phase 1: the open bins; a consumer stops at its first failure
      if (get_bit(r.fail1, c)) continue;
      const int sel = select_slot_warp(r.loads, k, m, w, cap, fit, lane);
      __syncwarp();
      if (lane == 0) {
        if (sel < m) {
          r.loads[sel] = __fadd_rn(r.loads[sel], w);
          r.bin_of[j] = r.names[sel];
          r.flags[j] = f | kPlaced;
        } else {
          set_bit(r.fail1, c);
        }
      }
      __syncwarp();
    } else {
      // phase 2: the consumer's own bin (named c), created on first use;
      // an item with w > C may hold its own empty bin
      const int own_c = r.own_slot[c];
      const bool create = own_c < 0;
      const int own = create ? k : own_c;
      const float lo = r.loads[own];
      const bool fits = (__fadd_rn(lo, w) <= cap || (lo == 0.0f && w > cap)) &&
                        !get_bit(r.own_fail, c);
      __syncwarp();
      if (lane == 0) {
        if (create) {
          r.names[own] = c;
          set_bit(r.used, c);
          r.own_slot[c] = own;
        }
        if (fits) {
          r.loads[own] = __fadd_rn(lo, w);
          r.bin_of[j] = c;
          r.flags[j] = f | kPlaced;
        } else {
          set_bit(r.own_fail, c);
          r.flags[j] = f | kToU;
          r.uord[j] = n + e;
        }
      }
      __syncwarp();
      k += create ? 1 : 0;
    }
  }

  // final stage: decreasing any-fit over U (speed desc, then the order
  // items joined U), sticky naming
  int n_u = 0;
  for (int i = lane; i < n; i += kWarp) {
    if (!(r.flags[i] & kToU)) continue;
    ++n_u;
    r.order[desc_rank(r, n, i, [&](int j) { return (r.flags[j] & kToU) != 0; },
                      [&](int j) { return r.uord[j]; })] = i;
  }
  n_u = warp_sum(n_u);
  __syncwarp();
  for (int t = 0; t < n_u; ++t) {
    const int j = r.order[t];
    place_or_create(r, k, m, words, j, r.sp[j], r.pv[j], fit, cap, lane);
  }
  return k;
}

__global__ void pack_rows_kernel(
    const float* __restrict__ speeds, const long long* __restrict__ prev,
    const unsigned char* __restrict__ active, long long* __restrict__ bin_of,
    float* __restrict__ loads, long long* __restrict__ names,
    long long* __restrict__ n_bins, int rows, int n, int modified,
    int strategy, int decreasing, int sticky, int cumulative, float cap) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int rows_here = blockDim.x / kWarp;
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  const long long row = static_cast<long long>(blockIdx.x) * rows_here + warp;
  if (row >= rows) return;                     // the whole warp
  const Row r = carve(smem + warp * pack_row_bytes(n), n);
  const int m = modified ? 2 * n + 1 : n + 1;
  const int u = 2 * n + 2;
  const int words = name_words(n);
  const long long in = row * n;
  for (int i = lane; i < n; i += kWarp) {
    r.sp[i] = speeds[in + i];
    const long long p = prev[in + i];
    r.pv[i] = p >= 0 && p < u ? static_cast<int>(p) : -1;
    r.flags[i] = active == nullptr || active[in + i] ? kAct : 0;
    r.bin_of[i] = -1;
  }
  for (int s = lane; s < m; s += kWarp) {
    r.loads[s] = 0.0f;
    r.names[s] = -1;
  }
  for (int s = lane; s < u; s += kWarp) r.own_slot[s] = -1;
  for (int wd = lane; wd < words; wd += kWarp) {
    const int past = u - wd * 32;              // bits of this word in range
    r.used[wd] = past >= 32 ? 0u : ~0u << past;
    r.fail1[wd] = 0u;
    r.own_fail[wd] = 0u;
  }
  __syncwarp();
  const int k = modified
      ? modified_walk(r, n, strategy, cumulative != 0, cap, lane)
      : any_fit_walk(r, n, strategy, decreasing != 0, sticky != 0, cap, lane);
  __syncwarp();
  for (int i = lane; i < n; i += kWarp) bin_of[in + i] = r.bin_of[i];
  const long long out = row * m;
  for (int s = lane; s < m; s += kWarp) {
    loads[out + s] = r.loads[s];
    names[out + s] = r.names[s];
  }
  if (lane == 0) n_bins[row] = k;
}

}  // namespace

extern "C" int select_slot_f32(const float* loads, const float* w,
                               const int* k, const float* cap,
                               const int* active, int* out, int b, int n,
                               int m, int strategy, cudaStream_t stream) {
  const long long rows = static_cast<long long>(b) * n;
  if (rows <= 0) return static_cast<int>(cudaGetLastError());
  const long long per_block = kSelectThreads / kWarp;
  const unsigned grid = static_cast<unsigned>((rows + per_block - 1) /
                                              per_block);
  select_slot_kernel<<<grid, kSelectThreads, 0, stream>>>(
      loads, w, k, cap, active, out, rows, m, strategy);
  return static_cast<int>(cudaGetLastError());
}

// One launch packs `rows` rows of n items: modified = 0 runs the classical
// any-fit (strategy 0-3, decreasing, sticky), modified = 1 Algorithm 1
// (strategy 2 or 3 is its fit, cumulative = 1 the cumulative consumer key,
// 0 the max-partition one).  Rows share blocks by their shared-memory
// bytes; a row wider than one block's shared memory is refused with
// cudaErrorInvalidValue (the wrapper raises before that).
extern "C" int pack_rows_f32(const float* speeds, const long long* prev,
                             const unsigned char* active, long long* bin_of,
                             float* loads, long long* names,
                             long long* n_bins, int rows, int n, int modified,
                             int strategy, int decreasing, int sticky,
                             int cumulative, float cap, cudaStream_t stream) {
  if (rows <= 0) return static_cast<int>(cudaGetLastError());
  const size_t row_bytes = pack_row_bytes(n);
  if (n < 0 || row_bytes > kMaxSmem) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  size_t per_block = kBlockSmemTarget / row_bytes;
  if (per_block > static_cast<size_t>(kMaxRowsPerBlock)) {
    per_block = kMaxRowsPerBlock;
  }
  if (per_block > static_cast<size_t>(rows)) per_block = rows;
  if (per_block < 1) per_block = 1;
  const size_t smem = per_block * row_bytes;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        pack_rows_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const unsigned grid = static_cast<unsigned>(
      (rows + per_block - 1) / per_block);
  pack_rows_kernel<<<grid, static_cast<unsigned>(per_block * kWarp), smem,
                     stream>>>(speeds, prev, active, bin_of, loads, names,
                               n_bins, rows, n, modified, strategy,
                               decreasing, sticky, cumulative, cap);
  return static_cast<int>(cudaGetLastError());
}
