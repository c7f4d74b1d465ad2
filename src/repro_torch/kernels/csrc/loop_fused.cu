// The whole closed loop of the lag twin for the heuristic packers, every
// step in one launch.
//
// Replaces the Pallas megakernel src/repro/kernels/loop_fused.py:220
// (loop_fused_batch over _loop_fused_kernel / _one_step).  Each step of
// one (policy, stream) row:
//   1. traversal order: identity, or the stable non-increasing sort of the
//      Decreasing variants as a pairwise rank;
//   2. slot selection per item (next / first / best / worst fit, ties to
//      the lowest slot) with bin creation;
//   3. Sec. IV-C sticky renaming of creation slots to bin names, with the
//      2n+2 name universe in 32-bit masks (hence n <= 14);
//   4. migration downtime for every moved partition;
//   5. produce + proportional drain (the lag_update math, in slot space).
//
// Bound on the H100: at the lag twin's shapes (n = 14) the per-step
// select, rank and naming work outweighs the bytes moved (the rate slab
// and five per-step outputs), so the bound is operations on the 32-bit
// cores; a row's steps are serial, so what the card can hide is bounded
// by the rows it holds (one lane a row).  The design:
//  - n is a template parameter (1..14); every array over items or slots
//    is read and written at compile-time indices only (a runtime slot,
//    rank or creator becomes a select over them, a log-depth tree where a
//    chain of selects would be long), so each row's lag, previous
//    assignment, downtime, slot loads and slots live in registers (no
//    local memory).  The loops over items and slots are unrolled; the
//    walks over traversal positions and over creation slots run at a
//    runtime index, so that the code of all eight heuristics (one path,
//    branching only on the warp's strategy) stays small enough for the
//    instruction cache (unrolled, a block of mixed heuristics ran slower
//    than its slowest heuristic alone);
//  - a warp is one policy, its lanes 32 consecutive streams, so strategies
//    never diverge inside a warp; a block holds the warps of up to 8
//    policies over the same 32 streams;
//  - those streams' rate and mask slabs for the next kChunk steps come
//    into shared memory by TMA bulk copies (one a stream, issued by warp
//    0's lanes) through a two-stage mbarrier ring, so a slab is read from
//    HBM once for all the block's policies;
//  - each step's five outputs (and, recording, the assignment) wait in
//    shared memory for kChunk steps and leave as contiguous runs a row.
// Sums run in index order with the _rn intrinsics and no FMA, so the
// kernel equals the plain PyTorch version bit for bit.
#include <cstdint>
#include <cuda_runtime.h>

#include "hopper.cuh"

namespace {

constexpr int kMaxN = 14;
constexpr int kChunk = 16;          // steps a ring stage holds
constexpr int kStages = 2;
constexpr int kMaxWarps = 8;        // policies a block
constexpr int kBarBytes = 128;      // the ring's mbarriers, padded
constexpr float kTiny = 1e-30f;

enum Strategy { kNext = 0, kFirst = 1, kBest = 2, kWorst = 3 };

struct LoopArgs {
  const float* rates;        // [B] rows of T*N rates, `rs` floats apart
  const uint8_t* active;     // [B] rows of T*N flags, `rsm` bytes apart, or null
  const float* lag0;         // [B, N] or null
  const int* strat_of;       // [P]
  const int* dec_of;         // [P]
  float* tot;                // [P*B, T]
  float* mx;
  int* cons;
  int* migs;
  int* unread;
  int* asg;                  // [P*B, T, N] or null
  long long rs, rsm;         // row strides: rs * 4 and rsm multiples of 16
  int n_pol, b, t_steps;
  float capacity, cap_step, dt;
  int mig;
};

__host__ __device__ constexpr int round16(int x) { return (x + 15) & ~15; }

// Shared-memory layout of one block, for n items a row and `warps`
// policies: the ring (rates, then masks) after the barriers, then each
// warp's output buffers.  Row strides leave the lanes' rows 4 banks
// apart.
struct Layout {
  int r_stride;      // floats a stream's rate row in a stage
  int m_stride;      // bytes a stream's mask row in a stage
  int a_stride;      // bytes a lane's assignment buffer (odd words)
  int ring_r, ring_m, warp0, warp_bytes, total;

  __host__ __device__ Layout(int n, int warps, bool masked, bool record) {
    r_stride = kChunk * n + 4;
    m_stride = kChunk * n + 16;
    a_stride = ((kChunk * n + 3) / 4 | 1) * 4;
    ring_r = kBarBytes;
    ring_m = ring_r + kStages * 32 * r_stride * 4;
    warp0 = ring_m + (masked ? kStages * 32 * m_stride : 0);
    warp_bytes = 3 * 32 * (kChunk + 1) * 4 + (record ? 32 * a_stride : 0);
    total = warp0 + warps * warp_bytes;
  }
};

// a compile-time index, usable as an int in device code
template <int I>
struct Idx {
  __host__ __device__ constexpr operator int() const { return I; }
};

// f(I) for I = L .. R-1 (each a compile-time constant), reduced by
// `join` as a balanced tree: log-depth dependency chains instead of a
// chain through every index
template <int L, int R, typename F, typename J>
__device__ __forceinline__ auto tree(F f, J join) {
  if constexpr (R - L == 1) {
    return f(Idx<L>{});
  } else {
    constexpr int H = (L + R) / 2;
    return join(tree<L, H>(f, join), tree<H, R>(f, join));
  }
}

// a candidate slot of the best / worst fit selection: the lowest score,
// the lower slot on a tie; a slot that does not fit scores +inf
struct Pick {
  float score;
  int s;
};

template <int N>
struct Row {
  float lag[N];
  int prev[N];
  int down[N];
};

struct StepOut {
  float total, worst;
  int k, moved, unread;
};

// Up to 15 small values (0..63) of the slots, 6 bits each, 5 to a word:
// a slot's entry is read and written at a runtime slot index without an
// array (which the compiler would put in local memory).
struct Packed {
  unsigned w0 = 0u, w1 = 0u, w2 = 0u;

  __device__ __forceinline__ unsigned get(int s) const {
    const unsigned w = s < 5 ? w0 : s < 10 ? w1 : w2;
    return (w >> (6 * (s % 5))) & 63u;
  }
  // `v` into slot s, whose entry is 0
  __device__ __forceinline__ void put(int s, unsigned v) {
    const unsigned bits = v << (6 * (s % 5));
    w0 |= s < 5 ? bits : 0u;
    w1 |= s >= 5 && s < 10 ? bits : 0u;
    w2 |= s >= 10 ? bits : 0u;
  }
};

// One step of one row: `sp_src` the step's N rates, `act` its active
// bits; the row's state is updated, the new assignment written to
// `asg_dst` (when not null), the step's reductions returned.  The loops
// over traversal positions and over creation slots run at a runtime
// index; every array they touch is read and written through selects over
// compile-time indices (or packed words), so it stays in registers.
template <int N>
__device__ __forceinline__ StepOut one_step(Row<N>& st, const float* sp_src,
                                            unsigned act, int strategy,
                                            bool dec, float capacity,
                                            float cap_step, float dt, int mig,
                                            int8_t* asg_dst) {
  constexpr int M = N + 1;
  const float inf = __int_as_float(0x7f800000);
  const auto bor = [](unsigned x, unsigned y) { return x | y; };
  float sp[N];
#pragma unroll
  for (int i = 0; i < N; ++i) sp[i] = sp_src[i];

  // phase 1: each item's traversal position: identity, or (Decreasing)
  // the items that go first, larger or equal with a lower index (each
  // pair compared once, both ways)
  int rank[N];
#pragma unroll
  for (int i = 0; i < N; ++i) rank[i] = dec ? 0 : i;
  if (dec) {
#pragma unroll
    for (int i = 0; i < N; ++i) {
#pragma unroll
      for (int j = i + 1; j < N; ++j) {
        rank[i] += sp[i] < sp[j];
        rank[j] += sp[j] <= sp[i];
      }
    }
  }

  // phase 2: slot selection and bin creation, items in traversal order
  float loads[M];
  int slot_of[N];
  Packed creator_prev;   // previous name + 1 of each slot's creator (0: none)
#pragma unroll
  for (int s = 0; s < M; ++s) loads[s] = inf;
#pragma unroll
  for (int i = 0; i < N; ++i) slot_of[i] = -1;
  int k = 0;
  float lastload = 0.0f;
#pragma unroll 1
  for (int q = 0; q < N; ++q) {
    // the one item of rank q: every other term of the ORs is 0
    const float w = __uint_as_float(tree<0, N>([&](auto I) {
      return rank[I] == q ? __float_as_uint(sp[I]) : 0u;
    }, bor));
    const unsigned meta = tree<0, N>([&](auto I) {
      return rank[I] == q ? static_cast<unsigned>(st.prev[I] + 1)
                                | static_cast<unsigned>(I) << 8
                                | ((act >> I) & 1u) << 16
                          : 0u;
    }, bor);
    const int j = (meta >> 8) & 0xff;
    const bool a = (meta >> 16) & 1u;
    bool found;
    int slot;
    if (strategy == kNext) {
      found = k > 0 && lastload + w <= capacity;
      slot = found ? k - 1 : k;
    } else if (strategy == kFirst) {
      const unsigned fit = tree<0, M>([&](auto I) {
        return loads[I] + w <= capacity ? 1u << I : 0u;
      }, bor);
      found = fit != 0u;
      slot = found ? __ffs(fit) - 1 : k;
    } else {
      const float sgn = strategy == kBest ? -1.0f : 1.0f;
      const Pick pick = tree<0, M>(
          [&](auto I) {
            return Pick{loads[I] + w <= capacity ? sgn * loads[I] : inf, I};
          },
          [](const Pick& x, const Pick& y) {   // x holds the lower slots
            return y.score < x.score ? y : x;
          });
      found = pick.score != inf;
      slot = found ? pick.s : k;
    }
    // an inactive item leaves every state alone
#pragma unroll
    for (int s = 0; s < M; ++s) {
      loads[s] = (a && s == slot) ? (found ? loads[s] + w : w) : loads[s];
    }
#pragma unroll
    for (int i = 0; i < N; ++i) slot_of[i] = (a && i == j) ? slot : slot_of[i];
    if (a && !found) creator_prev.put(k, meta & 0xffu);
    lastload = !a ? lastload
               : found ? (slot == k - 1 ? lastload + w : lastload) : w;
    k += (a && !found) ? 1 : 0;
  }

  // phase 3: sticky naming over creation slots (name bitmasks)
  Packed name_of;   // name + 1 of each live slot
  unsigned claimed = 0u, seen = 0u;
  int q = 0;
#pragma unroll 1
  for (int s = 0; s < k; ++s) {
    const int v = static_cast<int>(creator_prev.get(s)) - 1;
    const unsigned vbit = 1u << (v > 0 ? v : 0);
    const bool cand = v >= 0 && (seen & vbit) == 0u;
    seen = v >= 0 ? (seen | vbit) : seen;
    const bool win = cand && v >= q;
    name_of.put(s, static_cast<unsigned>((win ? v : q) + 1));
    claimed = win ? (claimed | vbit) : claimed;
    const unsigned mask = claimed | ((1u << (q + 1)) - 1u);
    const unsigned low = ~mask & (mask + 1u);
    q = (!win || v == q) ? __popc(low - 1u) : q;
  }
  int new_assign[N];
#pragma unroll
  for (int i = 0; i < N; ++i) {
    new_assign[i] = slot_of[i] >= 0
                        ? static_cast<int>(name_of.get(slot_of[i])) - 1
                        : -1;
  }

  // phases 4-5: downtime, then produce + drain in slot space
  float avail[N];
  bool live_p[N];
  int moved_ct = 0, unread_ct = 0;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const bool ai = (act >> i) & 1u;
    const bool moved = st.prev[i] >= 0 && new_assign[i] >= 0 &&
                       new_assign[i] != st.prev[i];
    const int d = st.down[i] - 1;
    st.down[i] = moved ? mig : (d > 0 ? d : 0);
    moved_ct += moved;
    unread_ct += st.down[i] > 0 && ai;
    live_p[i] = st.down[i] == 0 && new_assign[i] >= 0 && slot_of[i] >= 0;
    // __fmul_rn: never contracted into an FMA with the lag add
    avail[i] = st.lag[i] + (ai ? __fmul_rn(sp[i], dt) : 0.0f);
  }
  float total = 0.0f, worst = 0.0f;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    // the sum over item i's bin, its live items added in index order: the
    // plain version's per-bin sum, bit for bit (an array of per-bin sums
    // read at slot_of[i] would be compiled into local memory)
    float pb = 0.0f;
#pragma unroll
    for (int j = 0; j < N; ++j) {
      pb = (live_p[j] && slot_of[j] == slot_of[i]) ? pb + avail[j] : pb;
    }
    const float frac = live_p[i] ? fminf(1.0f, cap_step / fmaxf(pb, kTiny))
                                 : 0.0f;
    float nl = fmaxf(avail[i] * (1.0f - frac), 0.0f);
    nl = ((act >> i) & 1u) ? nl : 0.0f;
    st.lag[i] = nl;
    st.prev[i] = new_assign[i];
    total += nl;
    worst = i == 0 ? nl : fmaxf(worst, nl);
    if (asg_dst != nullptr) asg_dst[i] = static_cast<int8_t>(new_assign[i]);
  }
  return StepOut{total, worst, k, moved_ct, unread_ct};
}

template <int N>
__global__ void __launch_bounds__(kMaxWarps * 32, 1)
    loop_fused_kernel(LoopArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  const int pol = blockIdx.y * warps + warp;
  const int live_warps = min(warps, a.n_pol - static_cast<int>(blockIdx.y) * warps);
  const int stream0 = blockIdx.x * 32;
  const int stream = stream0 + lane;
  const bool on = stream < a.b;
  const bool masked = a.active != nullptr;
  const bool record = a.asg != nullptr;
  const Layout lay(N, warps, masked, record);

  const uint32_t bars = hopper::smem_u32(smem);
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (kStages + s); };
  float* ring_r = reinterpret_cast<float*>(smem + lay.ring_r);
  uint8_t* ring_m = smem + lay.ring_m;
  unsigned char* mine = smem + lay.warp0 + warp * lay.warp_bytes;
  float* out_tot = reinterpret_cast<float*>(mine);        // [32][kChunk + 1]
  float* out_mx = out_tot + 32 * (kChunk + 1);
  int* out_int = reinterpret_cast<int*>(out_mx + 32 * (kChunk + 1));
  int8_t* out_asg = reinterpret_cast<int8_t*>(out_int + 32 * (kChunk + 1));

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      hopper::mbar_init(full(s), 32);
      hopper::mbar_init(empty(s), live_warps);
    }
    hopper::mbar_init_fence();
  }
  __syncthreads();
  if (pol >= a.n_pol) return;

  const int t_steps = a.t_steps;
  const int chunks = (t_steps + kChunk - 1) / kChunk;
  // warp 0's lane l brings stream l's slab of chunk ch into its stage
  auto issue = [&](int ch) {
    const int s = ch % kStages;
    const int t0 = ch * kChunk;
    const int steps = min(kChunk, t_steps - t0);
    if (!on) {
      hopper::mbar_arrive(full(s));
      return;
    }
    const uint32_t br = round16(steps * N * 4);
    const uint32_t bm = masked ? round16(steps * N) : 0;
    hopper::mbar_expect_tx(full(s), br + bm);
    hopper::bulk_load(
        hopper::smem_u32(ring_r + (s * 32 + lane) * lay.r_stride),
        a.rates + stream * a.rs + static_cast<long long>(t0) * N, br,
        full(s));
    if (masked) {
      hopper::bulk_load(
          hopper::smem_u32(ring_m + (s * 32 + lane) * lay.m_stride),
          a.active + stream * a.rsm + static_cast<long long>(t0) * N, bm,
          full(s));
    }
  };
  if (warp == 0) {
    for (int ch = 0; ch < kStages && ch < chunks; ++ch) issue(ch);
  }

  Row<N> st;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    st.lag[i] = (a.lag0 == nullptr || !on) ? 0.0f
                                           : a.lag0[stream * static_cast<long long>(N) + i];
    st.prev[i] = -1;
    st.down[i] = 0;
  }
  const int strategy = a.strat_of[pol];
  const bool dec = a.dec_of[pol] != 0;
  const long long row0 = static_cast<long long>(pol) * a.b + stream0;

  for (int ch = 0; ch < chunks; ++ch) {
    const int s = ch % kStages;
    const uint32_t parity = (ch / kStages) & 1;
    const int t0 = ch * kChunk;
    const int steps = min(kChunk, t_steps - t0);
    hopper::mbar_wait(full(s), parity);
    const float* rr = ring_r + (s * 32 + lane) * lay.r_stride;
    const uint8_t* mm = ring_m + (s * 32 + lane) * lay.m_stride;
    for (int j = 0; j < steps; ++j) {
      unsigned act = (1u << N) - 1u;
      if (masked) {
        act = 0u;
#pragma unroll
        for (int i = 0; i < N; ++i) act |= (mm[j * N + i] != 0 ? 1u : 0u) << i;
      }
      int8_t* asg_dst = record ? out_asg + lane * lay.a_stride + j * N
                               : nullptr;
      const StepOut o = one_step<N>(st, rr + j * N, act, strategy, dec,
                                    a.capacity, a.cap_step, a.dt, a.mig,
                                    asg_dst);
      out_tot[lane * (kChunk + 1) + j] = o.total;
      out_mx[lane * (kChunk + 1) + j] = o.worst;
      out_int[lane * (kChunk + 1) + j] = o.k | (o.moved << 8)
                                         | (o.unread << 16);
    }
    __syncwarp();
    if (lane == 0) hopper::mbar_arrive(empty(s));

    // the chunk's outputs: a contiguous run of `steps` a row
    for (int e = lane; e < 32 * steps; e += 32) {
      const int r = e / steps, j = e - r * steps;
      if (stream0 + r >= a.b) continue;
      const long long o = (row0 + r) * t_steps + t0 + j;
      const int packed = out_int[r * (kChunk + 1) + j];
      a.tot[o] = out_tot[r * (kChunk + 1) + j];
      a.mx[o] = out_mx[r * (kChunk + 1) + j];
      a.cons[o] = packed & 0xff;
      a.migs[o] = (packed >> 8) & 0xff;
      a.unread[o] = packed >> 16;
    }
    if (record) {
      for (int r = 0; r < 32 && stream0 + r < a.b; ++r) {
        int* dst = a.asg + ((row0 + r) * t_steps + t0) * N;
        const int8_t* src = out_asg + r * lay.a_stride;
        for (int e = lane; e < steps * N; e += 32) dst[e] = src[e];
      }
    }
    __syncwarp();
    if (warp == 0 && ch + kStages < chunks) {
      hopper::mbar_wait(empty(s), parity);   // every policy is done with it
      issue(ch + kStages);
    }
  }
}

template <int N>
int launch_n(const LoopArgs& a, cudaStream_t stream) {
  const int warps = a.n_pol < kMaxWarps ? a.n_pol : kMaxWarps;
  const Layout lay(N, warps, a.active != nullptr, a.asg != nullptr);
  if (lay.total > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        loop_fused_kernel<N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        lay.total);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid((a.b + 31) / 32, (a.n_pol + warps - 1) / warps);
  loop_fused_kernel<N><<<grid, warps * 32, lay.total, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <int N>
int dispatch(int n, const LoopArgs& a, cudaStream_t stream) {
  if constexpr (N > kMaxN) {
    return static_cast<int>(cudaErrorInvalidValue);
  } else {
    return n == N ? launch_n<N>(a, stream) : dispatch<N + 1>(n, a, stream);
  }
}

}  // namespace

extern "C" int loop_fused_f32(const float* rates, const uint8_t* active,
                              const float* lag0, const int* strat_of,
                              const int* dec_of, float* tot, float* mx,
                              int* cons, int* migs, int* unread, int* asg,
                              int n_pol, int b, int t_steps, int n, int rs,
                              int rsm, float capacity, float cap_step,
                              float dt, int mig, cudaStream_t stream) {
  if (n < 1 || n > kMaxN || rs % 4 != 0 || rsm % 16 != 0 ||
      rs < t_steps * n || (active != nullptr && rsm < t_steps * n)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n_pol <= 0 || b <= 0 || t_steps <= 0) {
    return static_cast<int>(cudaGetLastError());
  }
  const LoopArgs a{rates, active, lag0, strat_of, dec_of, tot, mx, cons,
                   migs, unread, asg, rs, rsm, n_pol, b, t_steps, capacity,
                   cap_step, dt, mig};
  return dispatch<1>(n, a, stream);
}
