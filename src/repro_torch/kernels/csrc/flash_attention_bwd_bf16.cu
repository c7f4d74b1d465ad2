// Causal or full GQA attention backward (dQ, dK, dV) in bfloat16 on
// Hopper's tensor cores: every product on wgmma from bf16 tiles that a
// producer warp streams by TMA into an mbarrier-guarded ring, f32 sums.
//
// Replaces the backward of src/repro/kernels/ops.py's flash_attention
// (the custom_vjp at :29-60, whose _flash_bwd_rule recomputes through the
// jnp online softmax); the reference has no Pallas backward kernel.  q,
// o, do (B, H, Sq, hd); k, v (B, KV, Skv, hd), H % KV == 0; q head h reads
// kv head h / (H / KV) by index, so dk/dv (B, KV, Skv, hd) are summed over
// the G = H / KV query heads of each group and K/V are never repeated.
// lse (B, H, Sq) f32 is the forward's row logsumexp of S = Q K^T s, s =
// hd^-0.5, in natural-log units (flash_attention_bf16.cu writes it when
// asked); with the causal mask by absolute position (k_pos <= q_pos):
//   P   = exp(S - lse) = exp2(Q K^T * scale_log2 - lse * log2 e)
//   D   = rowsum(dO o O)
//   dV  = P^T dO;   dP = dO V^T;   dS = P o (dP - D)
//   dQ  = dS K s;   dK = dS^T Q s
// P and dS are f32 in registers and rounded to bf16 only as the operands
// of dV, dQ and dK, as SDPA's and FlashAttention-2's backwards round them;
// every sum is f32, and the outputs are rounded once to bf16.  Two
// kernels, deterministic (no atomics), launched in order on one stream:
//   * flash_bwd_dq_wgmma_kernel, one block per (128 query rows, head,
//     batch row): two consumer warpgroups of 64 rows and one producer
//     warp (288 threads).  The producer loads Q and dO once and streams K
//     and V tiles of 64 keys through a kStages-deep ring.  In the prologue
//     each warpgroup computes D for its rows from O and dO and writes D
//     and lse * log2 e to f32 scratch (rows padded to 64) for the next
//     kernel.  Per tile: S = Q K^T and dP = dO V^T on wgmma (both operands
//     K-major in shared memory), P and dS on the accumulator fragment, then
//     dQ += dS K with dS as the register A operand and K as MN-major B (the
//     descriptor's transpose bit): dS never touches shared memory;
//   * flash_bwd_dkv_wgmma_kernel, one block per (128 keys, kv head, batch
//     row), two consumer warpgroups of 64 keys and a producer warpgroup:
//     the block holds its K and V tiles and loops over the group's G query
//     heads and their q tiles of 64 rows, streamed by TMA with their lse
//     and D slices (bulk copies of the padded scratch).  Per tile: S^T = K
//     Q^T and dP^T = V dO^T on wgmma, P^T and dS^T in registers, then dV
//     += P^T dO and dK += dS^T Q with the register operand and dO, Q as
//     MN-major B.  dK and dV are summed over the whole group inside the
//     block.  A thread holds dK and dV (128 registers at hd 128) beside
//     S^T and dP^T (64): the producer is a whole warpgroup (384 threads)
//     that gives its registers to the consumers by setmaxnreg (232 a
//     consumer thread); with a producer warp (288 threads) ptxas capped a
//     thread at 168 registers and spilled 536 bytes of it.
// Seven products a causal tile pair (S twice, dP twice, dQ, dK, dV), all
// on the tensor cores.  Both kernels skip the tiles that the causal mask
// empties and mask element by element only the tiles that cross the
// diagonal, Sq or Skv; the longest causal rows (dq: the last q tiles) and
// columns (dkv: the first key blocks) are scheduled first: the block index
// that picks the tile varies slowest.
//
// Bound on the H100: operations.  Five products of the unmasked pairs (2 x
// B x H x pairs x hd FLOP each) against 989 TFLOP/s of dense bf16; the
// kernels do seven.  Head dims 64 and 128 (every model the port serves has
// 128): at 256 the dK and dV accumulators alone would take 256 registers
// a thread, and that route, like float32 (no tensor-core type keeps a full
// f32 product), stays on the CUDA-core kernels of flash_attention_bwd.cu.
// Later work: overlap of one tile's products with the next tile's
// elementwise work within a warpgroup, deeper rings, and persistent blocks.
#include <cmath>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "hopper.cuh"
#include "tensor_map.cuh"

namespace {

using namespace hopper;

constexpr int kConsumers = 2;                     // warpgroups of 64 rows
constexpr int kRows = 64 * kConsumers;            // a block's q rows / keys
constexpr int kThreads = 128 * kConsumers + 32;   // dq: + a producer warp
// dkv: + a producer warpgroup, so that setmaxnreg can move its registers
// to the consumers (launch bounds of 384 threads allow 168 a thread)
constexpr int kThreadsKv = 128 * (kConsumers + 1);
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;
constexpr int kTile = 64;                         // streamed tile rows
constexpr int kStages = 2;
constexpr int kW = 128;                           // swizzle span, bytes
constexpr int kCB = kW / 2;                       // columns a column block
constexpr uint32_t kSbo = 8 * kW;                 // 8-row group stride
constexpr float kLog2e = 1.4426950408889634f;

template <int HD>
struct Layout {
  static_assert(HD == 64 || HD == 128, "head dims 64 and 128");
  static constexpr int kNCB = HD / kCB;           // column blocks a row
  static constexpr int kBig = kRows * HD * 2;     // a 128-row tile, bytes
  static constexpr int kSmall = kTile * HD * 2;   // a 64-row tile, bytes
  // dq kernel: Q, dO; K, V stages; D and lse2 of the block's rows
  static constexpr int kDqK = 2 * kBig;
  static constexpr int kDqV = kDqK + kStages * kSmall;
  static constexpr int kDqVec = kDqV + kStages * kSmall;
  static constexpr int kDqBar = kDqVec + 2 * kRows * 4;
  static constexpr int kDqSmem = kDqBar + 64 + 1024;   // + base alignment
  // dkv kernel: K, V; Q, dO, lse2 and D stages
  static constexpr int kKvQ = 2 * kBig;
  static constexpr int kKvDo = kKvQ + kStages * kSmall;
  static constexpr int kKvLse = kKvDo + kStages * kSmall;
  static constexpr int kKvD = kKvLse + kStages * kTile * 4;
  static constexpr int kKvBar = kKvD + kStages * kTile * 4;
  static constexpr int kKvSmem = kKvBar + 64 + 1024;
};

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// K-major operand: rows row0 .. of a tile of `rows` rows stored as column
// blocks of [rows][128 B], the kk-th slice of 16 columns
__device__ __forceinline__ uint64_t kmajor(uint32_t tile, int rows, int row0,
                                           int kk) {
  const int col = kk * 32;                        // bytes into the row
  return wgmma_desc(tile + (col / kW) * rows * kW + row0 * kW + col % kW, 16,
                    kSbo, kSwizzle128);
}

// MN-major B operand: rows 16 kk .. 16 kk + 15 of a tile of `rows` rows
// (the reduction runs over rows), every column
__device__ __forceinline__ uint64_t mnmajor(uint32_t tile, int rows, int kk) {
  return wgmma_desc(tile + kk * 16 * kW, rows * kW, kSbo, kSwizzle128);
}

// d (64 x 64) = A (64 rows of a K-major tile) . B (a K-major kTile-row
// tile)^T over HD
template <int HD>
__device__ __forceinline__ void product_abt(float (&d)[32], uint32_t a,
                                            int a_rows, int a_row0,
                                            uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk)
    wgmma_ss_n64(d, kmajor(a, a_rows, a_row0, kk), kmajor(b, kTile, 0, kk),
                 kk > 0);
}

// d (64 x HD) += A (registers, 64 x 64 in slices of 16) . B (an MN-major
// kTile-row tile)
template <int HD>
__device__ __forceinline__ void product_ab(float (&d)[HD / 2],
                                           const uint32_t (&a)[4][4],
                                           uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint64_t db = mnmajor(b, kTile, kk);
    if constexpr (HD == 128) wgmma_rs_n128(d, a[kk], db, 1);
    else wgmma_rs_n64(d, a[kk], db, 1);
  }
}

__device__ __forceinline__ float dot8(uint4 a, uint4 b, float acc) {
  const __nv_bfloat162* x = reinterpret_cast<const __nv_bfloat162*>(&a);
  const __nv_bfloat162* y = reinterpret_cast<const __nv_bfloat162*>(&b);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 fx = __bfloat1622float2(x[i]);
    const float2 fy = __bfloat1622float2(y[i]);
    acc = fmaf(fx.x, fy.x, acc);
    acc = fmaf(fx.y, fy.y, acc);
  }
  return acc;
}

template <int HD>
__device__ __forceinline__ void store_rows(__nv_bfloat16* base, int r0,
                                           int rows, int cq,
                                           const float (&acc)[HD / 2],
                                           float scale) {
  // acc[4 j + e]: row r0 + 8 (e / 2), column 8 j + cq + e % 2
#pragma unroll
  for (int j = 0; j < HD / 8; ++j) {
    if (r0 < rows)
      *reinterpret_cast<__nv_bfloat162*>(base + (long long)r0 * HD + 8 * j
                                         + cq) =
          __floats2bfloat162_rn(acc[4 * j] * scale, acc[4 * j + 1] * scale);
    if (r0 + 8 < rows)
      *reinterpret_cast<__nv_bfloat162*>(base + (long long)(r0 + 8) * HD
                                         + 8 * j + cq) =
          __floats2bfloat162_rn(acc[4 * j + 2] * scale,
                                acc[4 * j + 3] * scale);
  }
}

template <int HD>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                          const __grid_constant__ CUtensorMap tm_do,
                          const __grid_constant__ CUtensorMap tm_k,
                          const __grid_constant__ CUtensorMap tm_v,
                          const __nv_bfloat16* __restrict__ o,
                          const __nv_bfloat16* __restrict__ dout,
                          const float* __restrict__ lse,
                          __nv_bfloat16* __restrict__ dq,
                          float* __restrict__ lse2_out,
                          float* __restrict__ d_out, int H, int KV, int Sq,
                          int Skv, int sq_pad, int causal, float scale,
                          float scale_log2) {
  using L = Layout<HD>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  const uint32_t s_q = base;
  const uint32_t s_do = base + L::kBig;
  const uint32_t s_k = base + L::kDqK;
  const uint32_t s_v = base + L::kDqV;
  float* v_d = reinterpret_cast<float*>(smem_raw + (base - raw) + L::kDqVec);
  float* v_lse = v_d + kRows;
  const uint32_t q_bar = base + L::kDqBar;
  const uint32_t full = q_bar + 8;                 // [kStages]
  const uint32_t empty = full + 8 * kStages;       // [kStages]

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int bkv = b * KV + (bh % H) / (H / KV);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kRows;  // longest first
  const int kv_end = causal ? min(Skv, q0 + kRows) : Skv;
  const int n_tiles = (kv_end + kTile - 1) / kTile;

  if (threadIdx.x == 0) {
    mbar_init(q_bar, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 128 * kConsumers);
    }
    mbar_init_fence();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == kConsumers) {
    // producer warp: lane 0 starts every load
    if (threadIdx.x % 32 == 0) {
      tma_prefetch_map(&tm_k);
      tma_prefetch_map(&tm_v);
      mbar_expect_tx(q_bar, 2 * L::kBig);
#pragma unroll
      for (int cb = 0; cb < L::kNCB; ++cb) {
        tma_load_3d(s_q + cb * kRows * kW, &tm_q, q_bar, cb * kCB, q0, bh);
        tma_load_3d(s_do + cb * kRows * kW, &tm_do, q_bar, cb * kCB, q0, bh);
      }
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % kStages;
        mbar_wait(empty + 8 * s, ((t / kStages) & 1) ^ 1);
        const uint32_t bar = full + 8 * s;
        mbar_expect_tx(bar, 2 * L::kSmall);
#pragma unroll
        for (int cb = 0; cb < L::kNCB; ++cb) {
          const uint32_t off = s * L::kSmall + cb * kTile * kW;
          tma_load_3d(s_k + off, &tm_k, bar, cb * kCB, t * kTile, bkv);
          tma_load_3d(s_v + off, &tm_v, bar, cb * kCB, t * kTile, bkv);
        }
      }
    }
    return;
  }

  // consumer warpgroup wg: query rows q0 + 64 wg .. + 63
  const int tid = threadIdx.x % 128;
  const int lane = tid % 32;
  const int qw = q0 + 64 * wg;
  {
    // D = rowsum(dO o O) and lse in log2 units, two threads a row; rows
    // past Sq (up to the 64-row padding) get zeros
    const int rl = 64 * wg + tid / 2;
    const int r = q0 + rl;
    float part = 0.0f;
    if (r < Sq) {
      const long long off =
          ((long long)bh * Sq + r) * HD + (tid % 2) * (HD / 2);
      const uint4* op = reinterpret_cast<const uint4*>(o + off);
      const uint4* dp = reinterpret_cast<const uint4*>(dout + off);
#pragma unroll
      for (int i = 0; i < HD / 16; ++i) part = dot8(op[i], dp[i], part);
    }
    part += __shfl_xor_sync(~0u, part, 1);
    if (tid % 2 == 0) {
      const float l2 = r < Sq ? lse[(long long)bh * Sq + r] * kLog2e : 0.0f;
      v_d[rl] = part;
      v_lse[rl] = l2;
      if (r < sq_pad) {
        d_out[(long long)bh * sq_pad + r] = part;
        lse2_out[(long long)bh * sq_pad + r] = l2;
      }
    }
    named_sync(1 + wg, 128);
  }
  const int rl0 = 64 * wg + 16 * (tid / 32) + lane / 4;
  const int r0 = q0 + rl0;                         // this thread's rows
  const int r1 = r0 + 8;
  const float d0 = v_d[rl0], d1 = v_d[rl0 + 8];
  const float l0 = v_lse[rl0], l1 = v_lse[rl0 + 8];
  const int cq = 2 * (lane % 4);                   // its column in a chunk
  float acc[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) acc[i] = 0.0f;

  mbar_wait(q_bar, 0);
  for (int t = 0; t < n_tiles; ++t) {
    const int s = t % kStages;
    const int k0 = t * kTile;
    mbar_wait(full + 8 * s, (t / kStages) & 1);
    if (qw < Sq && (!causal || k0 <= qw + 63)) {
      const uint32_t sk = s_k + s * L::kSmall;
      const uint32_t sv = s_v + s * L::kSmall;
      float sc[32], dp[32];
      wgmma_fence();
      product_abt<HD>(sc, s_q, kRows, 64 * wg, sk);
      wgmma_commit();
      product_abt<HD>(dp, s_do, kRows, 64 * wg, sv);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sc);
      fence_regs(dp);

      // sc[i]: row r0 (i % 4 < 2) or r1, key k0 + 8 (i / 4) + cq + i % 2
      const bool edge = k0 + kTile > Skv || (causal && k0 + kTile - 1 > qw);
      uint32_t ds[4][4];
#pragma unroll
      for (int i = 0; i < 32; i += 2) {
        const bool lo = i % 4 < 2;
        const float lr = lo ? l0 : l1;
        const float dr = lo ? d0 : d1;
        float p0 = exp2f(fmaf(sc[i], scale_log2, -lr));
        float p1 = exp2f(fmaf(sc[i + 1], scale_log2, -lr));
        if (edge) {
          const int row = lo ? r0 : r1;
          const int key = k0 + 8 * (i / 4) + cq;
          if (key >= Skv || (causal && key > row)) p0 = 0.0f;
          if (key + 1 >= Skv || (causal && key + 1 > row)) p1 = 0.0f;
        }
        ds[i / 8][(i % 8) / 2] =
            pack_bf16(p0 * (dp[i] - dr), p1 * (dp[i + 1] - dr));
      }
      fence_regs(acc);
      wgmma_fence();
      product_ab<HD>(acc, ds, sk);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
    }
    mbar_arrive(empty + 8 * s);
  }
  store_rows<HD>(dq + (long long)bh * Sq * HD, r0, Sq, cq, acc, scale);
}

template <int HD>
__global__ void __launch_bounds__(kThreadsKv, 1)
flash_bwd_dkv_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                           const __grid_constant__ CUtensorMap tm_do,
                           const __grid_constant__ CUtensorMap tm_k,
                           const __grid_constant__ CUtensorMap tm_v,
                           const float* __restrict__ lse2,
                           const float* __restrict__ dd,
                           __nv_bfloat16* __restrict__ dk,
                           __nv_bfloat16* __restrict__ dv, int H, int KV,
                           int Sq, int Skv, int sq_pad, int causal,
                           float scale, float scale_log2) {
  using L = Layout<HD>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  const uint32_t s_k = base;
  const uint32_t s_v = base + L::kBig;
  const uint32_t s_q = base + L::kKvQ;
  const uint32_t s_do = base + L::kKvDo;
  const uint32_t s_lse = base + L::kKvLse;
  const uint32_t s_dd = base + L::kKvD;
  const float* v_lse =
      reinterpret_cast<const float*>(smem_raw + (base - raw) + L::kKvLse);
  const float* v_dd =
      reinterpret_cast<const float*>(smem_raw + (base - raw) + L::kKvD);
  const uint32_t kv_bar = base + L::kKvBar;
  const uint32_t full = kv_bar + 8;                // [kStages]
  const uint32_t empty = full + 8 * kStages;       // [kStages]

  const int bkv = blockIdx.x;
  const int b = bkv / KV;
  const int G = H / KV;
  const int h0 = b * H + (bkv % KV) * G;           // the group's first head
  const int k0 = blockIdx.y * kRows;               // longest columns first
  // causal: q rows below the block's first key see none of it
  const int q_begin = causal ? k0 : 0;
  const int n_qt = q_begin < Sq ? (Sq - q_begin + kTile - 1) / kTile : 0;
  const int n_tiles = G * n_qt;

  if (threadIdx.x == 0) {
    mbar_init(kv_bar, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 128 * kConsumers);
    }
    mbar_init_fence();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == kConsumers) {
    // producer warpgroup: its thread 0 starts every load
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == 128 * kConsumers) {
      tma_prefetch_map(&tm_q);
      tma_prefetch_map(&tm_do);
      mbar_expect_tx(kv_bar, 2 * L::kBig);
#pragma unroll
      for (int cb = 0; cb < L::kNCB; ++cb) {
        tma_load_3d(s_k + cb * kRows * kW, &tm_k, kv_bar, cb * kCB, k0, bkv);
        tma_load_3d(s_v + cb * kRows * kW, &tm_v, kv_bar, cb * kCB, k0, bkv);
      }
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % kStages;
        const int bh = h0 + t / n_qt;
        const int q0 = q_begin + (t % n_qt) * kTile;
        mbar_wait(empty + 8 * s, ((t / kStages) & 1) ^ 1);
        const uint32_t bar = full + 8 * s;
        mbar_expect_tx(bar, 2 * L::kSmall + 2 * kTile * 4);
#pragma unroll
        for (int cb = 0; cb < L::kNCB; ++cb) {
          const uint32_t off = s * L::kSmall + cb * kTile * kW;
          tma_load_3d(s_q + off, &tm_q, bar, cb * kCB, q0, bh);
          tma_load_3d(s_do + off, &tm_do, bar, cb * kCB, q0, bh);
        }
        const long long vo = (long long)bh * sq_pad + q0;
        bulk_load(s_lse + s * kTile * 4, lse2 + vo, kTile * 4, bar);
        bulk_load(s_dd + s * kTile * 4, dd + vo, kTile * 4, bar);
      }
    }
    return;
  }

  // consumer warpgroup wg: keys k0 + 64 wg .. + 63; dK and dV alone take
  // 128 registers a thread at hd 128
  setmaxnreg_inc<kConsumerRegs>();
  const int tid = threadIdx.x % 128;
  const int lane = tid % 32;
  const int kw = k0 + 64 * wg;
  const int c0 = kw + 16 * (tid / 32) + lane / 4;  // this thread's keys
  const int cq = 2 * (lane % 4);
  float dka[HD / 2], dva[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) dka[i] = dva[i] = 0.0f;

  mbar_wait(kv_bar, 0);
  for (int t = 0; t < n_tiles; ++t) {
    const int s = t % kStages;
    const int q0 = q_begin + (t % n_qt) * kTile;
    mbar_wait(full + 8 * s, (t / kStages) & 1);
    if (kw < Skv && (!causal || q0 + kTile - 1 >= kw)) {
      const uint32_t sq = s_q + s * L::kSmall;
      const uint32_t sdo = s_do + s * L::kSmall;
      const float* lt = v_lse + s * kTile;
      const float* dt = v_dd + s * kTile;
      const bool edge = q0 + kTile > Sq || kw + 64 > Skv
                        || (causal && kw + 63 > q0);
      float st[32], dpt[32];
      wgmma_fence();
      product_abt<HD>(st, s_k, kRows, 64 * wg, sq);
      wgmma_commit();
      product_abt<HD>(dpt, s_v, kRows, 64 * wg, sdo);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(st);
      fence_regs(dpt);

      // st[i]: key c0 (i % 4 < 2) or c0 + 8, q row q0 + col + i % 2
      uint32_t pa[4][4], ds[4][4];
#pragma unroll
      for (int i = 0; i < 32; i += 2) {
        const int col = 8 * (i / 4) + cq;
        const float2 lv = *reinterpret_cast<const float2*>(lt + col);
        const float2 dv2 = *reinterpret_cast<const float2*>(dt + col);
        float p0 = exp2f(fmaf(st[i], scale_log2, -lv.x));
        float p1 = exp2f(fmaf(st[i + 1], scale_log2, -lv.y));
        if (edge) {
          const int key = i % 4 < 2 ? c0 : c0 + 8;
          const int row = q0 + col;
          if (key >= Skv || row >= Sq || (causal && key > row)) p0 = 0.0f;
          if (key >= Skv || row + 1 >= Sq || (causal && key > row + 1))
            p1 = 0.0f;
        }
        pa[i / 8][(i % 8) / 2] = pack_bf16(p0, p1);
        ds[i / 8][(i % 8) / 2] =
            pack_bf16(p0 * (dpt[i] - dv2.x), p1 * (dpt[i + 1] - dv2.y));
      }
      fence_regs(dva);
      fence_regs(dka);
      wgmma_fence();
      product_ab<HD>(dva, pa, sdo);
      product_ab<HD>(dka, ds, sq);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dva);
      fence_regs(dka);
    }
    mbar_arrive(empty + 8 * s);
  }
  const long long ko = ((long long)bkv * Skv) * HD;
  store_rows<HD>(dk + ko, c0, Skv, cq, dka, scale);
  store_rows<HD>(dv + ko, c0, Skv, cq, dva, 1.0f);
}

template <typename K>
cudaError_t allow_smem(K kernel, int smem) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
}

template <int HD>
int launch(const void* q, const void* k, const void* v, const void* o,
           const void* dout, const float* lse, void* dq, void* dk, void* dv,
           float* scratch, int B, int H, int KV, int Sq, int Skv, int causal,
           cudaStream_t stream) {
  using L = Layout<HD>;
  const int sq_pad = (Sq + kTile - 1) / kTile * kTile;
  float* lse2 = scratch;
  float* dd = scratch + (long long)B * H * sq_pad;
  // 128-row boxes for the tiles a block holds, 64-row boxes for the tiles
  // it streams
  CUtensorMap q_big, do_big, k_small, v_small, q_small, do_small, k_big,
      v_big;
  using tensor_map::make_bf16;
  if (!make_bf16(&q_big, q, HD, Sq, B * H, kW, kRows)
      || !make_bf16(&do_big, dout, HD, Sq, B * H, kW, kRows)
      || !make_bf16(&k_small, k, HD, Skv, B * KV, kW, kTile)
      || !make_bf16(&v_small, v, HD, Skv, B * KV, kW, kTile)
      || !make_bf16(&q_small, q, HD, Sq, B * H, kW, kTile)
      || !make_bf16(&do_small, dout, HD, Sq, B * H, kW, kTile)
      || !make_bf16(&k_big, k, HD, Skv, B * KV, kW, kRows)
      || !make_bf16(&v_big, v, HD, Skv, B * KV, kW, kRows))
    return static_cast<int>(cudaErrorInvalidValue);
  const double s = 1.0 / std::sqrt(static_cast<double>(HD));
  const float scale = static_cast<float>(s);
  const float scale_log2 = static_cast<float>(1.4426950408889634 * s);

  auto k1 = flash_bwd_dq_wgmma_kernel<HD>;
  cudaError_t e = allow_smem(k1, L::kDqSmem);
  if (e != cudaSuccess) return static_cast<int>(e);
  k1<<<dim3(B * H, (Sq + kRows - 1) / kRows), kThreads, L::kDqSmem,
       stream>>>(q_big, do_big, k_small, v_small,
                 static_cast<const __nv_bfloat16*>(o),
                 static_cast<const __nv_bfloat16*>(dout), lse,
                 static_cast<__nv_bfloat16*>(dq), lse2, dd, H, KV, Sq, Skv,
                 sq_pad, causal, scale, scale_log2);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);

  auto k2 = flash_bwd_dkv_wgmma_kernel<HD>;
  e = allow_smem(k2, L::kKvSmem);
  if (e != cudaSuccess) return static_cast<int>(e);
  k2<<<dim3(B * KV, (Skv + kRows - 1) / kRows), kThreadsKv, L::kKvSmem,
       stream>>>(q_small, do_small, k_big, v_big, lse2, dd,
                 static_cast<__nv_bfloat16*>(dk),
                 static_cast<__nv_bfloat16*>(dv), H, KV, Sq, Skv, sq_pad,
                 causal, scale, scale_log2);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// scratch: f32, 2 x B x H x round_up(Sq, 64) (lse in log2 units and D)
extern "C" int flash_attention_bwd_bf16_wgmma(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const float* lse, void* dq, void* dk, void* dv,
    float* scratch, int B, int H, int KV, int Sq, int Skv, int hd,
    int causal, cudaStream_t stream) {
  if (B <= 0 || H <= 0) return static_cast<int>(cudaGetLastError());
  if (KV <= 0 || H % KV != 0 || Skv <= 0 || Sq < 0
      || (hd != 64 && hd != 128))
    return static_cast<int>(cudaErrorInvalidValue);
  if (Sq == 0) {  // no query rows: no dq, and dk = dv = 0
    const size_t bytes = (size_t)B * KV * Skv * hd * 2;
    cudaError_t e = cudaMemsetAsync(dk, 0, bytes, stream);
    if (e == cudaSuccess) e = cudaMemsetAsync(dv, 0, bytes, stream);
    return static_cast<int>(e);
  }
  if (hd == 64)
    return launch<64>(q, k, v, o, dout, lse, dq, dk, dv, scratch, B, H, KV,
                      Sq, Skv, causal, stream);
  return launch<128>(q, k, v, o, dout, lse, dq, dk, dv, scratch, B, H, KV,
                     Sq, Skv, causal, stream);
}
