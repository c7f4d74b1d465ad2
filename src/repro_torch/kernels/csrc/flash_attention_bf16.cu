// Causal or full GQA attention forward in bfloat16 on Hopper's tensor cores:
// wgmma for both products, K/V tiles by TMA into a ring of shared-memory
// stages fed by a producer warp, the online softmax in registers.
//
// Replaces the Pallas kernel src/repro/kernels/flash_attention.py
// (flash_attention_fwd over _flash_kernel) for bfloat16 inputs; float32
// inputs keep the CUDA-core kernel of flash_attention.cu, since no tensor-
// core type computes an f32 product in full f32 (TF32 keeps about three
// digits).  q (B, H, Sq, hd), k/v (B, KV, Skv, hd), H % KV == 0; q head h
// reads kv head h / (H / KV) by index (the grouped K/V are never copied).
// Per query row, over KV tiles:
//   s     = q . k (bf16 products, f32 sums) * hd^-0.5 in f32; -inf where
//           k_pos > q_pos when causal (absolute positions from 0, also when
//           Sq != Skv) or k_pos >= Skv
//   m'    = max(m, max_j s);  p = exp(s - m');  alpha = exp(m - m')
//   l     = l * alpha + sum_j p (f32);  acc = acc * alpha + bf16(p) . v
//   out   = acc / max(l, 1e-30)        (f32 division, written in bf16)
// p is rounded to bf16 only as the operand of p . v, as the reference
// model's attention does (p_.astype(q.dtype)); every sum stays f32.
// When the caller passes `lse` (f32, B x H x Sq; NULL under no_grad and
// in serving, which then store nothing more), each row also stores its
// logsumexp of s in natural-log units, (m * scale_log2 + log2 l) * ln 2,
// for the backward (flash_attention_bwd_bf16.cu), which multiplies it
// back by log2 e and takes its exponentials with exp2 as this kernel does.
//
// Bound on the H100: operations.  At the prefill's shapes (q [8, 32, 1024,
// 128] over 8 KV heads, causal) the two products are 4*B*H*Sq*Skv*hd/2
// FLOP, 69 GFLOP, against 989 TFLOP/s of dense bf16: only wgmma reaches
// that rate, and it needs its operands in shared memory in the swizzled
// layout it reads, arriving without the math warps spending instructions
// on loads.  The design:
//   * one block per (128 query rows, head, batch row): two consumer
//     warpgroups of 64 rows each and one producer warp (288 threads);
//     blocks walk the q tiles from the last one, so the longest causal
//     rows start first;
//   * the producer's lane 0 loads the Q tile once and K/V tiles of kBK
//     keys into a ring of kStages stages by TMA (3-D tensor maps (hd, S,
//     B*heads): a tile past S is zero-filled, never the next head's rows),
//     each stage guarded by a full and an empty mbarrier;
//   * S = Q K^T on wgmma with both operands K-major in shared memory; the
//     f32 accumulator, packed to bf16 pairs, is the register A operand of
//     O += P V (V MN-major, the descriptor's transpose bit), so P never
//     touches shared memory;
//   * the softmax runs on the accumulator fragment: row max and sum over
//     the four threads of a quad by shuffles, no block-wide barrier; tiles
//     strictly above a warpgroup's diagonal are skipped, and only tiles
//     that cross the diagonal or Skv mask element by element;
//   * tile sizes by head dim: kBK = 128 keys up to hd 128 (hd 128: Q 32 KB
//     plus two stages of K and V, 160 KB), 64 keys at hd 256 (192 KB).
//     Rows wider than 128 bytes are loaded as column blocks of 128 bytes;
//     the TMA swizzle follows the row width (128 B from hd 64, 64 B at hd
//     32, 32 B at hd 16) and the wgmma descriptors name the same mode.
// Later work: intra-warpgroup overlap of softmax and wgmma, a TMA store of
// the output, and persistent blocks.
#include <cmath>
#include <type_traits>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "hopper.cuh"
#include "tensor_map.cuh"

namespace {

using namespace hopper;

constexpr int kConsumers = 2;                  // warpgroups of 64 q rows
constexpr int kBQ = 64 * kConsumers;           // query rows per block
constexpr int kThreads = 128 * kConsumers + 32;  // + one producer warp
constexpr int kStages = 2;

template <int HD>
struct Tiles {
  static constexpr int kBK = HD <= 128 ? 128 : 64;   // keys per KV tile
  static constexpr int kRow = HD * 2;                // bytes per row
  static constexpr int kW = kRow < 128 ? kRow : 128;   // swizzle span
  static constexpr int kCB = kW / 2;                 // columns per block
  static constexpr int kNCB = HD / kCB;              // column blocks
  static constexpr uint32_t kSwz =
      kW == 128 ? kSwizzle128 : kW == 64 ? kSwizzle64 : kSwizzle32;
  static constexpr int kQBytes = kBQ * kRow;
  static constexpr int kKVBytes = kBK * kRow;        // one K or one V tile
  static constexpr int kK = kQBytes;                 // offsets from the base
  static constexpr int kV = kK + kStages * kKVBytes;
  static constexpr int kBar = kV + kStages * kKVBytes;
  static constexpr int kSmem = kBar + 64 + 1024;     // + base alignment
};

__device__ __forceinline__ float neg_inf() {
  return __int_as_float(0xff800000);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

template <int N>
__device__ __forceinline__ void wgmma_s(float (&d)[N / 2], uint64_t a,
                                        uint64_t b, int scale_d) {
  if constexpr (N == 128) wgmma_ss_n128(d, a, b, scale_d);
  else wgmma_ss_n64(d, a, b, scale_d);
}

template <int N>
__device__ __forceinline__ void wgmma_pv(float (&d)[N / 2],
                                         const uint32_t (&a)[4], uint64_t b) {
  if constexpr (N == 256) wgmma_rs_n256(d, a, b, 1);
  else if constexpr (N == 128) wgmma_rs_n128(d, a, b, 1);
  else if constexpr (N == 64) wgmma_rs_n64(d, a, b, 1);
  else if constexpr (N == 32) wgmma_rs_n32(d, a, b, 1);
  else wgmma_rs_n16(d, a, b, 1);
}

template <int HD>
__global__ void __launch_bounds__(kThreads, 1)
flash_attention_bf16_kernel(const __grid_constant__ CUtensorMap tm_q,
                            const __grid_constant__ CUtensorMap tm_k,
                            const __grid_constant__ CUtensorMap tm_v,
                            __nv_bfloat16* __restrict__ o,
                            float* __restrict__ lse, int H, int KV, int Sq,
                            int Skv, int causal, float scale_log2) {
  using T = Tiles<HD>;
  constexpr int kBK = T::kBK;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t s_q = base;
  const uint32_t s_k = base + T::kK;
  const uint32_t s_v = base + T::kV;
  const uint32_t q_bar = base + T::kBar;
  const uint32_t full = q_bar + 8;                 // [kStages]
  const uint32_t empty = full + 8 * kStages;       // [kStages]

  const int nq = (Sq + kBQ - 1) / kBQ;
  const int q0 = (nq - 1 - blockIdx.x) * kBQ;      // longest rows first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int bh = b * H + h;
  const int bkv = b * KV + h / (H / KV);
  const int kv_end = causal ? min(Skv, q0 + kBQ) : Skv;
  const int n_tiles = (kv_end + kBK - 1) / kBK;

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
      mbar_expect_tx(q_bar, T::kQBytes);
#pragma unroll
      for (int cb = 0; cb < T::kNCB; ++cb)
        tma_load_3d(s_q + cb * kBQ * T::kW, &tm_q, q_bar, cb * T::kCB, q0,
                    bh);
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % kStages;
        mbar_wait(empty + 8 * s, ((t / kStages) & 1) ^ 1);
        const uint32_t bar = full + 8 * s;
        mbar_expect_tx(bar, 2 * T::kKVBytes);
#pragma unroll
        for (int cb = 0; cb < T::kNCB; ++cb) {
          const uint32_t off = s * T::kKVBytes + cb * kBK * T::kW;
          tma_load_3d(s_k + off, &tm_k, bar, cb * T::kCB, t * kBK, bkv);
          tma_load_3d(s_v + off, &tm_v, bar, cb * T::kCB, t * kBK, bkv);
        }
      }
    }
    return;
  }

  // consumer warpgroup wg: query rows q0 + 64 wg .. + 63
  const int tid = threadIdx.x % 128;
  const int lane = tid % 32;
  const int qw = q0 + 64 * wg;                     // first row of the group
  const int r0 = qw + 16 * (tid / 32) + lane / 4;  // this thread's rows
  const int r1 = r0 + 8;
  const int cq = 2 * (lane % 4);                   // its column in a chunk
  const uint32_t sbo = 8 * T::kW;                  // 8-row group stride
  float acc[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) acc[i] = 0.0f;
  float m0 = neg_inf(), m1 = neg_inf(), l0 = 0.0f, l1 = 0.0f;

  mbar_wait(q_bar, 0);
  for (int t = 0; t < n_tiles; ++t) {
    const int s = t % kStages;
    const int k0 = t * kBK;
    mbar_wait(full + 8 * s, (t / kStages) & 1);
    if (qw < Sq && (!causal || k0 <= qw + 63)) {
      // S = Q K^T over hd in slices of 16
      float sc[kBK / 2];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        const uint32_t col = kk * 32;              // bytes into the row
        const uint32_t cb = col / T::kW, in = col % T::kW;
        const uint64_t da = wgmma_desc(
            s_q + cb * kBQ * T::kW + 64 * wg * T::kW + in, 16, sbo, T::kSwz);
        const uint64_t db = wgmma_desc(
            s_k + s * T::kKVBytes + cb * kBK * T::kW + in, 16, sbo, T::kSwz);
        wgmma_s<kBK>(sc, da, db, kk > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sc);

      if (k0 + kBK > Skv || (causal && k0 + kBK - 1 > qw)) {
#pragma unroll
        for (int i = 0; i < kBK / 2; ++i) {
          const int key = k0 + 8 * (i / 4) + cq + i % 2;
          const int row = i % 4 < 2 ? r0 : r1;
          if (key >= Skv || (causal && key > row)) sc[i] = neg_inf();
        }
      }

      // online softmax on the fragment: rows r0 (e < 2) and r1 (e >= 2)
      float x0 = m0, x1 = m1;
#pragma unroll
      for (int j = 0; j < kBK / 8; ++j) {
        x0 = fmaxf(x0, fmaxf(sc[4 * j], sc[4 * j + 1]));
        x1 = fmaxf(x1, fmaxf(sc[4 * j + 2], sc[4 * j + 3]));
      }
      x0 = fmaxf(x0, __shfl_xor_sync(~0u, x0, 1));
      x0 = fmaxf(x0, __shfl_xor_sync(~0u, x0, 2));
      x1 = fmaxf(x1, __shfl_xor_sync(~0u, x1, 1));
      x1 = fmaxf(x1, __shfl_xor_sync(~0u, x1, 2));
      // the subtrahend in log2 units (0 while a row has seen no key)
      const float b0 = x0 == neg_inf() ? 0.0f : x0 * scale_log2;
      const float b1 = x1 == neg_inf() ? 0.0f : x1 * scale_log2;
      const float alpha0 = exp2f(m0 * scale_log2 - b0);   // m = -inf: 0
      const float alpha1 = exp2f(m1 * scale_log2 - b1);
      m0 = x0;
      m1 = x1;
      float sum0 = 0.0f, sum1 = 0.0f;
#pragma unroll
      for (int j = 0; j < kBK / 8; ++j) {
        sc[4 * j] = exp2f(fmaf(sc[4 * j], scale_log2, -b0));
        sc[4 * j + 1] = exp2f(fmaf(sc[4 * j + 1], scale_log2, -b0));
        sc[4 * j + 2] = exp2f(fmaf(sc[4 * j + 2], scale_log2, -b1));
        sc[4 * j + 3] = exp2f(fmaf(sc[4 * j + 3], scale_log2, -b1));
        sum0 += sc[4 * j] + sc[4 * j + 1];
        sum1 += sc[4 * j + 2] + sc[4 * j + 3];
      }
      l0 = l0 * alpha0 + sum0;           // this thread's share of the row
      l1 = l1 * alpha1 + sum1;
#pragma unroll
      for (int j = 0; j < HD / 8; ++j) {
        acc[4 * j] *= alpha0;
        acc[4 * j + 1] *= alpha0;
        acc[4 * j + 2] *= alpha1;
        acc[4 * j + 3] *= alpha1;
      }

      // O += P V: P in bf16 registers, V in slices of 16 keys
      uint32_t p[kBK / 16][4];
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          p[kk][e] = pack_bf16(sc[8 * kk + 2 * e], sc[8 * kk + 2 * e + 1]);
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) {
        const uint64_t dv = wgmma_desc(
            s_v + s * T::kKVBytes + kk * 16 * T::kW, kBK * T::kW, sbo,
            T::kSwz);
        wgmma_pv<HD>(acc, p[kk], dv);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
    }
    mbar_arrive(empty + 8 * s);
  }

  // out = acc / max(l, 1e-30), the row sums completed over the quad
  l0 += __shfl_xor_sync(~0u, l0, 1);
  l0 += __shfl_xor_sync(~0u, l0, 2);
  l1 += __shfl_xor_sync(~0u, l1, 1);
  l1 += __shfl_xor_sync(~0u, l1, 2);
  l0 = fmaxf(l0, 1e-30f);
  l1 = fmaxf(l1, 1e-30f);
  if (lse != nullptr && lane % 4 == 0) {
    // the row's logsumexp of s * hd^-0.5, natural log: (m * scale_log2 +
    // log2 l) * ln 2, with m * scale_log2 the subtrahend the exponentials
    // above were taken against
    constexpr float kLn2 = 0.6931471805599453f;
    float* lb = lse + (long long)bh * Sq;
    if (r0 < Sq) lb[r0] = (m0 * scale_log2 + log2f(l0)) * kLn2;
    if (r1 < Sq) lb[r1] = (m1 * scale_log2 + log2f(l1)) * kLn2;
  }
  __nv_bfloat16* ob = o + (long long)bh * Sq * HD + cq;
#pragma unroll
  for (int j = 0; j < HD / 8; ++j) {
    if (r0 < Sq)
      *reinterpret_cast<__nv_bfloat162*>(ob + (long long)r0 * HD + 8 * j) =
          __floats2bfloat162_rn(acc[4 * j] / l0, acc[4 * j + 1] / l0);
    if (r1 < Sq)
      *reinterpret_cast<__nv_bfloat162*>(ob + (long long)r1 * HD + 8 * j) =
          __floats2bfloat162_rn(acc[4 * j + 2] / l1, acc[4 * j + 3] / l1);
  }
}

template <int HD>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           int B, int H, int KV, int Sq, int Skv, int causal,
           cudaStream_t stream) {
  using T = Tiles<HD>;
  CUtensorMap tm_q, tm_k, tm_v;
  if (!tensor_map::make_bf16(&tm_q, q, HD, Sq, B * H, T::kW, kBQ)
      || !tensor_map::make_bf16(&tm_k, k, HD, Skv, B * KV, T::kW, T::kBK)
      || !tensor_map::make_bf16(&tm_v, v, HD, Skv, B * KV, T::kW, T::kBK))
    return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = flash_attention_bf16_kernel<HD>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, T::kSmem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((Sq + kBQ - 1) / kBQ, H, B);
  const float scale_log2 = static_cast<float>(
      1.4426950408889634 / std::sqrt(static_cast<double>(HD)));
  kernel<<<grid, kThreads, T::kSmem, stream>>>(
      tm_q, tm_k, tm_v, static_cast<__nv_bfloat16*>(o), lse, H, KV, Sq, Skv,
      causal, scale_log2);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int flash_attention_bf16(const void* q, const void* k,
                                    const void* v, void* o, float* lse,
                                    int B, int H, int KV, int Sq, int Skv,
                                    int hd, int causal, cudaStream_t stream) {
  if (B <= 0 || H <= 0 || Sq <= 0) return static_cast<int>(cudaGetLastError());
  if (KV <= 0 || H % KV != 0 || Skv <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (hd) {
    case 16:
      return launch<16>(q, k, v, o, lse, B, H, KV, Sq, Skv, causal, stream);
    case 32:
      return launch<32>(q, k, v, o, lse, B, H, KV, Sq, Skv, causal, stream);
    case 64:
      return launch<64>(q, k, v, o, lse, B, H, KV, Sq, Skv, causal, stream);
    case 128:
      return launch<128>(q, k, v, o, lse, B, H, KV, Sq, Skv, causal, stream);
    case 256:
      return launch<256>(q, k, v, o, lse, B, H, KV, Sq, Skv, causal, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
