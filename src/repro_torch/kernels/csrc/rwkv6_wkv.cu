// The RWKV-6 WKV recurrence: per (batch row, head), T sequential steps on an
// (hd, hd) float32 state, returning every step's output and the last state.
//
// Replaces the Pallas kernel src/repro/kernels/rwkv6_scan.py
// (rwkv6_wkv_fwd over _wkv_kernel).  r, k, v, w (B, T, H, hd), u (H, hd),
// s0 and s_last (B, H, hd, hd) indexed (k index i, v index j), out
// (B, T, H, hd), all float32.  Per step:
//   o_t[j]  = sum_i r_t[i] S[i][j] + a_t v_t[j], a_t = sum_i r_t[i] u[i] k_t[i]
//   S[i][j] = w_t[i] S[i][j] + k_t[i] v_t[j]
// which is o_t[j] = sum_i r_t[i] (S[i][j] + u[i] k_t[i] v_t[j]) with the
// bonus term factored out: three instructions a state element and step.
//
// Bound on the H100: bytes, at the prefill's T (5 f32 streams of hd a step
// and head against the 5 hd^2 + 5 hd operations the function needs there)
// and at T = 1 (the state read and written once).
//
// Design.  Columns of the state are independent; only r, k, w and u are
// shared by all of them.
// - Lanes: lane = g P + p holds the 4 neighbouring columns 4 g .. 4 g + 3
//   of its warp's NCW = 4 G of R = 8 rows (R = 4 at hd = 16), the runs of
//   4 rows 4 p + {0..3} and 4 P + 4 p + {0..3}: 32 state registers (16
//   at hd = 16), read and written once in float4 accesses coalesced
//   across the warp.  P = hd / R lanes share a column group.
// - Blocks: a head's columns go to C = 4 independent blocks (fewer where a
//   warp covers more than a quarter of them) of W warps, which re-read r,
//   k, w from L2 and read only their own v columns.  hd = 64: one warp a
//   block, B = 8, H = 40 is 1280 blocks, 9.7 an SM; hd = 128: 4 warps.
// - Sums: per step, lane p forms for each of its 4 columns the partial
//     q[j] = sum_i r[i] S[i][j] + (sum_i r[i] (u[i] k[i])) v[j]
//   over its rows i (in the order above, an FMA chain of R a column); the P
//   partials are summed as a pairwise tree in lane order by
//   __shfl_xor_sync: two halving exchanges leave each lane one column
//   (reduce-scatter), then log2(P / 4) butterflies; lanes p < 4 store
//   o_t for column 2 (p & 1) + (p >> 1 & 1), a coalesced store a step.
//   The chain a step is R FMAs and log2 P shuffles, and step t + 1 does
//   not wait on step t's sum.
// - Loads: the step rows of r, k, w (hd floats each) and of v (the
//   block's NC columns) come in tiles of KT = 8 steps through a ring of
//   NS = 3 stages in shared memory: thread 0 issues one bulk copy (TMA) a
//   step row and stream, at addresses uniform over the warp, completion
//   counted in bytes on the stage's mbarrier; tiles n + 1 and n + 2 are
//   in flight while tile n is consumed.
// - The state is read first (in flight while the ring is set up) and
//   written after the last step, each element by the lane that owns it,
//   so s_last may alias s0 (the in-place decode).  One layout serves the
//   prefill and T = 1.
// - Training's variant (CKPT, entry rwkv6_wkv_ckpt_f32) also writes the
//   state before every kBwdChunk<hd>-th step to ckpt (B, H, ceil(T /
//   chunk), hd, hd), the checkpoints the backward (rwkv6_wkv_bwd.cu)
//   sweeps from: each lane stores its state elements as they stand.  The
//   write is compiled in only there, so serving's kernel is unchanged.
#include <type_traits>

#include <cuda_runtime.h>

#include "hopper.cuh"
#include "rwkv6_chunk.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kKT = 8;       // steps a tile
constexpr int kNS = 3;       // ring stages

// R state rows a lane, P lanes a column group, G column groups (NCW
// columns) a warp, W warps (NC columns) a block, C blocks a (b, h), ROW
// floats a staged step
template <int HD>
struct Shape {
  static constexpr int R = HD >= 32 ? 8 : 4;
  static constexpr int P = HD / R;
  static constexpr int G = (32 / P < HD / 4) ? 32 / P : HD / 4;
  static constexpr int NCW = 4 * G;
  static constexpr int W = HD / NCW > 4 ? HD / NCW / 4 : 1;
  static constexpr int NC = W * NCW;
  static constexpr int C = HD / NC;
  static constexpr int ROW = 3 * HD + NC;
};

// row of the lane's i-th state row: runs of 4, 4 P apart, so the lanes of
// a column group read neighbouring float4s of a staged step row
template <int P>
__device__ __forceinline__ int row_of(int p, int i) {
  return 4 * p + 4 * P * (i >> 2) + (i & 3);
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

template <int HD, bool CKPT>
__global__ void __launch_bounds__(32 * Shape<HD>::W)
rwkv6_wkv_kernel(const float* __restrict__ r, const float* __restrict__ k,
                 const float* __restrict__ v, const float* __restrict__ w,
                 const float* __restrict__ u, const float* s0,
                 float* __restrict__ out, float* s_last,
                 float* __restrict__ ckpt, int T, int H) {
  using S = Shape<HD>;
  constexpr int P = S::P, G = S::G, NC = S::NC, C = S::C, ROW = S::ROW;
  constexpr int W = S::W, NCW = S::NCW, kR = S::R;
  static_assert(P >= 4, "the reduce-scatter needs 4 lanes a column group");
  __shared__ __align__(128) float ring[kNS * kKT * ROW];
  __shared__ __align__(8) unsigned long long bars[kNS];

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int cb = blockIdx.x % C;              // column block of this head
  const int h = blockIdx.x / C;
  const int b = blockIdx.y;
  const int p = lane % P;
  const bool live = lane / P < G;             // hd = 16 leaves lanes idle
  const int g = (lane / P) % G;
  const int cw = warp * NCW + 4 * g;          // the lane's columns in the block
  const int col = cb * NC + cw;               // ... in the head
  const long long step = static_cast<long long>(H) * HD;   // stride of t
  const long long bth0 = (static_cast<long long>(b) * T * H + h) * HD;

  // the lane's state block and bonus rows, read once, first: the loads are
  // in flight while the ring is set up and its first tiles requested
  const long long sbase = (static_cast<long long>(b) * H + h) * HD * HD + col;
  float4 st[kR];
  float uu[kR];
#pragma unroll
  for (int i = 0; i < kR; ++i) {
    st[i] = ld4(s0 + sbase + row_of<P>(p, i) * HD);
  }
#pragma unroll
  for (int i = 0; i < kR; i += 4) {
    const float4 q = ld4(u + h * HD + row_of<P>(p, i));
    uu[i] = q.x; uu[i + 1] = q.y; uu[i + 2] = q.z; uu[i + 3] = q.w;
  }
  auto full = [&](int s) { return hopper::smem_u32(&bars[s]); };
  if (threadIdx.x == 0) {
    for (int s = 0; s < kNS; ++s) hopper::mbar_init(full(s), 1);
    hopper::mbar_init_fence();
  }
  __syncthreads();
  const int tiles = (T + kKT - 1) / kKT;
  // tile n into stage n % kNS by thread 0: one bulk copy (TMA) a step row
  // and stream -- r, k, w: hd floats; v: the block's NC columns -- at
  // addresses the whole warp shares
  auto issue = [&](int n) {
    const int s = n % kNS;
    const int t0 = n * kKT;
    const int cnt = min(kKT, T - t0);
    hopper::mbar_expect_tx(full(s), cnt * ROW * 4);
    for (int tt = 0; tt < cnt; ++tt) {
      const long long o = bth0 + (t0 + tt) * step;
      const uint32_t dst = hopper::smem_u32(ring + (s * kKT + tt) * ROW);
      hopper::bulk_load(dst, r + o, HD * 4, full(s));
      hopper::bulk_load(dst + HD * 4, k + o, HD * 4, full(s));
      hopper::bulk_load(dst + 2 * HD * 4, w + o, HD * 4, full(s));
      hopper::bulk_load(dst + 3 * HD * 4, v + o + cb * NC, NC * 4, full(s));
    }
  };
  if (threadIdx.x == 0) {
    for (int n = 0; n < kNS && n < tiles; ++n) issue(n);
  }

  float* dst = out + bth0 + col;
  constexpr int kL = rwkv6::kBwdChunk<HD>;
  float* ck = nullptr;           // the lane's state elements in checkpoint 0
  if constexpr (CKPT) {
    ck = ckpt + (static_cast<long long>(b) * H + h) * ((T + kL - 1) / kL) *
                    HD * HD + col;
  }

  for (int n = 0; n < tiles; ++n) {
    const int s = n % kNS;
    const int t0 = n * kKT;
    const int cnt = min(kKT, T - t0);
    hopper::mbar_wait(full(s), (n / kNS) & 1);
    const float* tile = ring + s * kKT * ROW;
#pragma unroll 4
    for (int tt = 0; tt < cnt; ++tt) {
      if constexpr (CKPT) {
        if ((t0 + tt) % kL == 0 && live) {
          float* c = ck + static_cast<long long>((t0 + tt) / kL) * HD * HD;
#pragma unroll
          for (int i = 0; i < kR; ++i) {
            *reinterpret_cast<float4*>(c + row_of<P>(p, i) * HD) = st[i];
          }
        }
      }
      const float* row = tile + tt * ROW;
      float rr[kR], kk[kR], ww[kR];
#pragma unroll
      for (int i = 0; i < kR; i += 4) {
        const int ri = row_of<P>(p, i);
        const float4 a = ld4(row + ri), c = ld4(row + HD + ri),
                     e = ld4(row + 2 * HD + ri);
        rr[i] = a.x; rr[i + 1] = a.y; rr[i + 2] = a.z; rr[i + 3] = a.w;
        kk[i] = c.x; kk[i + 1] = c.y; kk[i + 2] = c.z; kk[i + 3] = c.w;
        ww[i] = e.x; ww[i + 1] = e.y; ww[i + 2] = e.z; ww[i + 3] = e.w;
      }
      const float4 vv = ld4(row + 3 * HD + cw);
      float a = 0.0f, o0 = 0.0f, o1 = 0.0f, o2 = 0.0f, o3 = 0.0f;
#pragma unroll
      for (int i = 0; i < kR; ++i) {
        a = fmaf(rr[i], uu[i] * kk[i], a);
        o0 = fmaf(rr[i], st[i].x, o0);
        o1 = fmaf(rr[i], st[i].y, o1);
        o2 = fmaf(rr[i], st[i].z, o2);
        o3 = fmaf(rr[i], st[i].w, o3);
        st[i].x = fmaf(ww[i], st[i].x, kk[i] * vv.x);
        st[i].y = fmaf(ww[i], st[i].y, kk[i] * vv.y);
        st[i].z = fmaf(ww[i], st[i].z, kk[i] * vv.z);
        st[i].w = fmaf(ww[i], st[i].w, kk[i] * vv.w);
      }
      o0 = fmaf(a, vv.x, o0);
      o1 = fmaf(a, vv.y, o1);
      o2 = fmaf(a, vv.z, o2);
      o3 = fmaf(a, vv.w, o3);
      // reduce-scatter over the P lanes of the column group: lane bit 0
      // keeps columns 2 (p & 1) + {0, 1} and sends the other two; bit 1
      // keeps column 2 (p & 1) + (p >> 1 & 1); the rest of the group's
      // lanes are then summed in
      const bool b0 = p & 1, b1 = p & 2;
      float k0 = b0 ? o2 : o0, k1 = b0 ? o3 : o1;
      k0 += __shfl_xor_sync(kFull, b0 ? o0 : o2, 1);
      k1 += __shfl_xor_sync(kFull, b0 ? o1 : o3, 1);
      float q = b1 ? k1 : k0;
      q += __shfl_xor_sync(kFull, b1 ? k0 : k1, 2);
#pragma unroll
      for (int m = 4; m < P; m <<= 1) q += __shfl_xor_sync(kFull, q, m);
      if (live && p < 4) dst[(t0 + tt) * step + 2 * b0 + b1] = q;
    }
    if (W > 1) {
      __syncthreads();                  // every warp is done with stage s
    } else {
      __syncwarp();
    }
    if (threadIdx.x == 0 && n + kNS < tiles) issue(n + kNS);
  }

  if (live) {
#pragma unroll
    for (int i = 0; i < kR; ++i) {
      *reinterpret_cast<float4*>(s_last + sbase + row_of<P>(p, i) * HD) =
          st[i];
    }
  }
}

template <int HD, bool CKPT>
int launch(const float* r, const float* k, const float* v, const float* w,
           const float* u, const float* s0, float* out, float* s_last,
           float* ckpt, int B, int T, int H, cudaStream_t stream) {
  const dim3 grid(H * Shape<HD>::C, B);
  rwkv6_wkv_kernel<HD, CKPT><<<grid, 32 * Shape<HD>::W, 0, stream>>>(
      r, k, v, w, u, s0, out, s_last, ckpt, T, H);
  return static_cast<int>(cudaGetLastError());
}

// chunk < 0: no checkpoints (serving); else it must be kBwdChunk<hd>
template <bool CKPT>
int dispatch(const void* r, const void* k, const void* v, const void* w,
             const void* u, const void* s0, void* out, void* s_last,
             void* ckpt, int chunk, int B, int T, int H, int hd,
             cudaStream_t stream) {
  if (B <= 0 || H <= 0) return static_cast<int>(cudaGetLastError());
  if (T <= 0 || B > 65535) return static_cast<int>(cudaErrorInvalidValue);
  auto run = [&](auto hd_tag) {
    constexpr int HD = decltype(hd_tag)::value;
    if (CKPT && chunk != rwkv6::kBwdChunk<HD>) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    return launch<HD, CKPT>(
        static_cast<const float*>(r), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<const float*>(w),
        static_cast<const float*>(u), static_cast<const float*>(s0),
        static_cast<float*>(out), static_cast<float*>(s_last),
        static_cast<float*>(ckpt), B, T, H, stream);
  };
  switch (hd) {
    case 16: return run(std::integral_constant<int, 16>());
    case 32: return run(std::integral_constant<int, 32>());
    case 64: return run(std::integral_constant<int, 64>());
    case 128: return run(std::integral_constant<int, 128>());
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" int rwkv6_wkv_f32(const void* r, const void* k, const void* v,
                             const void* w, const void* u, const void* s0,
                             void* out, void* s_last, int B, int T, int H,
                             int hd, cudaStream_t stream) {
  return dispatch<false>(r, k, v, w, u, s0, out, s_last, nullptr, -1, B, T,
                         H, hd, stream);
}

// the same with the backward's checkpoints written to ckpt (B, H,
// ceil(T / chunk), hd, hd); chunk must be kBwdChunk<hd>
extern "C" int rwkv6_wkv_ckpt_f32(const void* r, const void* k,
                                  const void* v, const void* w,
                                  const void* u, const void* s0, void* out,
                                  void* s_last, void* ckpt, int chunk, int B,
                                  int T, int H, int hd, cudaStream_t stream) {
  return dispatch<true>(r, k, v, w, u, s0, out, s_last, ckpt, chunk, B, T, H,
                        hd, stream);
}
