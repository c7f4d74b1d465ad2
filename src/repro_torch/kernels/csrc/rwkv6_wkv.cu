// The RWKV-6 WKV recurrence: per (batch row, head), T sequential steps on an
// (hd, hd) float32 state, returning every step's output and the last state.
//
// Replaces the Pallas kernel src/repro/kernels/rwkv6_scan.py
// (rwkv6_wkv_fwd over _wkv_kernel).  r, k, v, w (B, T, H, hd), u (H, hd),
// s0 and s_last (B, H, hd, hd) indexed (k index i, v index j), out
// (B, T, H, hd), all float32.  Per step, with kv[i][j] = k_t[i] v_t[j]:
//   o_t[j]  = sum_i r_t[i] (S[i][j] + u[i] kv[i][j])    (i = 0 .. hd-1)
//   S[i][j] = w_t[i] S[i][j] + kv[i][j]
// Everything is f32, as in the Pallas kernel.
//
// Bound on the H100: bytes, at the prefill's T (5 f32 streams of hd a step
// and head against the 5 hd^2 + 5 hd operations the function needs there:
// o_t = r_t S + (sum_i r_i u_i k_i) v_t, S = w S + k^T v) and at T = 1 (the
// state read and written once).
// Simple design: one block per (head, batch row) with hd threads; thread j
// keeps the state column S[:, j] in hd registers for all T, so the state
// never leaves the SM.  Tiles of 2048 / hd steps of r, k, v, w are staged in
// shared memory (two barriers a tile, not a step); every thread reads the
// same r/k/w/u entries, which shared memory broadcasts, and writes its own
// o_t[j], so the block's output writes are coalesced.  Thread j reads its
// state column before any write and writes only that column, so s_last may
// alias s0 (the in-place decode).  At the prefill's B = 8, H = 40 the grid
// is 320 blocks of 64 threads: a split of the state over more threads, and
// wgmma for the products, are later work.
#include <type_traits>

#include <cuda_runtime.h>

namespace {

constexpr int kTileFloats = 2048;     // floats of one stream in one tile

template <int HD>
__global__ void __launch_bounds__(HD)
rwkv6_wkv_kernel(const float* __restrict__ r, const float* __restrict__ k,
                 const float* __restrict__ v, const float* __restrict__ w,
                 const float* __restrict__ u, const float* s0,
                 float* __restrict__ out, float* s_last, int T, int H) {
  constexpr int kT = kTileFloats / HD;        // steps a tile
  __shared__ __align__(16) float s_r[kT * HD];
  __shared__ __align__(16) float s_k[kT * HD];
  __shared__ __align__(16) float s_w[kT * HD];
  __shared__ __align__(16) float s_u[HD];
  __shared__ float s_v[kT * HD];

  const int j = threadIdx.x;
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const long long step = (long long)H * HD;               // stride of t
  const long long base = ((long long)b * T * H + h) * HD + j;  // [b, 0, h, j]
  const long long col = ((long long)b * H + h) * HD * HD + j;  // [b, h, 0, j]

  float s[HD];
#pragma unroll
  for (int i = 0; i < HD; ++i) s[i] = s0[col + (long long)i * HD];
  s_u[j] = u[h * HD + j];

  for (int t0 = 0; t0 < T; t0 += kT) {
    const int cnt = min(kT, T - t0);
    __syncthreads();  // the previous tile is consumed (and s_u is written)
#pragma unroll 4
    for (int tt = 0; tt < cnt; ++tt) {
      const long long g = base + (long long)(t0 + tt) * step;
      s_r[tt * HD + j] = r[g];
      s_k[tt * HD + j] = k[g];
      s_v[tt * HD + j] = v[g];
      s_w[tt * HD + j] = w[g];
    }
    __syncthreads();
    for (int tt = 0; tt < cnt; ++tt) {
      const float4* r4 = reinterpret_cast<const float4*>(s_r + tt * HD);
      const float4* k4 = reinterpret_cast<const float4*>(s_k + tt * HD);
      const float4* w4 = reinterpret_cast<const float4*>(s_w + tt * HD);
      const float4* u4 = reinterpret_cast<const float4*>(s_u);
      const float vj = s_v[tt * HD + j];
      float o = 0.0f;
#pragma unroll
      for (int q = 0; q < HD / 4; ++q) {
        const float4 rq = r4[q], kq = k4[q], wq = w4[q], uq = u4[q];
        const float rr[4] = {rq.x, rq.y, rq.z, rq.w};
        const float kk[4] = {kq.x, kq.y, kq.z, kq.w};
        const float ww[4] = {wq.x, wq.y, wq.z, wq.w};
        const float uu[4] = {uq.x, uq.y, uq.z, uq.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = 4 * q + e;
          const float kv = kk[e] * vj;
          o += rr[e] * (s[i] + uu[e] * kv);
          s[i] = ww[e] * s[i] + kv;
        }
      }
      out[base + (long long)(t0 + tt) * step] = o;
    }
  }
#pragma unroll
  for (int i = 0; i < HD; ++i) s_last[col + (long long)i * HD] = s[i];
}

template <int HD>
int launch(const float* r, const float* k, const float* v, const float* w,
           const float* u, const float* s0, float* out, float* s_last, int B,
           int T, int H, cudaStream_t stream) {
  const dim3 grid(H, B);
  rwkv6_wkv_kernel<HD><<<grid, HD, 0, stream>>>(r, k, v, w, u, s0, out,
                                                s_last, T, H);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int rwkv6_wkv_f32(const void* r, const void* k, const void* v,
                             const void* w, const void* u, const void* s0,
                             void* out, void* s_last, int B, int T, int H,
                             int hd, cudaStream_t stream) {
  if (B <= 0 || H <= 0) return static_cast<int>(cudaGetLastError());
  if (T <= 0 || B > 65535) return static_cast<int>(cudaErrorInvalidValue);
  auto run = [&](auto hd_tag) {
    return launch<decltype(hd_tag)::value>(
        static_cast<const float*>(r), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<const float*>(w),
        static_cast<const float*>(u), static_cast<const float*>(s0),
        static_cast<float*>(out), static_cast<float*>(s_last), B, T, H,
        stream);
  };
  switch (hd) {
    case 16: return run(std::integral_constant<int, 16>());
    case 32: return run(std::integral_constant<int, 32>());
    case 64: return run(std::integral_constant<int, 64>());
    case 128: return run(std::integral_constant<int, 128>());
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
