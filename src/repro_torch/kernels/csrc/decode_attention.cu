// One query token per sequence against a KV cache (flash-decoding), the G
// query heads of a kv group together.
//
// Replaces the Pallas kernel src/repro/kernels/decode_attention.py
// (decode_attention_fwd over _decode_kernel).  q (B, KV, G, hd), caches
// (B, KV, S, hd), cache_len an int32 on the device (the counterpart of the
// Pallas scalar prefetch: the caller never syncs the host to pass it).
// Positions 0..min(cache_len, S - 1) are attended; later ones are neither
// read nor counted.  Per query row, over cache tiles:
//   s = (q * hd^-0.5) . k;  m' = max(m, max s);  p = exp(s - m')
//   l = l * exp(m - m') + sum p;  acc = acc * exp(m - m') + p . v
//   out = acc / max(l, 1e-30)          (written in the input type)
// Everything is f32 inside, as in the Pallas kernel.
//
// Bound on the H100: bytes, the (cache_len + 1) rows of K and V read once.
// Simple design: one block per (kv head, batch row), 256 threads; each
// tile of kTS positions is loaded with 16-byte vector loads into shared
// memory (K padded so that one thread per (row, position) dot product meets
// no bank conflict), one warp per query row runs the softmax, and the
// threads own fixed (row, column) entries of the f32 accumulator.  At the
// decode path's B = 8, KV = 8 the grid is 64 blocks on 132 SMs: a split
// over the cache (split-K) is later work.
#include <cmath>
#include <type_traits>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kTS = 64;        // cache positions per tile
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr size_t kMaxSmem = 227 * 1024;

__device__ __forceinline__ float neg_inf() {
  return __int_as_float(0xff800000);
}

// 16 bytes of T -> kN floats
template <typename T>
struct Vec;
template <>
struct Vec<float> {
  static constexpr int kN = 4;
  __device__ static void load(const float* p, float* out) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
  }
};
template <>
struct Vec<__nv_bfloat16> {
  static constexpr int kN = 8;
  __device__ static void load(const __nv_bfloat16* p, float* out) {
    const uint4 raw = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      out[2 * i] = f.x;
      out[2 * i + 1] = f.y;
    }
  }
};

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(~0u, x, o));
  return x;
}
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(~0u, x, o);
  return x;
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
decode_attention_kernel(const T* __restrict__ q, const T* __restrict__ kc,
                        const T* __restrict__ vc,
                        const int* __restrict__ cache_len,
                        T* __restrict__ o, int KV, int G, int S,
                        float scale) {
  constexpr int kN = Vec<T>::kN;
  constexpr int kChunks = HD / kN;          // vector loads per row
  extern __shared__ float smem[];
  float* s_q = smem;                        // [G][HD]
  float* s_k = s_q + G * HD;                // [kTS][HD + 1]
  float* s_v = s_k + kTS * (HD + 1);        // [kTS][HD]
  float* s_p = s_v + kTS * HD;              // [G][kTS]
  float* s_acc = s_p + G * kTS;             // [G][HD]
  float* s_m = s_acc + G * HD;              // [G]
  float* s_l = s_m + G;                     // [G]
  float* s_alpha = s_l + G;                 // [G]

  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int kvh = blockIdx.x;
  const int b = blockIdx.y;
  const long long bk = (long long)b * KV + kvh;
  const T* qb = q + bk * G * HD;
  const T* kb = kc + bk * S * HD;
  const T* vb = vc + bk * S * HD;
  T* ob = o + bk * G * HD;
  const int n = max(0, min(*cache_len + 1, S));   // positions attended

  for (int e = tid; e < G * kChunks; e += kThreads) {
    float f[kN];
    Vec<T>::load(qb + e * kN, f);
#pragma unroll
    for (int i = 0; i < kN; ++i) s_q[e * kN + i] = f[i] * scale;
  }
  for (int e = tid; e < G * HD; e += kThreads) s_acc[e] = 0.0f;
  if (tid < G) {
    s_m[tid] = -1e30f;
    s_l[tid] = 0.0f;
  }

  for (int s0 = 0; s0 < n; s0 += kTS) {
    const int cnt = min(kTS, n - s0);
    __syncthreads();  // the previous tile is consumed (and s_q is written)
    for (int e = tid; e < cnt * kChunks; e += kThreads) {
      const int c = e / kChunks;
      const int d0 = (e - c * kChunks) * kN;
      const long long g = (long long)(s0 + c) * HD + d0;
      float f[kN];
      Vec<T>::load(kb + g, f);
#pragma unroll
      for (int i = 0; i < kN; ++i) s_k[c * (HD + 1) + d0 + i] = f[i];
      Vec<T>::load(vb + g, f);
#pragma unroll
      for (int i = 0; i < kN; ++i) s_v[c * HD + d0 + i] = f[i];
    }
    __syncthreads();

    for (int e = tid; e < G * kTS; e += kThreads) {
      const int r = e / kTS;
      const int c = e - r * kTS;
      float dot = neg_inf();
      if (c < cnt) {
        const float* qr = s_q + r * HD;
        const float* kr = s_k + c * (HD + 1);
        dot = 0.0f;
#pragma unroll 16
        for (int d = 0; d < HD; ++d) dot = fmaf(qr[d], kr[d], dot);
      }
      s_p[e] = dot;
    }
    __syncthreads();

    // online softmax, one warp per query row
    for (int r = warp; r < G; r += kWarps) {
      float* row = s_p + r * kTS;
      float mx = -1e30f;
      for (int c = lane; c < kTS; c += 32) mx = fmaxf(mx, row[c]);
      const float m_prev = s_m[r];
      mx = fmaxf(m_prev, warp_max(mx));
      float sum = 0.0f;
      for (int c = lane; c < kTS; c += 32) {
        const float p = expf(row[c] - mx);   // beyond cnt: exp(-inf) = 0
        row[c] = p;
        sum += p;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float alpha = expf(m_prev - mx);
        s_alpha[r] = alpha;
        s_l[r] = s_l[r] * alpha + sum;
        s_m[r] = mx;
      }
    }
    __syncthreads();

    for (int e = tid; e < G * HD; e += kThreads) {
      const int r = e / HD;
      const int d = e - r * HD;
      const float* pr = s_p + r * kTS;
      float a = s_acc[e] * s_alpha[r];
      for (int c = 0; c < cnt; ++c) a = fmaf(pr[c], s_v[c * HD + d], a);
      s_acc[e] = a;
    }
  }
  __syncthreads();
  for (int e = tid; e < G * HD; e += kThreads)
    store(&ob[e], s_acc[e] / fmaxf(s_l[e / HD], 1e-30f));
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, const int* cache_len,
           void* o, int B, int KV, int G, int S, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (2 * G * HD + kTS * (HD + 1)
                                       + kTS * HD + G * kTS + 3 * G);
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = decode_attention_kernel<T, HD>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid(KV, B);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), cache_len, static_cast<T*>(o), KV, G, S,
      static_cast<float>(1.0 / std::sqrt(static_cast<double>(HD))));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v,
             const int* cache_len, void* o, int B, int KV, int G, int S,
             int hd, cudaStream_t stream) {
  if (B <= 0 || KV <= 0 || G <= 0) return static_cast<int>(cudaGetLastError());
  if (S <= 0) return static_cast<int>(cudaErrorInvalidValue);
  auto run = [&](auto hd_tag) {
    return launch<T, decltype(hd_tag)::value>(q, k, v, cache_len, o, B, KV,
                                               G, S, stream);
  };
  switch (hd) {
    case 16: return run(std::integral_constant<int, 16>());
    case 32: return run(std::integral_constant<int, 32>());
    case 64: return run(std::integral_constant<int, 64>());
    case 128: return run(std::integral_constant<int, 128>());
    case 256: return run(std::integral_constant<int, 256>());
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" int decode_attention_f32(const void* q, const void* k,
                                    const void* v, const int* cache_len,
                                    void* o, int B, int KV, int G, int S,
                                    int hd, cudaStream_t stream) {
  return dispatch<float>(q, k, v, cache_len, o, B, KV, G, S, hd, stream);
}

extern "C" int decode_attention_bf16(const void* q, const void* k,
                                     const void* v, const int* cache_len,
                                     void* o, int B, int KV, int G, int S,
                                     int hd, cudaStream_t stream) {
  return dispatch<__nv_bfloat16>(q, k, v, cache_len, o, B, KV, G, S, hd,
                                 stream);
}
