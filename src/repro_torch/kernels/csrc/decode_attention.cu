// One query token per sequence against a KV cache (flash-decoding), the G
// query heads of a kv group together, split over the cache.
//
// Replaces the Pallas kernel src/repro/kernels/decode_attention.py
// (decode_attention_fwd over _decode_kernel).  q (B, KV, G, hd), caches
// (B, KV, S, hd), cache_len an int32 on the device (the counterpart of the
// Pallas scalar prefetch: the caller never syncs the host to pass it).
// Positions 0..min(cache_len, S - 1) are attended; later ones are neither
// read nor counted.  Per query row, over cache tiles:
//   s = (q . k) * hd^-0.5;  m' = max(m, max s);  p = exp(s - m')
//   l = l * exp(m - m') + sum p;  acc = acc * exp(m - m') + p . v
// Everything is f32 inside, as in the Pallas kernel, in float32 and in
// bfloat16 alike.
//
// Bound on the H100: bytes, the n = cache_len + 1 rows of K and V read
// once (the decode path's last step: 37.7 MB, 11.3 us at 3.35 TB/s).  A
// block per (kv head, batch row) gave the decode path 64 blocks on 132
// SMs, each walking its cache alone.  The design:
//   * a split of the cache: `splits` blocks per (batch row, kv head, group
//     of up to 8 query rows), a number the wrapper picks from (B, KV, S)
//     alone (decode_splits in decode_attention.py).  Each block reads
//     cache_len itself and takes the ceil(n / splits) positions of its
//     split, so every split does equal work at every fill, and one launch
//     replays in a CUDA graph at any fill.  A split past n writes an empty
//     partial (m = -inf, l = 0, acc = 0);
//   * tiles of kTS positions copied by cp.async (16 bytes a thread) into a
//     two-stage ring, the next tile in flight while the current one is
//     computed; the group's query rows stay in shared memory in f32;
//   * q . k by kTPP threads a position (K rows padded so that the 16-byte
//     reads of a quarter warp meet no bank conflict), the softmax a warp a
//     row, p . v with each thread owning two columns of every row;
//   * each split writes its f32 partial (m, l, acc[G][hd]) to a workspace
//     that the wrapper allocates with the output, and a second kernel,
//     launched from the same entry point, merges the splits with the
//     log-sum-exp rescaling and writes the output in the input type (zeros
//     when n = 0).
//
// The partial call (decode_attention_partial_*; one shard of a decode over
// a cache sharded along its sequence, the reference's jnp decode_attention
// under GSPMD, src/repro/models/attention.py:263-302, which has no Pallas
// kernel) takes the shard's local fill in place of cache_len (positions
// 0..fill of the shard: none below 0, all of them at fill >= S) and runs
// the same split kernel; its merge combines the splits by the same
// rescaling but writes the shard's f32 (m, l, acc) undivided, for the
// shards to merge across ranks.  A shard with no position attended gets
// the finite m = -1e30 (the reference's NEG_INF) with l = acc = 0, never
// -inf: a merge over shards that are all empty then takes exp(0) * 0.
//
// The tailed call (decode_attention_tailed_*; the reference's jnp
// decode_attention_tailed, src/repro/models/attention.py:185, which has no
// Pallas kernel) attends main[0:main_len] ++ tail[0:tail_len] inclusive
// under one softmax, with main_len = (cache_len / W) * W and tail_len =
// cache_len - main_len, both computed here from cache_len on the device.
// The same kernels run it: the splits take equal shares of the n = main_len
// + tail_len + 1 positions of that joined sequence, position p read from
// main row p below main_len and from tail row p - main_len above, so every
// split does the work it does untailed at the same fill (main_len = 0, the
// first W steps, is a sequence of tail rows only).
#include <cmath>
#include <type_traits>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "hopper.cuh"

namespace {

using hopper::cp_async_16;
using hopper::smem_u32;

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxGroup = 8;        // query rows a block keeps
constexpr int kMergeThreads = 256;
constexpr float kNegInf = -1e30f;   // an empty shard's m (ref.NEG_INF)

__device__ __forceinline__ float neg_inf() {
  return __int_as_float(0xff800000);
}

// 16 bytes of T -> kN floats; two of T -> 2 floats
template <typename T>
struct Vec;
template <>
struct Vec<float> {
  static constexpr int kN = 4;
  __device__ static void load(const float* p, float* out) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
  }
  __device__ static float2 load2(const float* p) {
    return *reinterpret_cast<const float2*>(p);
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
  __device__ static float2 load2(const __nv_bfloat16* p) {
    return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
  }
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
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

template <typename T, int HD, int GB>
struct Plan {
  static constexpr int kVec = Vec<T>::kN;          // elements a 16-byte copy
  static constexpr int kChunks = HD / kVec;        // 16-byte chunks a row
  static constexpr int kTSMax = 16384 / (HD * (int)sizeof(T));
  static constexpr int kTS = kTSMax < 64 ? kTSMax : 64;   // positions a tile
  static constexpr int kTPP = kThreads / kTS;      // q . k threads a position
  // K row stride = kTPP (mod 8) 16-byte units: conflict-free q . k reads
  static constexpr int kKRow = 16 * (kChunks + ((kTPP - kChunks) % 8 + 8) % 8);
  static constexpr int kVRow = HD * (int)sizeof(T);
  static constexpr int kKTile = kTS * kKRow;
  static constexpr int kVTile = kTS * kVRow;
  static constexpr int kDT = HD / 2;               // p . v: two columns each
  static constexpr int kCP = kThreads / kDT;       // position phases
  static constexpr int kStage = 2 * kKTile + 2 * kVTile;   // both stages
  static constexpr int kSmem =
      kStage + 4 * (GB * HD + kTS * GB + 3 * GB);
  static_assert(kChunks % kTPP == 0, "a position's chunks split evenly");
  static_assert(kCP * GB * HD * 4 <= kStage, "the phase sums fit the ring");
};

template <typename T, int HD, int GB>
__global__ void __launch_bounds__(kThreads)
decode_split_kernel(const T* __restrict__ q, const T* __restrict__ kc,
                    const T* __restrict__ vc, const T* __restrict__ kt,
                    const T* __restrict__ vt,
                    const int* __restrict__ cache_len,
                    float* __restrict__ ws, int KV, int G, int S, int W,
                    int splits, float scale) {
  using P = Plan<T, HD, GB>;
  constexpr int kTS = P::kTS, kTPP = P::kTPP, kVec = P::kVec;
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* s_k = smem;                          // [2][kTS][kKRow B]
  unsigned char* s_v = s_k + 2 * P::kKTile;           // [2][kTS][kVRow B]
  float* s_q = reinterpret_cast<float*>(smem + P::kStage);   // [GB][HD]
  float* s_p = s_q + GB * HD;                         // [kTS][GB]
  float* s_m = s_p + kTS * GB;                        // [GB]
  float* s_l = s_m + GB;
  float* s_alpha = s_l + GB;

  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int split = blockIdx.x;
  const int kvh = blockIdx.y % KV;
  const int g0 = blockIdx.y / KV * GB;
  const long long pr = (long long)blockIdx.z * KV + kvh;
  const long long rows = (long long)gridDim.z * KV * splits * G;
  float* ws_m = ws;                                   // [B][KV][splits][G]
  float* ws_l = ws + rows;
  float* ws_acc = ws + 2 * rows;                      // [...][G][HD]
  const long long part = (pr * splits + split) * G;   // row (.., split, 0)

  // positions attended: n, the first n_main of them cache rows, the rest
  // (tailed, W > 0) tail rows
  const int clen = *cache_len;
  int n, n_main;
  if (W > 0) {
    const int main_len = max(0, clen) / W * W;
    n_main = min(main_len, S);
    n = n_main + min(max(0, clen - main_len) + 1, W);
  } else {
    n = n_main = max(0, min(clen + 1, S));
  }
  const int per = (n + splits - 1) / splits;
  const int lo = split * per;
  const int hi = min(n, lo + per);
  if (lo >= hi) {                                     // an empty partial
    for (int e = tid; e < GB * HD; e += kThreads) {
      const int g = g0 + e / HD;
      if (g >= G) continue;
      ws_acc[(part + g) * HD + e % HD] = 0.0f;
      if (e % HD == 0) {
        ws_m[part + g] = neg_inf();
        ws_l[part + g] = 0.0f;
      }
    }
    return;
  }

  const T* kb = kc + pr * S * HD;
  const T* vb = vc + pr * S * HD;
  const T* ktb = kt + pr * W * HD;                    // W = 0: never read
  const T* vtb = vt + pr * W * HD;
  auto load_tile = [&](int t) {                       // tile t -> stage t & 1
    const int p0 = lo + t * kTS;
    const int cnt = min(kTS, hi - p0);
    unsigned char* dk = s_k + (t & 1) * P::kKTile;
    unsigned char* dv = s_v + (t & 1) * P::kVTile;
    for (int e = tid; e < cnt * P::kChunks; e += kThreads) {
      const int c = e / P::kChunks;
      const int ch = e - c * P::kChunks;
      const int pos = p0 + c;
      const bool in_main = pos < n_main;
      const long long g =
          (long long)(in_main ? pos : pos - n_main) * HD + ch * kVec;
      cp_async_16(smem_u32(dk + c * P::kKRow + ch * 16),
                  (in_main ? kb : ktb) + g);
      cp_async_16(smem_u32(dv + c * P::kVRow + ch * 16),
                  (in_main ? vb : vtb) + g);
    }
  };
  const int n_t = (hi - lo + kTS - 1) / kTS;
  load_tile(0);
  hopper::cp_async_commit();

  const T* qb = q + pr * G * HD;
  for (int e = tid; e < GB * HD; e += kThreads) {
    const int g = g0 + e / HD;
    s_q[e] = g < G ? to_f32(qb[(long long)g * HD + e % HD]) : 0.0f;
  }
  if (tid < GB) {
    s_m[tid] = neg_inf();
    s_l[tid] = 0.0f;
  }

  const int c_pos = tid / kTPP;        // q . k: this thread's position
  const int c_part = tid % kTPP;       //        and its share of the chunks
  const int dp = tid % P::kDT;         // p . v: columns 2 dp, 2 dp + 1
  const int cp = tid / P::kDT;         //        of positions cp + kCP i
  float acc[GB][2];
#pragma unroll
  for (int g = 0; g < GB; ++g) acc[g][0] = acc[g][1] = 0.0f;

  for (int t = 0; t < n_t; ++t) {
    if (t + 1 < n_t) load_tile(t + 1);
    hopper::cp_async_commit();
    hopper::cp_async_wait<1>();        // tile t has landed (this thread's)
    __syncthreads();                   // ... and everyone's; s_q is written
    const int cnt = min(kTS, hi - lo - t * kTS);

    // scores s_p[c][g]
    {
      const unsigned char* kr = s_k + (t & 1) * P::kKTile + c_pos * P::kKRow;
      float dot[GB];
#pragma unroll
      for (int g = 0; g < GB; ++g) dot[g] = 0.0f;
#pragma unroll
      for (int i = 0; i < P::kChunks / kTPP; ++i) {
        const int ch = i * kTPP + c_part;
        float kf[kVec];
        Vec<T>::load(reinterpret_cast<const T*>(kr + ch * 16), kf);
#pragma unroll
        for (int g = 0; g < GB; ++g) {
#pragma unroll
          for (int v4 = 0; v4 < kVec; v4 += 4) {
            const float4 qv = *reinterpret_cast<const float4*>(
                s_q + g * HD + ch * kVec + v4);
            dot[g] = fmaf(qv.x, kf[v4], dot[g]);
            dot[g] = fmaf(qv.y, kf[v4 + 1], dot[g]);
            dot[g] = fmaf(qv.z, kf[v4 + 2], dot[g]);
            dot[g] = fmaf(qv.w, kf[v4 + 3], dot[g]);
          }
        }
      }
#pragma unroll
      for (int g = 0; g < GB; ++g) {
#pragma unroll
        for (int o = 1; o < kTPP; o <<= 1)
          dot[g] += __shfl_xor_sync(~0u, dot[g], o);
        if (g % kTPP == c_part)
          s_p[c_pos * GB + g] = c_pos < cnt ? dot[g] * scale : neg_inf();
      }
    }
    __syncthreads();

    // online softmax, one warp per query row
    for (int g = warp; g < GB; g += kWarps) {
      float mx = neg_inf();
      for (int c = lane; c < kTS; c += 32) mx = fmaxf(mx, s_p[c * GB + g]);
      const float m_prev = s_m[g];
      mx = fmaxf(m_prev, warp_max(mx));      // finite: the tile has a key
      float sum = 0.0f;
      for (int c = lane; c < kTS; c += 32) {
        const float p = expf(s_p[c * GB + g] - mx);   // masked: 0
        s_p[c * GB + g] = p;
        sum += p;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float alpha = expf(m_prev - mx);          // m = -inf: 0
        s_alpha[g] = alpha;
        s_l[g] = s_l[g] * alpha + sum;
        s_m[g] = mx;
      }
    }
    __syncthreads();

    // acc = acc * alpha + p . v
    const T* vt = reinterpret_cast<const T*>(s_v + (t & 1) * P::kVTile) +
                  2 * dp;
#pragma unroll
    for (int g = 0; g < GB; ++g) {
      const float alpha = s_alpha[g];
      acc[g][0] *= alpha;
      acc[g][1] *= alpha;
    }
    for (int c = cp; c < cnt; c += P::kCP) {
      const float2 v = Vec<T>::load2(vt + c * HD);
#pragma unroll
      for (int g = 0; g < GB; ++g) {
        const float p = s_p[c * GB + g];
        acc[g][0] = fmaf(p, v.x, acc[g][0]);
        acc[g][1] = fmaf(p, v.y, acc[g][1]);
      }
    }
    __syncthreads();   // the stage and s_p are free for the next tile
  }

  // sum the kCP position phases (over the ring, now idle) and write the
  // partial (m, l, acc)
  float* red = reinterpret_cast<float*>(smem);        // [kCP][GB][HD]
#pragma unroll
  for (int g = 0; g < GB; ++g) {
    red[(cp * GB + g) * HD + 2 * dp] = acc[g][0];
    red[(cp * GB + g) * HD + 2 * dp + 1] = acc[g][1];
  }
  __syncthreads();
  for (int e = tid; e < GB * HD; e += kThreads) {
    const int g = e / HD;
    const int d = e - g * HD;
    if (g0 + g >= G) continue;
    float a = 0.0f;
#pragma unroll
    for (int c = 0; c < P::kCP; ++c) a += red[(c * GB + g) * HD + d];
    ws_acc[(part + g0 + g) * HD + d] = a;
    if (d == 0) {
      ws_m[part + g0 + g] = s_m[g];
      ws_l[part + g0 + g] = s_l[g];
    }
  }
}

// out[b, kv, g, :] = sum_s w_s acc_s / max(sum_s w_s l_s, 1e-30) with
// w_s = exp(m_s - max_s m_s) (0 for an empty split): one block per (batch
// row, kv head), the weights first (a thread per (split, row), coalesced),
// then a thread per output element over the splits.  kPartial: the f32
// (m, l, acc) of the merged splits instead, acc undivided, into out (acc),
// m_out and l_out; m = kNegInf where no split holds a position
template <typename T, int HD, bool kPartial>
__global__ void __launch_bounds__(kMergeThreads)
decode_merge_kernel(const float* __restrict__ ws, void* __restrict__ out,
                    float* __restrict__ m_out, float* __restrict__ l_out,
                    int G, int splits, long long rows) {
  extern __shared__ float s_w[];                      // [splits][G], [G]
  float* s_l = s_w + splits * G;
  const long long base = (long long)blockIdx.x * splits * G;
  const float* ws_m = ws + base;
  const float* ws_l = ws + rows + base;
  const float* ws_acc = ws + 2 * rows + base * HD;
  const int tid = threadIdx.x;
  for (int i = tid; i < splits * G; i += kMergeThreads) s_w[i] = ws_m[i];
  __syncthreads();
  for (int g = tid; g < G; g += kMergeThreads) {
    float mx = neg_inf();
    for (int s = 0; s < splits; ++s) mx = fmaxf(mx, s_w[s * G + g]);
    s_l[g] = mx;
  }
  __syncthreads();
  for (int i = tid; i < splits * G; i += kMergeThreads) {
    const float m = s_w[i];
    s_w[i] = m == neg_inf() ? 0.0f : expf(m - s_l[i % G]);
  }
  __syncthreads();
  for (int g = tid; g < G; g += kMergeThreads) {
    float l = 0.0f;
    for (int s = 0; s < splits; ++s)
      l = fmaf(ws_l[s * G + g], s_w[s * G + g], l);
    if constexpr (kPartial) {
      const long long r = (long long)blockIdx.x * G + g;
      m_out[r] = s_l[g] == neg_inf() ? kNegInf : s_l[g];
      l_out[r] = l;
    } else {
      s_l[g] = fmaxf(l, 1e-30f);
    }
  }
  __syncthreads();
  for (int e = tid; e < G * HD; e += kMergeThreads) {
    const int g = e / HD;
    float a[4] = {0.0f, 0.0f, 0.0f, 0.0f};     // four chains for the loads
    int s = 0;
    for (; s + 4 <= splits; s += 4) {
#pragma unroll
      for (int u = 0; u < 4; ++u)
        a[u] = fmaf(ws_acc[(long long)(s + u) * G * HD + e],
                    s_w[(s + u) * G + g], a[u]);
    }
    for (; s < splits; ++s)
      a[0] = fmaf(ws_acc[(long long)s * G * HD + e], s_w[s * G + g], a[0]);
    const long long at = (long long)blockIdx.x * G * HD + e;
    const float sum = (a[0] + a[1]) + (a[2] + a[3]);
    if constexpr (kPartial)
      static_cast<float*>(out)[at] = sum;
    else
      store(&static_cast<T*>(out)[at], sum / s_l[g]);
  }
}

// m_out, l_out null: the output o in T; else the partial (m, l, acc = o) in
// f32
template <typename T, int HD, int GB>
int launch(const T* q, const T* k, const T* v, const T* kt, const T* vt,
           const int* cache_len, void* o, float* m_out, float* l_out,
           float* ws, int B, int KV, int G, int S, int W, int splits,
           cudaStream_t stream) {
  using P = Plan<T, HD, GB>;
  auto kernel = decode_split_kernel<T, HD, GB>;
  if (P::kSmem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, P::kSmem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid(splits, KV * ((G + GB - 1) / GB), B);
  kernel<<<grid, kThreads, P::kSmem, stream>>>(
      q, k, v, kt, vt, cache_len, ws, KV, G, S, W, splits,
      static_cast<float>(1.0 / std::sqrt(static_cast<double>(HD))));
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long rows = (long long)B * KV * splits * G;
  const int merge_smem = 4 * (splits + 1) * G;
  if (m_out != nullptr)
    decode_merge_kernel<T, HD, true>
        <<<B * KV, kMergeThreads, merge_smem, stream>>>(
            ws, o, m_out, l_out, G, splits, rows);
  else
    decode_merge_kernel<T, HD, false>
        <<<B * KV, kMergeThreads, merge_smem, stream>>>(
            ws, o, nullptr, nullptr, G, splits, rows);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int HD>
int by_group(const T* q, const T* k, const T* v, const T* kt, const T* vt,
             const int* cache_len, void* o, float* m_out, float* l_out,
             float* ws, int B, int KV, int G, int S, int W, int splits,
             cudaStream_t stream) {
  auto run = [&](auto gb) {
    return launch<T, HD, decltype(gb)::value>(q, k, v, kt, vt, cache_len, o,
                                              m_out, l_out, ws, B, KV, G, S,
                                              W, splits, stream);
  };
  if (G <= 1) return run(std::integral_constant<int, 1>());
  if (G <= 2) return run(std::integral_constant<int, 2>());
  if (G <= 4) return run(std::integral_constant<int, 4>());
  return run(std::integral_constant<int, kMaxGroup>());
}

// W = 0: the cache alone (kt, vt unused); W > 0: the tailed call; m_out
// and l_out given: the partial call (o its f32 acc)
template <typename T>
int dispatch(const void* q, const void* k, const void* v, const void* kt,
             const void* vt, const int* cache_len, void* o, void* m_out,
             void* l_out, void* ws, int B, int KV, int G, int S, int W,
             int hd, int splits, cudaStream_t stream) {
  if (B <= 0 || KV <= 0 || G <= 0) return static_cast<int>(cudaGetLastError());
  if (S <= 0 || W < 0 || splits <= 0 || splits > S)
    return static_cast<int>(cudaErrorInvalidValue);
  auto run = [&](auto hd_tag) {
    return by_group<T, decltype(hd_tag)::value>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<const T*>(kt),
        static_cast<const T*>(vt), cache_len, o, static_cast<float*>(m_out),
        static_cast<float*>(l_out), static_cast<float*>(ws), B, KV, G, S, W,
        splits, stream);
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

// ws: 4 * B * KV * splits * G * (hd + 2) bytes of f32 partials
extern "C" int decode_attention_f32(const void* q, const void* k,
                                    const void* v, const int* cache_len,
                                    void* o, void* ws, int B, int KV, int G,
                                    int S, int hd, int splits,
                                    cudaStream_t stream) {
  return dispatch<float>(q, k, v, nullptr, nullptr, cache_len, o, nullptr,
                         nullptr, ws, B, KV, G, S, 0, hd, splits, stream);
}

extern "C" int decode_attention_bf16(const void* q, const void* k,
                                     const void* v, const int* cache_len,
                                     void* o, void* ws, int B, int KV, int G,
                                     int S, int hd, int splits,
                                     cudaStream_t stream) {
  return dispatch<__nv_bfloat16>(q, k, v, nullptr, nullptr, cache_len, o,
                                 nullptr, nullptr, ws, B, KV, G, S, 0, hd,
                                 splits, stream);
}

// the tailed call: caches (B, KV, S, hd), tails (B, KV, W, hd), W >= 1
extern "C" int decode_attention_tailed_f32(const void* q, const void* k,
                                           const void* v, const void* kt,
                                           const void* vt,
                                           const int* cache_len, void* o,
                                           void* ws, int B, int KV, int G,
                                           int S, int W, int hd, int splits,
                                           cudaStream_t stream) {
  if (W <= 0) return static_cast<int>(cudaErrorInvalidValue);
  return dispatch<float>(q, k, v, kt, vt, cache_len, o, nullptr, nullptr, ws,
                         B, KV, G, S, W, hd, splits, stream);
}

extern "C" int decode_attention_tailed_bf16(const void* q, const void* k,
                                            const void* v, const void* kt,
                                            const void* vt,
                                            const int* cache_len, void* o,
                                            void* ws, int B, int KV, int G,
                                            int S, int W, int hd, int splits,
                                            cudaStream_t stream) {
  if (W <= 0) return static_cast<int>(cudaErrorInvalidValue);
  return dispatch<__nv_bfloat16>(q, k, v, kt, vt, cache_len, o, nullptr,
                                 nullptr, ws, B, KV, G, S, W, hd, splits,
                                 stream);
}

// the partial call: one shard's k/v (B, KV, S, hd), fill (device int32) the
// shard's last attended position; m, l (B, KV, G) and acc (B, KV, G, hd)
// float32
extern "C" int decode_attention_partial_f32(const void* q, const void* k,
                                            const void* v, const int* fill,
                                            void* m, void* l, void* acc,
                                            void* ws, int B, int KV, int G,
                                            int S, int hd, int splits,
                                            cudaStream_t stream) {
  return dispatch<float>(q, k, v, nullptr, nullptr, fill, acc, m, l, ws, B,
                         KV, G, S, 0, hd, splits, stream);
}

extern "C" int decode_attention_partial_bf16(const void* q, const void* k,
                                             const void* v, const int* fill,
                                             void* m, void* l, void* acc,
                                             void* ws, int B, int KV, int G,
                                             int S, int hd, int splits,
                                             cudaStream_t stream) {
  return dispatch<__nv_bfloat16>(q, k, v, nullptr, nullptr, fill, acc, m, l,
                                 ws, B, KV, G, S, 0, hd, splits, stream);
}
