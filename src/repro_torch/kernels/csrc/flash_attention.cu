// Causal or full GQA attention forward in float32 with an online softmax
// over KV tiles, on the CUDA cores.
//
// Replaces the Pallas kernel src/repro/kernels/flash_attention.py
// (flash_attention_fwd over _flash_kernel) for float32 inputs; bfloat16
// inputs take the tensor-core kernel of flash_attention_bf16.cu.  No
// tensor-core type computes an f32 product in full f32 (TF32 keeps about
// three digits), and the float32 agreement checks (logits within 1e-4)
// need full f32 products, so this kernel stays on the CUDA cores; no timed
// path runs flash attention in float32.  q (B, H, Sq, hd), k/v (B, KV,
// Skv, hd), H % KV == 0; q head h reads kv head h / (H / KV) by index, so
// the grouped K/V are never repeated in memory.  Per query row, over KV
// tiles:
//   s     = (q * hd^-0.5) . k          (f32; -inf where k_pos > q_pos when
//                                       causal, or k_pos >= Skv)
//   m'    = max(m, max_j s);  p = exp(s - m');  alpha = exp(m - m')
//   l     = l * alpha + sum_j p;  acc = acc * alpha + p . v
//   out   = acc / max(l, 1e-30)
// Everything is f32, as in the Pallas kernel.  Tiles strictly above the
// diagonal are skipped.  Any Sq and Skv: the ragged tails are masked.
// When `lse` is not NULL (f32, B x H x Sq), each row also stores its
// logsumexp m + log l (natural log) for the backward.
//
// Bound on the H100: operations, 4*B*H*Sq*Skv*hd/2 FLOP against the 67
// TFLOP/s of f32 outside the tensor cores.  One block per (q tile of kBQ
// rows, head, batch), 256 threads; the q tile (pre-scaled), a transposed
// K tile, a V tile and the score tile sit in shared memory, padded so that
// no warp meets a bank conflict; each thread keeps a 4 x 2 score tile and
// a 4 x (hd/16) output tile in registers.
#include <cmath>
#include <type_traits>

#include <cuda_runtime.h>

namespace {

constexpr int kBQ = 64;        // query rows per block
constexpr int kBK = 32;        // keys per KV tile
constexpr int kThreads = 256;  // 16 x 16: tx over columns, ty over rows
constexpr int kRowsPer = kBQ / 16;
constexpr int kKeysPer = kBK / 16;

__device__ __forceinline__ float neg_inf() {
  return __int_as_float(0xff800000);
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o,
                       float* __restrict__ lse, int H, int KV, int Sq,
                       int Skv, int causal, float scale) {
  extern __shared__ float smem[];
  float* s_q = smem;                          // [kBQ][HD + 1]
  float* s_kt = s_q + kBQ * (HD + 1);         // [HD][kBK + 1]
  float* s_v = s_kt + HD * (kBK + 1);         // [kBK][HD]
  float* s_p = s_v + kBK * HD;                // [kBQ][kBK + 1]
  float* s_m = s_p + kBQ * (kBK + 1);         // [kBQ]
  float* s_l = s_m + kBQ;                     // [kBQ]
  float* s_alpha = s_l + kBQ;                 // [kBQ]

  const float kNegInf = neg_inf();
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / KV);
  const T* qb = q + ((long long)b * H + h) * Sq * HD;
  const T* kb = k + ((long long)b * KV + kvh) * Skv * HD;
  const T* vb = v + ((long long)b * KV + kvh) * Skv * HD;
  T* ob = o + ((long long)b * H + h) * Sq * HD;

  for (int e = tid; e < kBQ * HD; e += kThreads) {
    const int r = e / HD;
    const int d = e - r * HD;
    s_q[r * (HD + 1) + d] =
        q0 + r < Sq ? to_f32(qb[(long long)(q0 + r) * HD + d]) * scale : 0.0f;
  }
  if (tid < kBQ) {
    s_m[tid] = -1e30f;
    s_l[tid] = 0.0f;
  }
  float acc[kRowsPer][HD / 16];
#pragma unroll
  for (int i = 0; i < kRowsPer; ++i)
#pragma unroll
    for (int j = 0; j < HD / 16; ++j) acc[i][j] = 0.0f;

  // causal: the last key any row of this tile may see
  const int k_end = causal ? min(Skv, q0 + kBQ) : Skv;
  for (int k0 = 0; k0 < k_end; k0 += kBK) {
    __syncthreads();  // the previous tile's K, V and P are consumed
    for (int e = tid; e < kBK * HD; e += kThreads) {
      const int c = e / HD;
      const int d = e - c * HD;
      const bool in = k0 + c < Skv;
      const long long g = (long long)(k0 + c) * HD + d;
      s_kt[d * (kBK + 1) + c] = in ? to_f32(kb[g]) : 0.0f;
      s_v[c * HD + d] = in ? to_f32(vb[g]) : 0.0f;
    }
    __syncthreads();

    // scores: rows ty + 16 i, keys tx + 16 j
    float s[kRowsPer][kKeysPer];
#pragma unroll
    for (int i = 0; i < kRowsPer; ++i)
#pragma unroll
      for (int j = 0; j < kKeysPer; ++j) s[i][j] = 0.0f;
#pragma unroll 8
    for (int d = 0; d < HD; ++d) {
      float qv[kRowsPer], kv[kKeysPer];
#pragma unroll
      for (int i = 0; i < kRowsPer; ++i)
        qv[i] = s_q[(ty + 16 * i) * (HD + 1) + d];
#pragma unroll
      for (int j = 0; j < kKeysPer; ++j)
        kv[j] = s_kt[d * (kBK + 1) + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < kRowsPer; ++i)
#pragma unroll
        for (int j = 0; j < kKeysPer; ++j)
          s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }
#pragma unroll
    for (int i = 0; i < kRowsPer; ++i) {
      const int r = ty + 16 * i;
#pragma unroll
      for (int j = 0; j < kKeysPer; ++j) {
        const int c = tx + 16 * j;
        const bool live = k0 + c < Skv && (!causal || k0 + c <= q0 + r);
        s_p[r * (kBK + 1) + c] = live ? s[i][j] : kNegInf;
      }
    }
    __syncthreads();

    // online softmax, one thread per row
    if (tid < kBQ) {
      float* row = s_p + tid * (kBK + 1);
      const float m_prev = s_m[tid];
      float mx = m_prev;
      for (int c = 0; c < kBK; ++c) mx = fmaxf(mx, row[c]);
      float sum = 0.0f;
      for (int c = 0; c < kBK; ++c) {
        const float p = expf(row[c] - mx);   // masked: exp(-inf) = 0
        row[c] = p;
        sum += p;
      }
      const float alpha = expf(m_prev - mx);
      s_alpha[tid] = alpha;
      s_l[tid] = s_l[tid] * alpha + sum;
      s_m[tid] = mx;
    }
    __syncthreads();

    // acc = acc * alpha + p . v: rows ty + 16 i, columns tx + 16 j
#pragma unroll
    for (int i = 0; i < kRowsPer; ++i) {
      const float alpha = s_alpha[ty + 16 * i];
#pragma unroll
      for (int j = 0; j < HD / 16; ++j) acc[i][j] *= alpha;
    }
    for (int c = 0; c < kBK; ++c) {
      float pv[kRowsPer];
#pragma unroll
      for (int i = 0; i < kRowsPer; ++i)
        pv[i] = s_p[(ty + 16 * i) * (kBK + 1) + c];
#pragma unroll
      for (int j = 0; j < HD / 16; ++j) {
        const float vv = s_v[c * HD + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < kRowsPer; ++i)
          acc[i][j] = fmaf(pv[i], vv, acc[i][j]);
      }
    }
  }
  __syncthreads();
  if (lse != nullptr && tid < kBQ && q0 + tid < Sq)
    lse[((long long)b * H + h) * Sq + q0 + tid] =
        s_m[tid] + logf(fmaxf(s_l[tid], 1e-30f));
#pragma unroll
  for (int i = 0; i < kRowsPer; ++i) {
    const int r = ty + 16 * i;
    if (q0 + r >= Sq) continue;
    const float l = fmaxf(s_l[r], 1e-30f);
#pragma unroll
    for (int j = 0; j < HD / 16; ++j)
      store(&ob[(long long)(q0 + r) * HD + tx + 16 * j], acc[i][j] / l);
  }
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           int B, int H, int KV, int Sq, int Skv, int causal,
           cudaStream_t stream) {
  const size_t smem = sizeof(float) * (kBQ * (HD + 1) + HD * (kBK + 1)
                                       + kBK * HD + kBQ * (kBK + 1) + 3 * kBQ);
  auto kernel = flash_attention_kernel<T, HD>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid((Sq + kBQ - 1) / kBQ, H, B);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), lse, H, KV, Sq, Skv,
      causal,
      static_cast<float>(1.0 / std::sqrt(static_cast<double>(HD))));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* o, float* lse,
             int B, int H, int KV, int Sq, int Skv, int hd, int causal,
             cudaStream_t stream) {
  if (B <= 0 || H <= 0 || Sq <= 0) return static_cast<int>(cudaGetLastError());
  if (KV <= 0 || H % KV != 0 || Skv <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  auto run = [&](auto hd_tag) {
    return launch<T, decltype(hd_tag)::value>(q, k, v, o, lse, B, H, KV, Sq,
                                               Skv, causal, stream);
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

extern "C" int flash_attention_f32(const void* q, const void* k,
                                   const void* v, void* o, float* lse, int B,
                                   int H, int KV, int Sq, int Skv, int hd,
                                   int causal, cudaStream_t stream) {
  return dispatch<float>(q, k, v, o, lse, B, H, KV, Sq, Skv, hd, causal,
                         stream);
}
