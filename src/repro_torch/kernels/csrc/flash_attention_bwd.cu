// Causal or full GQA attention backward (dQ, dK, dV) on the CUDA cores, in
// float32 from float32 or bfloat16 inputs.
//
// Replaces the backward of src/repro/kernels/ops.py's flash_attention
// (the custom_vjp at :29-60, whose _flash_bwd_rule recomputes through the
// jnp online softmax); the reference has no Pallas backward kernel.  q,
// o, do (B, H, Sq, hd); k, v (B, KV, Skv, hd), H % KV == 0; q head h reads
// kv head h / (H / KV) by index, so dk/dv (B, KV, Skv, hd) are summed over
// the H / KV query heads of each group and K/V are never repeated.  With s
// = hd^-0.5 and the causal mask by absolute position (k_pos <= q_pos, as
// the forward):
//   S   = Q K^T s;  lse = logsumexp_row(S);  P = exp(S - lse)
//   D   = rowsum(dO o O)
//   dV  = P^T dO;   dP = dO V^T;   dS = P o (dP - D)
//   dQ  = dS K s;   dK = dS^T Q s
// Every product and sum is float32; outputs are rounded once to the input
// dtype.  Two kernels, deterministic, no atomics:
//   * flash_bwd_dq_kernel, one block per (64 query rows, head, batch row):
//     pass 1 recomputes each row's logsumexp over the KV tiles (an online
//     max and sum, reduced over the 16 lanes of a row by shuffles), and
//     D from O and dO; pass 2 recomputes S and dP a tile at a time, forms
//     dS in shared memory and sums dQ in registers.  It writes lse and D
//     (float32 scratch, 2 x B x H x Sq) for the next kernel;
//   * flash_bwd_dkv_kernel, one block per (kBKV keys, kv head, batch row):
//     holds its K and V tile, loops over the group's query heads and the
//     q tiles of 32 rows, recomputes P^T and dS^T from lse and D, and sums
//     dK and dV in registers.
// Both skip the tiles that the causal mask empties.  256 threads as 16 x
// 16: a thread holds 4 (or 2) rows x 2 columns of each score tile and 4
// (or 2) rows x hd / 16 columns of each accumulator; every tile in shared
// memory is padded by one column, so no warp meets a bank conflict.
//
// Bound on the H100: operations.  Five products of the unmasked tiles
// (S, dP, dV, dQ, dK; 2 x B x H x Sq x Skv x hd FLOP each when full, about
// half when causal); the kernels do eight, recomputing S twice and dP
// twice, on the CUDA cores (67 TFLOP/s f32) rather than the tensor cores
// (989 bf16).  bfloat16 at head dims 64 and 128 -- every model the port
// trains -- takes the redesign in flash_attention_bwd_bf16.cu instead
// (wgmma on TMA-fed tiles, lse written by the forward kernel); these
// kernels stay for float32, where no tensor-core type keeps a full f32
// product, and for bfloat16 at head dims 16, 32 and 256.
#include <cmath>
#include <type_traits>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;  // 16 x 16: tx over columns, ty over rows
constexpr int kBQ = 64;        // dq kernel: query rows a block
constexpr int kBK = 32;        // dq kernel: keys a KV tile
constexpr int kBQ2 = 32;       // dkv kernel: query rows a q tile

template <int HD>
struct Dkv {
  static constexpr int kBKV = HD >= 256 ? 32 : 64;  // keys a block
};

__device__ __forceinline__ float neg_inf() {
  return __int_as_float(0xff800000);
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// reductions over the 16 lanes of one row (tx = lane % 16)
__device__ __forceinline__ float row_max(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ o,
                    const T* __restrict__ dout, T* __restrict__ dq,
                    float* __restrict__ lse_out, float* __restrict__ d_out,
                    int H, int KV, int Sq, int Skv, int causal, float scale) {
  constexpr int kR = kBQ / 16;   // rows a thread
  constexpr int kC = kBK / 16;   // keys a thread
  constexpr int kD = HD / 16;    // head-dim columns a thread
  constexpr int kLdQ = HD + 1;
  constexpr int kLdK = kBK + 1;
  extern __shared__ float smem[];
  float* s_q = smem;                     // [kBQ][HD + 1]
  float* s_do = s_q + kBQ * kLdQ;        // [kBQ][HD + 1]
  float* s_kt = s_do + kBQ * kLdQ;       // [HD][kBK + 1]
  float* s_vt = s_kt + HD * kLdK;        // [HD][kBK + 1]
  float* s_ds = s_vt + HD * kLdK;        // [kBQ][kBK + 1]

  const float kNegInf = neg_inf();
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / KV);
  const long long qoff = ((long long)b * H + h) * Sq;
  const T* qb = q + qoff * HD;
  const T* ob = o + qoff * HD;
  const T* dob = dout + qoff * HD;
  const T* kb = k + ((long long)b * KV + kvh) * Skv * HD;
  const T* vb = v + ((long long)b * KV + kvh) * Skv * HD;

  for (int e = tid; e < kBQ * HD; e += kThreads) {
    const int r = e / HD;
    const int d = e - r * HD;
    const bool in = q0 + r < Sq;
    const long long g = (long long)(q0 + r) * HD + d;
    s_q[r * kLdQ + d] = in ? to_f32(qb[g]) : 0.0f;
    s_do[r * kLdQ + d] = in ? to_f32(dob[g]) : 0.0f;
  }
  __syncthreads();

  // D = rowsum(dO o O): each lane its kD columns, then the row's 16 lanes
  float drow[kR];
#pragma unroll
  for (int i = 0; i < kR; ++i) {
    const int r = ty + 16 * i;
    float part = 0.0f;
    if (q0 + r < Sq) {
#pragma unroll
      for (int j = 0; j < kD; ++j) {
        const int d = tx + 16 * j;
        part = fmaf(s_do[r * kLdQ + d],
                    to_f32(ob[(long long)(q0 + r) * HD + d]), part);
      }
    }
    drow[i] = row_sum(part);
  }

  const int k_end = causal ? min(Skv, q0 + kBQ) : Skv;

  // pass 1: each row's logsumexp over the KV tiles
  float m[kR], l[kR];
#pragma unroll
  for (int i = 0; i < kR; ++i) {
    m[i] = -1e30f;
    l[i] = 0.0f;
  }
  for (int k0 = 0; k0 < k_end; k0 += kBK) {
    __syncthreads();  // the previous tile is consumed
    for (int e = tid; e < kBK * HD; e += kThreads) {
      const int c = e / HD;
      const int d = e - c * HD;
      s_kt[d * kLdK + c] =
          k0 + c < Skv ? to_f32(kb[(long long)(k0 + c) * HD + d]) : 0.0f;
    }
    __syncthreads();
    float s[kR][kC];
#pragma unroll
    for (int i = 0; i < kR; ++i)
#pragma unroll
      for (int j = 0; j < kC; ++j) s[i][j] = 0.0f;
#pragma unroll 8
    for (int d = 0; d < HD; ++d) {
      float qv[kR], kv[kC];
#pragma unroll
      for (int i = 0; i < kR; ++i) qv[i] = s_q[(ty + 16 * i) * kLdQ + d];
#pragma unroll
      for (int j = 0; j < kC; ++j) kv[j] = s_kt[d * kLdK + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < kR; ++i)
#pragma unroll
        for (int j = 0; j < kC; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }
#pragma unroll
    for (int i = 0; i < kR; ++i) {
      const int r = q0 + ty + 16 * i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < kC; ++j) {
        const int c = k0 + tx + 16 * j;
        const bool live = c < Skv && (!causal || c <= r);
        s[i][j] = live ? s[i][j] * scale : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max(mx));
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < kC; ++j) sum += expf(s[i][j] - m_new);
      l[i] = l[i] * expf(m[i] - m_new) + row_sum(sum);
      m[i] = m_new;
    }
  }
  float lse[kR];
#pragma unroll
  for (int i = 0; i < kR; ++i) {
    lse[i] = m[i] + logf(l[i]);
    const int r = q0 + ty + 16 * i;
    if (tx == 0 && r < Sq) {
      lse_out[qoff + r] = lse[i];
      d_out[qoff + r] = drow[i];
    }
  }

  // pass 2: dS a tile at a time; dQ += dS K
  float acc[kR][kD];
#pragma unroll
  for (int i = 0; i < kR; ++i)
#pragma unroll
    for (int j = 0; j < kD; ++j) acc[i][j] = 0.0f;
  for (int k0 = 0; k0 < k_end; k0 += kBK) {
    __syncthreads();  // the previous tile's K and dS are consumed
    for (int e = tid; e < kBK * HD; e += kThreads) {
      const int c = e / HD;
      const int d = e - c * HD;
      const bool in = k0 + c < Skv;
      const long long g = (long long)(k0 + c) * HD + d;
      s_kt[d * kLdK + c] = in ? to_f32(kb[g]) : 0.0f;
      s_vt[d * kLdK + c] = in ? to_f32(vb[g]) : 0.0f;
    }
    __syncthreads();
    float s[kR][kC], dp[kR][kC];
#pragma unroll
    for (int i = 0; i < kR; ++i)
#pragma unroll
      for (int j = 0; j < kC; ++j) s[i][j] = dp[i][j] = 0.0f;
#pragma unroll 4
    for (int d = 0; d < HD; ++d) {
      float qv[kR], dov[kR], kv[kC], vv[kC];
#pragma unroll
      for (int i = 0; i < kR; ++i) {
        qv[i] = s_q[(ty + 16 * i) * kLdQ + d];
        dov[i] = s_do[(ty + 16 * i) * kLdQ + d];
      }
#pragma unroll
      for (int j = 0; j < kC; ++j) {
        kv[j] = s_kt[d * kLdK + tx + 16 * j];
        vv[j] = s_vt[d * kLdK + tx + 16 * j];
      }
#pragma unroll
      for (int i = 0; i < kR; ++i)
#pragma unroll
        for (int j = 0; j < kC; ++j) {
          s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
          dp[i][j] = fmaf(dov[i], vv[j], dp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < kR; ++i) {
      const int r = ty + 16 * i;
#pragma unroll
      for (int j = 0; j < kC; ++j) {
        const int c = tx + 16 * j;
        const bool live = k0 + c < Skv && (!causal || k0 + c <= q0 + r);
        const float p = live ? expf(s[i][j] * scale - lse[i]) : 0.0f;
        s_ds[r * kLdK + c] = p * (dp[i][j] - drow[i]);
      }
    }
    __syncthreads();
    for (int c = 0; c < kBK; ++c) {
      float dsv[kR];
#pragma unroll
      for (int i = 0; i < kR; ++i) dsv[i] = s_ds[(ty + 16 * i) * kLdK + c];
#pragma unroll
      for (int j = 0; j < kD; ++j) {
        const float kk = s_kt[(tx + 16 * j) * kLdK + c];
#pragma unroll
        for (int i = 0; i < kR; ++i) acc[i][j] = fmaf(dsv[i], kk, acc[i][j]);
      }
    }
  }
  T* dqb = dq + qoff * HD;
#pragma unroll
  for (int i = 0; i < kR; ++i) {
    const int r = q0 + ty + 16 * i;
    if (r >= Sq) continue;
#pragma unroll
    for (int j = 0; j < kD; ++j)
      store(&dqb[(long long)r * HD + tx + 16 * j], acc[i][j] * scale);
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse_in,
                     const float* __restrict__ d_in, T* __restrict__ dk,
                     T* __restrict__ dv, int H, int KV, int Sq, int Skv,
                     int causal, float scale) {
  constexpr int kBKV = Dkv<HD>::kBKV;
  constexpr int kR = kBKV / 16;   // keys a thread
  constexpr int kC = kBQ2 / 16;   // query rows a thread
  constexpr int kD = HD / 16;     // head-dim columns a thread
  constexpr int kLdK = HD + 1;
  constexpr int kLdQ = kBQ2 + 1;
  extern __shared__ float smem[];
  float* s_k = smem;                     // [kBKV][HD + 1]
  float* s_v = s_k + kBKV * kLdK;        // [kBKV][HD + 1]
  float* s_qt = s_v + kBKV * kLdK;       // [HD][kBQ2 + 1]
  float* s_dot = s_qt + HD * kLdQ;       // [HD][kBQ2 + 1]
  float* s_pt = s_dot + HD * kLdQ;       // [kBKV][kBQ2 + 1]
  float* s_dst = s_pt + kBKV * kLdQ;     // [kBKV][kBQ2 + 1]
  float* s_lse = s_dst + kBKV * kLdQ;    // [kBQ2]
  float* s_dd = s_lse + kBQ2;            // [kBQ2]

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int k0 = blockIdx.x * kBKV;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int G = H / KV;
  const long long koff = ((long long)b * KV + kvh) * Skv;
  const T* kb = k + koff * HD;
  const T* vb = v + koff * HD;

  for (int e = tid; e < kBKV * HD; e += kThreads) {
    const int c = e / HD;
    const int d = e - c * HD;
    const bool in = k0 + c < Skv;
    const long long g = (long long)(k0 + c) * HD + d;
    s_k[c * kLdK + d] = in ? to_f32(kb[g]) : 0.0f;
    s_v[c * kLdK + d] = in ? to_f32(vb[g]) : 0.0f;
  }
  float dka[kR][kD], dva[kR][kD];
#pragma unroll
  for (int i = 0; i < kR; ++i)
#pragma unroll
    for (int j = 0; j < kD; ++j) dka[i][j] = dva[i][j] = 0.0f;

  // causal: rows below the tile's first key see none of it
  const int q_begin = causal ? (k0 / kBQ2) * kBQ2 : 0;
  for (int g = 0; g < G; ++g) {
    const long long qoff = ((long long)b * H + kvh * G + g) * Sq;
    const T* qb = q + qoff * HD;
    const T* dob = dout + qoff * HD;
    for (int q0 = q_begin; q0 < Sq; q0 += kBQ2) {
      __syncthreads();  // the previous q tile is consumed
      for (int e = tid; e < kBQ2 * HD; e += kThreads) {
        const int r = e / HD;
        const int d = e - r * HD;
        const bool in = q0 + r < Sq;
        const long long gi = (long long)(q0 + r) * HD + d;
        s_qt[d * kLdQ + r] = in ? to_f32(qb[gi]) : 0.0f;
        s_dot[d * kLdQ + r] = in ? to_f32(dob[gi]) : 0.0f;
      }
      if (tid < kBQ2) {
        const bool in = q0 + tid < Sq;
        s_lse[tid] = in ? lse_in[qoff + q0 + tid] : 0.0f;
        s_dd[tid] = in ? d_in[qoff + q0 + tid] : 0.0f;
      }
      __syncthreads();
      // S^T and dP^T: keys ty + 16 i, query rows tx + 16 j
      float st[kR][kC], dpt[kR][kC];
#pragma unroll
      for (int i = 0; i < kR; ++i)
#pragma unroll
        for (int j = 0; j < kC; ++j) st[i][j] = dpt[i][j] = 0.0f;
#pragma unroll 4
      for (int d = 0; d < HD; ++d) {
        float kv[kR], vv[kR], qv[kC], dov[kC];
#pragma unroll
        for (int i = 0; i < kR; ++i) {
          kv[i] = s_k[(ty + 16 * i) * kLdK + d];
          vv[i] = s_v[(ty + 16 * i) * kLdK + d];
        }
#pragma unroll
        for (int j = 0; j < kC; ++j) {
          qv[j] = s_qt[d * kLdQ + tx + 16 * j];
          dov[j] = s_dot[d * kLdQ + tx + 16 * j];
        }
#pragma unroll
        for (int i = 0; i < kR; ++i)
#pragma unroll
          for (int j = 0; j < kC; ++j) {
            st[i][j] = fmaf(kv[i], qv[j], st[i][j]);
            dpt[i][j] = fmaf(vv[i], dov[j], dpt[i][j]);
          }
      }
#pragma unroll
      for (int i = 0; i < kR; ++i) {
        const int c = ty + 16 * i;
#pragma unroll
        for (int j = 0; j < kC; ++j) {
          const int r = tx + 16 * j;
          const bool live = k0 + c < Skv && q0 + r < Sq &&
                            (!causal || k0 + c <= q0 + r);
          const float p = live ? expf(st[i][j] * scale - s_lse[r]) : 0.0f;
          s_pt[c * kLdQ + r] = p;
          s_dst[c * kLdQ + r] = p * (dpt[i][j] - s_dd[r]);
        }
      }
      __syncthreads();
      // dV += P^T dO;  dK += dS^T Q: keys ty + 16 i, columns tx + 16 j
      for (int r = 0; r < kBQ2; ++r) {
        float pv[kR], dsv[kR];
#pragma unroll
        for (int i = 0; i < kR; ++i) {
          pv[i] = s_pt[(ty + 16 * i) * kLdQ + r];
          dsv[i] = s_dst[(ty + 16 * i) * kLdQ + r];
        }
#pragma unroll
        for (int j = 0; j < kD; ++j) {
          const float dov = s_dot[(tx + 16 * j) * kLdQ + r];
          const float qv = s_qt[(tx + 16 * j) * kLdQ + r];
#pragma unroll
          for (int i = 0; i < kR; ++i) {
            dva[i][j] = fmaf(pv[i], dov, dva[i][j]);
            dka[i][j] = fmaf(dsv[i], qv, dka[i][j]);
          }
        }
      }
    }
  }
  T* dkb = dk + koff * HD;
  T* dvb = dv + koff * HD;
#pragma unroll
  for (int i = 0; i < kR; ++i) {
    const int c = k0 + ty + 16 * i;
    if (c >= Skv) continue;
#pragma unroll
    for (int j = 0; j < kD; ++j) {
      const long long gi = (long long)c * HD + tx + 16 * j;
      store(&dkb[gi], dka[i][j] * scale);
      store(&dvb[gi], dva[i][j]);
    }
  }
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, const void* o,
           const void* dout, void* dq, void* dk, void* dv, float* scratch,
           int B, int H, int KV, int Sq, int Skv, int causal,
           cudaStream_t stream) {
  const float scale =
      static_cast<float>(1.0 / std::sqrt(static_cast<double>(HD)));
  float* lse = scratch;
  float* dd = scratch + (long long)B * H * Sq;
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* dot = static_cast<const T*>(dout);

  const size_t smem1 = sizeof(float) * (2 * kBQ * (HD + 1)
                                        + 2 * HD * (kBK + 1)
                                        + kBQ * (kBK + 1));
  auto k1 = flash_bwd_dq_kernel<T, HD>;
  cudaError_t e = allow_smem(k1, smem1);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (Sq > 0) {  // Sq == 0: no dq; the dkv kernel writes zeros
    k1<<<dim3((Sq + kBQ - 1) / kBQ, H, B), kThreads, smem1, stream>>>(
        qt, kt, vt, static_cast<const T*>(o), dot, static_cast<T*>(dq), lse,
        dd, H, KV, Sq, Skv, causal, scale);
    e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }

  constexpr int kBKV = Dkv<HD>::kBKV;
  const size_t smem2 = sizeof(float) * (2 * kBKV * (HD + 1)
                                        + 2 * HD * (kBQ2 + 1)
                                        + 2 * kBKV * (kBQ2 + 1) + 2 * kBQ2);
  auto k2 = flash_bwd_dkv_kernel<T, HD>;
  e = allow_smem(k2, smem2);
  if (e != cudaSuccess) return static_cast<int>(e);
  k2<<<dim3((Skv + kBKV - 1) / kBKV, KV, B), kThreads, smem2, stream>>>(
      qt, kt, vt, dot, lse, dd, static_cast<T*>(dk), static_cast<T*>(dv), H,
      KV, Sq, Skv, causal, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, const void* o,
             const void* dout, void* dq, void* dk, void* dv, float* scratch,
             int B, int H, int KV, int Sq, int Skv, int hd, int causal,
             cudaStream_t stream) {
  if (B <= 0 || H <= 0) return static_cast<int>(cudaGetLastError());
  if (KV <= 0 || H % KV != 0 || Skv <= 0 || Sq < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  auto run = [&](auto hd_tag) {
    return launch<T, decltype(hd_tag)::value>(q, k, v, o, dout, dq, dk, dv,
                                               scratch, B, H, KV, Sq, Skv,
                                               causal, stream);
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

extern "C" int flash_attention_bwd_f32(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, void* dq, void* dk, void* dv, float* scratch, int B,
    int H, int KV, int Sq, int Skv, int hd, int causal, cudaStream_t stream) {
  return dispatch<float>(q, k, v, o, dout, dq, dk, dv, scratch, B, H, KV, Sq,
                         Skv, hd, causal, stream);
}

extern "C" int flash_attention_bwd_bf16(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, void* dq, void* dk, void* dv, float* scratch, int B,
    int H, int KV, int Sq, int Skv, int hd, int causal, cudaStream_t stream) {
  return dispatch<__nv_bfloat16>(q, k, v, o, dout, dq, dk, dv, scratch, B, H,
                                 KV, Sq, Skv, hd, causal, stream);
}
