// The backward of the RWKV-6 WKV recurrence (csrc/rwkv6_wkv.cu): per
// (batch row, head), the gradients of a loss with respect to r, k, v, w, u
// and s0, given its gradients do (every step's output) and ds_last (the
// last state).
//
// Replaces no Pallas kernel: the reference's forward kernel
// (src/repro/kernels/rwkv6_scan.py) has no backward, and its model takes
// the gradient of its lax.scan (src/repro/models/rwkv6.py:88, _wkv_scan)
// by autodiff.  r, k, v, w, do, dr, dk, dv, dw (B, T, H, hd), u and du
// (H, hd), s0, ds_last and ds0 (B, H, hd, hd) indexed (k index i, v
// index j), all float32.  With G_t = dL/dS_t (the state after step t),
// G_T = ds_last, dot_t = do_t . v_t and a_t = sum_i r_t[i] u[i] k_t[i],
// going back over t:
//   dr_t[i] = sum_j S_{t-1}[i][j] do_t[j] + u[i] k_t[i] dot_t
//   dk_t[i] = sum_j G_t[i][j] v_t[j]      + u[i] r_t[i] dot_t
//   dw_t[i] = sum_j G_t[i][j] S_{t-1}[i][j]
//   dv_t[j] = sum_i G_t[i][j] k_t[i]      + a_t do_t[j]
//   du[i]  += r_t[i] k_t[i] dot_t          (over t and the batch rows)
//   G_{t-1}[i][j] = w_t[i] G_t[i][j] + r_t[i] do_t[j]
// and ds0 = G_0.  S_{t-1} is recomputed forward, never rebuilt from S_t by
// dividing by w_t: exp(-exp(wlog)) is exactly 0 in float32 for wlog above
// ~4.65, where the gradient is finite.
//
// Bound on the H100: operations.  A step and head takes ~14 hd^2 (the
// recomputed state update 3, the G update 3, four products with the state
// 2 each) against 9 f32 streams of hd, so at hd = 64 it is 14 x 64 / 36 =
// 25 operations a byte, above the card's 20 (67 TFLOP/s over 3.35 TB/s).
//
// Design.  Rows of the state are independent in S and in G (row i of
// both needs only w_t[i], k_t[i], r_t[i] and whole v_t, do_t), so:
// - Blocks: a head's hd rows go to hd / 16 independent blocks of 16 rows
//   (4 at hd = 64: B = 4, H = 40 is 640 blocks).  dr, dk and dw are sums
//   over a row's columns and so are complete in the block; dv is a sum
//   over rows, so each block writes its partial (with its rows' share of
//   a_t) and a second kernel sums the partials in row-block order, and
//   du's partials (one a batch row) in batch order.  No atomics: two
//   calls give the same bits.
// - Threads: 8 warps, 2 rows a warp, 16 lanes a row, each lane hd / 16
//   neighbouring columns of its row of S and of G in registers.  A row's
//   sums over its columns are butterflies over its 16 lanes; dv's sums
//   over rows a shuffle between the warp's two rows, then, once a chunk,
//   the 8 warps' partials summed in warp order from shared memory.
// - States: the backward keeps the state before every kChunk-th step (16
//   at hd = 64) in a scratch buffer; a checkpoint pass inside this kernel
//   computes them (each block for its own rows, before its reverse
//   sweep), rather than the forward kernel storing them.  Chosen so that
//   the serving kernel and its bits stay as they are, and so that the
//   autograd Function saves only its inputs (with remat the forward runs
//   twice, and only the second run's saves would be used).  Every 5.4 GB
//   of states at L1's call would not fit beside the model; the
//   checkpoints are 335 MB.  The reverse sweep then takes the chunks in
//   reverse: each chunk's states are recomputed from its checkpoint into
//   registers (kChunk x hd / 16 = 64 a thread, the loops unrolled), and
//   the chunk is swept back from them.
// - Loads: a chunk's step rows (r, k, w: the block's 16 rows; v, do: all
//   hd columns) are copied to shared memory in 16-byte loads by all
//   threads, the per-step dot_t and the block's share of a_t computed
//   there once by a warp a step.
#include <type_traits>

#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kRows = 16;                 // state rows a block
constexpr int kWarps = 8;                 // 2 rows a warp, 16 lanes a row
constexpr int kThreads = 32 * kWarps;

// CPT columns a lane, kChunk steps a chunk (the states a lane keeps for
// one chunk: kChunk x CPT registers), RB row blocks a head; shared memory
// in floats: a chunk's step rows (ROW floats a step), per-step dot and
// a_t share, dr, dk and dw of the chunk, the warps' dv partials, u's rows
template <int HD>
struct Shape {
  static constexpr int CPT = HD / 16;
  static constexpr int kChunk = HD >= 64 ? 1024 / HD : 32;
  static constexpr int RB = HD / kRows;
  static constexpr int ROW = 3 * kRows + 2 * HD;
  static constexpr int TILE = kChunk * ROW;
  static constexpr int OUT = 3 * kChunk * kRows;
  static constexpr int DV = kChunk * kWarps * HD;
  static constexpr int SMEM = TILE + 2 * kChunk + OUT + DV + kRows;
};

template <int N>
__device__ __forceinline__ void load_n(float (&x)[N], const float* p) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int i = 0; i < N; i += 4) {
      const float4 q = *reinterpret_cast<const float4*>(p + i);
      x[i] = q.x; x[i + 1] = q.y; x[i + 2] = q.z; x[i + 3] = q.w;
    }
  } else if constexpr (N == 2) {
    const float2 q = *reinterpret_cast<const float2*>(p);
    x[0] = q.x; x[1] = q.y;
  } else {
    x[0] = p[0];
  }
}

template <int N>
__device__ __forceinline__ void store_n(float* p, const float (&x)[N]) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int i = 0; i < N; i += 4) {
      *reinterpret_cast<float4*>(p + i) =
          make_float4(x[i], x[i + 1], x[i + 2], x[i + 3]);
    }
  } else if constexpr (N == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(x[0], x[1]);
  } else {
    p[0] = x[0];
  }
}

__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int m = 8; m >= 1; m >>= 1) x += __shfl_xor_sync(kFull, x, m);
  return x;
}

// steps t0 .. t0 + cnt - 1 of the block's rows of r, k, w and all columns
// of v and do into `tile` (ROW floats a step: r, k, w, v, do); the
// checkpoint pass (ALL = false) reads only k, w and v
template <int HD, bool ALL>
__device__ __forceinline__ void load_tile(
    float* tile, const float* r, const float* k, const float* v,
    const float* w, const float* dout, long long base, long long step,
    int row0, int cnt) {
  using S = Shape<HD>;
  constexpr int QR = kRows / 4;           // float4s of a row stream a step
  constexpr int QC = HD / 4;              // ... of a column stream
  constexpr int Q = 3 * QR + 2 * QC;
  for (int q = threadIdx.x; q < cnt * Q; q += kThreads) {
    const int tt = q / Q;
    int e = q % Q;
    const long long o = base + tt * step;
    const float* src;
    float* dst = tile + tt * S::ROW;
    if (e < 3 * QR) {
      const int s = e / QR;
      if (!ALL && s == 0) continue;
      src = (s == 0 ? r : s == 1 ? k : w) + o + row0 + 4 * (e % QR);
      dst += s * kRows + 4 * (e % QR);
    } else {
      e -= 3 * QR;
      const int s = e / QC;
      if (!ALL && s == 1) continue;
      src = (s == 0 ? v : dout) + o + 4 * (e % QC);
      dst += 3 * kRows + s * HD + 4 * (e % QC);
    }
    *reinterpret_cast<float4*>(dst) =
        __ldg(reinterpret_cast<const float4*>(src));
  }
}

template <int HD>
__global__ void __launch_bounds__(kThreads)
rwkv6_wkv_bwd_kernel(const float* __restrict__ r, const float* __restrict__ k,
                     const float* __restrict__ v, const float* __restrict__ w,
                     const float* __restrict__ u, const float* __restrict__ s0,
                     const float* __restrict__ dout,
                     const float* __restrict__ ds_last,
                     float* __restrict__ dr, float* __restrict__ dk,
                     float* __restrict__ dv_out, float* __restrict__ dw,
                     float* __restrict__ ds0, float* __restrict__ ckpt,
                     float* __restrict__ du_part, long long part_stride,
                     int T, int H) {
  using S = Shape<HD>;
  constexpr int CPT = S::CPT, L = S::kChunk, ROW = S::ROW;
  extern __shared__ __align__(16) float smem[];
  float* tile = smem;                       // L x ROW
  float* dotv = tile + S::TILE;             // L: do_t . v_t
  float* apart = dotv + L;                  // L: the block's share of a_t
  float* outs = apart + L;                  // 3 x L x kRows: dr, dk, dw
  float* dvs = outs + S::OUT;               // L x kWarps x HD
  float* us = dvs + S::DV;                  // kRows: u's rows

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int rb = blockIdx.x % S::RB;        // row block of this head
  const int h = blockIdx.x / S::RB;
  const int b = blockIdx.y;
  const int il = 2 * warp + (lane >> 4);    // the lane's row in the block
  const int row0 = rb * kRows;
  const int c0 = (lane & 15) * CPT;         // its first column
  const bool lead = (lane & 15) == 0;       // writes its row's sums
  dv_out += rb * part_stride;               // this row block's dv partial
  const int n_chunks = (T + L - 1) / L;
  const long long step = static_cast<long long>(H) * HD;   // stride of t
  const long long bt0 = (static_cast<long long>(b) * T * H + h) * HD;
  const long long srow = ((static_cast<long long>(b) * H + h) * HD + row0 +
                          il) * HD + c0;    // the lane's state elements
  float* ck = ckpt + (static_cast<long long>(b) * H + h) * n_chunks * HD * HD
              + (row0 + il) * HD + c0;      // ... in checkpoint 0

  if (threadIdx.x < kRows) us[threadIdx.x] = u[h * HD + row0 + threadIdx.x];
  __syncthreads();

  // checkpoint pass: the state before each chunk's first step
  float st[CPT];
  load_n(st, s0 + srow);
  for (int n = 0; n + 1 < n_chunks; ++n) {
    store_n(ck + static_cast<long long>(n) * HD * HD, st);
    load_tile<HD, false>(tile, r, k, v, w, dout, bt0 + n * L * step, step,
                         row0, L);
    __syncthreads();
#pragma unroll
    for (int tt = 0; tt < L; ++tt) {
      const float* row = tile + tt * ROW;
      const float kk = row[kRows + il], ww = row[2 * kRows + il];
      float vv[CPT];
      load_n(vv, row + 3 * kRows + c0);
#pragma unroll
      for (int c = 0; c < CPT; ++c) st[c] = fmaf(ww, st[c], kk * vv[c]);
    }
    __syncthreads();
  }
  store_n(ck + static_cast<long long>(n_chunks - 1) * HD * HD, st);

  // the reverse sweep, a chunk at a time from the last
  float g[CPT];
  load_n(g, ds_last + srow);
  const float ui = us[il];
  float du_acc = 0.0f;
  for (int n = n_chunks - 1; n >= 0; --n) {
    const int t0 = n * L;
    const int cnt = min(L, T - t0);
    const long long base = bt0 + t0 * step;
    load_n(st, ck + static_cast<long long>(n) * HD * HD);
    load_tile<HD, true>(tile, r, k, v, w, dout, base, step, row0, cnt);
    __syncthreads();
    // per step: do_t . v_t over all columns, and sum_i r u k over the
    // block's rows, a warp a step, each summed as a butterfly
    for (int tt = warp; tt < cnt; tt += kWarps) {
      const float* row = tile + tt * ROW;
      float d = 0.0f;
#pragma unroll
      for (int j = lane; j < HD; j += 32) {
        d = fmaf(row[3 * kRows + HD + j], row[3 * kRows + j], d);
      }
      float a = lane < kRows ? row[lane] * us[lane] * row[kRows + lane]
                             : 0.0f;
#pragma unroll
      for (int m = 16; m >= 1; m >>= 1) {
        d += __shfl_xor_sync(kFull, d, m);
        a += __shfl_xor_sync(kFull, a, m);
      }
      if (lane == 0) {
        dotv[tt] = d;
        apart[tt] = a;
      }
    }
    __syncthreads();
    // the chunk's states S_{t-1}, recomputed from its checkpoint
    float hist[L][CPT];
#pragma unroll
    for (int tt = 0; tt < L; ++tt) {
      if (tt < cnt) {
#pragma unroll
        for (int c = 0; c < CPT; ++c) hist[tt][c] = st[c];
        if (tt + 1 < cnt) {
          const float* row = tile + tt * ROW;
          const float kk = row[kRows + il], ww = row[2 * kRows + il];
          float vv[CPT];
          load_n(vv, row + 3 * kRows + c0);
#pragma unroll
          for (int c = 0; c < CPT; ++c) st[c] = fmaf(ww, st[c], kk * vv[c]);
        }
      }
    }
    // back over the chunk
#pragma unroll
    for (int tt = L - 1; tt >= 0; --tt) {
      if (tt < cnt) {
        const float* row = tile + tt * ROW;
        const float rr = row[il], kk = row[kRows + il],
                    ww = row[2 * kRows + il];
        float vv[CPT], dd[CPT], dvp[CPT];
        load_n(vv, row + 3 * kRows + c0);
        load_n(dd, row + 3 * kRows + HD + c0);
        float pr = 0.0f, pk = 0.0f, pw = 0.0f;
#pragma unroll
        for (int c = 0; c < CPT; ++c) {
          pr = fmaf(hist[tt][c], dd[c], pr);
          pk = fmaf(g[c], vv[c], pk);
          pw = fmaf(g[c], hist[tt][c], pw);
          dvp[c] = g[c] * kk;
          g[c] = fmaf(ww, g[c], rr * dd[c]);
        }
        pr = row_sum(pr);
        pk = row_sum(pk);
        pw = row_sum(pw);
#pragma unroll
        for (int c = 0; c < CPT; ++c) {
          dvp[c] += __shfl_xor_sync(kFull, dvp[c], 16);
        }
        if (lane < 16) store_n(dvs + (tt * kWarps + warp) * HD + c0, dvp);
        if (lead) {
          const float dt = dotv[tt];
          outs[tt * kRows + il] = fmaf(ui * kk, dt, pr);
          outs[(L + tt) * kRows + il] = fmaf(ui * rr, dt, pk);
          outs[(2 * L + tt) * kRows + il] = pw;
          du_acc = fmaf(rr * kk, dt, du_acc);
        }
      }
    }
    __syncthreads();
    // the chunk's dr, dk, dw rows, and dv's partial (the 8 warps' sums in
    // warp order, and this block's share of a_t do_t)
    for (int q = threadIdx.x; q < 3 * cnt * kRows; q += kThreads) {
      const int which = q / (cnt * kRows);
      const int tt = q % (cnt * kRows) / kRows;
      const int i = q % kRows;
      float* dst = which == 0 ? dr : which == 1 ? dk : dw;
      dst[base + tt * step + row0 + i] = outs[(which * L + tt) * kRows + i];
    }
    for (int q = threadIdx.x; q < cnt * HD; q += kThreads) {
      const int tt = q / HD, j = q % HD;
      float s = 0.0f;
#pragma unroll
      for (int wp = 0; wp < kWarps; ++wp) {
        s += dvs[(tt * kWarps + wp) * HD + j];
      }
      dv_out[base + tt * step + j] =
          fmaf(apart[tt], tile[tt * ROW + 3 * kRows + HD + j], s);
    }
    __syncthreads();
  }
  store_n(ds0 + srow, g);
  if (lead) {
    du_part[(static_cast<long long>(b) * H + h) * HD + row0 + il] = du_acc;
  }
}

// dv = the sum of the RB row blocks' partials in block order (when RB >
// 1), du = the sum of the B batch rows' partials in batch order
__global__ void rwkv6_wkv_bwd_sum_kernel(const float* __restrict__ dv_part,
                                         float* __restrict__ dv,
                                         const float* __restrict__ du_part,
                                         float* __restrict__ du,
                                         long long n_dv4, int rb, int B,
                                         int n_du) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long q = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       q < n_dv4 || q < n_du; q += stride) {
    if (q < n_dv4) {
      float4 s = __ldg(reinterpret_cast<const float4*>(dv_part) + q);
      for (int p = 1; p < rb; ++p) {
        const float4 x =
            __ldg(reinterpret_cast<const float4*>(dv_part) + p * n_dv4 + q);
        s.x += x.x; s.y += x.y; s.z += x.z; s.w += x.w;
      }
      reinterpret_cast<float4*>(dv)[q] = s;
    }
    if (q < n_du) {
      float s = du_part[q];
      for (int bb = 1; bb < B; ++bb) {
        s += du_part[bb * static_cast<long long>(n_du) + q];
      }
      du[q] = s;
    }
  }
}

template <int HD>
int launch(const float* r, const float* k, const float* v, const float* w,
           const float* u, const float* s0, const float* dout,
           const float* ds_last, float* dr, float* dk, float* dv, float* dw,
           float* du, float* ds0, float* scratch, long long n_scratch, int B,
           int T, int H, cudaStream_t stream) {
  using S = Shape<HD>;
  const long long n_chunks = (T + S::kChunk - 1) / S::kChunk;
  const long long n_ckpt = static_cast<long long>(B) * H * n_chunks * HD * HD;
  const long long n_dv = static_cast<long long>(B) * T * H * HD;
  const long long n_part = S::RB > 1 ? S::RB * n_dv : 0;
  const long long n_du = static_cast<long long>(B) * H * HD;
  if (n_scratch < n_ckpt + n_part + n_du) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  float* ckpt = scratch;
  float* dv_part = S::RB > 1 ? scratch + n_ckpt : dv;
  float* du_part = scratch + n_ckpt + n_part;
  const int smem = S::SMEM * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(
      rwkv6_wkv_bwd_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(H * S::RB, B);
  rwkv6_wkv_bwd_kernel<HD><<<grid, kThreads, smem, stream>>>(
      r, k, v, w, u, s0, dout, ds_last, dr, dk, dv_part, dw, ds0, ckpt,
      du_part, S::RB > 1 ? n_dv : 0, T, H);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  // the partials of every row block, summed where the kernel left them
  // (with RB = 1 it wrote dv itself)
  const long long n_dv4 = S::RB > 1 ? n_dv / 4 : 0;
  const long long work = n_dv4 > H * HD ? n_dv4 : H * HD;
  const int blocks = static_cast<int>(work / 256 + 1 < 132 * 16
                                          ? work / 256 + 1 : 132 * 16);
  rwkv6_wkv_bwd_sum_kernel<<<blocks, 256, 0, stream>>>(
      dv_part, dv, du_part, du, n_dv4, S::RB, B, H * HD);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int rwkv6_wkv_bwd_f32(const void* r, const void* k, const void* v,
                                 const void* w, const void* u, const void* s0,
                                 const void* dout, const void* ds_last,
                                 void* dr, void* dk, void* dv, void* dw,
                                 void* du, void* ds0, void* scratch,
                                 long long n_scratch, int B, int T, int H,
                                 int hd, cudaStream_t stream) {
  if (B <= 0 || H <= 0) return static_cast<int>(cudaGetLastError());
  if (T <= 0 || B > 65535) return static_cast<int>(cudaErrorInvalidValue);
  auto run = [&](auto hd_tag) {
    return launch<decltype(hd_tag)::value>(
        static_cast<const float*>(r), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<const float*>(w),
        static_cast<const float*>(u), static_cast<const float*>(s0),
        static_cast<const float*>(dout), static_cast<const float*>(ds_last),
        static_cast<float*>(dr), static_cast<float*>(dk),
        static_cast<float*>(dv), static_cast<float*>(dw),
        static_cast<float*>(du), static_cast<float*>(ds0),
        static_cast<float*>(scratch), n_scratch, B, T, H, stream);
  };
  switch (hd) {
    case 16: return run(std::integral_constant<int, 16>());
    case 32: return run(std::integral_constant<int, 32>());
    case 64: return run(std::integral_constant<int, 64>());
    case 128: return run(std::integral_constant<int, 128>());
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
