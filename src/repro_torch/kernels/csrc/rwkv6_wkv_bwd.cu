// The backward of the RWKV-6 WKV recurrence (csrc/rwkv6_wkv.cu): per
// (batch row, head), the gradients of a loss with respect to r, k, v, w, u
// and s0, given its gradients do (every step's output) and ds_last (the
// last state).
//
// Replaces no Pallas kernel: the reference's forward kernel
// (src/repro/kernels/rwkv6_scan.py) has no backward, and its model takes
// the gradient of its lax.scan (src/repro/models/rwkv6.py:88, _wkv_scan)
// by autodiff.  r, k, v, w, do, dr, dk, dv, dw (B, T, H, hd), u and du
// (H, hd), ds_last and ds0 (B, H, hd, hd) indexed (k index i, v index j),
// ckpt (B, H, ceil(T / L), hd, hd): the state before every L-th step, as
// the forward kernel's checkpoint variant writes it (ckpt[.., 0] is s0);
// all float32.  With G_t = dL/dS_t (the state after step t), G_T =
// ds_last, dot_t = do_t . v_t and a_t = sum_i r_t[i] u[i] k_t[i], going
// back over t:
//   dr_t[i] = sum_j S_{t-1}[i][j] do_t[j] + u[i] k_t[i] dot_t
//   dk_t[i] = sum_j G_t[i][j] v_t[j]      + u[i] r_t[i] dot_t
//   dw_t[i] = sum_j G_t[i][j] S_{t-1}[i][j]
//   dv_t[j] = sum_i (G_t[i][j] + u[i] r_t[i] do_t[j]) k_t[i]
//   du[i]  += r_t[i] k_t[i] dot_t          (over t and the batch rows)
//   G_{t-1}[i][j] = w_t[i] G_t[i][j] + r_t[i] do_t[j]
// and ds0 = G_0.  S_{t-1} is recomputed forward from a checkpoint, never
// rebuilt from S_t by dividing by w_t: exp(-exp(wlog)) is exactly 0 in
// float32 for wlog above ~4.65, where the gradient is finite.
//
// Bound on the H100: operations.  A step and head takes ~14 hd^2 (the
// recomputed state update 3, the G update 3, four products with the state
// 2 each) against 9 f32 streams of hd, so at hd = 64 it is 14 x 64 / 36 =
// 25 operations a byte, above the card's 20 (67 TFLOP/s over 3.35 TB/s).
//
// Design.  Rows of the state are independent in S and in G (row i of
// both needs only w_t[i], k_t[i], r_t[i] and whole v_t, do_t); dv alone
// sums over rows.
// - Blocks and clusters: a head's hd rows go to RB = hd / 16 blocks of 16
//   rows (4 at hd = 64: B = 4, H = 40 is 640 blocks), and a head's RB
//   blocks form one thread block cluster, which sums dv's row-block
//   partials through distributed shared memory.  At hd 64 the registers
//   (128 a thread) and the shared memory (~53 KB) each cap an SM at 4
//   blocks, so those 640 blocks run as a round of 496 and a tail of 144.
// - One reverse sweep over chunks of L = kBwdChunk<hd> steps (8 at hd
//   64), last chunk first.  The chunk's first state is the checkpoint the
//   training forward wrote; the block recomputes the chunk's later states
//   into shared memory and sweeps the chunk back from them.
// - Warps: a producer warp, two row warps, hd / 64 column warps (one at
//   hd 16 and 32).  The producer's lane 0 fills a two-stage ring with chunk
//   n - 1 while chunk n is swept: five TMA tensor copies (r, k, w: the
//   block's 16 columns, v, do: all hd, each over the chunk's L steps) and
//   one bulk copy of the checkpoint's 16 rows, counted on the stage's
//   mbarrier.
// - Row threads: 4 lanes a state row, 8 rows a warp, each lane hd / 4
//   columns of the row's S and G in registers (float4 groups interleaved
//   so that a warp's shared-memory accesses are conflict-free).  dr, dk,
//   dw and the step's dot_t are four row sums: one reduce-scatter over
//   the 4 lanes (3 shuffles, 2 levels) leaves each lane one of them, and
//   one more shuffle brings dot_t to the lanes that need it.  Each lane
//   stores its output straight to global memory (a predicated store, no
//   divergence), where the store overlaps the next step.  A whole
//   chunk's steps are unrolled into one branch-free run (the one shorter
//   chunk goes step by step), so that the compiler overlaps a step's sums
//   and shuffles with the next step's loads and products.  A block is
//   held mostly by the serial latency of its warps, not by the SM's issue
//   rate: at T = 2048, hd 64, four blocks an SM (one full round of 124
//   clusters) take 1.6x the time of a lone block (one cluster), for four
//   times the work an SM (PERF.md section 6), so the rows go to two warps
//   rather than one.  At L1's call the round takes ~1.57 ms and the tail
//   of 144 blocks the other ~1.3 ms of ~2.9.
// - Column threads: a lane 2 columns, the block's 16 rows of G in
//   registers, the G recurrence run a second time, so that dv's partial
//   over the block's rows (with the rows' share of a_t do_t folded in) is
//   a sum inside the thread.  They leave it in shared memory.
// - One barrier a chunk: a cluster barrier, after which every block sums
//   its share of the chunk's steps over the cluster's RB partials in rank
//   order (distributed shared memory, double-buffered) and stores dv.  The
//   barrier also frees the ring stage the producer fills next.
// - du: each row's partial a batch row, summed over the batch rows in
//   order by a small second kernel.  No atomics: two calls give the same
//   bits.
#include <type_traits>

#include <cooperative_groups.h>
#include <cuda.h>
#include <cuda_runtime.h>

#include "hopper.cuh"
#include "rwkv6_chunk.cuh"
#include "tensor_map.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kRows = rwkv6::kBwdRows;    // state rows a block
constexpr int kNS = 2;                    // ring stages

// L steps a chunk, RB row blocks a head (the cluster), C columns of a row
// thread (4 lanes a row), NC column threads (2 columns each) in
// CW warps; shared memory in floats: kNS ring stages (r, k, w [L][16],
// v, do [L][hd], the checkpoint's 16 rows [16][hd], each 128-byte
// aligned), the recomputed states of a chunk's steps 1 .. L - 1 (rows
// padded to HP), two chunks of dv partials
template <int HD>
struct Shape {
  static constexpr int L = rwkv6::kBwdChunk<HD>;
  static constexpr int RB = HD / kRows;
  static constexpr int C = HD / 4;
  static constexpr int NC = HD / 2;
  static constexpr int CW = HD >= 64 ? HD / 64 : 1;
  static constexpr int THREADS = 32 * (3 + CW);
  static constexpr int MIN_BLOCKS = HD == 64 ? 4 : 1;
  static constexpr int HP = HD + 4;
  static constexpr int OK = L * kRows, OW = 2 * L * kRows;
  static constexpr int OV = 3 * L * kRows, OD = OV + L * HD;
  static constexpr int OC = OD + L * HD;
  static constexpr int STAGE = OC + kRows * HD;
  static constexpr int TX = 4 * STAGE;      // bytes a stage's copies bring
  static constexpr int HIST = (L - 1) * kRows * HP;
  static constexpr int DVB = L * HD;
  static constexpr int SMEM = 128 + 4 * (kNS * STAGE + HIST + 2 * DVB);
  static_assert((4 * OK) % 128 == 0 && (4 * OV) % 128 == 0 &&
                (4 * OD) % 128 == 0 && (4 * OC) % 128 == 0 &&
                (4 * STAGE) % 128 == 0, "TMA boxes 128-byte aligned");
};

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void st4(float* p, const float* x) {
  *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
}

template <int HD>
__global__ void __launch_bounds__(Shape<HD>::THREADS, Shape<HD>::MIN_BLOCKS)
rwkv6_wkv_bwd_kernel(const __grid_constant__ CUtensorMap tm_r,
                     const __grid_constant__ CUtensorMap tm_k,
                     const __grid_constant__ CUtensorMap tm_w,
                     const __grid_constant__ CUtensorMap tm_v,
                     const __grid_constant__ CUtensorMap tm_do,
                     const float* __restrict__ u,
                     const float* __restrict__ ckpt,
                     const float* __restrict__ ds_last,
                     float* __restrict__ dr, float* __restrict__ dk,
                     float* __restrict__ dv, float* __restrict__ dw,
                     float* __restrict__ ds0, float* __restrict__ du_part,
                     int T, int H) {
  using S = Shape<HD>;
  constexpr int L = S::L, RB = S::RB, C = S::C, HP = S::HP;
  constexpr int OK = S::OK, OW = S::OW, OV = S::OV, OD = S::OD, OC = S::OC;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  unsigned long long* bars = reinterpret_cast<unsigned long long*>(smem_raw);
  float* ring = reinterpret_cast<float*>(smem_raw + 128);
  float* hist = ring + kNS * S::STAGE;
  float* dvb = hist + S::HIST;

  cg::cluster_group cluster = cg::this_cluster();
  const int rb = static_cast<int>(cluster.block_rank());  // row block
  const int h = blockIdx.x / RB;
  const int b = blockIdx.y;
  const int row0 = rb * kRows;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int nch = (T + L - 1) / L;
  const long long step = static_cast<long long>(H) * HD;   // stride of t
  const long long bt0 = (static_cast<long long>(b) * T * H + h) * HD;
  const long long bh = static_cast<long long>(b) * H + h;
  const float* ckh = ckpt + bh * nch * HD * HD + row0 * HD;

  auto full = [&](int s) { return hopper::smem_u32(&bars[s]); };
  if (threadIdx.x == 0) {
    for (int s = 0; s < kNS; ++s) hopper::mbar_init(full(s), 1);
    hopper::mbar_init_fence();
    hopper::tma_prefetch_map(&tm_r);
    hopper::tma_prefetch_map(&tm_k);
    hopper::tma_prefetch_map(&tm_w);
    hopper::tma_prefetch_map(&tm_v);
    hopper::tma_prefetch_map(&tm_do);
  }
  // chunk c of the sweep (chunk nch - 1 - c of the sequence) into stage
  // c % kNS, by one thread; a last chunk shorter than L takes the steps
  // after it too (the next batch row's, or zeros past the end), unread
  auto issue = [&](int c) {
    const int s = c % kNS;
    const int n = nch - 1 - c;
    const int t = b * T + n * L;
    float* stg = ring + s * S::STAGE;
    const uint32_t bar = full(s);
    hopper::mbar_expect_tx(bar, S::TX);
    hopper::tma_load_3d(hopper::smem_u32(stg), &tm_r, bar, row0, h, t);
    hopper::tma_load_3d(hopper::smem_u32(stg + OK), &tm_k, bar, row0, h, t);
    hopper::tma_load_3d(hopper::smem_u32(stg + OW), &tm_w, bar, row0, h, t);
    hopper::tma_load_3d(hopper::smem_u32(stg + OV), &tm_v, bar, 0, h, t);
    hopper::tma_load_3d(hopper::smem_u32(stg + OD), &tm_do, bar, 0, h, t);
    hopper::bulk_load(hopper::smem_u32(stg + OC),
                      ckh + static_cast<long long>(n) * HD * HD,
                      kRows * HD * 4, bar);
  };

  const bool is_row = warp == 1 || warp == 2;
  const bool is_col = warp >= 3 && threadIdx.x - 96 < S::NC;
  // row thread: state row i of the block, column group cq: columns
  // 16 q + 4 cq + {0..3}, q < C / 4
  const int i = 8 * (warp - 1) + (lane >> 2);
  const int cq = lane & 3;
  // column thread: columns ja, ja + 1, rows row0 .. row0 + 15
  const int ja = 2 * (static_cast<int>(threadIdx.x) - 96);

  float gr[C];                  // row thread: its row of G
  float gca[kRows], gcb[kRows], uc[kRows];   // column thread
  float ui = 0.0f, du_acc = 0.0f;
  if (is_row) {
    const float* src = ds_last + (bh * HD + row0 + i) * HD + 4 * cq;
#pragma unroll
    for (int q = 0; q < C / 4; ++q) {
      const float4 x = ld4(src + 16 * q);
      gr[4 * q] = x.x; gr[4 * q + 1] = x.y;
      gr[4 * q + 2] = x.z; gr[4 * q + 3] = x.w;
    }
    ui = u[h * HD + row0 + i];
  }
  if (is_col) {
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const float2 x = *reinterpret_cast<const float2*>(
          ds_last + (bh * HD + row0 + i) * HD + ja);
      gca[i] = x.x;
      gcb[i] = x.y;
      uc[i] = u[h * HD + row0 + i];
    }
  }

  cluster.sync();          // barriers initialised, the cluster's blocks run
  if (threadIdx.x == 0) issue(0);

  for (int c = 0; c < nch; ++c) {
    const int s = c % kNS;
    const int t0 = (nch - 1 - c) * L;
    const int cnt = min(L, T - t0);
    const float* stg = ring + s * S::STAGE;
    float* dvc = dvb + (c & 1) * S::DVB;
    if (warp == 0) {
      // the next chunk's stage was last read in chunk c - 1, before the
      // cluster barrier this thread has passed
      if (lane == 0 && c + 1 < nch) issue(c + 1);
    } else if (is_row) {
      hopper::mbar_wait(full(s), (c / kNS) & 1);
      const float* ckr = stg + OC + i * HD + 4 * cq;
      {
        // S after steps t0 .. t0 + cnt - 2 into hist[0 .. cnt - 2]
        float st[C];
#pragma unroll
        for (int q = 0; q < C / 4; ++q) {
          const float4 x = ld4(ckr + 16 * q);
          st[4 * q] = x.x; st[4 * q + 1] = x.y;
          st[4 * q + 2] = x.z; st[4 * q + 3] = x.w;
        }
        auto rec_step = [&](const int tt) {
          const float kk = stg[OK + tt * kRows + i];
          const float ww = stg[OW + tt * kRows + i];
          float* hr = hist + (tt * kRows + i) * HP + 4 * cq;
#pragma unroll
          for (int q = 0; q < C / 4; ++q) {
            const float4 x = ld4(stg + OV + tt * HD + 16 * q + 4 * cq);
            const float vv[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              st[4 * q + e] = fmaf(ww, st[4 * q + e], kk * vv[e]);
            }
            st4(hr + 16 * q, st + 4 * q);
          }
        };
        // a whole chunk unrolled without a branch, so that the compiler
        // overlaps its steps; the one shorter chunk step by step
        if (cnt == L) {
#pragma unroll
          for (int tt = 0; tt + 1 < L; ++tt) rec_step(tt);
        } else {
          for (int tt = 0; tt + 1 < cnt; ++tt) rec_step(tt);
        }
      }
      const bool b0 = cq & 1, b1 = cq & 2;
      // the output this lane stores: dr, dk, dw (lanes 0-2 of a row)
      float* out = cq == 0 ? dr : cq == 1 ? dk : dw;
      auto row_step = [&](const int tt) {
        const float rr = stg[tt * kRows + i], kk = stg[OK + tt * kRows + i];
        const float ww = stg[OW + tt * kRows + i];
        const float* sp = tt == 0
            ? ckr : hist + ((tt - 1) * kRows + i) * HP + 4 * cq;
        float pr = 0.0f, pk = 0.0f, pw = 0.0f, pd = 0.0f;
#pragma unroll
        for (int q = 0; q < C / 4; ++q) {
          const float4 s4 = ld4(sp + 16 * q);
          const float4 v4 = ld4(stg + OV + tt * HD + 16 * q + 4 * cq);
          const float4 d4 = ld4(stg + OD + tt * HD + 16 * q + 4 * cq);
          const float sv[4] = {s4.x, s4.y, s4.z, s4.w};
          const float vv[4] = {v4.x, v4.y, v4.z, v4.w};
          const float dd[4] = {d4.x, d4.y, d4.z, d4.w};
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float gg = gr[4 * q + e];
            pr = fmaf(sv[e], dd[e], pr);
            pk = fmaf(gg, vv[e], pk);
            pw = fmaf(gg, sv[e], pw);
            pd = fmaf(dd[e], vv[e], pd);
            gr[4 * q + e] = fmaf(ww, gg, rr * dd[e]);
          }
        }
        // reduce-scatter over the row's 4 lanes: lane cq keeps the sum of
        // pr, pk, pw, pd (cq = 0, 1, 2, 3)
        const float x0 =
            (b1 ? pw : pr) + __shfl_xor_sync(kFull, b1 ? pr : pw, 2);
        const float x1 =
            (b1 ? pd : pk) + __shfl_xor_sync(kFull, b1 ? pk : pd, 2);
        const float sum =
            (b0 ? x1 : x0) + __shfl_xor_sync(kFull, b0 ? x0 : x1, 1);
        const float dt = __shfl_sync(kFull, sum, (lane & ~3) | 3);
        const float bonus = cq == 0 ? ui * kk : cq == 1 ? ui * rr : 0.0f;
        if (cq < 3) {
          out[bt0 + (t0 + tt) * step + row0 + i] = fmaf(bonus, dt, sum);
        } else {
          du_acc = fmaf(rr * kk, dt, du_acc);
        }
      };
      if (cnt == L) {
#pragma unroll
        for (int tt = L - 1; tt >= 0; --tt) row_step(tt);
      } else {
        for (int tt = cnt - 1; tt >= 0; --tt) row_step(tt);
      }
    } else if (is_col) {
      hopper::mbar_wait(full(s), (c / kNS) & 1);
      auto col_step = [&](const int tt) {
        const float2 d2 = *reinterpret_cast<const float2*>(
            stg + OD + tt * HD + ja);
        float dva = 0.0f, dvbb = 0.0f;
#pragma unroll
        for (int q = 0; q < kRows / 4; ++q) {
          const float4 r4 = ld4(stg + tt * kRows + 4 * q);
          const float4 k4 = ld4(stg + OK + tt * kRows + 4 * q);
          const float4 w4 = ld4(stg + OW + tt * kRows + 4 * q);
          const float rv[4] = {r4.x, r4.y, r4.z, r4.w};
          const float kv[4] = {k4.x, k4.y, k4.z, k4.w};
          const float wv[4] = {w4.x, w4.y, w4.z, w4.w};
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i = 4 * q + e;
            const float rda = rv[e] * d2.x, rdb = rv[e] * d2.y;
            dva = fmaf(fmaf(uc[i], rda, gca[i]), kv[e], dva);
            dvbb = fmaf(fmaf(uc[i], rdb, gcb[i]), kv[e], dvbb);
            gca[i] = fmaf(wv[e], gca[i], rda);
            gcb[i] = fmaf(wv[e], gcb[i], rdb);
          }
        }
        *reinterpret_cast<float2*>(dvc + tt * HD + ja) =
            make_float2(dva, dvbb);
      };
      if (cnt == L) {
#pragma unroll
        for (int tt = L - 1; tt >= 0; --tt) col_step(tt);
      } else {
        for (int tt = cnt - 1; tt >= 0; --tt) col_step(tt);
      }
    }
    // every block's dv partials of the chunk are in its shared memory; the
    // ring stage of chunk c is free
    cluster.sync();
    // this block's steps of the chunk (tt = rb, rb + RB, ...), all
    // columns: the RB partials summed in rank order
    const int mine = (cnt - rb + RB - 1) / RB;
    for (int q = threadIdx.x; q < mine * HD; q += S::THREADS) {
      const int tt = rb + RB * (q / HD), jj = q % HD;
      float* at = dvc + tt * HD + jj;
      float sum = *cluster.map_shared_rank(at, 0);
#pragma unroll
      for (int p = 1; p < RB; ++p) sum += *cluster.map_shared_rank(at, p);
      dv[bt0 + (t0 + tt) * step + jj] = sum;
    }
  }
  if (is_row) {
    float* dst = ds0 + (bh * HD + row0 + i) * HD + 4 * cq;
#pragma unroll
    for (int q = 0; q < C / 4; ++q) st4(dst + 16 * q, gr + 4 * q);
    if (cq == 3) du_part[bh * HD + row0 + i] = du_acc;
  }
  cluster.sync();          // no block exits while another reads its partials
}

// du = the sum of the B batch rows' partials in batch order
__global__ void rwkv6_wkv_du_sum_kernel(const float* __restrict__ du_part,
                                        float* __restrict__ du, int B,
                                        int n) {
  const int q = blockIdx.x * blockDim.x + threadIdx.x;
  if (q >= n) return;
  float s = du_part[q];
  for (int bb = 1; bb < B; ++bb) {
    s += du_part[bb * static_cast<long long>(n) + q];
  }
  du[q] = s;
}

// the launch of rwkv6_wkv_bwd_kernel<HD> on a (B, H) call: a cluster of
// RB blocks a head, the dynamic shared memory allowed
template <int HD>
cudaError_t configure(cudaLaunchConfig_t* cfg, cudaLaunchAttribute* attr,
                      int B, int H, cudaStream_t stream) {
  using S = Shape<HD>;
  const cudaError_t err = cudaFuncSetAttribute(
      rwkv6_wkv_bwd_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      S::SMEM);
  cfg->gridDim = dim3(H * S::RB, B, 1);
  cfg->blockDim = dim3(S::THREADS, 1, 1);
  cfg->dynamicSmemBytes = S::SMEM;
  cfg->stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = S::RB;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  return err;
}

template <int HD>
int launch(const float* r, const float* k, const float* v, const float* w,
           const float* u, const float* ckpt, const float* dout,
           const float* ds_last, float* dr, float* dk, float* dv, float* dw,
           float* du, float* ds0, float* scratch, long long n_scratch, int B,
           int T, int H, cudaStream_t stream) {
  using S = Shape<HD>;
  const long long n_du = static_cast<long long>(B) * H * HD;
  if (n_scratch < n_du) return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap tm_r, tm_k, tm_w, tm_v, tm_do;
  const long long steps = static_cast<long long>(B) * T;
  using tensor_map::make_f32_steps;
  if (!make_f32_steps(&tm_r, r, HD, H, steps, kRows, S::L)
      || !make_f32_steps(&tm_k, k, HD, H, steps, kRows, S::L)
      || !make_f32_steps(&tm_w, w, HD, H, steps, kRows, S::L)
      || !make_f32_steps(&tm_v, v, HD, H, steps, HD, S::L)
      || !make_f32_steps(&tm_do, dout, HD, H, steps, HD, S::L)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  cudaError_t err = configure<HD>(&cfg, attr, B, H, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaLaunchKernelEx(&cfg, rwkv6_wkv_bwd_kernel<HD>, tm_r, tm_k, tm_w,
                           tm_v, tm_do, u, ckpt, ds_last, dr, dk, dv, dw,
                           ds0, scratch, T, H);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n = H * HD;
  rwkv6_wkv_du_sum_kernel<<<(n + 255) / 256, 256, 0, stream>>>(
      scratch, du, B, n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int rwkv6_wkv_bwd_f32(const void* r, const void* k, const void* v,
                                 const void* w, const void* u,
                                 const void* ckpt, const void* dout,
                                 const void* ds_last, void* dr, void* dk,
                                 void* dv, void* dw, void* du, void* ds0,
                                 void* scratch, long long n_scratch,
                                 int chunk, int rows, int B, int T, int H,
                                 int hd, cudaStream_t stream) {
  if (B <= 0 || H <= 0) return static_cast<int>(cudaGetLastError());
  if (T <= 0 || B > 65535 || rows != kRows) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto run = [&](auto hd_tag) {
    constexpr int HD = decltype(hd_tag)::value;
    if (chunk != rwkv6::kBwdChunk<HD>) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    return launch<HD>(
        static_cast<const float*>(r), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<const float*>(w),
        static_cast<const float*>(u), static_cast<const float*>(ckpt),
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

// how many of the backward's clusters the card holds at once at head size
// hd, and each block's threads and dynamic shared memory (the numbers
// behind its waves)
extern "C" int rwkv6_wkv_bwd_occupancy(int hd, void* clusters, void* threads,
                                       void* smem) {
  auto run = [&](auto hd_tag) {
    constexpr int HD = decltype(hd_tag)::value;
    cudaLaunchConfig_t cfg = {};
    cudaLaunchAttribute attr[1];
    cudaError_t err = configure<HD>(&cfg, attr, 1, 1, nullptr);
    if (err == cudaSuccess) {
      err = cudaOccupancyMaxActiveClusters(static_cast<int*>(clusters),
                                           rwkv6_wkv_bwd_kernel<HD>, &cfg);
    }
    *static_cast<int*>(threads) = Shape<HD>::THREADS;
    *static_cast<int*>(smem) = Shape<HD>::SMEM;
    return static_cast<int>(err);
  };
  switch (hd) {
    case 16: return run(std::integral_constant<int, 16>());
    case 32: return run(std::integral_constant<int, 32>());
    case 64: return run(std::integral_constant<int, 64>());
    case 128: return run(std::integral_constant<int, 128>());
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
