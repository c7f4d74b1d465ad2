// Cost change of every single-item move, batched over annealing chains.
//
// Replaces the Pallas kernel src/repro/kernels/move_eval.py
// (move_delta_batch over _move_eval_kernel).  Per chain c, item p and bin
// name b, with w = speeds[p], a = assign[p]:
//   d_bins  = (counts[b] == 0) - (counts[a] == 1)
//   now     = prev[p] >= 0 && b != prev[p]
//   was     = prev[p] >= 0 && a != prev[p]
//   d_r     = ((now - was) * w) * (lam / cap)
//   allowed = b != a && (loads[b] + w <= cap || (counts[b] == 0 && w > cap))
//             && (no mask || active[p] > 0)
//   out     = allowed ? d_bins + d_r : 1e30
//
// Bound on the H100: bytes, the K*N*M*4 bytes of the output plane against
// 3.35 TB/s.  Simple design: one block per (chain, tile of kTile items);
// the chain's loads/counts and the tile's item data are staged in shared
// memory, and the block's threads run over the tile's (item, bin) pairs in
// row-major order, so the writes are coalesced.  The products and the sum
// use the _rn intrinsics so that nvcc never contracts them into an FMA:
// the kernel then equals the plain PyTorch version bit for bit.
#include <cuda_runtime.h>

namespace {

constexpr float kBlocked = 1e30f;
constexpr int kTile = 16;
constexpr int kThreads = 256;

__global__ void move_eval_kernel(const float* __restrict__ loads,
                                 const int* __restrict__ counts,
                                 const int* __restrict__ assign,
                                 const float* __restrict__ speeds,
                                 const int* __restrict__ prev,
                                 const float* __restrict__ lam,
                                 const float* __restrict__ cap,
                                 const int* __restrict__ active,
                                 float* __restrict__ out, int n, int m) {
  extern __shared__ unsigned char smem[];
  float* s_loads = reinterpret_cast<float*>(smem);
  int* s_counts = reinterpret_cast<int*>(s_loads + m);
  int* s_assign = s_counts + m;                        // kTile each below
  int* s_prev = s_assign + kTile;
  float* s_w = reinterpret_cast<float*>(s_prev + kTile);
  int* s_count_a = reinterpret_cast<int*>(s_w + kTile);
  int* s_live = s_count_a + kTile;

  const long long chain = blockIdx.x;
  const int p0 = blockIdx.y * kTile;
  const int tile = min(kTile, n - p0);
  for (int b = threadIdx.x; b < m; b += blockDim.x) {
    s_loads[b] = loads[chain * m + b];
    s_counts[b] = counts[chain * m + b];
  }
  if (threadIdx.x < tile) {
    const long long i = chain * n + p0 + threadIdx.x;
    s_assign[threadIdx.x] = assign[i];
    s_prev[threadIdx.x] = prev[i];
    s_w[threadIdx.x] = speeds[i];
    s_live[threadIdx.x] = active == nullptr || active[i] > 0;
  }
  __syncthreads();
  if (threadIdx.x < tile) {
    // the reference sums the one-hot row of counts: the same integer
    const int a = s_assign[threadIdx.x];
    s_count_a[threadIdx.x] = (a >= 0 && a < m) ? s_counts[a] : 0;
  }
  __syncthreads();

  const float c = cap[chain];
  const float lc = __fdiv_rn(lam[chain], c);
  float* dst = out + (chain * n + p0) * m;
  for (int e = threadIdx.x; e < tile * m; e += blockDim.x) {
    const int p = e / m;
    const int b = e - p * m;
    const int a = s_assign[p];
    const int pv = s_prev[p];
    const float w = s_w[p];
    const float d_bins = (s_counts[b] == 0 ? 1.0f : 0.0f)
                         - (s_count_a[p] == 1 ? 1.0f : 0.0f);
    const bool sticky = pv >= 0;
    const float now = (sticky && b != pv) ? 1.0f : 0.0f;
    const float was = (sticky && a != pv) ? 1.0f : 0.0f;
    const float d_r = __fmul_rn(__fmul_rn(now - was, w), lc);
    const bool allowed = b != a && s_live[p]
        && (__fadd_rn(s_loads[b], w) <= c || (s_counts[b] == 0 && w > c));
    dst[e] = allowed ? __fadd_rn(d_bins, d_r) : kBlocked;
  }
}

}  // namespace

extern "C" int move_eval_f32(const float* loads, const int* counts,
                             const int* assign, const float* speeds,
                             const int* prev, const float* lam,
                             const float* cap, const int* active, float* out,
                             int k, int n, int m, cudaStream_t stream) {
  if (k <= 0 || n <= 0 || m <= 0) return static_cast<int>(cudaGetLastError());
  const size_t smem = static_cast<size_t>(m) * (sizeof(float) + sizeof(int))
                      + kTile * 5 * sizeof(int);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        move_eval_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid(k, (n + kTile - 1) / kTile);
  move_eval_kernel<<<grid, kThreads, smem, stream>>>(
      loads, counts, assign, speeds, prev, lam, cap, active, out, n, m);
  return static_cast<int>(cudaGetLastError());
}
