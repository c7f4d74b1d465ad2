// One step of the lag twin's drain, batched over stream rows.
//
// Replaces the Pallas kernel src/repro/kernels/lag_update.py
// (lag_update_batch / lag_update_single over _drain_math).  Per row b:
//   avail_i = lag_i + (active_i ? produced_i : 0)
//   live_i  = readable_i && active_i && assign_i >= 0
//   L_c     = sum of avail_j over live j with assign_j == c
//   out_i   = max(avail_i * (1 - (live_i ? min(1, cap_c / max(L_c, 1e-30)) : 0)), 0)
//   out_i   = 0 where !active_i
//
// Bound on the H100: bytes (about 24 B per partition plus 4 B per bin
// against 3.35 TB/s).  Simple design: one block per row; avail, assign
// and live are staged in shared memory and every thread owns partitions,
// summing its bin's live backlog over the row in index order.  That is
// O(N^2) work per row, with no atomics, and deterministic.
#include <cuda_runtime.h>

namespace {

constexpr float kTiny = 1e-30f;
constexpr int kThreads = 128;

__global__ void lag_update_kernel(const float* __restrict__ lag,
                                  const float* __restrict__ produced,
                                  const int* __restrict__ assign,
                                  const int* __restrict__ readable,
                                  const float* __restrict__ cap,
                                  const int* __restrict__ active,
                                  float* __restrict__ out, int n, int m) {
  extern __shared__ unsigned char smem[];
  float* s_avail = reinterpret_cast<float*>(smem);
  int* s_bin = reinterpret_cast<int*>(s_avail + n);   // -1 when not live
  const long long row = blockIdx.x;
  const long long base = row * n;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const bool act = active == nullptr || active[base + i] > 0;
    const float p = act ? produced[base + i] : 0.0f;
    s_avail[i] = lag[base + i] + p;
    const int a = assign[base + i];
    s_bin[i] = (readable[base + i] > 0 && act && a >= 0) ? a : -1;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const float avail = s_avail[i];
    const int c = s_bin[i];
    float frac = 0.0f;
    if (c >= 0 && c < m) {
      float per_bin = 0.0f;
      for (int j = 0; j < n; ++j) {
        if (s_bin[j] == c) per_bin += s_avail[j];
      }
      frac = fminf(1.0f, cap[row * m + c] / fmaxf(per_bin, kTiny));
    }
    float o = fmaxf(avail * (1.0f - frac), 0.0f);
    if (active != nullptr && active[base + i] <= 0) o = 0.0f;
    out[base + i] = o;
  }
}

}  // namespace

extern "C" int lag_update_f32(const float* lag, const float* produced,
                              const int* assign, const int* readable,
                              const float* cap, const int* active, float* out,
                              int b, int n, int m, cudaStream_t stream) {
  if (b <= 0 || n <= 0) return static_cast<int>(cudaGetLastError());
  const size_t smem = static_cast<size_t>(n) * (sizeof(float) + sizeof(int));
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        lag_update_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  lag_update_kernel<<<b, kThreads, smem, stream>>>(lag, produced, assign,
                                                   readable, cap, active, out,
                                                   n, m);
  return static_cast<int>(cudaGetLastError());
}
