// Masked fit-strategy slot selection, batched over (stream, instance) rows.
//
// Replaces the Pallas kernel src/repro/kernels/binpack_select.py
// (select_slot_grid over _select_tile_kernel; select_slot_batch wraps it).
// Row r holds loads[r, 0:M], an item of size w[r], the bin count k[r] and
// the capacity cap[r].  Slot s fits iff s < k and loads + w <= cap:
//   strategy 1 "first": the lowest fitting slot;
//   strategy 2 "best":  the fitting slot of highest load, ties to the lowest;
//   strategy 3 "worst": the fitting slot of lowest load, ties to the lowest.
// Returns M when nothing fits and -1 when active[r] == 0.
//
// Bound on the H100: bytes (the loads plane, 4*M B per row, dominates).
// Simple design: one thread per row, looping over the M slots.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void select_slot_kernel(const float* __restrict__ loads,
                                   const float* __restrict__ w,
                                   const int* __restrict__ k,
                                   const float* __restrict__ cap,
                                   const int* __restrict__ active,
                                   int* __restrict__ out, long long rows,
                                   int m, int strategy) {
  const long long r = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (r >= rows) return;
  if (active != nullptr && active[r] <= 0) {
    out[r] = -1;
    return;
  }
  const float* l = loads + r * m;
  const float wr = w[r];
  const float cr = cap[r];
  const int kr = k[r];
  int best = m;
  float best_load = 0.0f;
  for (int s = 0; s < m && s < kr; ++s) {
    const float ls = l[s];
    if (!(ls + wr <= cr)) continue;
    if (best == m) {
      best = s;
      best_load = ls;
      if (strategy == 1) break;
    } else if ((strategy == 2 && ls > best_load) ||
               (strategy == 3 && ls < best_load)) {
      best = s;
      best_load = ls;
    }
  }
  out[r] = best;
}

}  // namespace

extern "C" int select_slot_f32(const float* loads, const float* w,
                               const int* k, const float* cap,
                               const int* active, int* out, int b, int n,
                               int m, int strategy, cudaStream_t stream) {
  const long long rows = static_cast<long long>(b) * n;
  if (rows <= 0) return static_cast<int>(cudaGetLastError());
  const unsigned grid = static_cast<unsigned>((rows + kThreads - 1) / kThreads);
  select_slot_kernel<<<grid, kThreads, 0, stream>>>(loads, w, k, cap, active,
                                                    out, rows, m, strategy);
  return static_cast<int>(cudaGetLastError());
}
