// The whole closed loop of the lag twin for the heuristic packers, every
// step in one launch.
//
// Replaces the Pallas megakernel src/repro/kernels/loop_fused.py
// (loop_fused_batch over _loop_fused_kernel / _one_step).  Each step of
// one (policy, stream) row:
//   1. traversal order: identity, or the stable non-increasing sort of the
//      Decreasing variants as a pairwise rank;
//   2. slot selection per item (next / first / best / worst fit, ties to
//      the lowest slot) with bin creation;
//   3. Sec. IV-C sticky renaming of creation slots to bin names, with the
//      2n+2 name universe in 32-bit masks (hence n <= 14);
//   4. migration downtime for every moved partition;
//   5. produce + proportional drain (the lag_update math, in slot space).
//
// Bound on the H100: at the lag twin's shapes (n = 14) the per-step
// select, rank and naming work outweighs the bytes moved (the rate slab
// and five per-step outputs), so the bound is operations on the 32-bit
// cores.  Simple design: one thread per (policy, stream) row carrying
// lag / previous assignment / downtime in local arrays across all T
// steps.  Reads are uncoalesced (a thread reads its own row's [t, :]
// slab); that is for a later change.
#include <cuda_runtime.h>

namespace {

constexpr int kMaxN = 14;
constexpr int kMaxM = kMaxN + 1;
constexpr float kTiny = 1e-30f;
constexpr int kThreads = 128;

enum Strategy { kNext = 0, kFirst = 1, kBest = 2, kWorst = 3 };

__global__ void loop_fused_kernel(
    const float* __restrict__ rates, const int* __restrict__ active,
    const float* __restrict__ lag0, const int* __restrict__ strat_of,
    const int* __restrict__ dec_of, float* __restrict__ tot,
    float* __restrict__ mx, int* __restrict__ cons, int* __restrict__ migs,
    int* __restrict__ unread, int* __restrict__ asg, int n_pol, int b,
    int t_steps, int n, float capacity, float cap_step, float dt, int mig) {
  const long long row = static_cast<long long>(blockIdx.x) * blockDim.x +
                        threadIdx.x;
  if (row >= static_cast<long long>(n_pol) * b) return;
  const int pol = static_cast<int>(row / b);
  const long long stream = row % b;
  const int strategy = strat_of[pol];
  const bool decreasing = dec_of[pol] != 0;
  const int m = n + 1;
  const float inf = __int_as_float(0x7f800000);

  float lag[kMaxN];
  int prev[kMaxN], down[kMaxN];
  for (int i = 0; i < n; ++i) {
    lag[i] = lag0 == nullptr ? 0.0f : lag0[stream * n + i];
    prev[i] = -1;
    down[i] = 0;
  }

  for (int t = 0; t < t_steps; ++t) {
    const long long off = (stream * t_steps + t) * n;
    float speeds[kMaxN], produced[kMaxN];
    bool act[kMaxN];
    for (int i = 0; i < n; ++i) {
      speeds[i] = rates[off + i];
      act[i] = active == nullptr || active[off + i] > 0;
      // __fmul_rn: never contracted into an FMA with the lag add below
      produced[i] = act[i] ? __fmul_rn(speeds[i], dt) : 0.0f;
    }

    // phase 1: traversal order (strictly-greater plus equal-lower-index)
    int order[kMaxN];
    if (decreasing) {
      for (int i = 0; i < n; ++i) {
        int rank = 0;
        for (int j = 0; j < n; ++j) {
          rank += (speeds[i] < speeds[j]) || (speeds[i] == speeds[j] && j < i);
        }
        order[rank] = i;
      }
    } else {
      for (int i = 0; i < n; ++i) order[i] = i;
    }

    // phase 2: slot selection and bin creation
    float loads[kMaxM];
    int creator[kMaxM], slot_of[kMaxN];
    for (int s = 0; s < m; ++s) {
      loads[s] = inf;
      creator[s] = -1;
    }
    for (int i = 0; i < n; ++i) slot_of[i] = -1;
    int k = 0;
    float lastload = 0.0f;
    for (int i = 0; i < n; ++i) {
      const int j = order[i];
      const float w = speeds[j];
      bool found;
      int slot;
      if (strategy == kNext) {
        found = k > 0 && lastload + w <= capacity;
        slot = found ? k - 1 : k;
      } else {
        int sel = -1;
        float best = inf;
        for (int s = 0; s < m; ++s) {
          if (!(loads[s] + w <= capacity)) continue;
          const float score = strategy == kFirst  ? static_cast<float>(s)
                              : strategy == kBest ? -loads[s]
                                                  : loads[s];
          if (sel < 0 || score < best) {
            sel = s;
            best = score;
          }
        }
        found = sel >= 0;
        slot = found ? sel : k;
      }
      if (!act[j]) continue;   // an inactive item leaves every state alone
      if (found) {
        loads[slot] = loads[slot] + w;
        lastload = slot == k - 1 ? lastload + w : lastload;
      } else {
        loads[slot] = w;
        creator[slot] = j;
        lastload = w;
        ++k;
      }
      slot_of[j] = slot;
    }

    // phase 3: sticky naming over creation slots (name bitmasks)
    int new_assign[kMaxN];
    for (int i = 0; i < n; ++i) new_assign[i] = -1;
    unsigned claimed = 0u, seen = 0u;
    int q = 0;
    for (int s = 0; s < n; ++s) {
      const int v = creator[s] >= 0 ? prev[creator[s]] : -1;
      const unsigned vbit = 1u << (v > 0 ? v : 0);
      const bool live = s < k;
      const bool cand = v >= 0 && (seen & vbit) == 0u;
      if (v >= 0) seen |= vbit;
      const bool win = cand && v >= q && live;
      const bool fall = live && !win;
      const int nm = win ? v : q;
      if (live) {
        for (int i = 0; i < n; ++i) {
          if (slot_of[i] == s) new_assign[i] = nm;
        }
      }
      if (win) claimed |= vbit;
      if (fall || (win && v == q)) {
        const unsigned mask = claimed | ((1u << (q + 1)) - 1u);
        const unsigned low = ~mask & (mask + 1u);
        q = __popc(low - 1u);
      }
    }

    // phases 4-5: downtime, then produce + drain in slot space
    float avail[kMaxN], per_bin[kMaxM];
    bool live_p[kMaxN];
    int moved_ct = 0, unread_ct = 0;
    for (int s = 0; s < m; ++s) per_bin[s] = 0.0f;
    for (int i = 0; i < n; ++i) {
      const bool moved = prev[i] >= 0 && new_assign[i] >= 0 &&
                         new_assign[i] != prev[i];
      const int d = down[i] - 1;
      down[i] = moved ? mig : (d > 0 ? d : 0);
      moved_ct += moved;
      unread_ct += down[i] > 0 && act[i];
      live_p[i] = down[i] == 0 && new_assign[i] >= 0 && slot_of[i] >= 0;
      avail[i] = lag[i] + produced[i];
      if (live_p[i]) per_bin[slot_of[i]] += avail[i];
    }
    float total = 0.0f, worst = 0.0f;
    for (int i = 0; i < n; ++i) {
      float frac = 0.0f;
      if (live_p[i]) {
        frac = fminf(1.0f, cap_step / fmaxf(per_bin[slot_of[i]], kTiny));
      }
      float nl = fmaxf(avail[i] * (1.0f - frac), 0.0f);
      if (!act[i]) nl = 0.0f;
      lag[i] = nl;
      prev[i] = new_assign[i];
      total += nl;
      worst = i == 0 ? nl : fmaxf(worst, nl);
    }
    const long long o = row * t_steps + t;
    tot[o] = total;
    mx[o] = worst;
    cons[o] = k;
    migs[o] = moved_ct;
    unread[o] = unread_ct;
    if (asg != nullptr) {
      for (int i = 0; i < n; ++i) asg[o * n + i] = new_assign[i];
    }
  }
}

}  // namespace

extern "C" int loop_fused_f32(const float* rates, const int* active,
                              const float* lag0, const int* strat_of,
                              const int* dec_of, float* tot, float* mx,
                              int* cons, int* migs, int* unread, int* asg,
                              int n_pol, int b, int t_steps, int n,
                              float capacity, float cap_step, float dt,
                              int mig, cudaStream_t stream) {
  if (n > kMaxN) return static_cast<int>(cudaErrorInvalidValue);
  const long long rows = static_cast<long long>(n_pol) * b;
  if (rows <= 0 || t_steps <= 0) return static_cast<int>(cudaGetLastError());
  const unsigned grid = static_cast<unsigned>((rows + kThreads - 1) / kThreads);
  loop_fused_kernel<<<grid, kThreads, 0, stream>>>(
      rates, active, lag0, strat_of, dec_of, tot, mx, cons, migs, unread, asg,
      n_pol, b, t_steps, n, capacity, cap_step, dt, mig);
  return static_cast<int>(cudaGetLastError());
}
