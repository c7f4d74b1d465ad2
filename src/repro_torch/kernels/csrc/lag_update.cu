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
// Bound on the H100: bytes (at the lag twin's dtypes 22 B a partition --
// f32 lag, produced and out, int64 assign, bool readable and active --
// plus 4 B a live bin's cap, against 3.35 TB/s).
//
// Design: a warp a row, 8 rows a block of 256 threads.  For N <= 32 a lane
// is a partition and the row never leaves registers: __match_any_sync on
// the partition's bin gives the lanes that share it, and each lane sums
// its bin's avail over those lanes' set bits from the lowest up (a
// __shfl_sync each), so L_c is the sum of avail_j over the bin's live j in
// increasing j with plain adds from 0, whatever the layout: the bits of a
// sequential loop over the row.  A wider row is strided over the lanes
// through a per-warp slice of shared memory, each lane summing its
// partitions' bins over the row in index order.  The inputs are read as
// they are held: assign as int32 or int64, readable and active as bool or
// int32 (non-zero is true), each [B, N] input at its own row stride, so
// the caller converts and copies nothing.
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr float kTiny = 1e-30f;
constexpr int kWarps = 8;              // rows a block

struct Args {
  const float* lag;
  const float* produced;
  const void* assign;
  const void* readable;
  const float* cap;
  const void* active;                  // null: every partition exists
  float* out;                          // contiguous [B, N]
  long long s_lag, s_prod, s_asg, s_read, s_cap, s_act;   // row strides
  int b, n, m;
};

// one partition's avail, its bin (-1 unless live with a bin below m) and
// whether it exists
template <typename TA, typename TR, typename TM>
__device__ __forceinline__ void load_one(const Args& a, long long row, int i,
                                         float& avail, int& bin, bool& act) {
  act = a.active == nullptr
        || static_cast<const TM*>(a.active)[row * a.s_act + i] != 0;
  const float p = act ? a.produced[row * a.s_prod + i] : 0.0f;
  avail = a.lag[row * a.s_lag + i] + p;
  const long long c = static_cast<const TA*>(a.assign)[row * a.s_asg + i];
  const bool live =
      static_cast<const TR*>(a.readable)[row * a.s_read + i] != 0 && act;
  bin = (live && c >= 0 && c < a.m) ? static_cast<int>(c) : -1;
}

__device__ __forceinline__ float drain(const Args& a, long long row,
                                       float avail, int bin, bool act,
                                       float per_bin) {
  float frac = 0.0f;
  if (bin >= 0) frac = fminf(1.0f, a.cap[row * a.s_cap + bin]
                                       / fmaxf(per_bin, kTiny));
  const float o = fmaxf(avail * (1.0f - frac), 0.0f);
  return act ? o : 0.0f;
}

template <typename TA, typename TR, typename TM>
__global__ void __launch_bounds__(kWarps * 32, 4)
lag_update_kernel(const Args a) {
  extern __shared__ unsigned char smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long row = static_cast<long long>(blockIdx.x) * (blockDim.x >> 5)
                        + warp;
  if (row >= a.b) return;
  const int n = a.n;
  float* o_row = a.out + row * n;

  if (n <= 32) {
    float avail = 0.0f;
    int bin = -1;
    bool act = true;
    if (lane < n) load_one<TA, TR, TM>(a, row, lane, avail, bin, act);
    // lanes outside every bin get a key of their own
    const int key = bin >= 0 ? bin : -1 - lane;
    unsigned rest = __match_any_sync(kFull, key);
    const int rounds = __reduce_max_sync(kFull, __popc(rest));
    float per_bin = 0.0f;
    for (int q = 0; q < rounds; ++q) {
      const int j = rest ? __ffs(rest) - 1 : lane;
      const float aj = __shfl_sync(kFull, avail, j);
      if (rest) {
        per_bin += aj;
        rest &= rest - 1;
      }
    }
    if (lane < n) o_row[lane] = drain(a, row, avail, bin, act, per_bin);
    return;
  }

  // a wider row: its avail and bins (-2 where the partition does not
  // exist) in the warp's slice of shared memory
  float* s_avail = reinterpret_cast<float*>(smem) + 2 * warp * n;
  int* s_bin = reinterpret_cast<int*>(s_avail + n);
  for (int i = lane; i < n; i += 32) {
    float avail;
    int bin;
    bool act;
    load_one<TA, TR, TM>(a, row, i, avail, bin, act);
    s_avail[i] = avail;
    s_bin[i] = act ? bin : -2;
  }
  __syncwarp();
  for (int i = lane; i < n; i += 32) {
    const int bin = s_bin[i];
    float per_bin = 0.0f;
    if (bin >= 0) {
      for (int j = 0; j < n; ++j) {
        if (s_bin[j] == bin) per_bin += s_avail[j];
      }
    }
    o_row[i] = drain(a, row, s_avail[i], bin < 0 ? -1 : bin, bin != -2,
                     per_bin);
  }
}

template <typename TA, typename TR, typename TM>
int launch(const Args& a, cudaStream_t stream) {
  // rows a block: 8, fewer where a wide row's slice would not fit
  const size_t per_row = a.n > 32 ? static_cast<size_t>(a.n) * 8 : 0;
  int warps = kWarps;
  while (warps > 1 && per_row * warps > 48 * 1024) --warps;
  const size_t smem = per_row * warps;
  auto kernel = lag_update_kernel<TA, TR, TM>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int blocks = (a.b + warps - 1) / warps;
  kernel<<<blocks, warps * 32, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename TA, typename TR>
int by_active(const Args& a, bool active_i32, cudaStream_t stream) {
  return active_i32 ? launch<TA, TR, int32_t>(a, stream)
                    : launch<TA, TR, uint8_t>(a, stream);
}

template <typename TA>
int by_readable(const Args& a, bool readable_i32, bool active_i32,
                cudaStream_t stream) {
  return readable_i32 ? by_active<TA, int32_t>(a, active_i32, stream)
                      : by_active<TA, uint8_t>(a, active_i32, stream);
}

}  // namespace

// assign_i64: assign is int64 (else int32); readable_i32 / active_i32: the
// mask is int32 (else one byte: bool); strides are the inputs' row strides
// in elements (their last dimension is contiguous)
extern "C" int lag_update_f32(const float* lag, const float* produced,
                              const void* assign, const void* readable,
                              const float* cap, const void* active,
                              float* out, int b, int n, int m,
                              int assign_i64, int readable_i32,
                              int active_i32, long long s_lag,
                              long long s_prod, long long s_asg,
                              long long s_read, long long s_cap,
                              long long s_act, cudaStream_t stream) {
  if (b <= 0 || n <= 0) return static_cast<int>(cudaGetLastError());
  const Args a{lag, produced, assign, readable, cap, active, out,
               s_lag, s_prod, s_asg, s_read, s_cap, s_act, b, n, m};
  return assign_i64 ? by_readable<int64_t>(a, readable_i32, active_i32, stream)
                    : by_readable<int32_t>(a, readable_i32, active_i32, stream);
}
