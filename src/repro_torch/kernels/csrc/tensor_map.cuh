// Host-side TMA tensor maps: for the bfloat16 attention kernels, a (hd,
// rows, heads) bf16 tensor, boxes of one 128-byte (or narrower) column
// block by `box_rows` rows of one head, swizzled to match the wgmma
// descriptors of the kernel that reads them; for the WKV backward, a
// float32 (B, T, H, hd) stream, boxes of some columns of one head over
// consecutive steps.
#pragma once

#include <cuda.h>  // CUtensorMap; its encoder is looked up in libcuda
#include <cuda_runtime.h>

namespace tensor_map {

using EncodeTiled = CUresult (*)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the libcuda the runtime already loaded, so
// that the library needs no -lcuda
inline EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                            cudaEnableDefault, &found);
#endif
    if (e == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// a (hd, rows, heads) bf16 map with boxes of (width / 2, box_rows, 1):
// `width` is the swizzle span in bytes (128, 64 or 32), and rows past
// `rows` read as zeros, never the next head's
inline bool make_bf16(CUtensorMap* map, const void* ptr, int hd, int rows,
                      int heads, int width, int box_rows) {
  EncodeTiled encode = encoder();
  if (encode == nullptr) return false;
  const cuuint64_t row_bytes = static_cast<cuuint64_t>(hd) * 2;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(hd),
                              static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(heads)};
  const cuuint64_t strides[2] = {
      row_bytes, row_bytes * static_cast<cuuint64_t>(rows)};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(width / 2),
                             static_cast<cuuint32_t>(box_rows), 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUtensorMapSwizzle swz =
      width == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
      : width == 64 ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_32B;
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                const_cast<void*>(ptr), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, swz,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// a (cols, heads, steps) f32 map of a (B, T, H, cols) tensor (steps = B
// T, so that a box never needs a batch row's own bound), boxes of
// (box_cols, 1, box_steps), unswizzled: a box lands as box_steps rows of
// box_cols floats; steps past the tensor's end read as zeros
inline bool make_f32_steps(CUtensorMap* map, const void* ptr, int cols,
                           int heads, long long steps, int box_cols,
                           int box_steps) {
  EncodeTiled encode = encoder();
  if (encode == nullptr) return false;
  const cuuint64_t row_bytes = static_cast<cuuint64_t>(cols) * 4;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(cols),
                              static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(steps)};
  const cuuint64_t strides[2] = {
      row_bytes, row_bytes * static_cast<cuuint64_t>(heads)};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(box_cols), 1,
                             static_cast<cuuint32_t>(box_steps)};
  const cuuint32_t elem[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3,
                const_cast<void*>(ptr), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace tensor_map
