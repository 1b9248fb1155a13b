// The Tensor Memory Accelerator (TMA) on Hopper: tensor maps encoded on
// the host, and tile loads into shared memory whose bytes an mbarrier
// counts. Shared by the block kernels' GEMM (gemm_sm90.cuh: 2-D maps of
// one matrix) and K7's batched variant (ns_polar.cu: 3-D maps of a batch
// of matrices, one matrix a plane, so that a box is zero-filled at each
// matrix's own edges).
//
// The maps are encoded through cuTensorMapEncodeTiled reached with
// cudaGetDriverEntryPoint: the library links nothing beyond the runtime.
#pragma once

#include <cuda.h>  // CUtensorMap and its enums; no driver call is linked
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "wgmma.cuh"

namespace basd {
namespace sm90 {

// TMA: the box at (c0 = column, c1 = row) of a 2-D map into shared
// memory, its bytes counted on `bar`.
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1)
      : "memory");
}

// The same for a 3-D map: (c0 = column, c1 = row, c2 = matrix).
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2)
      : "memory");
}

// cuTensorMapEncodeTiled, reached through the runtime (no -lcuda).
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

static EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                            cudaEnableDefault, &q);
#endif
    return (e == cudaSuccess && q == cudaDriverEntryPointSuccess)
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// Encodes a map of bf16 elements of `rank` dimensions (innermost first;
// strides in bytes for dimensions 1..rank-1), read in boxes of 64 columns
// x box_rows rows (x 1 in a third dimension), 128-byte swizzle, zero fill
// outside the map.
static int encode_map(CUtensorMap* map, const __nv_bfloat16* p,
                      cuuint32_t rank, const cuuint64_t* dims,
                      const cuuint64_t* strides, int box_rows) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return (int)cudaErrorNotSupported;
  const cuuint32_t box[3] = {(cuuint32_t)64, (cuuint32_t)box_rows, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank,
                        const_cast<__nv_bfloat16*>(p), dims, strides, box, elem,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// The 2-D map of a rows x cols bf16 matrix with a row pitch of ld
// elements, read in boxes of box_rows x 64 columns.
static int tensor_map(CUtensorMap* map, const __nv_bfloat16* p, int rows,
                      int cols, int ld, int box_rows) {
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)ld * sizeof(__nv_bfloat16)};
  return encode_map(map, p, 2, dims, strides, box_rows);
}

// The 3-D map of `count` contiguous rows x cols bf16 matrices, one a
// plane, read in boxes of box_rows x 64 columns of one matrix: a box is
// zero-filled past its own matrix's rows and columns.
static int tensor_map_3d(CUtensorMap* map, const __nv_bfloat16* p, int count,
                         int rows, int cols, int box_rows) {
  const cuuint64_t dims[3] = {(cuuint64_t)cols, (cuuint64_t)rows,
                              (cuuint64_t)count};
  const cuuint64_t strides[2] = {
      (cuuint64_t)cols * sizeof(__nv_bfloat16),
      (cuuint64_t)rows * cols * sizeof(__nv_bfloat16)};
  return encode_map(map, p, 3, dims, strides, box_rows);
}

}  // namespace sm90
}  // namespace basd
