// The GEMM of the port's block kernels on Hopper's tensor cores:
//   out[M, N] = epilogue(A . B)
// in bf16 with f32 accumulation. Each operand has a compile-time major:
// - A is K-major (A[M, K] row-major: the forward's activations, dY in
//   dY W) or MN-major (stored K x M: dY in the weight gradient dY^T X);
// - B is K-major (W[N, K], torch's (out, in) layout, in the forward's
//   x W^T) or MN-major (stored K x N: W in the input gradient dY W, X in
//   the weight gradient).
// It carries every launch_gemm_nk call of csrc/block_kernels.cuh that
// passes the rule below (the forward products of K1, K2, K3a, K4a, K11a
// and the recomputed forwards inside K3b, K4b and K11b: both K-major) and
// every launch_gemm_bwd call (the backward products of K3b, K4b and K11b:
// input gradients, the GELU-gradient and rounded products with an
// MN-major B, and the split-K weight gradients with both MN-major).
//
// What bounds it on the H100: at the teacher's MLP (M = 25216 rows, D =
// 384, F = 1536) each forward product is 29.7 GFLOP, 30 us at the 989
// TFLOP/s bf16 peak, against 20-97 MB of operands and output (6-29 us at
// 3.35 TB/s): operations, and the fc1 output's write. The student's
// backward products (D = 192, F = 768) are 1.9-7.4 GFLOP against 19-87 MB:
// bytes. The WMMA tile of common.cuh reached 4-8% of those bounds: its
// 32-deep slices were loaded by every thread between two barriers, so no
// load overlapped a product.
//
// Design:
// - A CTA owns a 128 x TN output tile (TN = 128 where N >= 256, else 64).
//   Two consumer warpgroups each hold 64 rows of f32 accumulators in
//   registers and issue wgmma.mma_async.m64nTNk16 with both operands read
//   from shared memory through descriptors; an MN-major operand sets the
//   instruction's transpose bit (tnspA / tnspB) and is read through a
//   descriptor of the MN-major canonical layout.
// - One producer warp keeps a ring of STAGES stages in flight: each stage
//   is 64 deep in K, 128 rows of A and TN of B, copied by TMA
//   (cp.async.bulk.tensor, a 128-byte swizzle matching the descriptors'
//   layout), its arrival counted by a "full" mbarrier; the consumers
//   release a stage through its "empty" mbarrier once the products that
//   read it have completed (wgmma.wait_group 1 keeps one stage of
//   products in flight behind the next one's issue). A K-major operand is
//   one box of rows x 64 K; an MN-major one is boxes of 64 MN-columns x 64
//   K-rows (the swizzle runs along MN), 8 KB apart, so warpgroup w's 64
//   rows of A sit 8 KB into the stage in either layout.
// - TMA zero-fills the box outside the matrix, so ragged M, N and K are
//   exact; the epilogue stores only rows < M and columns < N. An MN box
//   wholly past M or N is not loaded: it feeds only discarded outputs.
// - Split-K (the weight gradients): blockIdx.z owns the contraction rows
//   [z k_chunk, (z + 1) k_chunk), k_chunk a multiple of the 64-deep
//   stage, and writes its own f32 partial tile (EPI_PARTIAL); the caller
//   adds the partials in split order (reduce_partials_kernel): no atomics.
// - The epilogue is block_kernels.cuh's gemm_epilogue on the f32 tile,
//   parked in the ring's shared memory once the last stage is consumed:
//   the same rounding points as the WMMA tile (bias, round to bf16, GELU,
//   round; mask and residual in f32, rounded once; the second write into
//   the collection slab; the GELU gradient with one column-sum row per
//   128-row tile).
// - Sized for two CTAs an SM (at most ~99 KB of shared memory each), so
//   one CTA's epilogue overlaps the other's products.
//
// The tensor maps are encoded on the host at each launch (they hold the
// operands' addresses), through cuTensorMapEncodeTiled reached with
// cudaGetDriverEntryPoint: the library links nothing beyond the runtime.
//
// The rule (sm90_ok, mirrored by kernels/gemm.py: gemm_nk_variant and
// gemm_bwd_variant): bf16, every leading dimension % 8 == 0 (TMA's 16-byte
// row pitch) and every operand and output address 16-byte aligned.
// Anything else keeps the WMMA tile.
//
// Included by block_kernels.cuh after GemmT and gemm_epilogue, which it
// uses.
#pragma once

#include <cuda.h>  // CUtensorMap and its enums; no driver call is linked

#include <initializer_list>

namespace basd {
namespace sm90 {

constexpr int TM = 128;  // tile rows: two consumer warpgroups of 64
constexpr int TK = 64;   // contraction per stage: one 128-byte row of bf16
constexpr int BOX_BYTES = 64 * TK * 2;  // an MN-major box: 64 MN x 64 K
constexpr int CONSUMERS = 256;
constexpr int THREADS = CONSUMERS + 32;  // and one producer warp

template <int TN>
struct Cfg {
  static constexpr int STAGES = TN <= 64 ? 4 : 3;
  static constexpr int A_BYTES = TM * TK * 2;
  static constexpr int B_BYTES = TN * TK * 2;
  static constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
  static constexpr int RING = STAGES * STAGE_BYTES;
  static constexpr int LD = TN + 8;  // f32 tile row stride: float2 stores
                                     // of a half-warp hit 32 banks once
  static constexpr int C_BYTES = TM * LD * 4;
  static constexpr int BARS = RING > C_BYTES ? RING : C_BYTES;
  // 1024 bytes of slack to align the ring for the 128-byte swizzle
  static constexpr int SMEM = 1024 + BARS + 2 * STAGES * 8;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, int bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar))
               : "memory");
}

// Spin until the phase of parity `parity` of the barrier has completed.
// A phase that never completes (a copy that never lands) traps after
// ~2^34 cycles (~10 s) instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  const uint32_t a = smem_u32(bar);
  const long long start = clock64();
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
    if (!done && clock64() - start > (1ll << 34)) __trap();
  }
}

// TMA: the box at (c0 = column, c1 = row) of the map's matrix into
// shared memory, its bytes counted on `bar`.
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1)
      : "memory");
}

// wgmma descriptor of a K-major operand tile in shared memory with the
// 128-byte swizzle: rows of 128 bytes, 8-row groups 1024 bytes apart
// (stride byte offset), the leading byte offset unused (1). A k16 step
// advances the start address by 32 bytes.
__device__ __forceinline__ uint64_t smem_desc(const void* p) {
  const uint64_t a = smem_u32(p);
  return ((a & 0x3FFFF) >> 4) | (uint64_t(1) << 16) |
         (uint64_t(1024 >> 4) << 32) | (uint64_t(1) << 62);
}

// wgmma descriptor of an MN-major operand tile with the 128-byte swizzle
// (the canonical layout ((8, 8, m), (8, k)) : ((1, 8, LBO), (64, SBO)) in
// bf16 elements): 64 MN-elements a 128-byte row, one row per K index,
// the next 64 MN-elements a box further (the leading byte offset,
// BOX_BYTES), the next 8 K-rows 1024 bytes further (the stride byte
// offset). A k16 step advances the start address by 16 rows, 2048 bytes.
__device__ __forceinline__ uint64_t smem_desc_mn(const void* p) {
  const uint64_t a = smem_u32(p);
  return ((a & 0x3FFFF) >> 4) | (uint64_t(BOX_BYTES >> 4) << 16) |
         (uint64_t(1024 >> 4) << 32) | (uint64_t(1) << 62);
}

template <bool MN>
__device__ __forceinline__ uint64_t operand_desc(const uint8_t* tile, int kk) {
  return MN ? smem_desc_mn(tile + kk * 16 * 128) : smem_desc(tile + kk * 32);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int PENDING>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(PENDING) : "memory");
}

// d[64 x TN] += A[64 x 16] . B[16 x TN] from shared memory, A K-major
// (TA = 0) or M-major (TA = 1), B K-major (TB = 0) or N-major (TB = 1);
// f32 accumulators in the m64nTN layout (thread t of the warpgroup holds
// rows 16 (t / 32) + (t % 32) / 4 + 8 ((i / 2) % 2) and columns
// 8 (i / 4) + 2 (t % 4) + i % 2 for its registers i).
template <int TN, int TA, int TB>
__device__ __forceinline__ void wgmma_bf16(float* d, uint64_t a, uint64_t b) {
  static_assert(TN == 64 || TN == 128, "tile width 64 or 128");
  if constexpr (TN == 64) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31"
        "}, %32, %33, p, 1, 1, %35, %36;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "l"(a), "l"(b), "r"(1), "n"(TA), "n"(TB));
  } else {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63"
        "}, %64, %65, p, 1, 1, %67, %68;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
          "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
          "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(a), "l"(b), "r"(1), "n"(TA), "n"(TB));
  }
}

// Copies one stage: the 128 x 64 slice of A and the TN x 64 slice of B at
// contraction row k. MN-major boxes wholly past M (or N) are skipped.
template <int TN, bool A_MN, bool B_MN>
__device__ __forceinline__ void load_stage(uint8_t* stage, const CUtensorMap* map_a,
                                           const CUtensorMap* map_b, uint64_t* bar,
                                           int m0, int n0, int k, int a_boxes,
                                           int b_boxes) {
  if constexpr (A_MN) {
    for (int h = 0; h < a_boxes; ++h)
      tma_load_2d(stage + h * BOX_BYTES, map_a, bar, m0 + 64 * h, k);
  } else {
    tma_load_2d(stage, map_a, bar, k, m0);
  }
  uint8_t* b = stage + Cfg<TN>::A_BYTES;
  if constexpr (B_MN) {
    for (int j = 0; j < b_boxes; ++j)
      tma_load_2d(b + j * BOX_BYTES, map_b, bar, n0 + 64 * j, k);
  } else {
    tma_load_2d(b, map_b, bar, k, n0);
  }
}

template <int EPI, int TN, bool A_MN, bool B_MN>
__global__ void __launch_bounds__(THREADS, 2)
    gemm_sm90_kernel(const __grid_constant__ CUtensorMap map_a,
                     const __grid_constant__ CUtensorMap map_b,
                     const GemmT<bf16> g) {
  using C = Cfg<TN>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + C::BARS);
  uint64_t* empty = full + C::STAGES;
  const int m0 = blockIdx.y * TM;
  const int n0 = blockIdx.x * TN;
  const int k_begin = blockIdx.z * g.k_chunk;
  const int k_end = min(g.K, k_begin + g.k_chunk);
  const int k_tiles = (k_end - k_begin + TK - 1) / TK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < C::STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  float acc[TN / 2];
  if (threadIdx.x >= CONSUMERS) {
    // the producer warp: one lane keeps the ring full
    if (threadIdx.x == CONSUMERS) {
      const int a_boxes = A_MN ? min(2, (g.M - m0 + 63) / 64) : 1;
      const int b_boxes = B_MN ? min(TN / 64, (g.N - n0 + 63) / 64) : 1;
      const int bytes = (A_MN ? a_boxes * BOX_BYTES : C::A_BYTES) +
                        (B_MN ? b_boxes * BOX_BYTES : C::B_BYTES);
      for (int kt = 0; kt < k_tiles; ++kt) {
        const int s = kt % C::STAGES;
        if (kt >= C::STAGES) mbar_wait(&empty[s], (kt / C::STAGES - 1) & 1);
        mbar_expect_tx(&full[s], bytes);
        load_stage<TN, A_MN, B_MN>(smem + s * C::STAGE_BYTES, &map_a, &map_b,
                                   &full[s], m0, n0, k_begin + kt * TK,
                                   a_boxes, b_boxes);
      }
    }
  } else {
    const int wg = threadIdx.x / 128;
#pragma unroll
    for (int i = 0; i < TN / 2; ++i) acc[i] = 0.f;
    for (int kt = 0; kt < k_tiles; ++kt) {
      const int s = kt % C::STAGES;
      mbar_wait(&full[s], (kt / C::STAGES) & 1);
      // warpgroup wg's 64 rows of A are 8 KB into the stage either way
      const uint8_t* a = smem + s * C::STAGE_BYTES + wg * BOX_BYTES;
      const uint8_t* b = smem + s * C::STAGE_BYTES + C::A_BYTES;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < TK / 16; ++kk) {
        wgmma_bf16<TN, A_MN, B_MN>(acc, operand_desc<A_MN>(a, kk),
                                   operand_desc<B_MN>(b, kk));
      }
      wgmma_commit();
      // the previous stage's products are done: release it
      wgmma_wait<1>();
      if (kt > 0) mbar_arrive(&empty[(kt - 1) % C::STAGES]);
    }
    wgmma_wait<0>();
  }
  __syncthreads();  // every stage consumed: the ring becomes the f32 tile

  float* c = reinterpret_cast<float*>(smem);
  if (threadIdx.x < CONSUMERS) {
    const int t = threadIdx.x % 128;
    const int row = (threadIdx.x / 128) * 64 + (t / 32) * 16 + (t % 32) / 4;
    const int col = 2 * (t % 4);
#pragma unroll
    for (int i = 0; i < TN / 2; i += 2) {
      const int r = row + 8 * ((i / 2) % 2);
      const int cc = col + 8 * (i / 4);
      *reinterpret_cast<float2*>(c + r * C::LD + cc) =
          make_float2(acc[i], acc[i + 1]);
    }
  }
  __syncthreads();
  gemm_epilogue<EPI, bf16, TM, TN, C::LD>(g, c, m0, n0);
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

// The map of a rows x cols bf16 matrix with a row pitch of ld elements,
// read in boxes of box_rows x 64 columns, 128-byte swizzle, zero fill
// outside the matrix.
static int tensor_map(CUtensorMap* map, const bf16* p, int rows, int cols,
                      int ld, int box_rows) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)ld * sizeof(bf16)};
  const cuuint32_t box[2] = {(cuuint32_t)64, (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                        const_cast<bf16*>(p), dims, strides, box, elem,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// One product on the sm90 GEMM; k_chunk (a multiple of TK, or K) is the
// contraction of one blockIdx.z.
template <int EPI, int TN, bool A_MN, bool B_MN>
static int launch(GemmT<bf16> g, int k_chunk, cudaStream_t st) {
  using C = Cfg<TN>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      gemm_sm90_kernel<EPI, TN, A_MN, B_MN>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (attr != cudaSuccess) return (int)attr;
  if (k_chunk <= 0 || (k_chunk < g.K && k_chunk % TK != 0))
    return (int)cudaErrorInvalidValue;
  CUtensorMap map_a, map_b;
  int rc = A_MN ? tensor_map(&map_a, g.A, g.K, g.M, g.lda, TK)
                : tensor_map(&map_a, g.A, g.M, g.K, g.lda, TM);
  if (rc) return rc;
  rc = B_MN ? tensor_map(&map_b, g.B, g.K, g.N, g.ldb, TK)
            : tensor_map(&map_b, g.B, g.N, g.K, g.ldb, TN);
  if (rc) return rc;
  g.k_chunk = k_chunk;
  g.epi_vec = epi_vec_ok(g);
  const dim3 grid((g.N + TN - 1) / TN, (g.M + TM - 1) / TM,
                  (g.K + k_chunk - 1) / k_chunk);
  gemm_sm90_kernel<EPI, TN, A_MN, B_MN>
      <<<grid, THREADS, C::SMEM, st>>>(map_a, map_b, g);
  BASD_CHECK_LAUNCH();
  return 0;
}

}  // namespace sm90

// The sm90 GEMM's tile width for N output columns: 128 where N >= 256,
// else 64 (measured on an H100 by basd_tpu_torch/tune.py at the main
// path's shapes: 128 is 8-24% faster from N = 384 up, and at N = 576 too
// despite its half-empty last tile; 64 is 9% faster at N = 192; among the
// backward products 64 is 5-18% faster at N = 192 and 128 14% faster for
// the GELU gradient at N = 768).
// kernels/gemm.py:sm90_tile_n mirrors it.
inline int sm90_tile_n(int N) { return N >= 256 ? 128 : 64; }

// The sm90 GEMM's rule on its operands: every leading dimension a
// multiple of 8 elements (TMA's 16-byte row pitch) and every address
// (null ones aside) 16-byte aligned.
inline bool sm90_ok(std::initializer_list<int> lds,
                    std::initializer_list<const void*> ptrs) {
  for (int ld : lds)
    if (ld <= 0 || ld % 8 != 0) return false;
  for (const void* p : ptrs)
    if (reinterpret_cast<uintptr_t>(p) % 16 != 0) return false;
  return true;
}

// The forward GEMM's variant, decided before launch: the tile width of
// the sm90 GEMM, or 0 for the WMMA tile. kernels/gemm.py:gemm_nk_variant
// mirrors it.
inline int gemm_nk_tile_n(int N, int K, const void* A, const void* W,
                          const void* out) {
  return sm90_ok({K}, {A, W, out}) ? sm90_tile_n(N) : 0;
}

// A split-K weight gradient's tile width, and the CTAs it aims for. Both
// constants, so the split count, the partials' layout and the summation
// order depend on the shapes only, never on the card. Measured on an H100
// by basd_tpu_torch/tune.py at the main path's four weight gradients (dY^T
// X over 25216 rows: 192 x 192, 576 x 192, 192 x 768, 768 x 192): width
// 64 is 16-25% faster than 128 at the same split, and 198 CTAs take
// 0.109 ms for the four against 0.116 at 264 and 0.118 at 132.
constexpr int SPLIT_TILE_N = 64;
constexpr int SPLIT_TARGET = 198;

// Contraction rows per split of a weight gradient dW (m x n) summed over
// `rows` rows: enough splits of the sm90 tile grid (128 x SPLIT_TILE_N)
// for about SPLIT_TARGET CTAs, each a whole number of the GEMM's 64-deep
// stages; the splits cover rows 0..rows-1 once each, in order.
// kernels/gemm.py:split_k_chunk mirrors it.
inline int split_k_chunk(int rows, int m, int n) {
  const int tn = SPLIT_TILE_N;
  const int tiles = ((m + sm90::TM - 1) / sm90::TM) * ((n + tn - 1) / tn);
  const int stages = (rows + sm90::TK - 1) / sm90::TK;
  const int want = (SPLIT_TARGET + tiles - 1) / tiles;
  const int fit = stages < want ? stages : want;
  const int splits = fit > 1 ? fit : 1;
  return ((stages + splits - 1) / splits) * sm90::TK;
}

}  // namespace basd
