// The forward GEMM of the port's block kernels on Hopper's tensor cores:
//   out[M, N] = epilogue(A[M, K] . W[N, K]^T)
// with A row-major and W in torch's (out, in) layout, both bf16 and both
// K-major, which is wgmma's canonical operand layout. It carries every
// launch_gemm_nk call of csrc/block_kernels.cuh that passes the rule below:
// the forward products of K1, K2, K3a, K4a, K11a and the recomputed
// forwards inside K3b, K4b and K11b.
//
// What bounds it on the H100: at the teacher's MLP (M = 25216 rows, D =
// 384, F = 1536) each product is 29.7 GFLOP, 30 us at the 989 TFLOP/s
// bf16 peak, against 20-97 MB of operands and output (6-29 us at 3.35
// TB/s): operations, and the fc1 output's write. The WMMA tile of
// common.cuh reached 7.5% of that bound: its 32-deep slices were loaded by
// every thread between two barriers, so no load overlapped a product.
//
// Design:
// - A CTA owns a 128 x TN output tile (TN = 128 where N >= 256, else 64). Two consumer warpgroups each hold 64 rows of f32 accumulators in
//   registers and issue wgmma.mma_async.m64nTNk16 with both operands read
//   from shared memory through descriptors.
// - One producer warp keeps a ring of STAGES stages in flight: each stage
//   is a 128 x 64 slice of A and a TN x 64 slice of W, copied by TMA
//   (cp.async.bulk.tensor, a 128-byte swizzle matching the descriptors'
//   layout), its arrival counted by a "full" mbarrier; the consumers
//   release a stage through its "empty" mbarrier once the products that
//   read it have completed (wgmma.wait_group 1 keeps one stage of
//   products in flight behind the next one's issue).
// - TMA zero-fills the box outside the matrix, so ragged M, N and K are
//   exact; the epilogue stores only rows < M and columns < N.
// - The epilogue is block_kernels.cuh's gemm_epilogue on the f32 tile,
//   parked in the ring's shared memory once the last stage is consumed:
//   the same rounding points as the WMMA tile (bias, round to bf16, GELU,
//   round; mask and residual in f32, rounded once; the second write into
//   the collection slab).
// - Sized for two CTAs an SM (at most ~99 KB of shared memory each), so
//   one CTA's epilogue overlaps the other's products.
//
// The tensor maps are encoded on the host at each launch (they hold the
// operands' addresses), through cuTensorMapEncodeTiled reached with
// cudaGetDriverEntryPoint: the library links nothing beyond the runtime.
//
// The rule (gemm_nk_tile_n, mirrored by kernels/block_mlp.py:
// gemm_nk_variant): bf16, K % 8 == 0 (TMA's 16-byte row pitch) and A, W
// and out 16-byte aligned. Anything else keeps the WMMA tile.
//
// Included by block_kernels.cuh after GemmT and gemm_epilogue, which it
// uses.
#pragma once

#include <cuda.h>  // CUtensorMap and its enums; no driver call is linked

namespace basd {
namespace sm90 {

constexpr int TM = 128;  // tile rows: two consumer warpgroups of 64
constexpr int TK = 64;   // contraction per stage: one 128-byte row of bf16
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
// (stride byte offset), the leading byte offset unused (1).
__device__ __forceinline__ uint64_t smem_desc(const void* p) {
  const uint64_t a = smem_u32(p);
  return ((a & 0x3FFFF) >> 4) | (uint64_t(1) << 16) |
         (uint64_t(1024 >> 4) << 32) | (uint64_t(1) << 62);
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

// d[64 x TN] += A[64 x 16] . B[TN x 16]^T, both K-major in shared memory,
// f32 accumulators in the m64nTN layout (thread t of the warpgroup holds
// rows 16 (t / 32) + (t % 32) / 4 + 8 ((i / 2) % 2) and columns
// 8 (i / 4) + 2 (t % 4) + i % 2 for its registers i).
template <int TN>
__device__ __forceinline__ void wgmma_bf16(float* d, uint64_t a, uint64_t b);

template <>
__device__ __forceinline__ void wgmma_bf16<64>(float* d, uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_bf16<128>(float* d, uint64_t a, uint64_t b) {
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
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
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
      : "l"(a), "l"(b), "r"(1));
}


template <int EPI, int TN>
__global__ void __launch_bounds__(THREADS, 2)
    gemm_nk_sm90_kernel(const __grid_constant__ CUtensorMap map_a,
                        const __grid_constant__ CUtensorMap map_w,
                        const GemmT<bf16> g) {
  using C = Cfg<TN>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + C::BARS);
  uint64_t* empty = full + C::STAGES;
  const int m0 = blockIdx.y * TM;
  const int n0 = blockIdx.x * TN;
  const int k_tiles = (g.K + TK - 1) / TK;

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
      for (int kt = 0; kt < k_tiles; ++kt) {
        const int s = kt % C::STAGES;
        if (kt >= C::STAGES) mbar_wait(&empty[s], (kt / C::STAGES - 1) & 1);
        uint8_t* stage = smem + s * C::STAGE_BYTES;
        mbar_expect_tx(&full[s], C::STAGE_BYTES);
        tma_load_2d(stage, &map_a, &full[s], kt * TK, m0);
        tma_load_2d(stage + C::A_BYTES, &map_w, &full[s], kt * TK, n0);
      }
    }
  } else {
    const int wg = threadIdx.x / 128;
#pragma unroll
    for (int i = 0; i < TN / 2; ++i) acc[i] = 0.f;
    for (int kt = 0; kt < k_tiles; ++kt) {
      const int s = kt % C::STAGES;
      mbar_wait(&full[s], (kt / C::STAGES) & 1);
      const bf16* a = reinterpret_cast<const bf16*>(smem + s * C::STAGE_BYTES) +
                      wg * 64 * TK;
      const bf16* b = reinterpret_cast<const bf16*>(smem + s * C::STAGE_BYTES +
                                                    C::A_BYTES);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < TK / 16; ++kk) {
        wgmma_bf16<TN>(acc, smem_desc(a + kk * 16), smem_desc(b + kk * 16));
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

// The map of a row-major rows x cols bf16 matrix read in boxes of
// box_rows x TK, 128-byte swizzle, zero fill outside the matrix.
static int tensor_map(CUtensorMap* map, const bf16* p, int rows, int cols,
                      int box_rows) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * sizeof(bf16)};
  const cuuint32_t box[2] = {(cuuint32_t)TK, (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                        const_cast<bf16*>(p), dims, strides, box, elem,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

template <int EPI, int TN>
static int launch(GemmT<bf16> g, cudaStream_t st) {
  using C = Cfg<TN>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      gemm_nk_sm90_kernel<EPI, TN>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (attr != cudaSuccess) return (int)attr;
  CUtensorMap map_a, map_w;
  int rc = tensor_map(&map_a, g.A, g.M, g.K, TM);
  if (rc) return rc;
  rc = tensor_map(&map_w, g.B, g.N, g.K, TN);
  if (rc) return rc;
  g.epi_vec = epi_vec_ok(g);
  const dim3 grid((g.N + TN - 1) / TN, (g.M + TM - 1) / TM);
  gemm_nk_sm90_kernel<EPI, TN><<<grid, THREADS, C::SMEM, st>>>(map_a, map_w,
                                                               g);
  BASD_CHECK_LAUNCH();
  return 0;
}

}  // namespace sm90

// The forward GEMM's variant, decided before launch: the tile width of
// the sm90 GEMM, or 0 for the WMMA tile. Tiles 128 wide where N >= 256,
// else 64 (measured on an H100 by basd_tpu_torch/tune.py at the main
// path's shapes: 128 is 8-24% faster from N = 384 up, and at N = 576 too
// despite its half-empty last tile; 64 is 9% faster at N = 192).
// kernels/block_mlp.py:gemm_nk_variant and gemm_nk_tile_n mirror it.
inline int gemm_nk_tile_n(int N, int K, const void* A, const void* W,
                          const void* out) {
  const bool ok = K > 0 && K % 8 == 0 &&
                  reinterpret_cast<uintptr_t>(A) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(W) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(out) % 16 == 0;
  if (!ok) return 0;
  return N >= 256 ? 128 : 64;
}

}  // namespace basd
