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
// MN-major B, and the split-K weight gradients with both MN-major), and
// K2g's two products (block.cu), which run the same body under a kernel
// name of their own, swiglu_mlp_gemm_kernel.
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
// operands' addresses), by tma.cuh's tensor_map.
//
// The rule (sm90_ok, mirrored by kernels/gemm.py: gemm_nk_variant and
// gemm_bwd_variant): bf16, every leading dimension % 8 == 0 (TMA's 16-byte
// row pitch) and every operand and output address 16-byte aligned.
// Anything else keeps the WMMA tile.
//
// Included by block_kernels.cuh after GemmT and gemm_epilogue, which it
// uses.
#pragma once

#include <initializer_list>

#include "tma.cuh"

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

template <bool MN>
__device__ __forceinline__ uint64_t operand_desc(const uint8_t* tile, int kk) {
  return MN ? smem_desc_mn(tile + kk * 16 * 128, BOX_BYTES)
            : smem_desc(tile + kk * 32);
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

// The kernels' body: the tensor maps are the kernel's __grid_constant__
// parameters, which TMA reads in place.
template <int EPI, int TN, bool A_MN, bool B_MN>
__device__ __forceinline__ void gemm_sm90_body(const CUtensorMap& map_a,
                                               const CUtensorMap& map_b,
                                               const GemmT<bf16>& g) {
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

template <int EPI, int TN, bool A_MN, bool B_MN>
__global__ void __launch_bounds__(THREADS, 2)
    gemm_sm90_kernel(const __grid_constant__ CUtensorMap map_a,
                     const __grid_constant__ CUtensorMap map_b,
                     const GemmT<bf16> g) {
  gemm_sm90_body<EPI, TN, A_MN, B_MN>(map_a, map_b, g);
}

// The same GEMM under a name of its own: K2g's two products (block.cu), so
// that a device trace tells the SwiGLU MLP half's time apart.
template <int EPI, int TN>
__global__ void __launch_bounds__(THREADS, 2)
    swiglu_mlp_gemm_kernel(const __grid_constant__ CUtensorMap map_a,
                           const __grid_constant__ CUtensorMap map_b,
                           const GemmT<bf16> g) {
  gemm_sm90_body<EPI, TN, false, false>(map_a, map_b, g);
}

template <int EPI, int TN, bool A_MN, bool B_MN, bool SWIGLU>
constexpr auto sm90_kernel() {
  if constexpr (SWIGLU) {
    static_assert(!A_MN && !B_MN, "K2g's products are forward products");
    return &swiglu_mlp_gemm_kernel<EPI, TN>;
  } else {
    return &gemm_sm90_kernel<EPI, TN, A_MN, B_MN>;
  }
}

// One product on the sm90 GEMM; k_chunk (a multiple of TK, or K) is the
// contraction of one blockIdx.z. SWIGLU: under swiglu_mlp_gemm_kernel.
template <int EPI, int TN, bool A_MN, bool B_MN, bool SWIGLU = false>
static int launch(GemmT<bf16> g, int k_chunk, cudaStream_t st) {
  using C = Cfg<TN>;
  constexpr auto kernel = sm90_kernel<EPI, TN, A_MN, B_MN, SWIGLU>();
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
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
  kernel<<<grid, THREADS, C::SMEM, st>>>(map_a, map_b, g);
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
