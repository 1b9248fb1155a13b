// Shared device code for the port's hand-written Hopper kernels.
//
// One building block serves every matrix product inside the ported TPU
// kernels (K1/K3 attention halves, K2/K4 MLP halves and their backward,
// K7 Newton-Schulz polar): `tile_mma_k`, a 64x64 output tile of
// C = A . B over a range of the contraction with bf16 operands and f32
// accumulation on the tensor cores (WMMA 16x16x16, four warps of 32x32
// each), operands staged through shared memory in 32-deep K slices,
// zero-filled at the ragged edges so any M, N, K is exact. A is given as
// M x K or, for the weight gradients (X^T dY), as K x M; B as N x K (a
// weight in torch's (out, in) layout) or K x N. The f32 tile is left in
// shared memory for the caller's epilogue, which does the reference's
// bf16 rounding at the same points as the Pallas kernels.
//
// It is simple on purpose: no TMA, no wgmma, no multi-stage pipeline. The
// block kernels' bf16 products take gemm_sm90.cuh's GEMM, which has them,
// wherever its rule allows; this tile serves the operands it refuses
// (leading dimensions not a multiple of 8, unaligned addresses).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include <initializer_list>
#include <type_traits>

namespace basd {

using bf16 = __nv_bfloat16;

constexpr int BM = 64;
constexpr int BN = 64;
constexpr int BK = 32;
constexpr int A_LD = BK + 8;    // A tile [BM][BK], padded rows
constexpr int AKM_LD = BM + 8;  // A tile stored [BK][BM] (A given as K x M)
constexpr int BNK_LD = BK + 8;  // B tile stored [BN][BK] (B given as N x K)
constexpr int BKN_LD = BN + 8;  // B tile stored [BK][BN] (B given as K x N)
constexpr int C_LD = BN + 4;    // f32 result tile [BM][BN]
constexpr int TILE_THREADS = 128;  // four warps, 2 x 2 over the 64 x 64 tile

struct TileSmem {
  alignas(128) bf16 a[BM * A_LD > BK * AKM_LD ? BM * A_LD : BK * AKM_LD];
  alignas(128) bf16 b[BN * BNK_LD > BK * BKN_LD ? BN * BNK_LD : BK * BKN_LD];
  alignas(128) float c[BM * C_LD];
};

__device__ __forceinline__ float bf2f(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ bf16 f2bf(float v) { return __float2bfloat16(v); }
__device__ __forceinline__ float round_bf(float v) { return bf2f(f2bf(v)); }

// The element type T of a kernel templated on bf16 or float: to_f widens,
// from_f rounds to T, round_t rounds to T and back (the identity at f32).
template <typename T>
__device__ __forceinline__ float to_f(T v) {
  if constexpr (std::is_same_v<T, bf16>) {
    return __bfloat162float(v);
  } else {
    return v;
  }
}
template <typename T>
__device__ __forceinline__ T from_f(float v) {
  if constexpr (std::is_same_v<T, bf16>) {
    return __float2bfloat16(v);
  } else {
    return v;
  }
}
template <typename T>
__device__ __forceinline__ float round_t(float v) {
  return to_f<T>(from_f<T>(v));
}

// Two neighbouring elements (an even offset) widened to f32.
__device__ __forceinline__ float2 load2(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}

// Keeps a parameter out of template argument deduction (a null pointer
// argument then converts to the deduced T*).
template <typename T>
struct no_deduce {
  using type = T;
};
template <typename T>
using no_deduce_t = typename no_deduce<T>::type;

// Elements of T in 16 bytes: the width of the kernels' vector accesses.
template <typename T>
__host__ __device__ constexpr int epi_width() {
  return 16 / (int)sizeof(T);
}

// epi_width<T>() elements of T in one 16-byte access.
template <typename T>
struct alignas(16) Vec16 {
  T v[epi_width<T>()];
};

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// True when 8-element (16-byte) vector loads are legal for a row-major
// matrix with leading dimension `ld` starting at `p`.
__host__ __device__ inline bool vec_ok(const void* p, int ld) {
  return (reinterpret_cast<uintptr_t>(p) % 16 == 0) && (ld % 8 == 0);
}

// Copy the rows x cols window at (r0, c0) of a row-major R x C matrix into
// shared memory (row stride ld_s), zero-filling outside the matrix.
// `cols` is a multiple of 8.
__device__ __forceinline__ void load_tile(bf16* s, int ld_s, const bf16* g,
                                          int ld_g, int R, int C, int r0,
                                          int c0, int rows, int cols,
                                          bool vec) {
  const int chunks = cols / 8;
  for (int i = threadIdx.x; i < rows * chunks; i += blockDim.x) {
    const int r = i / chunks;
    const int c = (i % chunks) * 8;
    const int gr = r0 + r;
    const int gc = c0 + c;
    bf16* dst = s + r * ld_s + c;
    if (vec && gr < R && gc + 8 <= C) {
      *reinterpret_cast<uint4*>(dst) =
          *reinterpret_cast<const uint4*>(g + (size_t)gr * ld_g + gc);
    } else {
      for (int j = 0; j < 8; ++j) {
        dst[j] = (gr < R && gc + j < C) ? g[(size_t)gr * ld_g + gc + j]
                                        : f2bf(0.f);
      }
    }
  }
}

// sm.c[0:BM, 0:BN] = sum over k in [k_begin, k_end) of
// A[m0:m0+BM, k] B[k, n0:n0+BN] in f32 (k_begin a multiple of BK).
// With A_KM, A is given as K x M row-major (the tile is A^T's); otherwise
// M x K. With B_NK, B is given as N x K row-major (a weight in torch's
// (out, in) layout, or X for X X^T); otherwise as K x N row-major.
// Must be called by all TILE_THREADS threads of the block.
template <bool A_KM, bool B_NK>
__device__ void tile_mma_k(TileSmem& sm, const bf16* A, int lda, bool a_vec,
                           const bf16* B, int ldb, bool b_vec, int M, int N,
                           int k_begin, int k_end, int m0, int n0) {
  using namespace nvcuda;
  using ALayout = std::conditional_t<A_KM, wmma::col_major, wmma::row_major>;
  using BLayout = std::conditional_t<B_NK, wmma::col_major, wmma::row_major>;
  const int warp = threadIdx.x / 32;
  const int wm = (warp / 2) * 32;
  const int wn = (warp % 2) * 32;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  for (int k0 = k_begin; k0 < k_end; k0 += BK) {
    if constexpr (A_KM) {
      load_tile(sm.a, AKM_LD, A, lda, k_end, M, k0, m0, BK, BM, a_vec);
    } else {
      load_tile(sm.a, A_LD, A, lda, M, k_end, m0, k0, BM, BK, a_vec);
    }
    if constexpr (B_NK) {
      load_tile(sm.b, BNK_LD, B, ldb, N, k_end, n0, k0, BN, BK, b_vec);
    } else {
      load_tile(sm.b, BKN_LD, B, ldb, k_end, N, k0, n0, BK, BN, b_vec);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, ALayout> fa[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, BLayout> fb[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        if constexpr (A_KM) {
          wmma::load_matrix_sync(fa[i], sm.a + kk * AKM_LD + wm + 16 * i,
                                 AKM_LD);
        } else {
          wmma::load_matrix_sync(fa[i], sm.a + (wm + 16 * i) * A_LD + kk,
                                 A_LD);
        }
      }
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        if constexpr (B_NK) {
          wmma::load_matrix_sync(fb[j], sm.b + (wn + 16 * j) * BNK_LD + kk,
                                 BNK_LD);
        } else {
          wmma::load_matrix_sync(fb[j], sm.b + kk * BKN_LD + wn + 16 * j,
                                 BKN_LD);
        }
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(sm.c + (wm + 16 * i) * C_LD + wn + 16 * j,
                              acc[i][j], C_LD, wmma::mem_row_major);
  __syncthreads();
}

// The whole contraction with A given as M x K.
template <bool B_NK>
__device__ void tile_mma(TileSmem& sm, const bf16* A, int lda, bool a_vec,
                         const bf16* B, int ldb, bool b_vec, int M, int N,
                         int K, int m0, int n0) {
  tile_mma_k<false, B_NK>(sm, A, lda, a_vec, B, ldb, b_vec, M, N, 0, K, m0,
                          n0);
}

}  // namespace basd

#define BASD_CHECK_LAUNCH()                      \
  do {                                           \
    cudaError_t err_ = cudaGetLastError();       \
    if (err_ != cudaSuccess) return (int)err_;   \
  } while (0)
