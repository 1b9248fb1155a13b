// Device code shared by the block kernels of csrc/block.cu (K1, K2 and the
// K3a/K4a forwards), csrc/block_train.cu (the K3b/K4b backwards) and
// csrc/fused_mlp.cu (K11): the row LayerNorm, the tiled GEMMs with the
// epilogues the Pallas kernels round through, the column sums of an
// incoming gradient, the split-K weight gradient and the fixed-order
// reduction of partial sums. Everything launches on the caller's stream
// and returns the first launch error, or 0.
//
// The GEMM takes bf16 operands on the tensor cores (WMMA, common.cuh's
// tile_mma_k) or, for the f32 paths of K2/K4 and K11, f32 operands on CUDA
// cores (gemm_f32_kernel: full-f32 fused multiply-adds in order over k, no
// TF32, which the f32 paths of the reference keep off). The forward
// products (launch_gemm_nk) take gemm_sm90.cuh's wgmma GEMM instead of the
// WMMA tile where its rule allows. All three leave the f32 tile in shared
// memory for one epilogue, templated on the element type T and on the
// tile's size: every rounding to T there is the identity at f32.
#pragma once

#include "common.cuh"

namespace basd {

constexpr float GELU_C = 0.7978845608028654f;  // sqrt(2/pi)
constexpr float GELU_A = 0.044715f;

__device__ __forceinline__ float gelu_tanh(float p) {
  const float t = tanhf(GELU_C * (p + GELU_A * p * p * p));
  return 0.5f * p * (1.f + t);
}

// d/dp of gelu_tanh (basd_tpu/ops/pallas/fused_mlp.py:_gelu_tanh_grad)
__device__ __forceinline__ float gelu_tanh_grad(float p) {
  const float t = tanhf(GELU_C * (p + GELU_A * p * p * p));
  return 0.5f * (1.f + t) +
         0.5f * p * (1.f - t * t) * GELU_C * (1.f + 3.f * GELU_A * p * p);
}

// One warp per row: f32 two-pass statistics, out = T(xhat * s + b) (the
// identity rounding at f32). With mu/rstd not null the row statistics are
// stored too (the backward kernels recompute the LayerNorm and reuse them
// for its VJP).
template <typename T>
static __global__ void layernorm_kernel(const T* __restrict__ x,
                                        const float* __restrict__ scale,
                                        const float* __restrict__ bias,
                                        T* __restrict__ out,
                                        float* __restrict__ mu_out,
                                        float* __restrict__ rstd_out, int rows,
                                        int d, float eps) {
  const int row = (blockIdx.x * blockDim.x + threadIdx.x) / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  const T* xr = x + (size_t)row * d;
  T* orow = out + (size_t)row * d;
  const float inv_d = 1.f / (float)d;
  float s = 0.f;
  for (int i = lane; i < d; i += 32) s += to_f(xr[i]);
  const float mu = warp_sum(s) * inv_d;
  float sq = 0.f;
  for (int i = lane; i < d; i += 32) {
    const float c = to_f(xr[i]) - mu;
    sq += c * c;
  }
  const float var = warp_sum(sq) * inv_d;
  const float rstd = rsqrtf(var + eps);
  for (int i = lane; i < d; i += 32) {
    orow[i] = from_f<T>((to_f(xr[i]) - mu) * rstd * scale[i] + bias[i]);
  }
  if (mu_out != nullptr && lane == 0) {
    mu_out[row] = mu;
    rstd_out[row] = rstd;
  }
}

enum Epilogue {  // T: the GEMM's element type (bf16, or f32 for K11's f32 path)
  EPI_BIAS = 0,           // out = T(acc + bias)
  EPI_BIAS_GELU = 1,      // out = T(gelu(T(acc + bias)))
  EPI_BIAS_RESIDUAL = 2,  // out (and out2) = T(aux + T(acc + bias) * mask)
  EPI_BIAS_PRE_GELU = 3,  // out = p = T(acc + bias), out2 = T(gelu(p))
  EPI_DGELU = 4,          // d = acc * gelu'(aux); out = T(d); colpart += d
  EPI_F32 = 5,            // outf = acc
  EPI_PARTIAL = 6,        // outf[split] = acc over this split's K range
  EPI_ROUND = 7,          // out = T(acc)
};

// out[M, N] = epilogue(A . B) over the K range of blockIdx.z; operands,
// out, out2 and aux in T (bf16 or float).
template <typename T>
struct GemmT {
  const T* A;
  const T* B;
  int lda, ldb;
  bool a_vec, b_vec;
  int M, N, K;
  int k_chunk;  // contraction rows per blockIdx.z (a multiple of BK)
  const float* bias;
  T* out;
  T* out2;
  float* outf;
  const T* aux;        // residual (EPI_BIAS_RESIDUAL) or pre-GELU (EPI_DGELU)
  const float* mask;   // per block of rows_per_mask rows; null means 1
  int rows_per_mask;
  bool epi_vec;        // 16-byte epilogue accesses are legal (epi_vec_ok)
};
using Gemm = GemmT<bf16>;

// Elements of T in 16 bytes: the bias epilogues' vector width.
template <typename T>
__host__ __device__ constexpr int epi_width() {
  return 16 / (int)sizeof(T);
}

// The bias epilogues may move 16 bytes at a time: N a multiple of the
// width and every pointer they touch 16-byte aligned.
template <typename T>
inline bool epi_vec_ok(const GemmT<T>& g) {
  auto al = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  return g.N % epi_width<T>() == 0 && al(g.bias) && al(g.out) && al(g.out2) &&
         al(g.aux);
}

// The bias epilogues' arithmetic on one element: y = T(acc + bias); out =
// y, T(gelu(y)) or T(aux + y * m) (mask and residual in f32, rounded
// once); out2 = T(gelu(y)) beside the pre-activation, or the residual
// output's second copy.
template <int EPI, typename T>
__device__ __forceinline__ void bias_epilogue(float acc, float bias, float aux,
                                              float m, T& out, T& out2) {
  const float y = round_t<T>(acc + bias);
  if constexpr (EPI == EPI_BIAS) {
    out = from_f<T>(y);
  } else if constexpr (EPI == EPI_BIAS_GELU) {
    out = from_f<T>(gelu_tanh(y));
  } else if constexpr (EPI == EPI_BIAS_PRE_GELU) {
    out = from_f<T>(y);
    out2 = from_f<T>(gelu_tanh(y));
  } else {  // EPI_BIAS_RESIDUAL
    out = out2 = from_f<T>(aux + y * m);
  }
}

// W elements of T in one 16-byte access.
template <typename T>
struct alignas(16) Vec16 {
  T v[epi_width<T>()];
};

// The epilogue of one TM x TN tile at (m0, n0) whose f32 sums sit in
// shared memory at c (row stride LD): the WMMA and f32 tiles' BM x BN and
// the sm90 GEMM's 128 x TN. Must be called by every thread of the block.
template <int EPI, typename T, int TM = BM, int TN = BN, int LD = C_LD>
__device__ void gemm_epilogue(const GemmT<T>& g, float* c, int m0, int n0) {
  if constexpr (EPI == EPI_DGELU) {
    // d = acc * gelu'(pre) in place in the tile, then each of the first TN
    // threads sums its column over the tile's rows in order: one partial
    // row per row tile, summed in a fixed order by reduce_partials.
    for (int i = threadIdx.x; i < TM * TN; i += blockDim.x) {
      const int r = i / TN;
      const int cc = i % TN;
      const int gr = m0 + r;
      const int gc = n0 + cc;
      float d = 0.f;
      if (gr < g.M && gc < g.N) {
        const size_t o = (size_t)gr * g.N + gc;
        d = c[r * LD + cc] * gelu_tanh_grad(to_f(g.aux[o]));
        g.out[o] = from_f<T>(d);
      }
      c[r * LD + cc] = d;
    }
    __syncthreads();
    if (threadIdx.x < TN && n0 + threadIdx.x < g.N) {
      float s = 0.f;
      for (int r = 0; r < TM; ++r) s += c[r * LD + threadIdx.x];
      g.outf[(size_t)blockIdx.y * g.N + n0 + threadIdx.x] = s;
    }
    return;
  }
  constexpr bool BIAS_EPI = EPI == EPI_BIAS || EPI == EPI_BIAS_GELU ||
                            EPI == EPI_BIAS_PRE_GELU ||
                            EPI == EPI_BIAS_RESIDUAL;
  constexpr bool TWO = EPI == EPI_BIAS_PRE_GELU || EPI == EPI_BIAS_RESIDUAL;
  constexpr int W = epi_width<T>();
  if constexpr (BIAS_EPI && TN % W == 0) {
    if (g.epi_vec) {
      // W consecutive columns a thread: 16-byte loads of the tile, the bias
      // and the residual, 16-byte stores
      for (int i = threadIdx.x; i < TM * (TN / W); i += blockDim.x) {
        const int r = i / (TN / W);
        const int cc = (i % (TN / W)) * W;
        const int gr = m0 + r;
        const int gc = n0 + cc;
        if (gr >= g.M || gc >= g.N) continue;
        const size_t o = (size_t)gr * g.N + gc;
        float acc[W], bias[W];
#pragma unroll
        for (int j = 0; j < W; j += 4) {
          *reinterpret_cast<float4*>(acc + j) =
              *reinterpret_cast<const float4*>(c + r * LD + cc + j);
          *reinterpret_cast<float4*>(bias + j) =
              *reinterpret_cast<const float4*>(g.bias + gc + j);
        }
        Vec16<T> aux{}, out, out2;
        float m = 1.f;
        if constexpr (EPI == EPI_BIAS_RESIDUAL) {
          aux = *reinterpret_cast<const Vec16<T>*>(g.aux + o);
          if (g.mask) m = g.mask[gr / g.rows_per_mask];
        }
#pragma unroll
        for (int j = 0; j < W; ++j) {
          bias_epilogue<EPI, T>(acc[j], bias[j], to_f(aux.v[j]), m, out.v[j],
                                out2.v[j]);
        }
        *reinterpret_cast<Vec16<T>*>(g.out + o) = out;
        if (TWO && g.out2) *reinterpret_cast<Vec16<T>*>(g.out2 + o) = out2;
      }
      return;
    }
  }
  for (int i = threadIdx.x; i < TM * TN; i += blockDim.x) {
    const int r = i / TN;
    const int cc = i % TN;
    const int gr = m0 + r;
    const int gc = n0 + cc;
    if (gr >= g.M || gc >= g.N) continue;
    const float acc = c[r * LD + cc];
    const size_t o = (size_t)gr * g.N + gc;
    if constexpr (EPI == EPI_F32) {
      g.outf[o] = acc;
    } else if constexpr (EPI == EPI_ROUND) {
      g.out[o] = from_f<T>(acc);
    } else if constexpr (EPI == EPI_PARTIAL) {
      g.outf[(size_t)blockIdx.z * g.M * g.N + o] = acc;
    } else {
      float aux = 0.f, m = 1.f;
      if constexpr (EPI == EPI_BIAS_RESIDUAL) {
        aux = to_f(g.aux[o]);
        if (g.mask) m = g.mask[gr / g.rows_per_mask];
      }
      T out, out2;
      bias_epilogue<EPI, T>(acc, g.bias[gc], aux, m, out, out2);
      g.out[o] = out;
      if (TWO && g.out2) g.out2[o] = out2;
    }
  }
}

template <bool A_KM, bool B_NK, int EPI>
__global__ void __launch_bounds__(TILE_THREADS) gemm_kernel(Gemm g) {
  __shared__ __align__(128) TileSmem sm;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  const int k_begin = blockIdx.z * g.k_chunk;
  const int k_end = min(g.K, k_begin + g.k_chunk);
  tile_mma_k<A_KM, B_NK>(sm, g.A, g.lda, g.a_vec, g.B, g.ldb, g.b_vec, g.M,
                         g.N, k_begin, k_end, m0, n0);
  gemm_epilogue<EPI>(g, sm.c, m0, n0);
}

constexpr int F_BK = 16;  // contraction rows per step of the f32 GEMM

struct TileSmemF32 {
  float a[F_BK][BM + 4];  // A tile as [k][m]
  float b[F_BK][BN + 4];  // B tile as [k][n]
  float c[BM * C_LD];
};

// The f32 GEMM: the same tiles, split-K ranges and epilogues as gemm_kernel,
// on CUDA cores. Thread (ty, tx) of 8 x 16 owns rows 8ty..8ty+7 and columns
// 4tx..4tx+3 of the tile; every sum is fused multiply-adds in order over k.
template <bool A_KM, bool B_NK, int EPI>
__global__ void __launch_bounds__(TILE_THREADS)
    gemm_f32_kernel(GemmT<float> g) {
  __shared__ __align__(16) TileSmemF32 sm;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  const int k_begin = blockIdx.z * g.k_chunk;
  const int k_end = min(g.K, k_begin + g.k_chunk);
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  float acc[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = k_begin; k0 < k_end; k0 += F_BK) {
    // consecutive threads read consecutive addresses of either layout
    for (int i = threadIdx.x; i < F_BK * BM; i += TILE_THREADS) {
      const int m = A_KM ? i % BM : i / F_BK;
      const int k = A_KM ? i / BM : i % F_BK;
      const int gm = m0 + m;
      const int gk = k0 + k;
      float v = 0.f;
      if (gm < g.M && gk < k_end)
        v = A_KM ? g.A[(size_t)gk * g.lda + gm] : g.A[(size_t)gm * g.lda + gk];
      sm.a[k][m] = v;
    }
    for (int i = threadIdx.x; i < F_BK * BN; i += TILE_THREADS) {
      const int n = B_NK ? i / F_BK : i % BN;
      const int k = B_NK ? i % F_BK : i / BN;
      const int gn = n0 + n;
      const int gk = k0 + k;
      float v = 0.f;
      if (gn < g.N && gk < k_end)
        v = B_NK ? g.B[(size_t)gn * g.ldb + gk] : g.B[(size_t)gk * g.ldb + gn];
      sm.b[k][n] = v;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < F_BK; ++kk) {
      float a[8], b[4];
#pragma unroll
      for (int i = 0; i < 8; ++i) a[i] = sm.a[kk][8 * ty + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = sm.b[kk][4 * tx + j];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          acc[i][j] = __fmaf_rn(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      sm.c[(8 * ty + i) * C_LD + 4 * tx + j] = acc[i][j];
  __syncthreads();
  gemm_epilogue<EPI>(g, sm.c, m0, n0);
}

// out[j] = sum_{s < S} part[s * n + j], s in order: the second pass of
// every cross-block sum (deterministic, no atomics).
static __global__ void reduce_partials_kernel(const float* __restrict__ part,
                                       float* __restrict__ out, int S,
                                       int n) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= n) return;
  float acc = 0.f;
  for (int s = 0; s < S; ++s) acc += part[(size_t)s * n + j];
  out[j] = acc;
}

// A gemm of A (M x K, or K x M with A_KM) and B (N x K with B_NK, else
// K x N) into an M x N output; split > 1 only with EPI_PARTIAL. bf16
// operands take the WMMA kernel, f32 operands the CUDA-core one.
template <bool A_KM, bool B_NK, int EPI, typename T>
static int launch_gemm(GemmT<T> g, int k_chunk, cudaStream_t st) {
  g.k_chunk = k_chunk;
  g.a_vec = vec_ok(g.A, g.lda);
  g.b_vec = vec_ok(g.B, g.ldb);
  g.epi_vec = epi_vec_ok(g);
  const int splits = (g.K + k_chunk - 1) / k_chunk;
  dim3 grid((g.N + BN - 1) / BN, (g.M + BM - 1) / BM, splits);
  if constexpr (std::is_same_v<T, float>) {
    gemm_f32_kernel<A_KM, B_NK, EPI><<<grid, TILE_THREADS, 0, st>>>(g);
  } else {
    gemm_kernel<A_KM, B_NK, EPI><<<grid, TILE_THREADS, 0, st>>>(g);
  }
  BASD_CHECK_LAUNCH();
  return 0;
}

}  // namespace basd

#include "gemm_sm90.cuh"

namespace basd {

// out[M, N] = epilogue(A[M, K] . W[N, K]^T + bias): the forward products,
// W in torch's (out, in) layout. bf16 operands that pass gemm_nk_tile_n's
// rule take the sm90 GEMM, other bf16 operands the WMMA tile, f32 ones the
// CUDA-core tile.
template <int EPI, typename T>
static int launch_gemm_nk(const T* A, const T* W, const float* bias, T* out,
                          int M, int N, int K, no_deduce_t<const T*> aux,
                          const float* mask, int rows_per_mask,
                          no_deduce_t<T*> out2, cudaStream_t st) {
  GemmT<T> g{};
  g.A = A;
  g.lda = K;
  g.B = W;
  g.ldb = K;
  g.M = M;
  g.N = N;
  g.K = K;
  g.bias = bias;
  g.out = out;
  g.out2 = out2;
  g.aux = aux;
  g.mask = mask;
  g.rows_per_mask = rows_per_mask;
  if constexpr (std::is_same_v<T, bf16>) {
    const int tile_n = gemm_nk_tile_n(N, K, A, W, out);
    if (tile_n == 128) return sm90::launch<EPI, 128>(g, st);
    if (tile_n == 64) return sm90::launch<EPI, 64>(g, st);
  }
  return launch_gemm<false, true, EPI>(g, K, st);
}

template <typename T>
static int launch_layernorm(const T* x, const float* s, const float* b,
                            T* out, float* mu, float* rstd, int rows, int d,
                            float eps, cudaStream_t st) {
  const int threads = 256;
  const int blocks = (int)(((size_t)rows * 32 + threads - 1) / threads);
  layernorm_kernel<T><<<blocks, threads, 0, st>>>(x, s, b, out, mu, rstd,
                                                  rows, d, eps);
  BASD_CHECK_LAUNCH();
  return 0;
}

static int launch_reduce(const float* part, float* out, int S, int n,
                         cudaStream_t st) {
  reduce_partials_kernel<<<(n + 255) / 256, 256, 0, st>>>(part, out, S, n);
  BASD_CHECK_LAUNCH();
  return 0;
}

// dy = do * mask[row / N] (f32) -> dyb (bf16); part[chunk, c] = sum of dy
// over the chunk's rows, in order. One thread per column. A null mask is
// 1 and a null dyb is not written: the plain column sums of do.
template <typename T>
static __global__ void dy_kernel(const T* __restrict__ dout,
                                 const float* __restrict__ mask,
                                 T* __restrict__ dyb,
                                 float* __restrict__ part, int M, int N, int D,
                                 int row_chunk) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= D) return;
  const int r0 = blockIdx.y * row_chunk;
  const int r1 = min(M, r0 + row_chunk);
  float acc = 0.f;
  for (int r = r0; r < r1; ++r) {
    const size_t o = (size_t)r * D + c;
    const float dy = mask ? to_f(dout[o]) * mask[r / N] : to_f(dout[o]);
    if (dyb) dyb[o] = from_f<T>(dy);
    acc += dy;
  }
  part[(size_t)blockIdx.y * D + c] = acc;
}

template <typename T>
static int launch_dy(const T* dout, const float* mask, no_deduce_t<T*> dyb,
                     float* part, int M, int N, int D, int row_chunk,
                     cudaStream_t st) {
  dim3 grid((D + 127) / 128, (M + row_chunk - 1) / row_chunk);
  dy_kernel<<<grid, 128, 0, st>>>(dout, mask, dyb, part, M, N, D, row_chunk);
  BASD_CHECK_LAUNCH();
  return 0;
}

// dW (m x n) = A^T B summed over `rows` rows, A (rows x m), B (rows x n):
// split-K partials into part, then their fixed-order sum.
template <typename T>
static int weight_grad(const T* A, int m, const T* B, int n, int rows,
                       int k_chunk, float* part, float* dw, cudaStream_t st) {
  GemmT<T> g{};
  g.A = A;
  g.lda = m;
  g.B = B;
  g.ldb = n;
  g.M = m;
  g.N = n;
  g.K = rows;
  g.outf = part;
  int rc = launch_gemm<true, false, EPI_PARTIAL>(g, k_chunk, st);
  if (rc) return rc;
  return launch_reduce(part, dw, (rows + k_chunk - 1) / k_chunk, m * n, st);
}

}  // namespace basd
