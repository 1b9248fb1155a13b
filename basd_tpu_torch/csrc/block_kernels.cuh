// Device code shared by the block kernels of csrc/block.cu (K1, K2 and the
// K3a/K4a forwards), csrc/block_train.cu (the K3b/K4b backwards) and
// csrc/fused_mlp.cu (K11): the row LayerNorm, one tiled WMMA GEMM with the
// epilogues the Pallas kernels round through, the column sums of an
// incoming gradient, the split-K weight gradient and the fixed-order
// reduction of partial sums. Everything launches on the caller's stream
// and returns the first launch error, or 0.
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

// One warp per row: f32 two-pass statistics, out = bf16(xhat * s + b).
// With mu/rstd not null the row statistics are stored too (the backward
// kernels recompute the LayerNorm and reuse them for its VJP).
static __global__ void layernorm_bf16_kernel(const bf16* __restrict__ x,
                                      const float* __restrict__ scale,
                                      const float* __restrict__ bias,
                                      bf16* __restrict__ out,
                                      float* __restrict__ mu_out,
                                      float* __restrict__ rstd_out, int rows,
                                      int d, float eps) {
  const int row = (blockIdx.x * blockDim.x + threadIdx.x) / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  const bf16* xr = x + (size_t)row * d;
  bf16* orow = out + (size_t)row * d;
  const float inv_d = 1.f / (float)d;
  float s = 0.f;
  for (int i = lane; i < d; i += 32) s += bf2f(xr[i]);
  const float mu = warp_sum(s) * inv_d;
  float sq = 0.f;
  for (int i = lane; i < d; i += 32) {
    const float c = bf2f(xr[i]) - mu;
    sq += c * c;
  }
  const float var = warp_sum(sq) * inv_d;
  const float rstd = rsqrtf(var + eps);
  for (int i = lane; i < d; i += 32) {
    orow[i] = f2bf((bf2f(xr[i]) - mu) * rstd * scale[i] + bias[i]);
  }
  if (mu_out != nullptr && lane == 0) {
    mu_out[row] = mu;
    rstd_out[row] = rstd;
  }
}

enum Epilogue {
  EPI_BIAS = 0,           // out = bf16(acc + bias)
  EPI_BIAS_GELU = 1,      // out = bf16(gelu(bf16(acc + bias)))
  EPI_BIAS_RESIDUAL = 2,  // out (and out2) = bf16(aux + bf16(acc + bias) * mask)
  EPI_BIAS_PRE_GELU = 3,  // out = p = bf16(acc + bias), out2 = bf16(gelu(p))
  EPI_DGELU = 4,          // d = acc * gelu'(aux); out = bf16(d); colpart += d
  EPI_F32 = 5,            // outf = acc
  EPI_PARTIAL = 6,        // outf[split] = acc over this split's K range
  EPI_BF16 = 7,           // out = bf16(acc)
};

// out[M, N] = epilogue(A . B) over the K range of blockIdx.z.
struct Gemm {
  const bf16* A;
  const bf16* B;
  int lda, ldb;
  bool a_vec, b_vec;
  int M, N, K;
  int k_chunk;  // contraction rows per blockIdx.z (a multiple of BK)
  const float* bias;
  bf16* out;
  bf16* out2;
  float* outf;
  const bf16* aux;     // residual (EPI_BIAS_RESIDUAL) or pre-GELU (EPI_DGELU)
  const float* mask;   // per block of rows_per_mask rows; null means 1
  int rows_per_mask;
};

template <bool A_KM, bool B_NK, int EPI>
__global__ void __launch_bounds__(TILE_THREADS) gemm_kernel(Gemm g) {
  __shared__ __align__(128) TileSmem sm;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  const int k_begin = blockIdx.z * g.k_chunk;
  const int k_end = min(g.K, k_begin + g.k_chunk);
  tile_mma_k<A_KM, B_NK>(sm, g.A, g.lda, g.a_vec, g.B, g.ldb, g.b_vec, g.M,
                         g.N, k_begin, k_end, m0, n0);
  if constexpr (EPI == EPI_DGELU) {
    // d = acc * gelu'(pre) in place in the tile, then each of the first BN
    // threads sums its column over the tile's rows in order: one partial
    // row per 64-row tile, summed in a fixed order by reduce_partials.
    for (int i = threadIdx.x; i < BM * BN; i += blockDim.x) {
      const int r = i / BN;
      const int c = i % BN;
      const int gr = m0 + r;
      const int gc = n0 + c;
      float d = 0.f;
      if (gr < g.M && gc < g.N) {
        const size_t o = (size_t)gr * g.N + gc;
        d = sm.c[r * C_LD + c] * gelu_tanh_grad(bf2f(g.aux[o]));
        g.out[o] = f2bf(d);
      }
      sm.c[r * C_LD + c] = d;
    }
    __syncthreads();
    if (threadIdx.x < BN && n0 + threadIdx.x < g.N) {
      float s = 0.f;
      for (int r = 0; r < BM; ++r) s += sm.c[r * C_LD + threadIdx.x];
      g.outf[(size_t)blockIdx.y * g.N + n0 + threadIdx.x] = s;
    }
    return;
  }
  for (int i = threadIdx.x; i < BM * BN; i += blockDim.x) {
    const int r = i / BN;
    const int c = i % BN;
    const int gr = m0 + r;
    const int gc = n0 + c;
    if (gr >= g.M || gc >= g.N) continue;
    const float acc = sm.c[r * C_LD + c];
    const size_t o = (size_t)gr * g.N + gc;
    if constexpr (EPI == EPI_F32) {
      g.outf[o] = acc;
    } else if constexpr (EPI == EPI_BF16) {
      g.out[o] = f2bf(acc);
    } else if constexpr (EPI == EPI_PARTIAL) {
      g.outf[(size_t)blockIdx.z * g.M * g.N + o] = acc;
    } else {
      const float y = round_bf(acc + g.bias[gc]);
      if constexpr (EPI == EPI_BIAS) {
        g.out[o] = f2bf(y);
      } else if constexpr (EPI == EPI_BIAS_GELU) {
        g.out[o] = f2bf(gelu_tanh(y));
      } else if constexpr (EPI == EPI_BIAS_PRE_GELU) {
        g.out[o] = f2bf(y);
        g.out2[o] = f2bf(gelu_tanh(y));
      } else {  // EPI_BIAS_RESIDUAL
        const float m = g.mask ? g.mask[gr / g.rows_per_mask] : 1.f;
        const bf16 v = f2bf(bf2f(g.aux[o]) + y * m);
        g.out[o] = v;
        if (g.out2) g.out2[o] = v;
      }
    }
  }
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
// K x N) into an M x N output; split > 1 only with EPI_PARTIAL.
template <bool A_KM, bool B_NK, int EPI>
static int launch_gemm(Gemm g, int k_chunk, cudaStream_t st) {
  g.k_chunk = k_chunk;
  g.a_vec = vec_ok(g.A, g.lda);
  g.b_vec = vec_ok(g.B, g.ldb);
  const int splits = (g.K + k_chunk - 1) / k_chunk;
  dim3 grid((g.N + BN - 1) / BN, (g.M + BM - 1) / BM, splits);
  gemm_kernel<A_KM, B_NK, EPI><<<grid, TILE_THREADS, 0, st>>>(g);
  BASD_CHECK_LAUNCH();
  return 0;
}

// out[M, N] = epilogue(A[M, K] . W[N, K]^T + bias): the forward products,
// W in torch's (out, in) layout.
template <int EPI>
static int launch_gemm_nk(const bf16* A, const bf16* W, const float* bias,
                          bf16* out, int M, int N, int K, const bf16* aux,
                          const float* mask, int rows_per_mask, bf16* out2,
                          cudaStream_t st) {
  Gemm g{};
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
  return launch_gemm<false, true, EPI>(g, K, st);
}

static int launch_layernorm(const bf16* x, const float* s, const float* b,
                            bf16* out, float* mu, float* rstd, int rows, int d,
                            float eps, cudaStream_t st) {
  const int threads = 256;
  const int blocks = (int)(((size_t)rows * 32 + threads - 1) / threads);
  layernorm_bf16_kernel<<<blocks, threads, 0, st>>>(x, s, b, out, mu, rstd,
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
static __global__ void dy_kernel(const bf16* __restrict__ dout,
                                 const float* __restrict__ mask,
                                 bf16* __restrict__ dyb,
                                 float* __restrict__ part, int M, int N, int D,
                                 int row_chunk) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= D) return;
  const int r0 = blockIdx.y * row_chunk;
  const int r1 = min(M, r0 + row_chunk);
  float acc = 0.f;
  for (int r = r0; r < r1; ++r) {
    const size_t o = (size_t)r * D + c;
    const float dy = mask ? bf2f(dout[o]) * mask[r / N] : bf2f(dout[o]);
    if (dyb) dyb[o] = f2bf(dy);
    acc += dy;
  }
  part[(size_t)blockIdx.y * D + c] = acc;
}

static int launch_dy(const bf16* dout, const float* mask, bf16* dyb,
                     float* part, int M, int N, int D, int row_chunk,
                     cudaStream_t st) {
  dim3 grid((D + 127) / 128, (M + row_chunk - 1) / row_chunk);
  dy_kernel<<<grid, 128, 0, st>>>(dout, mask, dyb, part, M, N, D, row_chunk);
  BASD_CHECK_LAUNCH();
  return 0;
}

// dW (m x n) = A^T B summed over `rows` rows, A (rows x m), B (rows x n):
// split-K partials into part, then their fixed-order sum.
static int weight_grad(const bf16* A, int m, const bf16* B, int n, int rows,
                       int k_chunk, float* part, float* dw, cudaStream_t st) {
  Gemm g{};
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
