// Device code shared by the block kernels of csrc/block.cu (K1, K2 and the
// K3a/K4a forwards), csrc/block_train.cu (the K3b/K4b backwards) and
// csrc/fused_mlp.cu (K11): the tiled GEMMs with the epilogues the Pallas
// kernels round through, the column sums of an incoming gradient, the
// split-K weight gradient and the fixed-order reduction of partial sums;
// the row LayerNorm is layernorm.cuh's. Everything launches on the
// caller's stream and returns the first launch error, or 0.
//
// The GEMM takes bf16 operands on the tensor cores or, for the f32 paths
// of K2/K4 and K11, f32 operands on CUDA cores (gemm_f32_kernel: full-f32
// fused multiply-adds in order over k, no TF32, which the f32 paths of the
// reference keep off). bf16 products take gemm_sm90.cuh's wgmma GEMM where
// its rule allows: the forward products (launch_gemm_nk, both operands
// K-major) and the backward ones (launch_gemm_bwd: B read as K x N, A as
// M x K or, for the weight gradients, K x M). Other bf16 operands take
// common.cuh's WMMA tile (tile_mma_k). All three leave the f32 tile in
// shared memory for one epilogue, templated on the element type T and on
// the tile's size: every rounding to T there is the identity at f32.
#pragma once

#include "common.cuh"
#include "layernorm.cuh"

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

enum Epilogue {  // T: the GEMM's element type (bf16, or f32 for K11's f32 path)
  EPI_BIAS = 0,           // out = T(acc + bias)
  EPI_BIAS_GELU = 1,      // out = T(gelu(T(acc + bias)))
  EPI_BIAS_RESIDUAL = 2,  // out (and out2) = T(aux + T(acc + bias) * mask)
  EPI_BIAS_PRE_GELU = 3,  // out = p = T(acc + bias), out2 = T(gelu(p))
  EPI_DGELU = 4,          // d = acc * gelu'(aux); out = T(d); colpart += d
  EPI_F32 = 5,            // outf = acc
  EPI_PARTIAL = 6,        // outf[split] = acc over this split's K range
  EPI_ROUND = 7,          // out = T(acc)
  EPI_BIAS_SWIGLU = 8,    // out = T(silu(T(acc_a + b_a)) * T(acc_g + b_g))
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
  int k_chunk;  // contraction rows per blockIdx.z (a multiple of BK; of 64
                // on the sm90 GEMM)
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

__device__ __forceinline__ float silu(float a) { return a / (1.f + expf(-a)); }

// K2g's fc1 epilogue (EPI_BIAS_SWIGLU, the sm90 GEMM at TN = 128 alone).
// The product's N = 2 F columns come interleaved in groups of 64
// (kernels/block_mlp.py:swiglu_interleave), so the tile at n0 holds the
// gate input a of hidden units f0..f0+63 in its first 64 columns and their
// g in its last 64, f0 = n0 / 2, and out is (M, F). Rounding as
// EPI_BIAS_GELU's: a = T(acc_a + bias_a) and g = T(acc_g + bias_g), then
// silu(a) * g in f32, rounded once. 16-byte accesses only: K2g's entry
// (block.cu) admits no operands that forbid them.
template <typename T, int TM, int TN, int LD>
__device__ void swiglu_epilogue(const GemmT<T>& g, const float* c, int m0,
                                int n0) {
  static_assert(TN == 128, "a SwiGLU tile pairs 64 a with 64 g columns");
  constexpr int W = epi_width<T>();
  constexpr int H = TN / 2;
  const int f = g.N / 2;
  for (int i = threadIdx.x; i < TM * (H / W); i += blockDim.x) {
    const int r = i / (H / W);
    const int cc = (i % (H / W)) * W;
    const int gr = m0 + r;
    if (gr >= g.M || n0 + cc >= g.N) continue;
    float acc_a[W], acc_g[W], bias_a[W], bias_g[W];
#pragma unroll
    for (int j = 0; j < W; j += 4) {
      *reinterpret_cast<float4*>(acc_a + j) =
          *reinterpret_cast<const float4*>(c + r * LD + cc + j);
      *reinterpret_cast<float4*>(acc_g + j) =
          *reinterpret_cast<const float4*>(c + r * LD + H + cc + j);
      *reinterpret_cast<float4*>(bias_a + j) =
          *reinterpret_cast<const float4*>(g.bias + n0 + cc + j);
      *reinterpret_cast<float4*>(bias_g + j) =
          *reinterpret_cast<const float4*>(g.bias + n0 + H + cc + j);
    }
    Vec16<T> out;
#pragma unroll
    for (int j = 0; j < W; ++j) {
      const float a = round_t<T>(acc_a[j] + bias_a[j]);
      const float gate = round_t<T>(acc_g[j] + bias_g[j]);
      out.v[j] = from_f<T>(silu(a) * gate);
    }
    *reinterpret_cast<Vec16<T>*>(g.out + (size_t)gr * f + n0 / 2 + cc) = out;
  }
}

// The epilogue of one TM x TN tile at (m0, n0) whose f32 sums sit in
// shared memory at c (row stride LD): the WMMA and f32 tiles' BM x BN and
// the sm90 GEMM's 128 x TN. Must be called by every thread of the block.
template <int EPI, typename T, int TM = BM, int TN = BN, int LD = C_LD>
__device__ void gemm_epilogue(const GemmT<T>& g, float* c, int m0, int n0) {
  if constexpr (EPI == EPI_BIAS_SWIGLU) {
    swiglu_epilogue<T, TM, TN, LD>(g, c, m0, n0);
    return;
  }
  if constexpr (EPI == EPI_DGELU) {
    // d = acc * gelu'(pre) in place in the tile, then each of the first TN
    // threads sums its column over the tile's TM rows in order: one
    // partial row per row tile, summed in a fixed order by
    // reduce_partials. W columns a thread (16-byte accesses) where
    // epi_vec_ok allows; the same values either way.
    constexpr int W = epi_width<T>();
    const bool vec = TN % W == 0 && g.epi_vec;
    const int step = vec ? W : 1;
    for (int i = threadIdx.x; i < TM * (TN / step); i += blockDim.x) {
      const int r = i / (TN / step);
      const int cc = (i % (TN / step)) * step;
      const int gr = m0 + r;
      const int gc = n0 + cc;
      float* t = c + r * LD + cc;
      const size_t o = (size_t)gr * g.N + gc;
      if (vec) {
        float d[W];
#pragma unroll
        for (int j = 0; j < W; ++j) d[j] = 0.f;
        if (gr < g.M && gc < g.N) {  // N % W == 0: all W columns are in
          const Vec16<T> pre = *reinterpret_cast<const Vec16<T>*>(g.aux + o);
          Vec16<T> out;
#pragma unroll
          for (int j = 0; j < W; ++j) {
            d[j] = t[j] * gelu_tanh_grad(to_f(pre.v[j]));
            out.v[j] = from_f<T>(d[j]);
          }
          *reinterpret_cast<Vec16<T>*>(g.out + o) = out;
        }
#pragma unroll
        for (int j = 0; j < W; ++j) t[j] = d[j];
      } else {
        float d = 0.f;
        if (gr < g.M && gc < g.N) {
          d = t[0] * gelu_tanh_grad(to_f(g.aux[o]));
          g.out[o] = from_f<T>(d);
        }
        t[0] = d;
      }
    }
    // the column sums: `parts` threads a column each add a band of rows
    // in order, then the first TN threads add the bands in order
    __syncthreads();
    const int parts = blockDim.x / TN;  // 2 or 4
    const int band = (TM + parts - 1) / parts;
    const int col = threadIdx.x % TN;
    const int part = threadIdx.x / TN;
    float s = 0.f;
    if (part < parts) {
      for (int r = part * band; r < min(TM, (part + 1) * band); ++r)
        s += c[r * LD + col];
    }
    __syncthreads();
    if (part < parts) c[part * LD + col] = s;
    __syncthreads();
    if (threadIdx.x < TN && n0 + threadIdx.x < g.N) {
      float t = 0.f;
      for (int p = 0; p < parts; ++p) t += c[p * LD + threadIdx.x];
      g.outf[(size_t)blockIdx.y * g.N + n0 + threadIdx.x] = t;
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
// CUDA-core tile. EPI_F32 writes the f32 sums alone to outf (M, N), no
// bias: a tensor-parallel rank's share of a row-parallel product.
template <int EPI, typename T>
static int launch_gemm_nk(const T* A, const T* W, const float* bias, T* out,
                          int M, int N, int K, no_deduce_t<const T*> aux,
                          const float* mask, int rows_per_mask,
                          no_deduce_t<T*> out2, cudaStream_t st,
                          float* outf = nullptr) {
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
  g.outf = outf;
  if constexpr (std::is_same_v<T, bf16>) {
    const int tile_n = gemm_nk_tile_n(
        N, K, A, W, EPI == EPI_F32 ? static_cast<const void*>(outf) : out);
    if (tile_n == 128) return sm90::launch<EPI, 128, false, false>(g, K, st);
    if (tile_n == 64) return sm90::launch<EPI, 64, false, false>(g, K, st);
  }
  return launch_gemm<false, true, EPI>(g, K, st);
}

// The backward products' variant, decided before launch like
// gemm_nk_tile_n: the sm90 GEMM for bf16 operands whose leading
// dimensions are multiples of 8 and whose operand and output addresses are
// 16-byte aligned, else 0 (the WMMA tile at bf16, the CUDA-core tile at
// f32). The sm90 tile is sm90_tile_n(N) wide, and 64 for a split-K weight
// gradient (SPLIT_TILE_N). kernels/gemm.py:gemm_bwd_variant mirrors it.
template <typename T>
inline int gemm_bwd_tile_n(const GemmT<T>& g, bool split_k) {
  if constexpr (std::is_same_v<T, bf16>) {
    if (sm90_ok({g.lda, g.ldb}, {g.A, g.B, g.out, g.outf, g.aux}))
      return split_k ? SPLIT_TILE_N : sm90_tile_n(g.N);
  }
  return 0;
}

// The rows of one output tile of a variant (tile_n 0: the WMMA or f32
// tile): the EPI_DGELU column partials come one row per row tile.
inline int gemm_tile_m(int tile_n) { return tile_n ? sm90::TM : BM; }

// A backward product out[M, N] = epilogue(A . B) with B read as K x N (N
// contiguous: a weight in torch's (out, in) layout in dY W, or X in
// dY^T X) and A as M x K or, with A_KM, as K x M (dY in dY^T X), on the
// variant tile_n names (gemm_bwd_tile_n's choice, or a test's): the sm90
// GEMM with an MN-major B (and A with A_KM) at tile width 64 or 128, else
// the WMMA tile (bf16) or the CUDA-core tile (f32). k_chunk > 0 only with
// EPI_PARTIAL (a multiple of 64: the sm90 stage).
template <bool A_KM, int EPI, typename T>
static int launch_gemm_bwd(GemmT<T> g, int tile_n, int k_chunk,
                           cudaStream_t st) {
  if (k_chunk <= 0) k_chunk = g.K;
  if constexpr (std::is_same_v<T, bf16>) {
    if (tile_n == 128) return sm90::launch<EPI, 128, A_KM, true>(g, k_chunk, st);
    if (tile_n == 64) return sm90::launch<EPI, 64, A_KM, true>(g, k_chunk, st);
  }
  return launch_gemm<A_KM, false, EPI>(g, k_chunk, st);
}

// The rule's backward product: the variant gemm_bwd_tile_n picks; the
// rows of its tile through tile_m when asked.
template <bool A_KM, int EPI, typename T>
static int gemm_bwd(GemmT<T> g, int k_chunk, cudaStream_t st,
                    int* tile_m = nullptr) {
  const int tile_n = gemm_bwd_tile_n(g, EPI == EPI_PARTIAL);
  if (tile_m) *tile_m = gemm_tile_m(tile_n);
  return launch_gemm_bwd<A_KM, EPI>(g, tile_n, k_chunk, st);
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
// split-K partials (split_k_chunk's rows each) into part, then their sum
// in split order. part holds splits * m * n floats.
template <typename T>
static int weight_grad(const T* A, int m, const T* B, int n, int rows,
                       float* part, float* dw, cudaStream_t st) {
  GemmT<T> g{};
  g.A = A;
  g.lda = m;
  g.B = B;
  g.ldb = n;
  g.M = m;
  g.N = n;
  g.K = rows;
  g.outf = part;
  const int k_chunk = split_k_chunk(rows, m, n);
  int rc = gemm_bwd<true, EPI_PARTIAL>(g, k_chunk, st);
  if (rc) return rc;
  return launch_reduce(part, dw, (rows + k_chunk - 1) / k_chunk, m * n, st);
}

// dpre (M x N) = T(d), d = (dy . W) * gelu'(pre) with W (K x N) read as
// K x N (torch's (out = K, in = N) layout); db (N) = the column sums of d
// in f32: one partial row per row tile of the product into part, added in
// order. part holds ceil(M / 64) * N floats.
template <typename T>
static int dgelu_grad(const T* dy, const T* W, const T* pre, int M, int N,
                      int K, T* dpre, float* part, float* db,
                      cudaStream_t st) {
  GemmT<T> g{};
  g.A = dy;
  g.lda = K;
  g.B = W;
  g.ldb = N;
  g.M = M;
  g.N = N;
  g.K = K;
  g.out = dpre;
  g.aux = pre;
  g.outf = part;
  int tile_m = BM;
  int rc = gemm_bwd<false, EPI_DGELU>(g, 0, st, &tile_m);
  if (rc) return rc;
  return launch_reduce(part, db, (M + tile_m - 1) / tile_m, N, st);
}

// out (rows x n) = A (rows x k) . W (k x n), W in torch's (out, in)
// layout read as K x N: the input gradient of a forward x W^T, in f32
// (EPI_F32, outf) or rounded to T (EPI_ROUND, out).
template <int EPI, typename T>
static int input_grad(const T* A, const T* W, int rows, int k, int n,
                      no_deduce_t<T*> out, float* outf, cudaStream_t st) {
  GemmT<T> g{};
  g.A = A;
  g.lda = k;
  g.B = W;
  g.ldb = n;
  g.M = rows;
  g.N = n;
  g.K = k;
  g.out = out;
  g.outf = outf;
  return gemm_bwd<false, EPI>(g, 0, st);
}

}  // namespace basd
