// K1 and K2: the frozen teacher's two fused block halves on Hopper.
//
// K1 replaces basd_tpu/ops/pallas/fused_block_attn.py:fused_block_attn
// (_fwd_kernel):  out = x + proj(MHSA(LN1(x) W_qkv + b_qkv)), plus the
// head-mean softmax row of the CLS query (the distillation importance).
// K2 replaces basd_tpu/ops/pallas/fused_block_mlp.py:fused_ln_mlp_collect
// (_fwd_collect_kernel):  out = x + mask * fc2(gelu_tanh(fc1(LN2(x)))),
// with `out` written a second time into layer `idx`'s slab of the flat
// (L*B*N, D) collection stack, in place.
//
// What bounds them on the H100: at the teacher's shapes (B*N = 25216 rows,
// D = 384, B=128) the products and the attention come to ~97 GFLOP per
// block (counted from the shapes), ~0.1 ms at the bf16 tensor-core peak,
// and an activation slab is ~20 MB, a few microseconds of HBM. So neither
// bytes nor
// FLOPs bind this first version: its simple WMMA tiles and the per-(image,
// head) CUDA-core attention do. The design keeps the reference's rounding
// points exactly (f32 LN statistics, bf16 operands, f32 accumulation, bf16
// hand-offs where the TPU kernel rounds) and, unlike the TPU kernel, lets
// the qkv slab, the attention output and the MLP hidden state round-trip
// through device memory: separate launches (LN, GEMM + epilogue, attention,
// head-sum) instead of one VMEM-resident body. Fusing them is later work.
//
// Every function returns the first non-zero cudaGetLastError() after a
// launch, or 0. Nothing here allocates or synchronises; all buffers come
// from the caller and every launch goes on the caller's stream.

#include "common.cuh"

namespace basd {

constexpr float GELU_C = 0.7978845608028654f;  // sqrt(2/pi)
constexpr float GELU_A = 0.044715f;

enum Epilogue { EPI_BIAS = 0, EPI_BIAS_GELU = 1, EPI_BIAS_RESIDUAL = 2 };

__global__ void layernorm_bf16_kernel(const bf16* __restrict__ x,
                                      const float* __restrict__ scale,
                                      const float* __restrict__ bias,
                                      bf16* __restrict__ out, int rows, int d,
                                      float eps) {
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
}

// out[M, N] = epilogue(A[M, K] . W[N, K]^T + bias), W in torch's (out, in)
// layout. EPI_BIAS_RESIDUAL: out = bf16(resid + bf16(acc + bias) * mask),
// mask per block of `rows_per_mask` rows (1 when mask is null), also
// written to out2 when it is not null.
template <int EPI>
__global__ void __launch_bounds__(TILE_THREADS)
    gemm_nk_kernel(const bf16* A, const bf16* W, const float* bias,
                   bf16* out, int M, int N, int K, bool a_vec, bool w_vec,
                   const bf16* resid, const float* mask, int rows_per_mask,
                   bf16* out2) {
  __shared__ __align__(128) TileSmem sm;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  tile_mma<true>(sm, A, K, a_vec, W, K, w_vec, M, N, K, m0, n0);
  for (int i = threadIdx.x; i < BM * BN; i += blockDim.x) {
    const int r = i / BN;
    const int c = i % BN;
    const int gr = m0 + r;
    const int gc = n0 + c;
    if (gr >= M || gc >= N) continue;
    const float y = round_bf(sm.c[r * C_LD + c] + bias[gc]);
    const size_t o = (size_t)gr * N + gc;
    if constexpr (EPI == EPI_BIAS) {
      out[o] = f2bf(y);
    } else if constexpr (EPI == EPI_BIAS_GELU) {
      const float t = tanhf(GELU_C * (y + GELU_A * y * y * y));
      out[o] = f2bf(0.5f * y * (1.f + t));
    } else {
      const float m = mask ? mask[gr / rows_per_mask] : 1.f;
      const bf16 v = f2bf(bf2f(resid[o]) + y * m);
      out[o] = v;
      if (out2) out2[o] = v;
    }
  }
}

// One block per (image, head): scores in f32 from bf16 q, k; f32 softmax;
// bf16 probabilities times v with f32 accumulation and deferred
// normalisation (the TPU kernel's order). The CLS query's row, divided by
// l * H, goes to imp_heads[b, h, :]; heads are summed later in a fixed
// order, so no atomics.
__global__ void attention_heads_kernel(const bf16* __restrict__ qkv,
                                       bf16* __restrict__ out,
                                       float* __restrict__ imp_heads, int N,
                                       int D, int H, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int e = D / H;
  const int ldk = e + 2;  // odd word stride: conflict-free key-row reads
  const int nwarps = blockDim.x / 32;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  bf16* ks = reinterpret_cast<bf16*>(smem_raw);
  bf16* vs = ks + N * ldk;
  float* ps = reinterpret_cast<float*>(vs + N * e);
  float* qs = ps + nwarps * N;

  const int b = blockIdx.x / H;
  const int h = blockIdx.x % H;
  const size_t ld = 3 * (size_t)D;
  const bf16* base = qkv + (size_t)b * N * ld;
  for (int i = threadIdx.x; i < N * e; i += blockDim.x) {
    const int n = i / e;
    const int c = i % e;
    ks[n * ldk + c] = base[n * ld + D + h * e + c];
    vs[n * e + c] = base[n * ld + 2 * D + h * e + c];
  }
  __syncthreads();

  float* p_row = ps + warp * N;
  float* q_row = qs + warp * e;
  for (int qi = warp; qi < N; qi += nwarps) {
    for (int c = lane; c < e; c += 32) q_row[c] = bf2f(base[qi * ld + h * e + c]);
    __syncwarp();
    float m_loc = -INFINITY;
    for (int j = lane; j < N; j += 32) {
      const bf16* kr = ks + j * ldk;
      float acc = 0.f;
      for (int c = 0; c < e; c += 2) {
        const float2 kv =
            __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(kr + c));
        acc += q_row[c] * kv.x + q_row[c + 1] * kv.y;
      }
      const float s = acc * scale;
      p_row[j] = s;
      m_loc = fmaxf(m_loc, s);
    }
    const float m = warp_max(m_loc);
    float l_loc = 0.f;
    for (int j = lane; j < N; j += 32) {
      const float p = expf(p_row[j] - m);
      p_row[j] = p;
      l_loc += p;
    }
    const float l = warp_sum(l_loc);
    __syncwarp();
    if (qi == 0) {
      const float den = l * (float)H;
      for (int j = lane; j < N; j += 32)
        imp_heads[((size_t)b * H + h) * N + j] = p_row[j] / den;
    }
    for (int c2 = lane; c2 < e / 2; c2 += 32) {
      float a0 = 0.f, a1 = 0.f;
      for (int j = 0; j < N; ++j) {
        const float p = round_bf(p_row[j]);
        const float2 v = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(vs + j * e + 2 * c2));
        a0 += p * v.x;
        a1 += p * v.y;
      }
      bf16* o = out + ((size_t)b * N + qi) * D + h * e + 2 * c2;
      o[0] = f2bf(a0 / l);
      o[1] = f2bf(a1 / l);
    }
    __syncwarp();
  }
}

// imp[b, n] = sum_h imp_heads[b, h, n], heads added in order 0..H-1.
__global__ void head_sum_kernel(const float* __restrict__ imp_heads,
                                float* __restrict__ imp, int B, int H, int N) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= B * N) return;
  const int b = i / N;
  const int n = i % N;
  float acc = imp_heads[((size_t)b * H) * N + n];
  for (int h = 1; h < H; ++h) acc += imp_heads[((size_t)b * H + h) * N + n];
  imp[i] = acc;
}

template <int EPI>
static int launch_gemm(const bf16* A, const bf16* W, const float* bias,
                       bf16* out, int M, int N, int K, const bf16* resid,
                       const float* mask, int rows_per_mask, bf16* out2,
                       cudaStream_t st) {
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  gemm_nk_kernel<EPI><<<grid, TILE_THREADS, 0, st>>>(
      A, W, bias, out, M, N, K, vec_ok(A, K), vec_ok(W, K), resid, mask,
      rows_per_mask, out2);
  BASD_CHECK_LAUNCH();
  return 0;
}

static int launch_layernorm(const bf16* x, const float* s, const float* b,
                            bf16* out, int rows, int d, float eps,
                            cudaStream_t st) {
  const int threads = 256;
  const int blocks = (int)(((size_t)rows * 32 + threads - 1) / threads);
  layernorm_bf16_kernel<<<blocks, threads, 0, st>>>(x, s, b, out, rows, d, eps);
  BASD_CHECK_LAUNCH();
  return 0;
}

}  // namespace basd

using basd::bf16;

extern "C" const char* basd_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// K1. x, out: (B, N, D) bf16; w_qkv (3D, D), w_proj (D, D) bf16; LN affine
// and biases f32; imp: (B, N) f32 (CLS key included). Workspaces:
// ws_xn (B*N, D) bf16 (LN output, then the attention output), ws_qkv
// (B*N, 3D) bf16, ws_imp (B, H, N) f32.
extern "C" int basd_block_attn_fwd(const void* x, const float* ln_s,
                                   const float* ln_b, const void* w_qkv,
                                   const float* b_qkv, const void* w_proj,
                                   const float* b_proj, void* out, float* imp,
                                   void* ws_xn, void* ws_qkv, float* ws_imp,
                                   int B, int N, int D, int H, float eps,
                                   float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int M = B * N;
  const bf16* xb = static_cast<const bf16*>(x);
  bf16* xn = static_cast<bf16*>(ws_xn);
  bf16* qkv = static_cast<bf16*>(ws_qkv);
  int rc = basd::launch_layernorm(xb, ln_s, ln_b, xn, M, D, eps, st);
  if (rc) return rc;
  rc = basd::launch_gemm<basd::EPI_BIAS>(
      xn, static_cast<const bf16*>(w_qkv), b_qkv, qkv, M, 3 * D, D, nullptr,
      nullptr, 1, nullptr, st);
  if (rc) return rc;

  const int threads = 256;
  const int e = D / H;
  const size_t smem = (size_t)N * (e + 2) * sizeof(bf16) +
                      (size_t)N * e * sizeof(bf16) +
                      (size_t)(threads / 32) * (N + e) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      basd::attention_heads_kernel,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  basd::attention_heads_kernel<<<B * H, threads, smem, st>>>(qkv, xn, ws_imp,
                                                              N, D, H, scale);
  BASD_CHECK_LAUNCH();
  basd::head_sum_kernel<<<(M + 255) / 256, 256, 0, st>>>(ws_imp, imp, B, H, N);
  BASD_CHECK_LAUNCH();

  return basd::launch_gemm<basd::EPI_BIAS_RESIDUAL>(
      xn, static_cast<const bf16*>(w_proj), b_proj, static_cast<bf16*>(out),
      M, D, D, xb, nullptr, 1, nullptr, st);
}

// K2. x, out: (B, N, D) bf16; mask (B,) f32; w1 (F, D), w2 (D, F) bf16;
// LN affine and biases f32; buf_rows: the (B*N, D) slab of the collection
// stack that receives `out` as well. Workspaces: ws_xn (B*N, D) bf16,
// ws_h (B*N, F) bf16.
extern "C" int basd_block_mlp_collect_fwd(const void* x, const float* mask,
                                          const float* ln_s, const float* ln_b,
                                          const void* w1, const float* b1,
                                          const void* w2, const float* b2,
                                          void* out, void* buf_rows,
                                          void* ws_xn, void* ws_h, int B,
                                          int N, int D, int F, float eps,
                                          void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int M = B * N;
  const bf16* xb = static_cast<const bf16*>(x);
  bf16* xn = static_cast<bf16*>(ws_xn);
  bf16* hid = static_cast<bf16*>(ws_h);
  int rc = basd::launch_layernorm(xb, ln_s, ln_b, xn, M, D, eps, st);
  if (rc) return rc;
  rc = basd::launch_gemm<basd::EPI_BIAS_GELU>(
      xn, static_cast<const bf16*>(w1), b1, hid, M, F, D, nullptr, nullptr, 1,
      nullptr, st);
  if (rc) return rc;
  return basd::launch_gemm<basd::EPI_BIAS_RESIDUAL>(
      hid, static_cast<const bf16*>(w2), b2, static_cast<bf16*>(out), M, D, F,
      xb, mask, N, static_cast<bf16*>(buf_rows), st);
}
