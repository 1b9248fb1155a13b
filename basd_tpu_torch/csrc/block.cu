// K1 and K2: the frozen teacher's two fused block halves on Hopper, and
// the forwards of the student's K3 and K4.
//
// K1 replaces basd_tpu/ops/pallas/fused_block_attn.py:fused_block_attn
// (_fwd_kernel):  out = x + proj(MHSA(LN1(x) W_qkv + b_qkv)), plus the
// head-mean softmax row of the CLS query (the distillation importance).
// K2 replaces basd_tpu/ops/pallas/fused_block_mlp.py:fused_ln_mlp_collect
// (_fwd_collect_kernel):  out = x + mask * fc2(gelu_tanh(fc1(LN2(x)))),
// with `out` written a second time into layer `idx`'s slab of the flat
// (L*B*N, D) collection stack, in place.
// K3a replaces fused_block_attn.py:_fwd_train (_fwd_train_kernel): K1's
// launches with a per-image DropPath multiplier in the proj epilogue and
// the per-(image, head, query) logsumexp in f32 in place of the CLS
// importance. K4a replaces fused_block_mlp.py:_fwd (fused_ln_mlp): K2's
// entry point called with no collection buffer.
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

#include "block_kernels.cuh"

namespace basd {

// One block per (image, head): scores in f32 from bf16 q, k; f32 softmax;
// bf16 probabilities times v with f32 accumulation and deferred
// normalisation (the TPU kernel's order). With LSE false (K1) the CLS
// query's row, divided by l * H, goes to stat[b, h, :]; heads are summed
// later in a fixed order, so no atomics. With LSE true (K3a) every query
// row's m + log(l) goes to stat[b, h, query].
template <bool LSE>
__global__ void attention_heads_kernel(const bf16* __restrict__ qkv,
                                       bf16* __restrict__ out,
                                       float* __restrict__ stat, int N, int D,
                                       int H, float scale) {
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
    if constexpr (LSE) {
      if (lane == 0) stat[((size_t)b * H + h) * N + qi] = m + logf(l);
    } else if (qi == 0) {
      const float den = l * (float)H;
      for (int j = lane; j < N; j += 32)
        stat[((size_t)b * H + h) * N + j] = p_row[j] / den;
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

// LN, qkv GEMM and per-(image, head) attention; the attention output
// lands in ws_xn (the LN output is dead by then).
template <bool LSE>
static int attention_half(const bf16* x, const float* ln_s, const float* ln_b,
                          const bf16* w_qkv, const float* b_qkv, bf16* ws_xn,
                          bf16* ws_qkv, float* stat, int B, int N, int D,
                          int H, float eps, float scale, cudaStream_t st) {
  const int M = B * N;
  int rc = launch_layernorm(x, ln_s, ln_b, ws_xn, nullptr, nullptr, M, D, eps,
                            st);
  if (rc) return rc;
  rc = launch_gemm_nk<EPI_BIAS>(ws_xn, w_qkv, b_qkv, ws_qkv, M, 3 * D, D,
                                nullptr, nullptr, 1, nullptr, st);
  if (rc) return rc;
  const int threads = 256;
  const int e = D / H;
  const size_t smem = (size_t)N * (e + 2) * sizeof(bf16) +
                      (size_t)N * e * sizeof(bf16) +
                      (size_t)(threads / 32) * (N + e) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      attention_heads_kernel<LSE>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  attention_heads_kernel<LSE><<<B * H, threads, smem, st>>>(ws_qkv, ws_xn,
                                                            stat, N, D, H,
                                                            scale);
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
  int rc = basd::attention_half<false>(
      xb, ln_s, ln_b, static_cast<const bf16*>(w_qkv), b_qkv, xn,
      static_cast<bf16*>(ws_qkv), ws_imp, B, N, D, H, eps, scale, st);
  if (rc) return rc;
  basd::head_sum_kernel<<<(M + 255) / 256, 256, 0, st>>>(ws_imp, imp, B, H, N);
  BASD_CHECK_LAUNCH();
  return basd::launch_gemm_nk<basd::EPI_BIAS_RESIDUAL>(
      xn, static_cast<const bf16*>(w_proj), b_proj, static_cast<bf16*>(out),
      M, D, D, xb, nullptr, 1, nullptr, st);
}

// K3a. As K1 with mask (B,) f32 applied to the proj branch and lse
// (B, H, N) f32 written instead of the importance. Workspaces: ws_xn
// (B*N, D) bf16, ws_qkv (B*N, 3D) bf16.
extern "C" int basd_block_attn_train_fwd(
    const void* x, const float* mask, const float* ln_s, const float* ln_b,
    const void* w_qkv, const float* b_qkv, const void* w_proj,
    const float* b_proj, void* out, float* lse, void* ws_xn, void* ws_qkv,
    int B, int N, int D, int H, float eps, float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bf16* xb = static_cast<const bf16*>(x);
  bf16* xn = static_cast<bf16*>(ws_xn);
  int rc = basd::attention_half<true>(
      xb, ln_s, ln_b, static_cast<const bf16*>(w_qkv), b_qkv, xn,
      static_cast<bf16*>(ws_qkv), lse, B, N, D, H, eps, scale, st);
  if (rc) return rc;
  return basd::launch_gemm_nk<basd::EPI_BIAS_RESIDUAL>(
      xn, static_cast<const bf16*>(w_proj), b_proj, static_cast<bf16*>(out),
      B * N, D, D, xb, mask, N, nullptr, st);
}

// K2 and K4a. x, out: (B, N, D) bf16; mask (B,) f32; w1 (F, D), w2 (D, F)
// bf16; LN affine and biases f32; buf_rows: the (B*N, D) slab of the
// collection stack that receives `out` as well (K2), or null (K4a).
// Workspaces: ws_xn (B*N, D) bf16, ws_h (B*N, F) bf16.
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
  int rc = basd::launch_layernorm(xb, ln_s, ln_b, xn, nullptr, nullptr, M, D,
                                  eps, st);
  if (rc) return rc;
  rc = basd::launch_gemm_nk<basd::EPI_BIAS_GELU>(
      xn, static_cast<const bf16*>(w1), b1, hid, M, F, D, nullptr, nullptr, 1,
      nullptr, st);
  if (rc) return rc;
  return basd::launch_gemm_nk<basd::EPI_BIAS_RESIDUAL>(
      hid, static_cast<const bf16*>(w2), b2, static_cast<bf16*>(out), M, D, F,
      xb, mask, N, static_cast<bf16*>(buf_rows), st);
}
