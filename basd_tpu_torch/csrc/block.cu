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

#include "attention.cuh"
#include "block_kernels.cuh"

namespace basd {

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
  return launch_attention_heads<LSE>(ws_qkv, ws_xn, stat, B, N, D, H, scale,
                                     st);
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
  rc = basd::launch_head_sum(ws_imp, imp, B, H, N, st);
  if (rc) return rc;
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
