// K1 and K2: the frozen teacher's two fused block halves on Hopper, and
// the forwards of the student's K3 and K4.
//
// K1 replaces basd_tpu/ops/pallas/fused_block_attn.py:fused_block_attn
// (_fwd_kernel):  out = x + proj(MHSA(LN1(x) W_qkv + b_qkv)), plus the
// head-mean softmax row of the CLS query (the distillation importance).
// K2 replaces basd_tpu/ops/pallas/fused_block_mlp.py:fused_ln_mlp_collect
// (_fwd_collect_kernel):  out = x + mask * fc2(gelu_tanh(fc1(LN2(x)))),
// with `out` written a second time into layer `idx`'s slab of the flat
// (L*B*N, D) collection stack, in place. Its _f32 entry runs the same chain
// on f32 tensors (the reference's f32 Pallas kernel: tanh-GELU, no
// rounding) through the CUDA-core f32 GEMM.
// K3a replaces fused_block_attn.py:_fwd_train (_fwd_train_kernel): K1's
// launches with a per-image DropPath multiplier in the proj epilogue and
// the per-(image, head, query) logsumexp in f32 in place of the CLS
// importance. K4a replaces fused_block_mlp.py:_fwd (fused_ln_mlp): K2's
// entry point called with no collection buffer.
//
// What bounds them on the H100: at the teacher's shapes (B*N = 25216 rows,
// D = 384, B=128) the products and the attention come to ~97 GFLOP per
// block (counted from the shapes), ~0.1 ms at the bf16 tensor-core peak,
// and an activation slab is ~20 MB, a few microseconds of HBM. Every
// forward product runs on gemm_sm90.cuh's wgmma GEMM (TMA ring, two
// consumer warpgroups), the attention on attention.cuh's tensor-core
// kernel. The design keeps the reference's rounding
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

// K2 and K4a: LayerNorm, fc1 + bias + GELU, fc2 + bias + mask + residual
// (+ the collection slab), in T (bf16, or f32 on the CUDA-core GEMM).
template <typename T>
static int mlp_collect_fwd(const void* x, const float* mask, const float* ln_s,
                           const float* ln_b, const void* w1, const float* b1,
                           const void* w2, const float* b2, void* out,
                           void* buf_rows, void* ws_xn, void* ws_h, int B,
                           int N, int D, int F, float eps, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int M = B * N;
  const T* xb = static_cast<const T*>(x);
  T* xn = static_cast<T*>(ws_xn);
  T* hid = static_cast<T*>(ws_h);
  int rc = launch_layernorm(xb, ln_s, ln_b, xn, nullptr, nullptr, M, D, eps,
                            st);
  if (rc) return rc;
  rc = launch_gemm_nk<EPI_BIAS_GELU>(static_cast<const T*>(xn),
                                     static_cast<const T*>(w1), b1, hid, M, F,
                                     D, nullptr, nullptr, 1, nullptr, st);
  if (rc) return rc;
  return launch_gemm_nk<EPI_BIAS_RESIDUAL>(
      static_cast<const T*>(hid), static_cast<const T*>(w2), b2,
      static_cast<T*>(out), M, D, F, xb, mask, N, static_cast<T*>(buf_rows),
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

// K2 and K4a. x, out: (B, N, D) bf16 (f32 for the _f32 entry); mask (B,)
// f32; w1 (F, D), w2 (D, F) in x's type; LN affine and biases f32;
// buf_rows: the (B*N, D) slab of the collection stack that receives `out`
// as well (K2), or null (K4a). Workspaces in x's type: ws_xn (B*N, D),
// ws_h (B*N, F).
extern "C" int basd_block_mlp_collect_fwd(const void* x, const float* mask,
                                          const float* ln_s, const float* ln_b,
                                          const void* w1, const float* b1,
                                          const void* w2, const float* b2,
                                          void* out, void* buf_rows,
                                          void* ws_xn, void* ws_h, int B,
                                          int N, int D, int F, float eps,
                                          void* stream) {
  return basd::mlp_collect_fwd<bf16>(x, mask, ln_s, ln_b, w1, b1, w2, b2, out,
                                     buf_rows, ws_xn, ws_h, B, N, D, F, eps,
                                     stream);
}
extern "C" int basd_block_mlp_collect_fwd_f32(
    const void* x, const float* mask, const float* ln_s, const float* ln_b,
    const void* w1, const float* b1, const void* w2, const float* b2,
    void* out, void* buf_rows, void* ws_xn, void* ws_h, int B, int N, int D,
    int F, float eps, void* stream) {
  return basd::mlp_collect_fwd<float>(x, mask, ln_s, ln_b, w1, b1, w2, b2,
                                      out, buf_rows, ws_xn, ws_h, B, N, D, F,
                                      eps, stream);
}

// One forward product out (M, N) bf16 = bf16(A (M, K) . W (N, K)^T + bias)
// through launch_gemm_nk's EPI_BIAS, on the variant `tile_n` names: -1 the
// rule's choice, 0 the WMMA tile, 64 or 128 the sm90 GEMM at that tile
// width (which must then pass the rule's operand checks). It lets a test
// hold the two GEMMs against each other at any shape; the kernels above
// reach the same code through their own entries.
extern "C" int basd_gemm_nk(const void* A, const void* W, const float* bias,
                            void* out, int M, int N, int K, int tile_n,
                            void* stream) {
  using namespace basd;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bf16* a = static_cast<const bf16*>(A);
  const bf16* w = static_cast<const bf16*>(W);
  bf16* o = static_cast<bf16*>(out);
  if (tile_n < 0) {
    return launch_gemm_nk<EPI_BIAS>(a, w, bias, o, M, N, K, nullptr, nullptr,
                                    1, nullptr, st);
  }
  Gemm g{};
  g.A = a;
  g.lda = K;
  g.B = w;
  g.ldb = K;
  g.M = M;
  g.N = N;
  g.K = K;
  g.bias = bias;
  g.out = o;
  g.rows_per_mask = 1;
  if (tile_n == 0) return launch_gemm<false, true, EPI_BIAS>(g, K, st);
  if (gemm_nk_tile_n(N, K, A, W, out) == 0) return (int)cudaErrorInvalidValue;
  if (tile_n == 128) return sm90::launch<EPI_BIAS, 128>(g, st);
  if (tile_n == 64) return sm90::launch<EPI_BIAS, 64>(g, st);
  return (int)cudaErrorInvalidValue;
}
