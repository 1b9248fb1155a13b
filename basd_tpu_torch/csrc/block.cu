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
// K2g is K2 for a SwiGLU MLP (DINOv2's SwiGLUFFN, timm's SwiGLUPacked),
// which no TPU kernel has:  out = x + mask * fc2(silu(a) * g), [a | g] =
// fc1(LN2(x)), written into the stack as K2's is. Its three launches run
// K2's kernels under names of their own (swiglu_mlp_ln_kernel,
// swiglu_mlp_gemm_kernel).
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
// Tensor parallelism (basd_tpu_torch/parallel/mesh.py): a rank holds H of
// the block's HT heads of width E (so its qkv slab is 3 H E wide and its
// proj takes K = H E) and F of the MLP's hidden units. With `partial` set
// an entry stops at its share of the row-parallel product: the f32 sums of
// proj (K1, K3a) or fc2 (K2/K4a) over the rank's heads or hidden units,
// without bias, mask, residual or collection slab, which the caller adds
// once the ranks' shares are summed (K1's importance is its heads' CLS
// rows over l HT, summed the same way). With partial = 0, H E = D and
// HT = H the entries are the whole block, as before.
//
// Every function returns the first non-zero cudaGetLastError() after a
// launch, or 0. Nothing here allocates or synchronises; all buffers come
// from the caller and every launch goes on the caller's stream.

#include "attention.cuh"
#include "block_kernels.cuh"

namespace basd {

// LN, qkv GEMM and per-(image, head) attention of H heads of width E; the
// (B*N, H E) attention output lands in ws_xn (the LN output is dead by
// then, and H E <= D).
template <bool LSE>
static int attention_half(const bf16* x, const float* ln_s, const float* ln_b,
                          const bf16* w_qkv, const float* b_qkv, bf16* ws_xn,
                          bf16* ws_qkv, float* stat, int B, int N, int D,
                          int H, int E, int HT, float eps, float scale,
                          cudaStream_t st) {
  const int M = B * N;
  const int Dh = H * E;
  int rc = launch_layernorm(x, ln_s, ln_b, ws_xn, nullptr, nullptr, M, D, eps,
                            st);
  if (rc) return rc;
  rc = launch_gemm_nk<EPI_BIAS>(ws_xn, w_qkv, b_qkv, ws_qkv, M, 3 * Dh, D,
                                nullptr, nullptr, 1, nullptr, st);
  if (rc) return rc;
  return launch_attention_heads<LSE>(ws_qkv, ws_xn, stat, B, N, Dh, H, scale,
                                     st, HT);
}

// The proj product of the attention output (B*N, H E): the whole block's
// out = bf16(x + mask * bf16(acc + b_proj)), or the rank's f32 share acc.
static int proj_product(const bf16* attn, const bf16* w_proj,
                        const float* b_proj, const bf16* x, const float* mask,
                        void* out, int B, int N, int D, int Dh, int partial,
                        cudaStream_t st) {
  if (partial) {
    return launch_gemm_nk<EPI_F32>(attn, w_proj, nullptr,
                                   static_cast<bf16*>(nullptr), B * N, D, Dh,
                                   nullptr, nullptr, 1, nullptr, st,
                                   static_cast<float*>(out));
  }
  return launch_gemm_nk<EPI_BIAS_RESIDUAL>(attn, w_proj, b_proj,
                                           static_cast<bf16*>(out), B * N, D,
                                           Dh, x, mask, N, nullptr, st);
}

// K2g's LayerNorm: launch_layernorm's rows under swiglu_mlp_ln_kernel.
static int launch_swiglu_layernorm(const bf16* x, const float* s,
                                   const float* b, bf16* out, int rows, int d,
                                   float eps, cudaStream_t st) {
  const int group = ln_group<bf16>(d, x, out, s, b, LN_CHUNKS);
  swiglu_mlp_ln_kernel<bf16><<<ln_blocks(rows, group), LN_THREADS, 0, st>>>(
      x, s, b, out, rows, d, eps, group);
  BASD_CHECK_LAUNCH();
  return 0;
}

// K2 and K4a: LayerNorm, fc1 + bias + GELU, fc2 + bias + mask + residual
// (+ the collection slab), in T (bf16, or f32 on the CUDA-core GEMM); with
// `partial`, fc2's f32 sums alone into out (float).
template <typename T>
static int mlp_collect_fwd(const void* x, const float* mask, const float* ln_s,
                           const float* ln_b, const void* w1, const float* b1,
                           const void* w2, const float* b2, void* out,
                           void* buf_rows, void* ws_xn, void* ws_h, int B,
                           int N, int D, int F, int partial, float eps,
                           void* stream) {
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
  if (partial) {
    return launch_gemm_nk<EPI_F32>(
        static_cast<const T*>(hid), static_cast<const T*>(w2), nullptr,
        static_cast<T*>(nullptr), M, D, F, nullptr, nullptr, 1, nullptr, st,
        static_cast<float*>(out));
  }
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

// K1. x: (B, N, D) bf16; w_qkv (3 H E, D), w_proj (D, H E) bf16; LN affine
// and biases f32; imp: (B, N) f32 (CLS key included), the CLS rows over
// l HT summed over the H heads. out: (B, N, D) bf16, or with `partial` the
// f32 sums of proj (b_proj unused). Workspaces: ws_xn (B*N, D) bf16 (LN
// output, then the attention output), ws_qkv (B*N, 3 H E) bf16, ws_imp
// (B, H, N) f32.
extern "C" int basd_block_attn_fwd(const void* x, const float* ln_s,
                                   const float* ln_b, const void* w_qkv,
                                   const float* b_qkv, const void* w_proj,
                                   const float* b_proj, void* out, float* imp,
                                   void* ws_xn, void* ws_qkv, float* ws_imp,
                                   int B, int N, int D, int H, int E, int HT,
                                   int partial, float eps, float scale,
                                   void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bf16* xb = static_cast<const bf16*>(x);
  bf16* xn = static_cast<bf16*>(ws_xn);
  int rc = basd::attention_half<false>(
      xb, ln_s, ln_b, static_cast<const bf16*>(w_qkv), b_qkv, xn,
      static_cast<bf16*>(ws_qkv), ws_imp, B, N, D, H, E, HT, eps, scale, st);
  if (rc) return rc;
  rc = basd::launch_head_sum(ws_imp, imp, B, H, N, st);
  if (rc) return rc;
  return basd::proj_product(xn, static_cast<const bf16*>(w_proj), b_proj, xb,
                            nullptr, out, B, N, D, H * E, partial, st);
}

// K3a. As K1 with mask (B,) f32 applied to the proj branch and lse
// (B, H, N) f32 written instead of the importance; with `partial` the f32
// sums of proj alone (mask and b_proj unused). Workspaces: ws_xn (B*N, D)
// bf16, ws_qkv (B*N, 3 H E) bf16.
extern "C" int basd_block_attn_train_fwd(
    const void* x, const float* mask, const float* ln_s, const float* ln_b,
    const void* w_qkv, const float* b_qkv, const void* w_proj,
    const float* b_proj, void* out, float* lse, void* ws_xn, void* ws_qkv,
    int B, int N, int D, int H, int E, int partial, float eps, float scale,
    void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bf16* xb = static_cast<const bf16*>(x);
  bf16* xn = static_cast<bf16*>(ws_xn);
  int rc = basd::attention_half<true>(
      xb, ln_s, ln_b, static_cast<const bf16*>(w_qkv), b_qkv, xn,
      static_cast<bf16*>(ws_qkv), lse, B, N, D, H, E, H, eps, scale, st);
  if (rc) return rc;
  return basd::proj_product(xn, static_cast<const bf16*>(w_proj), b_proj, xb,
                            mask, out, B, N, D, H * E, partial, st);
}

// K2 and K4a. x, out: (B, N, D) bf16 (f32 for the _f32 entry); mask (B,)
// f32; w1 (F, D), w2 (D, F) in x's type; LN affine and biases f32;
// buf_rows: the (B*N, D) slab of the collection stack that receives `out`
// as well (K2), or null (K4a). With `partial`: out (B, N, D) f32, the sums
// of fc2 over the rank's F hidden units alone (mask, b2 and buf_rows
// unused). Workspaces in x's type: ws_xn (B*N, D), ws_h (B*N, F).
extern "C" int basd_block_mlp_collect_fwd(const void* x, const float* mask,
                                          const float* ln_s, const float* ln_b,
                                          const void* w1, const float* b1,
                                          const void* w2, const float* b2,
                                          void* out, void* buf_rows,
                                          void* ws_xn, void* ws_h, int B,
                                          int N, int D, int F, int partial,
                                          float eps, void* stream) {
  return basd::mlp_collect_fwd<bf16>(x, mask, ln_s, ln_b, w1, b1, w2, b2, out,
                                     buf_rows, ws_xn, ws_h, B, N, D, F,
                                     partial, eps, stream);
}
extern "C" int basd_block_mlp_collect_fwd_f32(
    const void* x, const float* mask, const float* ln_s, const float* ln_b,
    const void* w1, const float* b1, const void* w2, const float* b2,
    void* out, void* buf_rows, void* ws_xn, void* ws_h, int B, int N, int D,
    int F, int partial, float eps, void* stream) {
  return basd::mlp_collect_fwd<float>(x, mask, ln_s, ln_b, w1, b1, w2, b2,
                                      out, buf_rows, ws_xn, ws_h, B, N, D, F,
                                      partial, eps, stream);
}

// K2g. x, out: (B, N, D) bf16; mask (B,) f32; w1 (2F, D) bf16, fc1's rows
// [a | g] interleaved in groups of 64 (kernels/block_mlp.py:
// swiglu_interleave), b1 (2F) f32 likewise; w2 (D, F) bf16, b2 (D) f32
// (LayerScale folded in); buf_rows: the (B*N, D) slab of the collection
// stack that receives `out` as well, or null. Workspaces: ws_xn (B*N, D),
// ws_h (B*N, F) bf16. LN as K2's, then fc1 with EPI_BIAS_SWIGLU into ws_h
// (one 128-wide tile pairs 64 units' a and g), then fc2 with
// EPI_BIAS_RESIDUAL as K2's. Every product on the sm90 GEMM: F a multiple
// of 64 and D of 8, every pointer 16-byte aligned, or cudaErrorInvalidValue
// before any launch.
extern "C" int basd_block_swiglu_fwd(const void* x, const float* mask,
                                     const float* ln_s, const float* ln_b,
                                     const void* w1, const float* b1,
                                     const void* w2, const float* b2,
                                     void* out, void* buf_rows, void* ws_xn,
                                     void* ws_h, int B, int N, int D, int F,
                                     float eps, void* stream) {
  using namespace basd;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (F <= 0 || F % 64 != 0 ||
      !sm90_ok({D, F}, {x, mask, ln_s, ln_b, w1, b1, w2, b2, out, buf_rows,
                        ws_xn, ws_h}))
    return (int)cudaErrorInvalidValue;
  const int M = B * N;
  const bf16* xb = static_cast<const bf16*>(x);
  bf16* xn = static_cast<bf16*>(ws_xn);
  bf16* hid = static_cast<bf16*>(ws_h);
  int rc = launch_swiglu_layernorm(xb, ln_s, ln_b, xn, M, D, eps, st);
  if (rc) return rc;
  Gemm g1{};
  g1.A = xn;
  g1.lda = D;
  g1.B = static_cast<const bf16*>(w1);
  g1.ldb = D;
  g1.M = M;
  g1.N = 2 * F;
  g1.K = D;
  g1.bias = b1;
  g1.out = hid;
  g1.rows_per_mask = 1;
  rc = sm90::launch<EPI_BIAS_SWIGLU, 128, false, false, true>(g1, D, st);
  if (rc) return rc;
  Gemm g2{};
  g2.A = hid;
  g2.lda = F;
  g2.B = static_cast<const bf16*>(w2);
  g2.ldb = F;
  g2.M = M;
  g2.N = D;
  g2.K = F;
  g2.bias = b2;
  g2.out = static_cast<bf16*>(out);
  g2.out2 = static_cast<bf16*>(buf_rows);
  g2.aux = xb;
  g2.mask = mask;
  g2.rows_per_mask = N;
  if (sm90_tile_n(D) == 128)
    return sm90::launch<EPI_BIAS_RESIDUAL, 128, false, false, true>(g2, F, st);
  return sm90::launch<EPI_BIAS_RESIDUAL, 64, false, false, true>(g2, F, st);
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
  if (tile_n == 128) return sm90::launch<EPI_BIAS, 128, false, false>(g, K, st);
  if (tile_n == 64) return sm90::launch<EPI_BIAS, 64, false, false>(g, K, st);
  return (int)cudaErrorInvalidValue;
}

// One backward product through launch_gemm_bwd, on the variant `tile_n`
// names: -1 the rule's choice (gemm_bwd_tile_n), 0 the WMMA tile, 64 or
// 128 the sm90 GEMM at that tile width (which must then pass the rule).
// B (K, N) and every other matrix are bf16 and contiguous; `epi` picks
// the product and its epilogue:
//   EPI_F32 (5):     outf (M, N) = A (M, K) . B               (input_grad)
//   EPI_ROUND (7):   out (M, N) = bf16(A (M, K) . B)          (K11b's dx)
//   EPI_DGELU (4):   d = (A (M, K) . B) * gelu'(aux (M, N)), out = bf16(d),
//                    outf (N) = the column sums of d, through ws_part of
//                    ceil(M / 64) * N floats                   (dgelu_grad)
//   EPI_PARTIAL (6): outf (M, N) = A^T B, A (K, M), the split-K partials
//                    of k_chunk rows (-1: split_k_chunk's) in ws_part of
//                    splits * M * N floats, added in split order
//                                                              (weight_grad)
// It lets a test hold the variants against each other at any shape; the
// kernels above reach the same code through their own entries.
extern "C" int basd_gemm_bwd(const void* A, const void* B, const void* aux,
                             void* out, float* outf, float* ws_part, int M,
                             int N, int K, int epi, int tile_n, int k_chunk,
                             void* stream) {
  using namespace basd;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  Gemm g{};
  g.A = static_cast<const bf16*>(A);
  g.B = static_cast<const bf16*>(B);
  g.aux = static_cast<const bf16*>(aux);
  g.out = static_cast<bf16*>(out);
  g.lda = epi == EPI_PARTIAL ? M : K;
  g.ldb = N;
  g.M = M;
  g.N = N;
  g.K = K;
  g.outf = epi == EPI_F32 ? outf : ws_part;
  const int rule = gemm_bwd_tile_n(g, epi == EPI_PARTIAL);
  if (tile_n < 0) tile_n = rule;
  if (tile_n > 0 && rule == 0) return (int)cudaErrorInvalidValue;
  if (tile_n != 0 && tile_n != 64 && tile_n != 128)
    return (int)cudaErrorInvalidValue;
  int rc;
  switch (epi) {
    case EPI_F32:
      return launch_gemm_bwd<false, EPI_F32>(g, tile_n, 0, st);
    case EPI_ROUND:
      return launch_gemm_bwd<false, EPI_ROUND>(g, tile_n, 0, st);
    case EPI_DGELU:
      rc = launch_gemm_bwd<false, EPI_DGELU>(g, tile_n, 0, st);
      if (rc) return rc;
      return launch_reduce(ws_part, outf, (M + gemm_tile_m(tile_n) - 1) /
                                              gemm_tile_m(tile_n), N, st);
    case EPI_PARTIAL:
      if (k_chunk < 0) k_chunk = split_k_chunk(K, M, N);
      if (k_chunk <= 0 || k_chunk % 64 != 0) return (int)cudaErrorInvalidValue;
      rc = launch_gemm_bwd<true, EPI_PARTIAL>(g, tile_n, k_chunk, st);
      if (rc) return rc;
      return launch_reduce(ws_part, outf, (K + k_chunk - 1) / k_chunk, M * N,
                           st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
