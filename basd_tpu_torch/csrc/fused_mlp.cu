// K11: the fused MLP  out = fc2(gelu_tanh(fc1(x)))  and its recompute VJP
// on Hopper, the module-chain MLP of `tpu.student_mlp_impl=fused`.
//
// K11a replaces basd_tpu/ops/pallas/fused_mlp.py:_fwd (_fwd_kernel): two
// launches of the shared forward GEMM (csrc/block_kernels.cuh's
// launch_gemm_nk: the wgmma GEMM of gemm_sm90.cuh at bf16), fc1 with the
// bias + GELU epilogue (pre rounded to bf16, GELU in f32, hidden rounded to
// bf16) and fc2 with the bias epilogue (out = bf16(acc + b2)).
// K11b replaces _bwd (_bwd_kernel), nothing but x saved: it recomputes pre
// and the hidden state, then
//   db2 = sum do,  dW2 = do^T h,  dpre = (do W2) gelu'(pre) (f32),
//   db1 = sum dpre (f32, before the bf16 copy),  dW1 = bf16(dpre)^T x,
//   dx = bf16(bf16(dpre) W1),
// K4b's backward (csrc/block_train.cu) without the LayerNorm, the mask and
// the residual. The TPU kernel adds its weight and bias gradients into one
// f32 block across a sequential grid; here every cross-row sum is per-block
// partials (split-K slices sized by the shapes alone, the row tiles of the
// GELU-gradient epilogue, row chunks of the column sums) added in a fixed
// order: no atomics, so two calls give equal bits. Every bf16 product runs
// on gemm_sm90.cuh's wgmma GEMM: the forward ones K-major, the backward
// ones (block_kernels.cuh's weight_grad, dgelu_grad, input_grad) with the
// weight, or both operands of a weight gradient, MN-major.
//
// What bounds them on the H100: at the student's shapes (B*N = 25216 rows,
// D = 192, F = 768) K11a is 4 M D F = 14.9 GFLOP and K11b 10 M D F = 37.2
// GFLOP (15 and 38 us at the bf16 tensor-core peak) against ~20 MB and
// ~30 MB of unavoidable traffic (6 and 9 us at 3.35 TB/s): operations
// bound them. This version is bound by neither: the round trips of the
// (M, F) hidden state, pre-activation and dpre through device memory,
// which the TPU kernel keeps in VMEM, and the f32 weight-gradient
// partials do.
//
// The _f32 entries are the same chains on f32 tensors (the JAX package's
// f32 path), through the CUDA-core f32 GEMM of csrc/block_kernels.cuh with
// the same epilogues: no rounding of the pre-activation, the hidden state
// or dpre (each round to T is the identity at f32), tanh-GELU as at bf16.
// A plain right kernel, not a fast one.
//
// Every entry returns the first non-zero cudaGetLastError() after a launch,
// or 0. Nothing here allocates or synchronises.

#include "block_kernels.cuh"

namespace basd {

template <typename T>
static int fused_mlp_fwd(const void* x, const void* w1, const float* b1,
                         const void* w2, const float* b2, void* out,
                         void* ws_h, int M, int D, int F, int Do,
                         void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  T* hid = static_cast<T*>(ws_h);
  int rc = launch_gemm_nk<EPI_BIAS_GELU>(
      static_cast<const T*>(x), static_cast<const T*>(w1), b1, hid, M, F, D,
      nullptr, nullptr, 1, nullptr, st);
  if (rc) return rc;
  return launch_gemm_nk<EPI_BIAS>(static_cast<const T*>(hid),
                                  static_cast<const T*>(w2), b2,
                                  static_cast<T*>(out), M, Do, F, nullptr,
                                  nullptr, 1, nullptr, st);
}

template <typename T>
static int fused_mlp_bwd(const void* x, const void* dout, const void* w1,
                         const float* b1, const void* w2, void* dx, float* dw1,
                         float* db1, float* dw2, float* db2, void* ws_pre,
                         void* ws_h, void* ws_dpre, float* ws_part, int M,
                         int D, int F, int Do, int row_chunk, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const T* xb = static_cast<const T*>(x);
  const T* dob = static_cast<const T*>(dout);
  const T* w1b = static_cast<const T*>(w1);
  T* pre = static_cast<T*>(ws_pre);
  T* hid = static_cast<T*>(ws_h);
  T* dpre = static_cast<T*>(ws_dpre);

  int rc = launch_gemm_nk<EPI_BIAS_PRE_GELU>(xb, w1b, b1, pre, M, F, D,
                                             nullptr, nullptr, 1, hid, st);
  if (rc) return rc;
  rc = launch_dy(dob, nullptr, nullptr, ws_part, M, 1, Do, row_chunk, st);
  if (rc) return rc;
  rc = launch_reduce(ws_part, db2, (M + row_chunk - 1) / row_chunk, Do, st);
  if (rc) return rc;
  rc = weight_grad(dob, Do, static_cast<const T*>(hid), F, M, ws_part, dw2,
                   st);
  if (rc) return rc;
  // dpre = (do W2) * gelu'(pre), its copy in T, db1 its column sums
  rc = dgelu_grad(dob, static_cast<const T*>(w2), static_cast<const T*>(pre),
                  M, F, Do, dpre, ws_part, db1, st);
  if (rc) return rc;
  rc = weight_grad(static_cast<const T*>(dpre), F, xb, D, M, ws_part, dw1,
                   st);
  if (rc) return rc;
  // dx = T(dpre W1), W1 (F, D) read as K x N
  return input_grad<EPI_ROUND>(static_cast<const T*>(dpre), w1b, M, F, D,
                               static_cast<T*>(dx), nullptr, st);
}

}  // namespace basd

using basd::bf16;

// K11a. x (M, D), out (M, Do); w1 (F, D), w2 (Do, F), all bf16 (f32 for
// the _f32 entry); b1, b2 f32. Workspace: ws_h (M, F) in x's type.
extern "C" int basd_fused_mlp_fwd(const void* x, const void* w1,
                                  const float* b1, const void* w2,
                                  const float* b2, void* out, void* ws_h,
                                  int M, int D, int F, int Do, void* stream) {
  return basd::fused_mlp_fwd<bf16>(x, w1, b1, w2, b2, out, ws_h, M, D, F, Do,
                                   stream);
}
extern "C" int basd_fused_mlp_fwd_f32(const void* x, const void* w1,
                                      const float* b1, const void* w2,
                                      const float* b2, void* out, void* ws_h,
                                      int M, int D, int F, int Do,
                                      void* stream) {
  return basd::fused_mlp_fwd<float>(x, w1, b1, w2, b2, out, ws_h, M, D, F, Do,
                                    stream);
}

// K11b. x (M, D), dout (M, Do), dx (M, D); w1 (F, D), w2 (Do, F), all bf16
// (f32 for the _f32 entry); b1 f32. Outputs in f32: dw1 (F, D), db1 (F),
// dw2 (Do, F), db2 (Do). Workspaces: ws_pre, ws_h, ws_dpre (M, F) in x's
// type; ws_part f32 of max(splits * m * n over dW2 and dW1 (split_k_chunk),
// GELU-gradient row tiles * F, row chunks * Do) elements.
extern "C" int basd_fused_mlp_bwd(const void* x, const void* dout,
                                  const void* w1, const float* b1,
                                  const void* w2, void* dx, float* dw1,
                                  float* db1, float* dw2, float* db2,
                                  void* ws_pre, void* ws_h, void* ws_dpre,
                                  float* ws_part, int M, int D, int F, int Do,
                                  int row_chunk, void* stream) {
  return basd::fused_mlp_bwd<bf16>(x, dout, w1, b1, w2, dx, dw1, db1, dw2,
                                   db2, ws_pre, ws_h, ws_dpre, ws_part, M, D,
                                   F, Do, row_chunk, stream);
}
extern "C" int basd_fused_mlp_bwd_f32(const void* x, const void* dout,
                                      const void* w1, const float* b1,
                                      const void* w2, void* dx, float* dw1,
                                      float* db1, float* dw2, float* db2,
                                      void* ws_pre, void* ws_h, void* ws_dpre,
                                      float* ws_part, int M, int D, int F,
                                      int Do, int row_chunk, void* stream) {
  return basd::fused_mlp_bwd<float>(x, dout, w1, b1, w2, dx, dw1, db1, dw2,
                                    db2, ws_pre, ws_h, ws_dpre, ws_part, M, D,
                                    F, Do, row_chunk, stream);
}
