// K3b and K4b: the backward passes of the student's fused block halves on
// Hopper.
//
// K3b replaces basd_tpu/ops/pallas/fused_block_attn.py:_bwd_train
// (_bwd_train_kernel), the VJP of  out = x + mask * proj(MHSA(qkv(LN(x)))).
// K4b replaces basd_tpu/ops/pallas/fused_block_mlp.py:_bwd (_bwd_kernel),
// the VJP of  out = x + mask * fc2(gelu_tanh(fc1(LN(x)))). Its _f32 entry
// runs the same chain on f32 tensors through the CUDA-core f32 GEMM, every
// rounding below then the identity.
// Both recompute from the block input x (and, for attention, the forward's
// per-row logsumexp) instead of saving activations, and round where the
// TPU kernels round: bf16 LN output, bf16 qkv / pre-activation / hidden,
// dy = do * mask with a bf16 copy, f32 accumulation of every product, bf16
// operands into the weight-gradient products, the LN VJP per row in f32
// and dx = bf16(do + dxln).
//
// The TPU kernels add their weight, bias and LN gradients into one f32
// block across a sequential grid. Hopper's blocks run in no order, so here
// every cross-row sum is two passes: per-block partials into a scratch
// buffer (split-K slices of the weight-gradient GEMMs, sized by the shapes
// alone (split_k_chunk); the row tiles of the GELU-gradient epilogue, 128
// rows on the sm90 GEMM; row chunks of the column sums; (image, tile)
// blocks of the attention backward), then reduce_partials_kernel adds them
// in a fixed order. No atomics: two calls give equal bits.
//
// What bounds them on the H100: at the student's shapes (B*N = 25216 rows,
// D = 192, F = 768, 3 heads, B=128) K3b is ~36 GFLOP and K4b ~45 GFLOP
// (counted from the shapes; 0.04-0.05 ms at the bf16 tensor-core peak)
// against ~0.1 GB of unavoidable traffic (0.03 ms at 3.35 TB/s). Every
// bf16 product runs on gemm_sm90.cuh's wgmma GEMM: the recomputed forward
// ones (qkv; fc1) with both operands K-major, the backward ones through
// block_kernels.cuh's input_grad, dgelu_grad and weight_grad with the
// weight (or, in the weight gradients, both operands) MN-major. What is
// left binds it: the round trips of the recomputed slabs and of the f32
// gradients through device memory, and the launches between them (about
// a dozen a block). K3b's attention
// is the tensor-core backward core of csrc/attention_bwd.cuh (K10b's too):
// a query-tiled launch for attn, delta and dq, a key-tiled one for dk and
// dv, each staging 64-row blocks, so nothing of the N x N scores reaches
// device memory.
//
// Every entry returns the first non-zero cudaGetLastError() after a
// launch, or 0. Nothing here allocates or synchronises.

#include "attention_bwd.cuh"
#include "block_kernels.cuh"

namespace basd {

// LN VJP, one warp per row: g = dxn * scale,
// dx = T(do + rstd * (g - mean(g) - xhat * mean(g * xhat))).
template <typename T>
__global__ void ln_bwd_rows_kernel(const T* __restrict__ x,
                                   const T* __restrict__ dout,
                                   const float* __restrict__ dxn,
                                   const float* __restrict__ scale,
                                   const float* __restrict__ mu,
                                   const float* __restrict__ rstd,
                                   T* __restrict__ dx, int rows, int d) {
  const int row = (blockIdx.x * blockDim.x + threadIdx.x) / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  const size_t base = (size_t)row * d;
  const float m = mu[row];
  const float rs = rstd[row];
  const float inv_d = 1.f / (float)d;
  float sg = 0.f, sgx = 0.f;
  for (int i = lane; i < d; i += 32) {
    const float xhat = (to_f(x[base + i]) - m) * rs;
    const float g = dxn[base + i] * scale[i];
    sg += g;
    sgx += g * xhat;
  }
  const float mg = warp_sum(sg) * inv_d;
  const float mgx = warp_sum(sgx) * inv_d;
  for (int i = lane; i < d; i += 32) {
    const float xhat = (to_f(x[base + i]) - m) * rs;
    const float g = dxn[base + i] * scale[i];
    const float dxln = rs * (g - mg - xhat * mgx);
    dx[base + i] = from_f<T>(to_f(dout[base + i]) + dxln);
  }
}

// LN parameter partials over a row chunk, one thread per column:
// part_s[chunk, c] = sum dxn * xhat, part_b[chunk, c] = sum dxn.
template <typename T>
__global__ void ln_param_partials_kernel(const T* __restrict__ x,
                                         const float* __restrict__ dxn,
                                         const float* __restrict__ mu,
                                         const float* __restrict__ rstd,
                                         float* __restrict__ part_s,
                                         float* __restrict__ part_b, int M,
                                         int D, int row_chunk) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= D) return;
  const int r0 = blockIdx.y * row_chunk;
  const int r1 = min(M, r0 + row_chunk);
  float as = 0.f, ab = 0.f;
  for (int r = r0; r < r1; ++r) {
    const size_t o = (size_t)r * D + c;
    const float xhat = (to_f(x[o]) - mu[r]) * rstd[r];
    as += dxn[o] * xhat;
    ab += dxn[o];
  }
  part_s[(size_t)blockIdx.y * D + c] = as;
  part_b[(size_t)blockIdx.y * D + c] = ab;
}

// LN VJP rows into dx, then the scale/bias sums into dln_s, dln_b.
template <typename T>
static int ln_backward(const T* x, const T* dout, const float* dxn,
                       const float* ln_s, const float* mu, const float* rstd,
                       T* dx, float* dln_s, float* dln_b, float* part,
                       int M, int D, int row_chunk, cudaStream_t st) {
  const int threads = 256;
  const int blocks = (int)(((size_t)M * 32 + threads - 1) / threads);
  ln_bwd_rows_kernel<T><<<blocks, threads, 0, st>>>(x, dout, dxn, ln_s, mu,
                                                    rstd, dx, M, D);
  BASD_CHECK_LAUNCH();
  const int chunks = (M + row_chunk - 1) / row_chunk;
  dim3 grid((D + 127) / 128, chunks);
  ln_param_partials_kernel<T><<<grid, 128, 0, st>>>(
      x, dxn, mu, rstd, part, part + (size_t)chunks * D, M, D, row_chunk);
  BASD_CHECK_LAUNCH();
  int rc = launch_reduce(part, dln_s, chunks, D, st);
  if (rc) return rc;
  return launch_reduce(part + (size_t)chunks * D, dln_b, chunks, D, st);
}

// K4b's chain in T (bf16, or f32 on the CUDA-core GEMM).
template <typename T>
static int mlp_bwd(const void* x, const float* mask, const void* dout,
                   const float* ln_s, const float* ln_b, const void* w1,
                   const float* b1, const void* w2, void* dx, float* dw1,
                   float* db1, float* dw2, float* db2, float* dln_s,
                   float* dln_b, void* ws_xn, float* ws_stats, void* ws_pre,
                   void* ws_h, void* ws_dyb, void* ws_dpre, float* ws_f32,
                   float* ws_part, int B, int N, int D, int F, int row_chunk,
                   float eps, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int M = B * N;
  const T* xb = static_cast<const T*>(x);
  const T* dob = static_cast<const T*>(dout);
  const T* w1b = static_cast<const T*>(w1);
  const T* w2b = static_cast<const T*>(w2);
  T* xn = static_cast<T*>(ws_xn);
  T* pre = static_cast<T*>(ws_pre);
  T* hid = static_cast<T*>(ws_h);
  T* dyb = static_cast<T*>(ws_dyb);
  T* dpre = static_cast<T*>(ws_dpre);
  float* mu = ws_stats;
  float* rstd = ws_stats + M;

  int rc = launch_layernorm(xb, ln_s, ln_b, xn, mu, rstd, M, D, eps, st);
  if (rc) return rc;
  rc = launch_gemm_nk<EPI_BIAS_PRE_GELU>(xn, w1b, b1, pre, M, F, D, nullptr,
                                         nullptr, 1, hid, st);
  if (rc) return rc;
  rc = launch_dy(dob, mask, dyb, ws_part, M, N, D, row_chunk, st);
  if (rc) return rc;
  rc = launch_reduce(ws_part, db2, (M + row_chunk - 1) / row_chunk, D, st);
  if (rc) return rc;
  rc = weight_grad(dyb, D, hid, F, M, ws_part, dw2, st);
  if (rc) return rc;
  // dpre = (dyb W2) * gelu'(pre), its copy in T, db1 its column sums
  rc = dgelu_grad(dyb, w2b, pre, M, F, D, dpre, ws_part, db1, st);
  if (rc) return rc;
  rc = weight_grad(dpre, F, xn, D, M, ws_part, dw1, st);
  if (rc) return rc;
  rc = input_grad<EPI_F32>(dpre, w1b, M, F, D, nullptr, ws_f32, st);  // dxn
  if (rc) return rc;
  return ln_backward(xb, dob, ws_f32, ln_s, mu, rstd, static_cast<T*>(dx),
                     dln_s, dln_b, ws_part, M, D, row_chunk, st);
}

}  // namespace basd

using basd::bf16;

// K3b. x, dout, dx: (B, N, D) bf16; mask (B,) f32; lse (B, H, N) f32;
// w_qkv (3D, D), w_proj (D, D) bf16; LN affine and b_qkv f32. Outputs in
// f32: dw_qkv (3D, D), db_qkv (3D), dw_proj (D, D), db_proj, dln_s, dln_b
// (D). Workspaces: ws_xn, ws_dyb, ws_attn (B*N, D) bf16; ws_qkv, ws_dqkv
// (B*N, 3D) bf16; ws_stats (2 B*N) f32; ws_f32 (B*N, D) f32; ws_part f32
// of max(splits * m * n over dW_proj and dW_qkv (split_k_chunk),
// B * ceil(N / 64) * 3D, 2 * row chunks * D) elements; ws_delta (B, H, N)
// f32.
extern "C" int basd_block_attn_train_bwd(
    const void* x, const float* mask, const void* dout, const float* lse,
    const float* ln_s, const float* ln_b, const void* w_qkv,
    const float* b_qkv, const void* w_proj, void* dx, float* dw_qkv,
    float* db_qkv, float* dw_proj, float* db_proj, float* dln_s, float* dln_b,
    void* ws_xn, float* ws_stats, void* ws_qkv, void* ws_dyb, float* ws_f32,
    void* ws_attn, void* ws_dqkv, float* ws_part, float* ws_delta, int B,
    int N, int D, int H, int row_chunk, float eps, float scale,
    void* stream) {
  using namespace basd;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int M = B * N;
  const bf16* xb = static_cast<const bf16*>(x);
  const bf16* dob = static_cast<const bf16*>(dout);
  const bf16* wq = static_cast<const bf16*>(w_qkv);
  const bf16* wp = static_cast<const bf16*>(w_proj);
  bf16* xn = static_cast<bf16*>(ws_xn);
  bf16* qkv = static_cast<bf16*>(ws_qkv);
  bf16* dyb = static_cast<bf16*>(ws_dyb);
  bf16* attn = static_cast<bf16*>(ws_attn);
  bf16* dqkv = static_cast<bf16*>(ws_dqkv);
  float* mu = ws_stats;
  float* rstd = ws_stats + M;

  int rc = launch_layernorm(xb, ln_s, ln_b, xn, mu, rstd, M, D, eps, st);
  if (rc) return rc;
  rc = launch_gemm_nk<EPI_BIAS>(xn, wq, b_qkv, qkv, M, 3 * D, D, nullptr,
                                nullptr, 1, nullptr, st);
  if (rc) return rc;
  rc = launch_dy(dob, mask, dyb, ws_part, M, N, D, row_chunk, st);
  if (rc) return rc;
  rc = launch_reduce(ws_part, db_proj, (M + row_chunk - 1) / row_chunk, D, st);
  if (rc) return rc;
  rc = input_grad<EPI_F32>(dyb, wp, M, D, D, nullptr, ws_f32, st);  // dattn
  if (rc) return rc;

  // the attention backward (csrc/attention_bwd.cuh): attn, dqkv and the
  // column sums of dqkv per (image, tile), added in order into db_qkv
  AttnBwd a{};
  a.qkv = qkv;
  a.lse = lse;
  a.dattn = ws_f32;
  a.attn = attn;
  a.dqkv = dqkv;
  a.delta = ws_delta;
  a.part = ws_part;
  a.B = B;
  a.N = N;
  a.D = D;
  a.H = H;
  a.scale = scale;
  int part_rows = 0;
  rc = launch_attention_bwd<true, bf16>(a, &part_rows, st);
  if (rc) return rc;
  rc = launch_reduce(ws_part, db_qkv, part_rows, 3 * D, st);
  if (rc) return rc;

  rc = weight_grad(dyb, D, attn, D, M, ws_part, dw_proj, st);
  if (rc) return rc;
  rc = weight_grad(dqkv, 3 * D, xn, D, M, ws_part, dw_qkv, st);
  if (rc) return rc;
  rc = input_grad<EPI_F32>(dqkv, wq, M, 3 * D, D, nullptr, ws_f32, st);  // dxn
  if (rc) return rc;
  return ln_backward(xb, dob, ws_f32, ln_s, mu, rstd, static_cast<bf16*>(dx),
                     dln_s, dln_b, ws_part, M, D, row_chunk, st);
}

// K4b. x, dout, dx: (B, N, D) bf16 (f32 for the _f32 entry); mask (B,)
// f32; w1 (F, D), w2 (D, F) in x's type; LN affine and b1 f32. Outputs in
// f32: dw1 (F, D), db1 (F), dw2 (D, F), db2, dln_s, dln_b (D). Workspaces
// in x's type: ws_xn, ws_dyb (B*N, D); ws_pre, ws_h, ws_dpre (B*N, F); in
// f32: ws_stats (2 B*N), ws_f32 (B*N, D), ws_part of max(splits * F * D
// over dW2 and dW1 (split_k_chunk), GELU-gradient row tiles * F,
// 2 * row chunks * D) elements.
extern "C" int basd_block_mlp_bwd(
    const void* x, const float* mask, const void* dout, const float* ln_s,
    const float* ln_b, const void* w1, const float* b1, const void* w2,
    void* dx, float* dw1, float* db1, float* dw2, float* db2, float* dln_s,
    float* dln_b, void* ws_xn, float* ws_stats, void* ws_pre, void* ws_h,
    void* ws_dyb, void* ws_dpre, float* ws_f32, float* ws_part, int B, int N,
    int D, int F, int row_chunk, float eps, void* stream) {
  return basd::mlp_bwd<bf16>(x, mask, dout, ln_s, ln_b, w1, b1, w2, dx, dw1,
                             db1, dw2, db2, dln_s, dln_b, ws_xn, ws_stats,
                             ws_pre, ws_h, ws_dyb, ws_dpre, ws_f32, ws_part, B,
                             N, D, F, row_chunk, eps, stream);
}
extern "C" int basd_block_mlp_bwd_f32(
    const void* x, const float* mask, const void* dout, const float* ln_s,
    const float* ln_b, const void* w1, const float* b1, const void* w2,
    void* dx, float* dw1, float* db1, float* dw2, float* db2, float* dln_s,
    float* dln_b, void* ws_xn, float* ws_stats, void* ws_pre, void* ws_h,
    void* ws_dyb, void* ws_dpre, float* ws_f32, float* ws_part, int B, int N,
    int D, int F, int row_chunk, float eps, void* stream) {
  return basd::mlp_bwd<float>(x, mask, dout, ln_s, ln_b, w1, b1, w2, dx, dw1,
                              db1, dw2, db2, dln_s, dln_b, ws_xn, ws_stats,
                              ws_pre, ws_h, ws_dyb, ws_dpre, ws_f32, ws_part,
                              B, N, D, F, row_chunk, eps, stream);
}
