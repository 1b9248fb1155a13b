// K10: attention over the packed (B, N, 3D) qkv slab on Hopper, the
// module-chain attention of `tpu.*_attention_impl=flash`.
//
// K10a replaces basd_tpu/ops/pallas/flash_attention.py:_fwd (_fwd_kernel):
// o = softmax(scale q k^T) v per head, with the per-(image, head, query)
// logsumexp in f32. K10c replaces _fwd_hp (_fwd_kernel_hp) and, for an odd
// head count, _fwd with the importance output: o and the head-mean of the
// CLS query's softmax row (B, N). K10b replaces _bwd (_bwd_kernel): dqkv
// from qkv, the saved o, do (already rounded to qkv's dtype) and lse.
//
// K10a and K10c are the per-(image, head) attention of K1 and K3a
// (csrc/attention.cuh) on the caller's slab, without their LN and GEMMs:
// the TPU kernel's rounding (f32 scores, f32 softmax, bf16 probabilities
// into P.V, deferred normalisation, lse = m + log l) is already theirs.
// The importance is each head's CLS row over l * H, summed over heads in
// order (the TPU head-loop kernel divides the head sum by H instead, the
// head-pair one adds pair sums: the three agree to f32 rounding).
//
// K10b is the backward attention core of csrc/attention_bwd.cuh (which
// K3b shares) on the flash VJP's inputs: delta = sum f32(do) f32(o) from the
// saved o (no recompute of o, no dattn GEMM), p = exp(s - lse),
// dp = do v^T, ds = bf16(p (dp - delta) scale), dq = ds k, dk = ds^T q,
// dv = round_t(p)^T do; outputs in qkv's type, no column sums.
//
// What bounds them on the H100: at the student's shapes (B=128, N=197,
// D=192, 3 heads) K10a is 4 B N^2 D = 3.8 GFLOP and K10b 10 B N^2 D =
// 9.5 GFLOP, 4 and 10 us at the bf16 tensor-core peak, against 39 MB and
// 78 MB of unavoidable traffic (12 and 23 us at 3.35 TB/s): bytes bound
// them. At bf16 both run on tensor cores (mma.sync; K10a and K10c one CTA
// per (image, head, 64-row query tile) with two softmax passes, K10b two
// launches tiled over 64-query and 64-key blocks; the two headers' notes
// have the designs); the forward at f32 or at a head width those kernels
// do not take runs on CUDA cores, one warp per row, and so does K10b (two
// launches, each holding two of q, k, v and do of one (image, head) in
// shared memory: ~159 KB at f32, N=257, E=64).
//
// Every kernel is templated on the slab's element type T (bf16 or f32):
// scores, softmax and every accumulation stay f32, and each point where
// the TPU kernel rounds to the slab's dtype rounds to T, the identity at
// f32. The _f32 entries take f32 slabs (the JAX package's f32 path).
//
// Every entry returns the first non-zero cudaGetLastError() after a launch,
// or 0. Nothing here allocates or synchronises.

#include "attention_bwd.cuh"

namespace basd {

// K10a: o and lse.
template <typename T>
static int flash_fwd(const void* qkv, void* o, float* lse, int B, int N, int D,
                     int H, float scale, void* stream) {
  return launch_attention_heads<true>(static_cast<const T*>(qkv),
                                      static_cast<T*>(o), lse, B, N, D, H,
                                      scale, static_cast<cudaStream_t>(stream));
}

// K10c: o and the ordered head sum of the per-head CLS rows.
template <typename T>
static int flash_imp(const void* qkv, void* o, float* imp, float* ws_imp,
                     int B, int N, int D, int H, float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int rc = launch_attention_heads<false>(static_cast<const T*>(qkv),
                                         static_cast<T*>(o), ws_imp, B, N, D,
                                         H, scale, st);
  if (rc) return rc;
  return launch_head_sum(ws_imp, imp, B, H, N, st);
}

// K10b: dqkv, through the backward attention core.
template <typename T>
static int flash_bwd(const void* qkv, const void* o, const void* dout,
                     const float* lse, void* dqkv, float* ws_delta, int B,
                     int N, int D, int H, float scale, void* stream) {
  AttnBwd a{};
  a.qkv = qkv;
  a.lse = lse;
  a.o = o;
  a.dout = dout;
  a.dqkv = dqkv;
  a.delta = ws_delta;
  a.B = B;
  a.N = N;
  a.D = D;
  a.H = H;
  a.scale = scale;
  return launch_attention_bwd<false, T>(a, nullptr,
                                        static_cast<cudaStream_t>(stream));
}

}  // namespace basd

using basd::bf16;

// K10a. qkv (B, N, 3D) -> o (B, N, D) in qkv's type, lse (B, H, N) f32.
extern "C" int basd_flash_attn_fwd(const void* qkv, void* o, float* lse, int B,
                                   int N, int D, int H, float scale,
                                   void* stream) {
  return basd::flash_fwd<bf16>(qkv, o, lse, B, N, D, H, scale, stream);
}
extern "C" int basd_flash_attn_fwd_f32(const void* qkv, void* o, float* lse,
                                       int B, int N, int D, int H, float scale,
                                       void* stream) {
  return basd::flash_fwd<float>(qkv, o, lse, B, N, D, H, scale, stream);
}

// K10c. qkv (B, N, 3D) -> o (B, N, D) in qkv's type, imp (B, N) f32 (CLS
// key included). Workspace: ws_imp (B, H, N) f32.
extern "C" int basd_flash_attn_imp(const void* qkv, void* o, float* imp,
                                   float* ws_imp, int B, int N, int D, int H,
                                   float scale, void* stream) {
  return basd::flash_imp<bf16>(qkv, o, imp, ws_imp, B, N, D, H, scale, stream);
}
extern "C" int basd_flash_attn_imp_f32(const void* qkv, void* o, float* imp,
                                       float* ws_imp, int B, int N, int D,
                                       int H, float scale, void* stream) {
  return basd::flash_imp<float>(qkv, o, imp, ws_imp, B, N, D, H, scale,
                                stream);
}

// K10b. qkv (B, N, 3D), o and dout (B, N, D) in one type, lse (B, H, N)
// f32 -> dqkv (B, N, 3D) in that type. Workspace: ws_delta (B, H, N) f32.
extern "C" int basd_flash_attn_bwd(const void* qkv, const void* o,
                                   const void* dout, const float* lse,
                                   void* dqkv, float* ws_delta, int B, int N,
                                   int D, int H, float scale, void* stream) {
  return basd::flash_bwd<bf16>(qkv, o, dout, lse, dqkv, ws_delta, B, N, D, H,
                               scale, stream);
}
extern "C" int basd_flash_attn_bwd_f32(const void* qkv, const void* o,
                                       const void* dout, const float* lse,
                                       void* dqkv, float* ws_delta, int B,
                                       int N, int D, int H, float scale,
                                       void* stream) {
  return basd::flash_bwd<float>(qkv, o, dout, lse, dqkv, ws_delta, B, N, D, H,
                                scale, stream);
}
