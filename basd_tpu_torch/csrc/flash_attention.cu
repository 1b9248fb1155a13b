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
// K10b keeps K3b's two-phase design (csrc/block_train.cu) on the flash
// VJP's inputs: delta = sum f32(do) f32(o) from the saved bf16 o (no
// recompute of o, no dattn GEMM), p = exp(s - lse), dp = do v^T,
// ds = bf16(p (dp - delta) scale); phase A walks query rows for dq = ds k,
// phase B key rows for dk = ds^T q and dv = bf16(p)^T do, with the scores
// recomputed bit-identically (dot_rows). Outputs are in qkv's type, no
// column sums.
//
// What bounds them on the H100: at the student's shapes (B=128, N=197,
// D=192, 3 heads) K10a is 4 B N^2 D = 3.8 GFLOP and K10b 10 B N^2 D =
// 9.5 GFLOP, 4 and 10 us at the bf16 tensor-core peak, against 39 MB and
// 78 MB of unavoidable traffic (12 and 23 us at 3.35 TB/s): bytes bound
// them. K10a and K10c at bf16 run the tensor-core forward of
// csrc/attention.cuh (one CTA per (image, head, 64-row query tile),
// mma.sync products, two softmax passes; its note has the design); K10b,
// and the forward at f32 or at a head width that kernel does not take,
// run on CUDA cores, one warp per row: one block holds one (image, head),
// K and V (forward) or q, k, v, do (backward: ~118 KB at N=197, ~154 KB at
// N=257, E=64, bf16) in shared memory, so nothing of the N x N scores
// reaches device memory.
//
// Every kernel is templated on the slab's element type T (bf16 or f32):
// scores, softmax and every accumulation stay f32, and each point where
// the TPU kernel rounds to the slab's dtype rounds to T, the identity at
// f32. The _f32 entries take f32 slabs (the JAX package's f32 path); at
// f32 the backward's shared memory (~222 KB at N=197, E=64) leaves no room
// for N=257, which the wrapper refuses before launch.
//
// Every entry returns the first non-zero cudaGetLastError() after a launch,
// or 0. Nothing here allocates or synchronises.

#include "attention.cuh"

namespace basd {

// Flash backward of one (image, head) per block; see the file note.
template <typename T>
__global__ void flash_bwd_kernel(const T* __restrict__ qkv,
                                 const T* __restrict__ o,
                                 const T* __restrict__ dout,
                                 const float* __restrict__ lse,
                                 T* __restrict__ dqkv, int N, int D, int H,
                                 float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int e = D / H;
  const int ldk = e + 2;  // odd word stride at bf16: conflict-free row reads
  const int nwarps = blockDim.x / 32;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  T* qs = reinterpret_cast<T*>(smem_raw);
  T* ks = qs + N * ldk;
  T* vs = ks + N * ldk;
  T* dos = vs + N * ldk;
  float* lse_s = reinterpret_cast<float*>(dos + N * ldk);
  float* delta_s = lse_s + N;
  float* rows_s = delta_s + N;  // two rows of N per warp

  const int b = blockIdx.x / H;
  const int h = blockIdx.x % H;
  const size_t ld3 = 3 * (size_t)D;
  const T* base = qkv + (size_t)b * N * ld3;
  const T* obase = o + (size_t)b * N * D;
  const T* dbase = dout + (size_t)b * N * D;
  for (int i = threadIdx.x; i < N * e; i += blockDim.x) {
    const int n = i / e;
    const int c = i % e;
    qs[n * ldk + c] = base[n * ld3 + h * e + c];
    ks[n * ldk + c] = base[n * ld3 + D + h * e + c];
    vs[n * ldk + c] = base[n * ld3 + 2 * D + h * e + c];
    dos[n * ldk + c] = dbase[(size_t)n * D + h * e + c];
  }
  for (int i = threadIdx.x; i < N; i += blockDim.x)
    lse_s[i] = lse[((size_t)b * H + h) * N + i];
  __syncthreads();

  // delta, one warp per query row
  for (int i = warp; i < N; i += nwarps) {
    float acc = 0.f;
    for (int c = lane; c < e; c += 32)
      acc += to_f(obase[(size_t)i * D + h * e + c]) * to_f(dos[i * ldk + c]);
    acc = warp_sum(acc);
    if (lane == 0) delta_s[i] = acc;
  }
  __syncthreads();

  float* row_a = rows_s + warp * 2 * N;
  float* row_b = row_a + N;

  // phase A: query rows, dq = ds k
  for (int i = warp; i < N; i += nwarps) {
    const T* qi = qs + i * ldk;
    const T* doi = dos + i * ldk;
    const float lse_i = lse_s[i];
    const float delta = delta_s[i];
    for (int j = lane; j < N; j += 32) {
      const float s = __fmul_rn(dot_rows(qi, ks + j * ldk, e), scale);
      const float p = expf(__fsub_rn(s, lse_i));
      const float dp = dot_rows(doi, vs + j * ldk, e);
      row_a[j] =
          round_t<T>(__fmul_rn(__fmul_rn(p, __fsub_rn(dp, delta)), scale));
    }
    __syncwarp();
    const size_t qrow = ((size_t)b * N + i) * ld3 + h * e;
    for (int c2 = lane; c2 < e / 2; c2 += 32) {
      float a0 = 0.f, a1 = 0.f;
      for (int j = 0; j < N; ++j) {
        const float ds = row_a[j];
        const float2 k = load2(ks + j * ldk + 2 * c2);
        a0 += ds * k.x;
        a1 += ds * k.y;
      }
      dqkv[qrow + 2 * c2] = from_f<T>(a0);
      dqkv[qrow + 2 * c2 + 1] = from_f<T>(a1);
    }
    __syncwarp();
  }

  // phase B: key rows, dk = ds^T q, dv = round_t(p)^T do
  for (int j = warp; j < N; j += nwarps) {
    const T* kj = ks + j * ldk;
    const T* vj = vs + j * ldk;
    for (int i = lane; i < N; i += 32) {
      const float s = __fmul_rn(dot_rows(qs + i * ldk, kj, e), scale);
      const float p = expf(__fsub_rn(s, lse_s[i]));
      const float dp = dot_rows(dos + i * ldk, vj, e);
      row_a[i] = round_t<T>(p);
      row_b[i] = round_t<T>(
          __fmul_rn(__fmul_rn(p, __fsub_rn(dp, delta_s[i])), scale));
    }
    __syncwarp();
    const size_t krow = ((size_t)b * N + j) * ld3 + h * e;
    for (int c2 = lane; c2 < e / 2; c2 += 32) {
      float k0 = 0.f, k1 = 0.f, v0 = 0.f, v1 = 0.f;
      for (int i = 0; i < N; ++i) {
        const float ds = row_b[i];
        const float pb = row_a[i];
        const float2 q = load2(qs + i * ldk + 2 * c2);
        const float2 dv = load2(dos + i * ldk + 2 * c2);
        k0 += ds * q.x;
        k1 += ds * q.y;
        v0 += pb * dv.x;
        v1 += pb * dv.y;
      }
      dqkv[krow + D + 2 * c2] = from_f<T>(k0);
      dqkv[krow + D + 2 * c2 + 1] = from_f<T>(k1);
      dqkv[krow + 2 * D + 2 * c2] = from_f<T>(v0);
      dqkv[krow + 2 * D + 2 * c2 + 1] = from_f<T>(v1);
    }
    __syncwarp();
  }
}

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

// K10b: dqkv.
template <typename T>
static int flash_bwd(const void* qkv, const void* o, const void* dout,
                     const float* lse, void* dqkv, int B, int N, int D, int H,
                     float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int threads = 256;
  const int e = D / H;
  const size_t smem = (size_t)4 * N * (e + 2) * sizeof(T) +
                      (size_t)2 * N * sizeof(float) +
                      (size_t)(threads / 32) * 2 * N * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  flash_bwd_kernel<T><<<B * H, threads, smem, st>>>(
      static_cast<const T*>(qkv), static_cast<const T*>(o),
      static_cast<const T*>(dout), lse, static_cast<T*>(dqkv), N, D, H, scale);
  BASD_CHECK_LAUNCH();
  return 0;
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
// f32 -> dqkv (B, N, 3D) in that type.
extern "C" int basd_flash_attn_bwd(const void* qkv, const void* o,
                                   const void* dout, const float* lse,
                                   void* dqkv, int B, int N, int D, int H,
                                   float scale, void* stream) {
  return basd::flash_bwd<bf16>(qkv, o, dout, lse, dqkv, B, N, D, H, scale,
                               stream);
}
extern "C" int basd_flash_attn_bwd_f32(const void* qkv, const void* o,
                                       const void* dout, const float* lse,
                                       void* dqkv, int B, int N, int D, int H,
                                       float scale, void* stream) {
  return basd::flash_bwd<float>(qkv, o, dout, lse, dqkv, B, N, D, H, scale,
                                stream);
}
