// Per-(image, head) softmax attention over a packed (B, N, 3D) qkv slab,
// shared by K1 and K3a (csrc/block.cu, after their LN and qkv GEMM), K10a
// and K10c (csrc/flash_attention.cu, on the caller's slab), and the
// bit-identical score recompute of the backward kernels (K3b in
// csrc/block_train.cu, K10b in csrc/flash_attention.cu).
#pragma once

#include "common.cuh"

namespace basd {

// dot of two bf16 rows in f32, products added in order with explicit
// fused multiply-adds: both phases of an attention backward call it, so
// every recomputed score is bit-identical between them.
__device__ __forceinline__ float dot_bf(const bf16* a, const bf16* b, int e) {
  float acc = 0.f;
  for (int c = 0; c < e; c += 2) {
    const float2 av =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(a + c));
    const float2 bv =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(b + c));
    acc = __fmaf_rn(av.x, bv.x, acc);
    acc = __fmaf_rn(av.y, bv.y, acc);
  }
  return acc;
}

// One block per (image, head): scores in f32 from bf16 q, k; f32 softmax;
// bf16 probabilities times v with f32 accumulation and deferred
// normalisation (the TPU kernels' order). With LSE false (K1, K10c) the
// CLS query's row, divided by l * H, goes to stat[b, h, :]; heads are
// summed later in a fixed order, so no atomics. With LSE true (K3a, K10a)
// every query row's m + log(l) goes to stat[b, h, query].
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
static __global__ void head_sum_kernel(const float* __restrict__ imp_heads,
                                       float* __restrict__ imp, int B, int H,
                                       int N) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= B * N) return;
  const int b = i / N;
  const int n = i % N;
  float acc = imp_heads[((size_t)b * H) * N + n];
  for (int h = 1; h < H; ++h) acc += imp_heads[((size_t)b * H + h) * N + n];
  imp[i] = acc;
}

// attention_heads_kernel over the (B, N, 3D) slab into out (B, N, D) and
// stat (B, H, N), with the shared memory its (image, head) needs.
template <bool LSE>
static int launch_attention_heads(const bf16* qkv, bf16* out, float* stat,
                                  int B, int N, int D, int H, float scale,
                                  cudaStream_t st) {
  const int threads = 256;
  const int e = D / H;
  const size_t smem = (size_t)N * (e + 2) * sizeof(bf16) +
                      (size_t)N * e * sizeof(bf16) +
                      (size_t)(threads / 32) * (N + e) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      attention_heads_kernel<LSE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  attention_heads_kernel<LSE><<<B * H, threads, smem, st>>>(qkv, out, stat, N,
                                                            D, H, scale);
  BASD_CHECK_LAUNCH();
  return 0;
}

// imp (B, N) = the ordered head sum of imp_heads (B, H, N).
static int launch_head_sum(const float* imp_heads, float* imp, int B, int H,
                           int N, cudaStream_t st) {
  head_sum_kernel<<<(B * N + 255) / 256, 256, 0, st>>>(imp_heads, imp, B, H,
                                                       N);
  BASD_CHECK_LAUNCH();
  return 0;
}

}  // namespace basd
