// The forward attention core of the port: per-(image, head) softmax
// attention over a packed (B, N, 3D) qkv slab, shared by K1 and K3a
// (csrc/block.cu, after their LN and qkv GEMM) and K10a and K10c
// (csrc/flash_attention.cu, on the caller's slab); plus the ordered dot
// product with which the backward kernels (K3b in csrc/block_train.cu, K10b
// in csrc/flash_attention.cu) recompute every score bit-identically.
//
// It replaces the attention of basd_tpu/ops/pallas/fused_block_attn.py
// (_fwd_kernel, _fwd_train_kernel) and flash_attention.py (_fwd_kernel,
// _fwd_kernel_hp): s = scale q k^T in f32, m = max s, p = exp(s - m),
// l = sum p in f32, o = (bf16(p) v accumulated in f32) / l stored in the
// slab's type (the normalisation deferred past P.V), and either
// lse = m + log l per query row (LSE: K3a, K10a) or the CLS query's row
// p[0, :] / (l H) per head (K1, K10c; head_sum_kernel adds the heads in
// order, so no atomics; a tensor-parallel rank's K1 divides by the
// block's head count, not by its own).
//
// What bounds it on the H100: 4 B N^2 D operations against the slab read
// once and o written once. At the student's slab (B=128, N=197, D=192)
// that is 3.8 GFLOP against ~39 MB, ~97 operations a byte, below the ~295
// at which the bf16 tensor cores and not HBM would bind: bytes bind, 0.0117
// ms at 3.35 TB/s (0.0232 ms at the DeiT-S teacher's D=384).
//
// Two kernels, chosen before launch by the slab's type and head width
// (launch_attention_heads; kernels/block_attn.py:attn_fwd_variant mirrors
// the rule for the wrappers' per-variant launch counts):
// - attention_tc_kernel, bf16 slabs with E % 16 == 0 and 16 <= E <= 128
//   (every preset of models/registry.py has E = 64): one CTA of four warps
//   per (image, head, 64-row query tile), each warp 16 query rows. K and V
//   of the (image, head) are staged into shared memory with cp.async
//   (16-byte chunks; rows padded to a multiple of 16 and zero-filled, so no
//   stale NaN meets a zero probability; rows E + 8 wide, an odd number of
//   16-byte chunks, so ldmatrix reads them without bank conflicts): ~60 KB
//   at N=197, ~78 KB at N=257. The warp's Q rows go from device memory
//   straight into mma A fragments. Products are
//   mma.sync.m16n8k16 bf16 -> f32 with ldmatrix (plain for K in Q K^T,
//   .trans for V in P.V): the kernel is bytes-bound, so mma.sync's rate is
//   ample and the warpgroup-wide wgmma would add descriptors and
//   asynchrony for nothing. The softmax takes two passes over 64-key
//   blocks: pass 1 the exact row max m (quad shuffles of the m16n8
//   accumulator rows), pass 2 recomputes S with the same instructions,
//   forms p = exp(s - m) against the final m, sums l from those p, packs
//   bf16(p) from the accumulator registers into A fragments and adds P.V.
//   So p is rounded to bf16 where the TPU kernel rounds it, and l is the
//   reference's sum of the same p (no online rescaling). Keys >= N score
//   -inf; query rows >= N are computed and not stored. The second Q K^T
//   adds 2 B N^2 D operations, free while bytes bind.
// - attention_simt_kernel<T>, bf16 with any other even E, and every f32
//   slab (K10 at f32): one block of eight warps per (image, head), one warp
//   per query row, scores and P.V as CUDA-core FMAs over shared memory,
//   rounding p to T (the identity at f32) before P.V.
#pragma once

#include "common.cuh"

namespace basd {

// dot of two rows of T in f32, products added in order with explicit
// fused multiply-adds: both phases of an attention backward call it, so
// every recomputed score is bit-identical between them.
template <typename T>
__device__ __forceinline__ float dot_rows(const T* a, const T* b, int e) {
  float acc = 0.f;
  for (int c = 0; c < e; c += 2) {
    const float2 av = load2(a + c);
    const float2 bv = load2(b + c);
    acc = __fmaf_rn(av.x, bv.x, acc);
    acc = __fmaf_rn(av.y, bv.y, acc);
  }
  return acc;
}

// One block per (image, head) on CUDA cores: scores in f32 from q, k in T;
// f32 softmax; probabilities rounded to T times v with f32 accumulation and
// deferred normalisation. With LSE false the CLS query's row, divided by
// l * H, goes to stat[b, h, :]; with LSE true every query row's m + log(l)
// goes to stat[b, h, query].
template <bool LSE, typename T>
__global__ void attention_simt_kernel(const T* __restrict__ qkv,
                                      T* __restrict__ out,
                                      float* __restrict__ stat, int N, int D,
                                      int H, int HT, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int e = D / H;
  const int ldk = e + 2;  // odd word stride at bf16: conflict-free key rows
  const int nwarps = blockDim.x / 32;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  T* ks = reinterpret_cast<T*>(smem_raw);
  T* vs = ks + N * ldk;
  float* ps = reinterpret_cast<float*>(vs + N * e);
  float* qs = ps + nwarps * N;

  const int b = blockIdx.x / H;
  const int h = blockIdx.x % H;
  const size_t ld = 3 * (size_t)D;
  const T* base = qkv + (size_t)b * N * ld;
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
    for (int c = lane; c < e; c += 32)
      q_row[c] = to_f(base[qi * ld + h * e + c]);
    __syncwarp();
    float m_loc = -INFINITY;
    for (int j = lane; j < N; j += 32) {
      const T* kr = ks + j * ldk;
      float acc = 0.f;
      for (int c = 0; c < e; c += 2) {
        const float2 kv = load2(kr + c);
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
      const float den = l * (float)HT;
      for (int j = lane; j < N; j += 32)
        stat[((size_t)b * H + h) * N + j] = p_row[j] / den;
    }
    for (int c2 = lane; c2 < e / 2; c2 += 32) {
      float a0 = 0.f, a1 = 0.f;
      for (int j = 0; j < N; ++j) {
        const float p = round_t<T>(p_row[j]);
        const float2 v = load2(vs + j * e + 2 * c2);
        a0 += p * v.x;
        a1 += p * v.y;
      }
      T* o = out + ((size_t)b * N + qi) * D + h * e + 2 * c2;
      o[0] = from_f<T>(a0 / l);
      o[1] = from_f<T>(a1 / l);
    }
    __syncwarp();
  }
}

// ---- tensor-core kernel (bf16) ----------------------------------------

constexpr int TC_ROWS = 64;     // query rows per CTA, 16 per warp
constexpr int TC_THREADS = 128;
constexpr int TC_KEYS = 64;     // keys per block of the two softmax passes

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(smem)),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int PENDING>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(PENDING) : "memory");
}

// Four 8x8 b16 matrices; lanes 8i..8i+7 give the row addresses of matrix i.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}

// d += a . b, a 16x16 (row), b 16x8 (col), bf16 in, f32 accumulate.
__device__ __forceinline__ void mma_16816(float (&d)[4], const uint32_t (&a)[4],
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// bf16(lo) in the low half, bf16(hi) in the high half: the lower column
// index of an mma operand register.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t load_u32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// s[j] = scale * Q K^T over keys kb + 8j .. kb + 8j + 7 (j < nt, nt even),
// masked to -inf at keys >= N. Accumulator layout (m16n8): s[j][0..1] at
// row g, keys kb + 8j + 2t + {0, 1}; s[j][2..3] at row g + 8, same keys
// (g = lane / 4, t = lane % 4).
template <int E>
__device__ __forceinline__ void tc_scores(float (&s)[TC_KEYS / 8][4],
                                          const uint32_t (&qa)[E / 16][4],
                                          const bf16* ks, int kb, int nt,
                                          int N, float scale, int lane) {
  constexpr int LDS = E + 8;
  const int mi = lane / 8;
  const int r = lane % 8;
  const int t = lane % 4;
#pragma unroll
  for (int j = 0; j < TC_KEYS / 8; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) s[j][i] = 0.f;
#pragma unroll
  for (int jp = 0; jp < TC_KEYS / 16; ++jp) {
    if (2 * jp < nt) {
      // matrices: keys 16jp + 0..7 at columns +0 / +8, keys +8..15 likewise
      const bf16* row =
          ks + (kb + 16 * jp + r + (mi / 2) * 8) * LDS + (mi % 2) * 8;
#pragma unroll
      for (int kt = 0; kt < E / 16; ++kt) {
        uint32_t bk[4];
        ldmatrix_x4(bk, row + kt * 16);
        mma_16816(s[2 * jp], qa[kt], bk[0], bk[1]);
        mma_16816(s[2 * jp + 1], qa[kt], bk[2], bk[3]);
      }
    }
  }
#pragma unroll
  for (int j = 0; j < TC_KEYS / 8; ++j) {
    const int key = kb + 8 * j + 2 * t;
    s[j][0] = key < N ? s[j][0] * scale : -INFINITY;
    s[j][1] = key + 1 < N ? s[j][1] * scale : -INFINITY;
    s[j][2] = key < N ? s[j][2] * scale : -INFINITY;
    s[j][3] = key + 1 < N ? s[j][3] * scale : -INFINITY;
  }
}

// One CTA per (image, head, 64-row query tile); see the file note.
template <bool LSE, int E>
__global__ void __launch_bounds__(TC_THREADS)
    attention_tc_kernel(const bf16* __restrict__ qkv, bf16* __restrict__ out,
                        float* __restrict__ stat, int N, int D, int H,
                        int HT, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int LDS = E + 8;    // an odd number of 16-byte chunks per row
  constexpr int KT = E / 16;    // k16 steps over the head width
  constexpr int ET = E / 8;     // n8 tiles of the output row
  constexpr int CH = E / 8;     // 16-byte chunks per staged row
  constexpr int NJ = TC_KEYS / 8;
  const int npad = (N + 15) & ~15;
  bf16* ks = reinterpret_cast<bf16*>(smem_raw);
  bf16* vs = ks + npad * LDS;

  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const size_t ld = 3 * (size_t)D;
  const bf16* base = qkv + (size_t)b * N * ld;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const int mi = lane / 8;
  const int r = lane % 8;

  // K (group 0), then V (group 1), rows N..npad-1 zero-filled
  for (int part = 1; part <= 2; ++part) {
    bf16* dst0 = part == 1 ? ks : vs;
    for (int i = threadIdx.x; i < npad * CH; i += TC_THREADS) {
      const int n = i / CH;
      const int c = (i % CH) * 8;
      bf16* dst = dst0 + n * LDS + c;
      if (n < N) {
        cp_async16(dst, base + n * ld + part * D + h * E + c);
      } else {
        *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
      }
    }
    cp_async_commit();
  }

  // this warp's 16 query rows as A fragments, rows >= N zero
  const int q0 = blockIdx.x * TC_ROWS + warp * 16;
  const bool active = q0 < N;
  const int r0 = q0 + g;
  const int r1 = r0 + 8;
  uint32_t qa[KT][4];
#pragma unroll
  for (int kt = 0; kt < KT; ++kt) {
    const int c = h * E + kt * 16 + 2 * t;
    qa[kt][0] = r0 < N ? load_u32(base + r0 * ld + c) : 0u;
    qa[kt][1] = r1 < N ? load_u32(base + r1 * ld + c) : 0u;
    qa[kt][2] = r0 < N ? load_u32(base + r0 * ld + c + 8) : 0u;
    qa[kt][3] = r1 < N ? load_u32(base + r1 * ld + c + 8) : 0u;
  }

  cp_async_wait<1>();  // K has landed
  __syncthreads();

  // pass 1: the exact row max
  float m0 = -INFINITY, m1 = -INFINITY;
  float s[NJ][4];
  if (active) {
    for (int kb = 0; kb < npad; kb += TC_KEYS) {
      const int nt = min(TC_KEYS, npad - kb) / 8;
      tc_scores<E>(s, qa, ks, kb, nt, N, scale, lane);
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        if (j < nt) {
          m0 = fmaxf(m0, fmaxf(s[j][0], s[j][1]));
          m1 = fmaxf(m1, fmaxf(s[j][2], s[j][3]));
        }
      }
    }
#pragma unroll
    for (int o = 1; o <= 2; o <<= 1) {
      m0 = fmaxf(m0, __shfl_xor_sync(0xffffffffu, m0, o));
      m1 = fmaxf(m1, __shfl_xor_sync(0xffffffffu, m1, o));
    }
  }

  cp_async_wait<0>();  // V has landed
  __syncthreads();
  if (!active) return;

  // pass 2: p against the final max, l, O += bf16(p) V
  const bool cls_row = !LSE && blockIdx.x == 0 && warp == 0 && g == 0;
  float* imp_row = stat + (size_t)bh * N;
  float l0 = 0.f, l1 = 0.f;
  float acc[ET][4];
#pragma unroll
  for (int et = 0; et < ET; ++et)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[et][i] = 0.f;
  for (int kb = 0; kb < npad; kb += TC_KEYS) {
    const int nt = min(TC_KEYS, npad - kb) / 8;
    tc_scores<E>(s, qa, ks, kb, nt, N, scale, lane);
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      if (j < nt) {
        s[j][0] = expf(s[j][0] - m0);
        s[j][1] = expf(s[j][1] - m0);
        s[j][2] = expf(s[j][2] - m1);
        s[j][3] = expf(s[j][3] - m1);
        l0 += s[j][0] + s[j][1];
        l1 += s[j][2] + s[j][3];
        if (cls_row) {  // CLS row p, divided by l H once l is known
          const int key = kb + 8 * j + 2 * t;
          if (key < N) imp_row[key] = s[j][0];
          if (key + 1 < N) imp_row[key + 1] = s[j][1];
        }
      }
    }
#pragma unroll
    for (int kp = 0; kp < NJ / 2; ++kp) {
      if (2 * kp < nt) {
        const uint32_t pa[4] = {pack_bf16(s[2 * kp][0], s[2 * kp][1]),
                                pack_bf16(s[2 * kp][2], s[2 * kp][3]),
                                pack_bf16(s[2 * kp + 1][0], s[2 * kp + 1][1]),
                                pack_bf16(s[2 * kp + 1][2], s[2 * kp + 1][3])};
        // matrices: keys +0..7 / +8..15 at columns 16ep, then 16ep + 8
        const bf16* vrow =
            vs + (kb + 16 * kp + r + (mi % 2) * 8) * LDS + (mi / 2) * 8;
#pragma unroll
        for (int ep = 0; ep < ET / 2; ++ep) {
          uint32_t bv[4];
          ldmatrix_x4_trans(bv, vrow + ep * 16);
          mma_16816(acc[2 * ep], pa, bv[0], bv[1]);
          mma_16816(acc[2 * ep + 1], pa, bv[2], bv[3]);
        }
      }
    }
  }
#pragma unroll
  for (int o = 1; o <= 2; o <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, o);
    l1 += __shfl_xor_sync(0xffffffffu, l1, o);
  }

  bf16* orow0 = out + ((size_t)b * N + r0) * D + h * E + 2 * t;
  bf16* orow1 = orow0 + 8 * (size_t)D;
#pragma unroll
  for (int et = 0; et < ET; ++et) {
    if (r0 < N)
      *reinterpret_cast<__nv_bfloat162*>(orow0 + 8 * et) =
          __floats2bfloat162_rn(acc[et][0] / l0, acc[et][1] / l0);
    if (r1 < N)
      *reinterpret_cast<__nv_bfloat162*>(orow1 + 8 * et) =
          __floats2bfloat162_rn(acc[et][2] / l1, acc[et][3] / l1);
  }
  if constexpr (LSE) {
    if (t == 0) {
      if (r0 < N) stat[(size_t)bh * N + r0] = m0 + logf(l0);
      if (r1 < N) stat[(size_t)bh * N + r1] = m1 + logf(l1);
    }
  } else if (cls_row) {  // this thread's own CLS entries, now over l H
    const float den = l0 * (float)HT;
    for (int key = 2 * t; key < N; key += 8) {
      imp_row[key] = imp_row[key] / den;
      if (key + 1 < N) imp_row[key + 1] = imp_row[key + 1] / den;
    }
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

// True when the tensor-core kernel takes a bf16 slab of head width e.
__host__ __device__ inline bool attention_tc_ok(int e) {
  return e % 16 == 0 && e >= 16 && e <= 128;
}

template <bool LSE, int E>
static int launch_attention_tc(const bf16* qkv, bf16* out, float* stat, int B,
                               int N, int D, int H, int HT, float scale,
                               cudaStream_t st) {
  const int npad = (N + 15) & ~15;
  const size_t smem = (size_t)2 * npad * (E + 8) * sizeof(bf16);
  cudaError_t err = cudaFuncSetAttribute(
      attention_tc_kernel<LSE, E>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((N + TC_ROWS - 1) / TC_ROWS, B * H);
  attention_tc_kernel<LSE, E><<<grid, TC_THREADS, smem, st>>>(
      qkv, out, stat, N, D, H, HT, scale);
  BASD_CHECK_LAUNCH();
  return 0;
}

template <bool LSE, typename T>
static int launch_attention_simt(const T* qkv, T* out, float* stat, int B,
                                 int N, int D, int H, int HT, float scale,
                                 cudaStream_t st) {
  const int threads = 256;
  const int e = D / H;
  const size_t smem = (size_t)N * (e + 2) * sizeof(T) +
                      (size_t)N * e * sizeof(T) +
                      (size_t)(threads / 32) * (N + e) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      attention_simt_kernel<LSE, T>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  attention_simt_kernel<LSE, T><<<B * H, threads, smem, st>>>(
      qkv, out, stat, N, D, H, HT, scale);
  BASD_CHECK_LAUNCH();
  return 0;
}

// launch_attention_tc<LSE, E> for the runtime head width e, one of
// 16, 32, ..., 128.
template <bool LSE, int E = 16>
static int launch_attention_tc_e(int e, const bf16* qkv, bf16* out,
                                 float* stat, int B, int N, int D, int H,
                                 int HT, float scale, cudaStream_t st) {
  if constexpr (E <= 128) {
    if (e == E)
      return launch_attention_tc<LSE, E>(qkv, out, stat, B, N, D, H, HT,
                                         scale, st);
    return launch_attention_tc_e<LSE, E + 16>(e, qkv, out, stat, B, N, D, H,
                                              HT, scale, st);
  } else {
    return (int)cudaErrorInvalidValue;
  }
}

// The attention of the (B, N, 3D) slab into out (B, N, D) and stat
// (B, H, N): the tensor-core kernel for a bf16 slab whose head width it
// takes (its rows must start 16-byte aligned), the CUDA-core kernel
// otherwise. Decided here, before any launch. D is the slab's H heads of
// E = D / H each: a tensor-parallel rank passes its own heads (H) and
// their width (H E), and the block's head count HT, the divisor of the CLS
// row (0: H, the whole block).
template <bool LSE, typename T>
static int launch_attention_heads(const T* qkv, T* out, float* stat, int B,
                                  int N, int D, int H, float scale,
                                  cudaStream_t st, int HT = 0) {
  const int e = D / H;
  if (HT <= 0) HT = H;
  if constexpr (std::is_same_v<T, bf16>) {
    if (attention_tc_ok(e)) {
      if (!vec_ok(qkv, 3 * D)) return (int)cudaErrorMisalignedAddress;
      if (B * H > 65535) return (int)cudaErrorInvalidConfiguration;
      return launch_attention_tc_e<LSE>(e, qkv, out, stat, B, N, D, H, HT,
                                        scale, st);
    }
  }
  return launch_attention_simt<LSE>(qkv, out, stat, B, N, D, H, HT, scale,
                                    st);
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
