// K7: hybrid Newton-Schulz polar factor on Hopper.
//
// Replaces basd_tpu/ops/pallas/ns_polar.py:ns_polar_hybrid (_ns_kernel):
// for each (r, c) matrix (r <= c), an f32 Frobenius prescale, then the 5
// quintic steps of _QUINTIC_SCHEDULE
//     G = X X^T,  H = b G + c G G^T,  X <- a X + H X
// and 2 cubic steps  X <- 1.5 X - 0.5 (X X^T) X, with bf16 operands, f32
// accumulation and every intermediate rounded to bf16, as the TPU kernel
// does: G, G G^T, H and each new X are rounded to bf16; the a X, b G,
// 1.5 X and 0.5 (.) terms are combined in f32 (no fused multiply-add)
// before the rounding. Only the order of accumulation inside a product
// differs from the reference.
//
// What bounds it on the H100: at the Procrustes batch (P*B = 512 matrices
// of 192 x 384 at B=128) the iteration is ~240 GFLOP (counted from the
// shapes), ~0.24 ms at the bf16 tensor-core peak, against 151 MB of input
// and 75 MB of output (0.07 ms at 3.35 TB/s): operations, as the TPU
// kernel's point is that device memory sees one read of x and one write
// of the polar factor.
//
// Three variants, chosen before launch from the shapes by the caller
// (kernels/ns_polar.py:ns_polar_variant):
// - on-chip (ns_polar_onchip_kernel): the whole iteration in one CTA's
//   shared memory. The rows are padded with zeros to RP = 64, 128 or 192
//   (zero rows stay zero through every step and touch no real entry);
//   X (RP x c bf16) and G/H (RP x RP bf16) are stored as the 128-byte-
//   swizzled blocks of 64 columns that wgmma.cuh describes: 221,184 bytes
//   at (192, 384), of the 232,448 a block may use. RP / 64 consumer
//   warpgroups each own one 64-row panel and issue wgmma with both
//   operands in shared memory: G = X X^T (m64nRPk16, X K-major as A and
//   as B), G G^T (the same on G), and Y = M X for M = H or G in column
//   chunks of 128 (m64n128k16, X MN-major as B: the same blocks read
//   across their rows, the leading byte offset one block). Accumulators
//   stay in registers across a CTA barrier, after which H overwrites G in
//   place and each chunk of Y overwrites its chunk of X (the other
//   warpgroups have finished reading it). The prescale reads x twice from
//   device memory (the norm, then scale and round into the swizzled X);
//   the CTA writes the final X once. One CTA an SM (its shared memory),
//   512 CTAs over ~3.9 waves of the 132 SMs.
// - stream (ns_polar_stream_kernel), for RP <= 192 where X and G do not
//   fit one CTA (the CNN-to-ViT paths' (192, 768) and (192, 2048)): one
//   CTA a matrix keeps G/H (RP x RP bf16) in shared memory and streams X
//   through a ring of 6 chunks of 64 columns (~222 KB at RP = 192). A
//   step is one pass over the chunks: each chunk of X_k arrives by a bulk
//   copy, becomes its chunk of X_{k+1} = a X + H X (m64n64k16, X MN-major)
//   in place, leaves by a bulk copy and adds its Y Y^T to the next G's
//   accumulators, which stay in registers across the pass (m64nRPk16):
//   device memory sees X read once and written once a step, in a
//   workspace that keeps each chunk in the swizzled layout, so that the
//   copies move plain bytes. The f32 Frobenius prescale reads x twice (the
//   norm, then the first pass scales and rounds it chunk by chunk); the
//   last pass writes the factor. The function is bound by its operations
//   at (512, 192, 768) and (512, 192, 2048) (0.447 and 1.131 ms of bf16
//   products at the peak); this design adds device-memory traffic of 2.87
//   and 7.65 GB (x twice in f32, X in and out once a step), 0.86 and 2.28
//   ms at 3.35 TB/s, the floor of its time at c = 2048.
//   A cluster design (S = c / 256 CTAs a matrix, X by columns in shared
//   memory, the partial Grams reduce-scattered and all-gathered over
//   distributed shared memory) was measured first and lost: its exchange
//   took longer than the Gram product it serves (PERF.md).
// - workspace (ns_polar_hybrid_kernel), for the other shapes (r > 192,
//   e.g. (384, 768), a DeiT-S student under a DeiT-B teacher): one
//   128-thread CTA a
//   matrix walks the iteration on common.cuh's WMMA tile, keeping X
//   (ping-pong), G and H in a per-matrix device-memory workspace (~0.44
//   MB a matrix at (192, 384), read back through L2).

#include "common.cuh"
#include "wgmma.cuh"

namespace basd {

__constant__ float QUINTIC[5][3] = {
    {4.0848f, -6.8946f, 2.9270f},
    {3.9505f, -6.3029f, 2.6377f},
    {3.7418f, -5.5913f, 2.3037f},
    {2.8769f, -3.1427f, 1.2046f},
    {2.8366f, -3.0525f, 1.2012f},
};
constexpr int NUM_CUBIC = 2;

enum NsPhase { NS_GRAM = 0, NS_H = 1, NS_QUINTIC_Y = 2, NS_CUBIC_Y = 3 };

// One phase: every 64 x 64 tile of the M x N product, then its epilogue.
// Reads and writes of the workspace by this block are ordered by the
// __syncthreads inside tile_mma and at the end of the phase.
template <bool B_NK, int PHASE>
__device__ void ns_phase(TileSmem& sm, const bf16* A, int lda, const bf16* B,
                         int ldb, int M, int N, int K, bf16* dst,
                         const bf16* aux, float ca, float cb, float cc) {
  const int tiles_n = (N + BN - 1) / BN;
  const int tiles = ((M + BM - 1) / BM) * tiles_n;
  for (int t = 0; t < tiles; ++t) {
    const int m0 = (t / tiles_n) * BM;
    const int n0 = (t % tiles_n) * BN;
    tile_mma<B_NK>(sm, A, lda, true, B, ldb, true, M, N, K, m0, n0);
    for (int i = threadIdx.x; i < BM * BN; i += blockDim.x) {
      const int r = i / BN;
      const int c = i % BN;
      const int gr = m0 + r;
      const int gc = n0 + c;
      if (gr >= M || gc >= N) continue;
      const float acc = sm.c[r * C_LD + c];
      const size_t o = (size_t)gr * N + gc;
      float v;
      if constexpr (PHASE == NS_GRAM) {
        v = acc;  // G (or X X^T), rounded below
      } else if constexpr (PHASE == NS_H) {
        v = cb * bf2f(aux[o]) + cc * round_bf(acc);  // aux = G
      } else if constexpr (PHASE == NS_QUINTIC_Y) {
        v = ca * bf2f(aux[o]) + acc;  // aux = X
      } else {
        v = 1.5f * bf2f(aux[o]) - 0.5f * acc;  // aux = X
      }
      dst[o] = f2bf(v);
    }
    __syncthreads();
  }
}

__global__ void __launch_bounds__(TILE_THREADS)
    ns_polar_hybrid_kernel(const float* x, bf16* out, bf16* ws, int r,
                           int c) {
  __shared__ __align__(128) TileSmem sm;
  __shared__ float red[TILE_THREADS / 32];
  const size_t rc = (size_t)r * c;
  const size_t rr = (size_t)r * r;
  const float* xm = x + blockIdx.x * rc;
  bf16* xa = ws + blockIdx.x * (2 * rc + 2 * rr);
  bf16* xb = xa + rc;
  bf16* g = xb + rc;
  bf16* hm = g + rr;

  // f32 Frobenius prescale
  float s = 0.f;
  for (size_t i = threadIdx.x; i < rc; i += blockDim.x) s += xm[i] * xm[i];
  s = warp_sum(s);
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = s;
  __syncthreads();
  float norm2 = 0.f;
  for (int w = 0; w < TILE_THREADS / 32; ++w) norm2 += red[w];
  const float inv = rsqrtf(norm2 + 1e-30f);
  for (size_t i = threadIdx.x; i < rc; i += blockDim.x) xa[i] = f2bf(xm[i] * inv);
  __syncthreads();

  for (int step = 0; step < 5; ++step) {
    const float a = QUINTIC[step][0];
    const float b = QUINTIC[step][1];
    const float cq = QUINTIC[step][2];
    ns_phase<true, NS_GRAM>(sm, xa, c, xa, c, r, r, c, g, nullptr, 0.f, 0.f, 0.f);
    ns_phase<true, NS_H>(sm, g, r, g, r, r, r, r, hm, g, 0.f, b, cq);
    ns_phase<false, NS_QUINTIC_Y>(sm, hm, r, xa, c, r, c, r, xb, xa, a, 0.f, 0.f);
    bf16* tmp = xa;
    xa = xb;
    xb = tmp;
  }
  for (int step = 0; step < NUM_CUBIC; ++step) {
    ns_phase<true, NS_GRAM>(sm, xa, c, xa, c, r, r, c, g, nullptr, 0.f, 0.f, 0.f);
    ns_phase<false, NS_CUBIC_Y>(sm, g, r, xa, c, r, c, r, xb, xa, 0.f, 0.f, 0.f);
    bf16* tmp = xa;
    xa = xb;
    xb = tmp;
  }
  bf16* om = out + blockIdx.x * rc;
  for (size_t i = threadIdx.x; i < rc; i += blockDim.x) om[i] = xa[i];
}

// ---- the on-chip variant ----

constexpr int ONCHIP_MAX_RP = 192;
constexpr int NS_CHUNK = 128;  // columns of Y a product: m64n128k16

// Dynamic shared memory of the on-chip variant: 1024 bytes of alignment
// slack, X, G/H and one float a warp for the norm's reduction.
// kernels/ns_polar.py:onchip_smem_bytes mirrors it.
inline long long onchip_smem_bytes(int rp, int c) {
  return 1024LL + 2LL * rp * c + 2LL * rp * rp + 4LL * (2 * rp / 32);
}

// acc[0:N/2] = A[64 x K] . B[K x N] for warpgroup `wg`'s 64-row panel of
// a matrix A stored as swizzled blocks of RP rows (K-major), with B read
// through `b_desc(k16 step)`.
// Keeps the compiler from moving reads or writes of the accumulators
// across the asynchronous products (no instruction is emitted).
template <int N>
__device__ __forceinline__ void acc_fence(float* acc) {
#pragma unroll
  for (int i = 0; i < N / 2; ++i) asm volatile("" : "+f"(acc[i])::"memory");
}

template <int N, int TB, typename BDesc>
__device__ __forceinline__ void panel_product(float* acc, const uint8_t* a,
                                              int a_block, int k_steps, int wg,
                                              BDesc b_desc) {
#pragma unroll
  for (int i = 0; i < N / 2; ++i) acc[i] = 0.f;
  acc_fence<N>(acc);
  sm90::wgmma_fence();
  for (int ks = 0; ks < k_steps; ++ks) {
    const uint8_t* ap = a + (ks >> 2) * a_block + wg * 64 * 128 + (ks & 3) * 32;
    sm90::wgmma_bf16<N, 0, TB>(acc, sm90::smem_desc(ap), b_desc(ks));
  }
  sm90::wgmma_commit();
  sm90::wgmma_wait<0>();
  acc_fence<N>(acc);
}

// Row (within the 64-row panel) and column (within the N-wide product) of
// accumulator pair i / 2 (i even) of thread t of a warpgroup.
__device__ __forceinline__ int acc_row(int t, int i) {
  return 16 * (t / 32) + (t % 32) / 4 + 8 * ((i / 2) % 2);
}
__device__ __forceinline__ int acc_col(int t, int i) {
  return 8 * (i / 4) + 2 * (t % 4);
}

__device__ __forceinline__ __nv_bfloat162* bf2_at(uint8_t* base, int row,
                                                  int col, int block) {
  return reinterpret_cast<__nv_bfloat162*>(
      base + sm90::swizzle_offset(row, col, block));
}

// M M^T of a matrix M (RP x K bf16, swizzled blocks `block` bytes apart):
// this warpgroup's 64 x RP panel.
template <int RP>
__device__ __forceinline__ void gram_panel(float* acc, const uint8_t* m,
                                           int block, int k, int wg) {
  panel_product<RP, 0>(acc, m, block, k / 16, wg, [&](int ks) {
    return sm90::smem_desc(m + (ks >> 2) * block + (ks & 3) * 32);
  });
}

// Rounds this warpgroup's panel of an RP-wide product to bf16 into dst
// (RP x RP, swizzled), as G.
template <int RP>
__device__ __forceinline__ void store_panel(const float* acc, uint8_t* dst,
                                            int wg, int t) {
#pragma unroll
  for (int i = 0; i < RP / 2; i += 2) {
    *bf2_at(dst, wg * 64 + acc_row(t, i), acc_col(t, i), RP * 128) =
        __floats2bfloat162_rn(acc[i], acc[i + 1]);
  }
}

// Y = coef_x X + coef_m (M X) for every column chunk of X, M = H (quintic:
// coef_x = a, coef_m = 1) or G (cubic: 1.5, -0.5), each chunk of Y written
// over its chunk of X once every warpgroup has read it.
template <int RP>
__device__ __forceinline__ void update_x(uint8_t* x, const uint8_t* m, int c,
                                        int wg, int t, float coef_x,
                                        float coef_m, bool quintic) {
  float acc[NS_CHUNK / 2];
  const int x_block = RP * 128;
  for (int j = 0; j < c / NS_CHUNK; ++j) {
    const uint8_t* xb = x + (2 * j) * x_block;
    panel_product<NS_CHUNK, 1>(acc, m, RP * 128, RP / 16, wg, [&](int ks) {
      return sm90::smem_desc_mn(xb + ks * 16 * 128, x_block);
    });
    __syncthreads();  // every warpgroup has read X[:, chunk j]
#pragma unroll
    for (int i = 0; i < NS_CHUNK / 2; i += 2) {
      __nv_bfloat162* p = bf2_at(x, wg * 64 + acc_row(t, i),
                                 NS_CHUNK * j + acc_col(t, i), x_block);
      const float2 xv = __bfloat1622float2(*p);
      float y0, y1;
      if (quintic) {  // a X + H X
        y0 = __fadd_rn(__fmul_rn(coef_x, xv.x), acc[i]);
        y1 = __fadd_rn(__fmul_rn(coef_x, xv.y), acc[i + 1]);
      } else {  // 1.5 X - 0.5 (G X)
        y0 = __fadd_rn(__fmul_rn(coef_x, xv.x), __fmul_rn(coef_m, acc[i]));
        y1 = __fadd_rn(__fmul_rn(coef_x, xv.y), __fmul_rn(coef_m, acc[i + 1]));
      }
      *p = __floats2bfloat162_rn(y0, y1);
    }
  }
  sm90::fence_proxy_async();
  __syncthreads();  // the new X is whole before the next product reads it
}

template <int RP>
__global__ void __launch_bounds__(2 * RP, 1)
    ns_polar_onchip_kernel(const float* __restrict__ x, bf16* __restrict__ out,
                           int r, int c) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint8_t* xs = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* gs = xs + (size_t)2 * RP * c;
  float* red = reinterpret_cast<float*>(gs + 2 * RP * RP);
  constexpr int THREADS = 2 * RP;
  const int tid = threadIdx.x;
  const int wg = tid / 128;
  const int t = tid % 128;
  const int x_block = RP * 128;
  const size_t rc = (size_t)r * c;
  const float* xm = x + blockIdx.x * rc;

  // f32 Frobenius prescale: the norm, then scale and round into X
  float s = 0.f;
  for (size_t i = 4 * (size_t)tid; i < rc; i += 4 * THREADS) {
    const float4 v = *reinterpret_cast<const float4*>(xm + i);
    s += v.x * v.x + v.y * v.y + v.z * v.z + v.w * v.w;
  }
  s = warp_sum(s);
  if (tid % 32 == 0) red[tid / 32] = s;
  __syncthreads();
  float norm2 = 0.f;
  for (int w = 0; w < THREADS / 32; ++w) norm2 += red[w];
  const float inv = rsqrtf(norm2 + 1e-30f);
  const int chunks = c / 8;
  for (int i = tid; i < RP * chunks; i += THREADS) {
    const int row = i / chunks;
    const int col = (i % chunks) * 8;
    uint4 packed = make_uint4(0u, 0u, 0u, 0u);
    if (row < r) {
      const float4 lo = *reinterpret_cast<const float4*>(xm + (size_t)row * c + col);
      const float4 hi = *reinterpret_cast<const float4*>(xm + (size_t)row * c + col + 4);
      __nv_bfloat162 h[4] = {
          __floats2bfloat162_rn(__fmul_rn(lo.x, inv), __fmul_rn(lo.y, inv)),
          __floats2bfloat162_rn(__fmul_rn(lo.z, inv), __fmul_rn(lo.w, inv)),
          __floats2bfloat162_rn(__fmul_rn(hi.x, inv), __fmul_rn(hi.y, inv)),
          __floats2bfloat162_rn(__fmul_rn(hi.z, inv), __fmul_rn(hi.w, inv))};
      packed = *reinterpret_cast<uint4*>(h);
    }
    *reinterpret_cast<uint4*>(xs + sm90::swizzle_offset(row, col, x_block)) = packed;
  }
  sm90::fence_proxy_async();
  __syncthreads();

  float acc[RP / 2];
  for (int step = 0; step < 5 + NUM_CUBIC; ++step) {
    // G = X X^T, rounded to bf16 (the previous step's reads of G/H ended
    // at update_x's barriers)
    gram_panel<RP>(acc, xs, x_block, c, wg);
    store_panel<RP>(acc, gs, wg, t);
    sm90::fence_proxy_async();
    __syncthreads();
    if (step < 5) {
      const float a = QUINTIC[step][0];
      const float b = QUINTIC[step][1];
      const float cq = QUINTIC[step][2];
      // G G^T; H = b G + c bf16(G G^T) over G once every panel is done
      gram_panel<RP>(acc, gs, RP * 128, RP, wg);
      __syncthreads();
#pragma unroll
      for (int i = 0; i < RP / 2; i += 2) {
        __nv_bfloat162* p = bf2_at(gs, wg * 64 + acc_row(t, i), acc_col(t, i),
                                   RP * 128);
        const float2 g = __bfloat1622float2(*p);
        const float2 g2 = __bfloat1622float2(__floats2bfloat162_rn(acc[i], acc[i + 1]));
        *p = __floats2bfloat162_rn(
            __fadd_rn(__fmul_rn(b, g.x), __fmul_rn(cq, g2.x)),
            __fadd_rn(__fmul_rn(b, g.y), __fmul_rn(cq, g2.y)));
      }
      sm90::fence_proxy_async();
      __syncthreads();
      update_x<RP>(xs, gs, c, wg, t, a, 1.f, true);
    } else {
      update_x<RP>(xs, gs, c, wg, t, 1.5f, -0.5f, false);
    }
  }

  bf16* om = out + blockIdx.x * rc;
  for (int i = tid; i < r * chunks; i += THREADS) {
    const int row = i / chunks;
    const int col = (i % chunks) * 8;
    *reinterpret_cast<uint4*>(om + (size_t)row * c + col) =
        *reinterpret_cast<const uint4*>(xs + sm90::swizzle_offset(row, col, x_block));
  }
}

template <int RP>
int launch_onchip(const float* x, bf16* out, int batch, int r, int c,
                  cudaStream_t st) {
  const long long smem = onchip_smem_bytes(RP, c);
  const cudaError_t err = cudaFuncSetAttribute(
      ns_polar_onchip_kernel<RP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  ns_polar_onchip_kernel<RP><<<batch, 2 * RP, smem, st>>>(x, out, r, c);
  BASD_CHECK_LAUNCH();
  return 0;
}

// ---- the streaming variant ----

constexpr int STREAM_COLS = 64;    // columns of X a chunk: one swizzled block
constexpr int STREAM_STAGES = 6;   // chunks in shared memory
constexpr int STREAM_LAG = 2;      // iterations from a chunk's store to its slot's refill

// Dynamic shared memory of the streaming variant: alignment slack, G/H,
// the ring of chunks, one mbarrier a slot and one float a warp.
// kernels/ns_polar.py:stream_smem_bytes mirrors it.
inline long long stream_smem_bytes(int rp) {
  return 1024LL + 2LL * rp * rp + (long long)STREAM_STAGES * rp * 128 +
         8LL * STREAM_STAGES + 4LL * (2 * rp / 32);
}

__device__ __forceinline__ void bulk_load(uint8_t* dst, const void* src,
                                          int bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(sm90::smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(sm90::smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ void bulk_store(void* dst, const uint8_t* src,
                                           int bytes) {
  asm volatile(
      "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n"
      "cp.async.bulk.commit_group;\n" ::"l"(dst),
      "r"(sm90::smem_u32(src)), "r"(bytes)
      : "memory");
}

// Wait until at most N of this thread's bulk stores are pending, the
// others complete (their writes to device memory done).
template <int N>
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group %0;\n" ::"n"(N) : "memory");
}

// acc += this warpgroup's 64 rows of a chunk (RP x 64 bf16, one swizzled
// block) times the chunk transposed: the chunk's share of the next Gram.
template <int RP>
__device__ __forceinline__ void gram_accumulate(float* acc, const uint8_t* chunk,
                                                int wg) {
  acc_fence<RP>(acc);
  sm90::wgmma_fence();
#pragma unroll
  for (int ks = 0; ks < STREAM_COLS / 16; ++ks) {
    sm90::wgmma_bf16<RP, 0, 0>(acc,
                               sm90::smem_desc(chunk + wg * 64 * 128 + ks * 32),
                               sm90::smem_desc(chunk + ks * 32));
  }
  sm90::wgmma_commit();
  sm90::wgmma_wait<0>();
  acc_fence<RP>(acc);
}

// The parts of the streaming kernel: the full kernel runs all three; the
// others exist to time them apart (basd_ns_polar_stream_part). IO: the norm,
// x read into X_0 and the factor written; PRODUCTS: every wgmma product and
// its epilogue; TRAFFIC: the chunks' stores to and loads from device memory
// and the waits for them. Without IO, X_0 is zero; without TRAFFIC, each
// slot keeps what it held.
enum StreamPart { STREAM_IO = 1, STREAM_PRODUCTS = 2, STREAM_TRAFFIC = 4, STREAM_ALL = 7 };

// One CTA a matrix, G/H in shared memory, X streamed from device memory in
// 64-column chunks through a ring of STREAM_STAGES slots. Iteration i =
// pass * nch + j of 8 passes over the nch chunks: pass 0 scales and rounds
// x into X_0, passes 1-7 are the 7 steps, pass p reading X_{p-1} and
// writing X_p. A chunk of X_p is stored (bulk copy, the slot's bytes as
// they are: ws keeps X chunk by chunk in the swizzled layout) and adds its
// Y Y^T to the next Gram's accumulators, which stay in registers across
// the pass; the last pass writes the factor instead. Thread 0 refills the
// slot of iteration i - STREAM_LAG with the chunk of iteration
// i + STREAM_STAGES - STREAM_LAG once its own stores up to iteration
// i - STREAM_LAG are complete: that slot's store has read it, and (nch >=
// STREAM_STAGES) the chunk to load was stored at least that long ago.
template <int RP, int PARTS>
__global__ void __launch_bounds__(2 * RP, 1)
    ns_polar_stream_kernel(const float* __restrict__ x, bf16* __restrict__ out,
                           bf16* __restrict__ ws, int r, int c) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int SLOT = RP * 128;  // bytes of a chunk
  constexpr int THREADS = 2 * RP;
  constexpr int NS = STREAM_STAGES;
  uint8_t* gs = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* ring = gs + 2 * RP * RP;
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + NS * SLOT);
  float* red = reinterpret_cast<float*>(full + NS);
  const int tid = threadIdx.x;
  const int wg = tid / 128;
  const int t = tid % 128;
  const int nch = c / STREAM_COLS;
  const int iters = (6 + NUM_CUBIC) * nch;
  const size_t rc = (size_t)r * c;
  const float* xm = x + blockIdx.x * rc;
  bf16* om = out + blockIdx.x * rc;
  uint8_t* xbuf = reinterpret_cast<uint8_t*>(ws + (size_t)blockIdx.x * 2 * RP * c);
  const size_t buf_bytes = (size_t)2 * RP * c;

  if (tid == 0) {
    for (int s = 0; s < NS; ++s) sm90::mbar_init(full + s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // f32 Frobenius norm
  constexpr bool IO = (PARTS & STREAM_IO) != 0;
  constexpr bool PRODUCTS = (PARTS & STREAM_PRODUCTS) != 0;
  constexpr bool TRAFFIC = (PARTS & STREAM_TRAFFIC) != 0;
  float sq = 0.f;
  for (size_t i = 4 * (size_t)tid; IO && i < rc; i += 4 * THREADS) {
    const float4 v = *reinterpret_cast<const float4*>(xm + i);
    sq += v.x * v.x + v.y * v.y + v.z * v.z + v.w * v.w;
  }
  sq = warp_sum(sq);
  if (tid % 32 == 0) red[tid / 32] = sq;
  __syncthreads();
  float norm2 = 0.f;
  for (int w = 0; w < THREADS / 32; ++w) norm2 += red[w];
  const float inv = rsqrtf(norm2 + 1e-30f);

  float accg[RP / 2];
  float accy[STREAM_COLS / 2];
#pragma unroll
  for (int i = 0; i < RP / 2; ++i) accg[i] = 0.f;
  float coef_x = 0.f, coef_m = 0.f;
  for (int pass = 0; pass < 6 + NUM_CUBIC; ++pass) {
    if (PRODUCTS && pass > 0) {
      // G of X_{pass-1}, rounded to bf16 (every read of G/H as M ended at
      // the last chunk's first barrier); for a quintic step, H over it
      store_panel<RP>(accg, gs, wg, t);
      sm90::fence_proxy_async();
      __syncthreads();
      const int step = pass - 1;
      if (step < 5) {
        const float b = QUINTIC[step][1];
        const float cq = QUINTIC[step][2];
        gram_panel<RP>(accg, gs, RP * 128, RP, wg);
        __syncthreads();
#pragma unroll
        for (int i = 0; i < RP / 2; i += 2) {
          __nv_bfloat162* p = bf2_at(gs, wg * 64 + acc_row(t, i), acc_col(t, i),
                                     RP * 128);
          const float2 g = __bfloat1622float2(*p);
          const float2 g2 = __bfloat1622float2(__floats2bfloat162_rn(accg[i], accg[i + 1]));
          *p = __floats2bfloat162_rn(
              __fadd_rn(__fmul_rn(b, g.x), __fmul_rn(cq, g2.x)),
              __fadd_rn(__fmul_rn(b, g.y), __fmul_rn(cq, g2.y)));
        }
        sm90::fence_proxy_async();
        __syncthreads();
        coef_x = QUINTIC[step][0];
        coef_m = 1.f;
      } else {
        coef_x = 1.5f;
        coef_m = -0.5f;
      }
#pragma unroll
      for (int i = 0; i < RP / 2; ++i) accg[i] = 0.f;
    }
    const bool last = pass == 5 + NUM_CUBIC;
    for (int j = 0; j < nch; ++j) {
      const int it = pass * nch + j;
      const int s = it % NS;
      uint8_t* slot = ring + s * SLOT;
      if (pass == 0) {
        // X_0's chunk j: x scaled and rounded, rows from r on zero
        for (int i = tid; i < RP * 8; i += THREADS) {
          const int row = i / 8;
          const int col = (i % 8) * 8;
          uint4 packed = make_uint4(0u, 0u, 0u, 0u);
          if (IO && row < r) {
            const float* src = xm + (size_t)row * c + j * STREAM_COLS + col;
            const float4 lo = *reinterpret_cast<const float4*>(src);
            const float4 hi = *reinterpret_cast<const float4*>(src + 4);
            __nv_bfloat162 h[4] = {
                __floats2bfloat162_rn(__fmul_rn(lo.x, inv), __fmul_rn(lo.y, inv)),
                __floats2bfloat162_rn(__fmul_rn(lo.z, inv), __fmul_rn(lo.w, inv)),
                __floats2bfloat162_rn(__fmul_rn(hi.x, inv), __fmul_rn(hi.y, inv)),
                __floats2bfloat162_rn(__fmul_rn(hi.z, inv), __fmul_rn(hi.w, inv))};
            packed = *reinterpret_cast<uint4*>(h);
          }
          *reinterpret_cast<uint4*>(slot + sm90::swizzle_offset(row, col, SLOT)) = packed;
        }
      } else {
        if constexpr (TRAFFIC) {
          // the fills of slot s so far: one every NS iterations from the
          // first load iteration on it
          const int first = nch + ((s - nch) % NS + NS) % NS;
          sm90::mbar_wait(full + s, ((it - first) / NS) & 1);
        }
        if constexpr (PRODUCTS) {
          // M X for this chunk (M = H or G, X MN-major as B)
          panel_product<STREAM_COLS, 1>(accy, gs, RP * 128, RP / 16, wg, [&](int ks) {
            return sm90::smem_desc_mn(slot + ks * 16 * 128, SLOT);
          });
          __syncthreads();  // every warpgroup has read the chunk
#pragma unroll
          for (int i = 0; i < STREAM_COLS / 2; i += 2) {
            __nv_bfloat162* p = bf2_at(slot, wg * 64 + acc_row(t, i), acc_col(t, i), SLOT);
            const float2 xv = __bfloat1622float2(*p);
            const float y0 = __fadd_rn(__fmul_rn(coef_x, xv.x), __fmul_rn(coef_m, accy[i]));
            const float y1 = __fadd_rn(__fmul_rn(coef_x, xv.y), __fmul_rn(coef_m, accy[i + 1]));
            *p = __floats2bfloat162_rn(y0, y1);
          }
        }
      }
      sm90::fence_proxy_async();
      __syncthreads();  // the chunk of X_pass is whole
      if (!last) {
        if (TRAFFIC && tid == 0)
          bulk_store(xbuf + (pass % 2) * buf_bytes + (size_t)j * SLOT, slot, SLOT);
        if constexpr (PRODUCTS) gram_accumulate<RP>(accg, slot, wg);
      } else if constexpr (IO) {
        for (int i = tid; i < r * 8; i += THREADS) {
          const int row = i / 8;
          const int col = (i % 8) * 8;
          *reinterpret_cast<uint4*>(om + (size_t)row * c + j * STREAM_COLS + col) =
              *reinterpret_cast<const uint4*>(slot + sm90::swizzle_offset(row, col, SLOT));
        }
      }
      if (TRAFFIC && tid == 0) {
        // (the last pass stores nothing: the stores still pending are the
        // previous pass's last, one of them the slot's)
        if (last) {
          bulk_wait<0>();
        } else {
          bulk_wait<STREAM_LAG>();
        }
        const int next = it + NS - STREAM_LAG;
        if (next >= nch && next < iters) {
          const int np = next / nch;
          uint64_t* bar = full + next % NS;
          sm90::mbar_expect_tx(bar, SLOT);
          bulk_load(ring + (next % NS) * SLOT,
                    xbuf + ((np - 1) % 2) * buf_bytes + (size_t)(next % nch) * SLOT,
                    SLOT, bar);
        }
      }
    }
  }
  if (TRAFFIC && tid == 0) bulk_wait<0>();
}

// The shapes the streaming variant takes (kernels/ns_polar.py:
// ns_polar_variant picks it only where the on-chip variant does not fit).
inline bool stream_shape_ok(int r, int c) {
  return r > 0 && r <= c && r <= ONCHIP_MAX_RP && r % 8 == 0 &&
         c % STREAM_COLS == 0 && c >= STREAM_COLS * STREAM_STAGES;
}

template <int RP, int PARTS>
int launch_stream(const float* x, bf16* out, bf16* ws, int batch, int r, int c,
                  cudaStream_t st) {
  const long long smem = stream_smem_bytes(RP);
  const cudaError_t err = cudaFuncSetAttribute(
      ns_polar_stream_kernel<RP, PARTS>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  ns_polar_stream_kernel<RP, PARTS><<<batch, 2 * RP, smem, st>>>(x, out, ws, r, c);
  BASD_CHECK_LAUNCH();
  return 0;
}

}  // namespace basd

// The workspace variant. x: (batch, r, c) f32 with r <= c, r % 8 == 0,
// c % 8 == 0; out: (batch, r, c) bf16; ws: batch * (2 r c + 2 r r) bf16.
extern "C" int basd_ns_polar_hybrid(const float* x, void* out, void* ws,
                                    int batch, int r, int c, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  basd::ns_polar_hybrid_kernel<<<batch, basd::TILE_THREADS, 0, st>>>(
      x, static_cast<basd::bf16*>(out), static_cast<basd::bf16*>(ws), r, c);
  BASD_CHECK_LAUNCH();
  return 0;
}

// The on-chip variant. x: (batch, r, c) f32 with r <= 192, r <= c,
// r % 8 == 0, c % 128 == 0, 16-byte aligned; out: (batch, r, c) bf16.
extern "C" int basd_ns_polar_onchip(const float* x, void* out, int batch,
                                    int r, int c, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  basd::bf16* o = static_cast<basd::bf16*>(out);
  const int rp = (r + 63) / 64 * 64;
  if (r <= 0 || r > c || r % 8 != 0 || c % basd::NS_CHUNK != 0 ||
      rp > basd::ONCHIP_MAX_RP ||
      basd::onchip_smem_bytes(rp, c) > 232448)
    return (int)cudaErrorInvalidValue;
  if (batch == 0) return 0;
  if (rp == 64) return basd::launch_onchip<64>(x, o, batch, r, c, st);
  if (rp == 128) return basd::launch_onchip<128>(x, o, batch, r, c, st);
  return basd::launch_onchip<192>(x, o, batch, r, c, st);
}

// The streaming variant. x: (batch, r, c) f32 with r <= 192, r <= c,
// r % 8 == 0, c % 64 == 0, c >= 64 STREAM_STAGES, 16-byte aligned; out:
// (batch, r, c) bf16; ws: batch * 2 * RP * c bf16 (RP: r padded to 64),
// two copies of X chunk by chunk.
extern "C" int basd_ns_polar_stream(const float* x, void* out, void* ws,
                                    int batch, int r, int c, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  basd::bf16* o = static_cast<basd::bf16*>(out);
  basd::bf16* w = static_cast<basd::bf16*>(ws);
  if (!basd::stream_shape_ok(r, c)) return (int)cudaErrorInvalidValue;
  if (batch == 0) return 0;
  const int rp = (r + 63) / 64 * 64;
  constexpr int ALL = basd::STREAM_ALL;
  if (rp == 64) return basd::launch_stream<64, ALL>(x, o, w, batch, r, c, st);
  if (rp == 128) return basd::launch_stream<128, ALL>(x, o, w, batch, r, c, st);
  return basd::launch_stream<192, ALL>(x, o, w, batch, r, c, st);
}

// The streaming variant with some of its parts (basd::StreamPart bits: 1
// IO, 3 IO and products, 5 IO and traffic, 7 all), at 129 <= r <= 192
// only: for timing its parts apart.
extern "C" int basd_ns_polar_stream_part(const float* x, void* out, void* ws,
                                         int batch, int r, int c, int parts,
                                         void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  basd::bf16* o = static_cast<basd::bf16*>(out);
  basd::bf16* w = static_cast<basd::bf16*>(ws);
  if (!basd::stream_shape_ok(r, c) || r <= 128) return (int)cudaErrorInvalidValue;
  if (batch == 0) return 0;
  switch (parts) {
    case 1: return basd::launch_stream<192, 1>(x, o, w, batch, r, c, st);
    case 3: return basd::launch_stream<192, 3>(x, o, w, batch, r, c, st);
    case 5: return basd::launch_stream<192, 5>(x, o, w, batch, r, c, st);
    case 7: return basd::launch_stream<192, 7>(x, o, w, batch, r, c, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
