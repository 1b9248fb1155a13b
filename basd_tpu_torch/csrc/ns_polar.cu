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
// of 192 x 384 at B=128) the iteration needs ~171 GFLOP (X X^T and G G^T
// are symmetric: r (r + 1) / 2 dot products each; kernels/ns_polar.py:
// polar_flops), ~0.17 ms at the bf16 tensor-core peak, against 151 MB of
// input and 75 MB of output (0.07 ms at 3.35 TB/s): operations, as the TPU
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
//   at (512, 192, 768) and (512, 192, 2048) (0.33 and 0.84 ms of bf16
//   products at the peak); this design adds device-memory traffic of 2.87
//   and 7.65 GB (x twice in f32, X in and out once a step), 0.86 and 2.28
//   ms at 3.35 TB/s, the floor of its time at c = 2048.
//   A cluster design (S = c / 256 CTAs a matrix, X by columns in shared
//   memory, the partial Grams reduce-scattered and all-gathered over
//   distributed shared memory) was measured first and lost: its exchange
//   took longer than the Gram product it serves (PERF.md).
// - batched (ns_batched_kernel), for rows over 192 (the DINOv2 teachers'
//   calibrated students: (512, 320, 768) under ViT-B/14, (512, 512, 1024)
//   under ViT-L/14; (384, 768), a DeiT-S student under a DeiT-B teacher):
//   G (r x r bf16, 205 KB at r = 320) no longer fits beside a ring of X
//   chunks in one CTA. Each product of each step is one launch over every
//   matrix, the grid (output tile, matrix), each CTA a 128 x 128 tile of
//   one matrix's product on gemm_sm90.cuh's machinery: two consumer
//   warpgroups issuing wgmma from a TMA ring that one producer warp keeps
//   full, fed by 3-D tensor maps (one matrix a plane: a box is zero-filled
//   at its own matrix's edges, so ragged r needs no padding in memory); a
//   warpgroup whose 64 rows lie past r issues nothing. G and G G^T are
//   symmetric: only their tiles on and above the diagonal are computed,
//   each off-diagonal one also stored transposed (6 of 9 tiles at r =
//   320). The Newton-Schulz
//   epilogue runs on the accumulators in registers: G rounded, H = b G +
//   c bf16(G G^T) with G as the aux operand, a X + H X or 1.5 X - 0.5 G X
//   with X as the aux operand, each rounded once and stored as bf16 pairs.
//   19 products and a prescale launch a call (20 launches); X (ping-pong),
//   G and H live in a device-memory workspace, 2 r c + 2 r r bf16 a
//   matrix. Its floor is bytes: each product reads its operands and writes
//   its result once, ~1.2 GB a step at (512, 320, 768), ~2.4 ms over the
//   call at 3.35 TB/s against 0.94 ms of products at the bf16 peak; the
//   grid keeps a matrix's tiles adjacent so that its operands are re-read
//   from L2. Each output element is one CTA's fixed-order sum: two
//   launches give the same bits.

#include "common.cuh"
#include "tma.cuh"
#include "wgmma.cuh"

namespace basd {

// The schedule, written once: the device copy for the on-chip and
// streaming variants, the host copy for the batched variant's launches,
// which take a step's coefficients as arguments.
#define BASD_QUINTIC_SCHEDULE    \
  {{4.0848f, -6.8946f, 2.9270f}, \
   {3.9505f, -6.3029f, 2.6377f}, \
   {3.7418f, -5.5913f, 2.3037f}, \
   {2.8769f, -3.1427f, 1.2046f}, \
   {2.8366f, -3.0525f, 1.2012f}}
__constant__ float QUINTIC[5][3] = BASD_QUINTIC_SCHEDULE;
constexpr float QUINTIC_HOST[5][3] = BASD_QUINTIC_SCHEDULE;
constexpr int NUM_CUBIC = 2;

enum NsPhase { NS_GRAM = 0, NS_H = 1, NS_QUINTIC_Y = 2, NS_CUBIC_Y = 3 };

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

// ---- the batched variant ----

namespace nsb {
constexpr int TM = 128;              // output rows a CTA: two warpgroups of 64
constexpr int TN = 128;              // output columns a CTA
constexpr int TK = 64;               // contraction a stage
constexpr int BOX = 64 * TK * 2;     // an MN-major box of B: 64 N x 64 K
constexpr int STAGES = 3;
constexpr int A_BYTES = TM * TK * 2;
constexpr int B_BYTES = TN * TK * 2;
constexpr int STAGE = A_BYTES + B_BYTES;
// alignment slack for the 128-byte swizzle, the ring, two mbarriers a
// stage: ~97 KB, two CTAs an SM
constexpr int SMEM = 1024 + STAGES * STAGE + 2 * STAGES * 8;
constexpr int T_LD = TM + 8;         // row pitch of a transposed tile staged
                                     // in the drained ring (16-byte rows)
constexpr int CONSUMERS = 256;
constexpr int THREADS = CONSUMERS + 32;  // and one producer warp
constexpr int PRESCALE_THREADS = 256;
}  // namespace nsb

// One product of a step over every matrix of the batch: out = epilogue(A .
// B), A (M x K) K-major, B K-major (N x K) or MN-major (stored K x N).
struct NsProduct {
  bf16* out;        // (batch, M, N)
  const bf16* aux;  // (batch, M, N): G for NS_H, X for the Y phases
  int M, N, K;
  float ca, cb;     // NS_H: b and c; NS_QUINTIC_Y: a
};

// The r x r products (NS_GRAM: G = X X^T; NS_H: G G^T, from which H) are
// symmetric: a CTA computes an output tile (mt, nt) with mt <= nt and, off
// the diagonal, writes its transpose as tile (nt, mt) too (staged in the
// drained ring, stored in 16-byte rows). H's aux G is then symmetric bit
// for bit off the diagonal tiles, so the transposed H is H's own value.
template <int EPI>
__host__ __device__ constexpr bool symmetric_epi() {
  return EPI == NS_GRAM || EPI == NS_H;
}

// Output tile of matrix blockIdx.z: (blockIdx.y, blockIdx.x), or for a
// symmetric product the blockIdx.x-th tile (mt, nt), mt <= nt, in row
// order.
template <int EPI, bool B_MN>
__global__ void __launch_bounds__(nsb::THREADS, 2)
    ns_batched_kernel(const __grid_constant__ CUtensorMap map_a,
                      const __grid_constant__ CUtensorMap map_b,
                      const NsProduct p) {
  constexpr bool SYM = symmetric_epi<EPI>();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + nsb::STAGES * nsb::STAGE);
  uint64_t* empty = full + nsb::STAGES;
  int mt = blockIdx.y, nt = blockIdx.x;
  if constexpr (SYM) {
    const int tiles = (p.M + nsb::TM - 1) / nsb::TM;
    int t = blockIdx.x;
    mt = 0;
    while (t >= tiles - mt) {
      t -= tiles - mt;
      ++mt;
    }
    nt = mt + t;
  }
  const int m0 = mt * nsb::TM;
  const int n0 = nt * nsb::TN;
  const int z = blockIdx.z;
  const int k_tiles = (p.K + nsb::TK - 1) / nsb::TK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < nsb::STAGES; ++s) {
      sm90::mbar_init(&full[s], 1);
      sm90::mbar_init(&empty[s], nsb::CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= nsb::CONSUMERS) {
    // the producer warp: one lane keeps the ring full
    if (threadIdx.x == nsb::CONSUMERS) {
      const int b_boxes = B_MN ? min(nsb::TN / 64, (p.N - n0 + 63) / 64) : 1;
      const int bytes = nsb::A_BYTES + (B_MN ? b_boxes * nsb::BOX : nsb::B_BYTES);
      for (int kt = 0; kt < k_tiles; ++kt) {
        const int s = kt % nsb::STAGES;
        if (kt >= nsb::STAGES) sm90::mbar_wait(&empty[s], (kt / nsb::STAGES - 1) & 1);
        uint8_t* stage = smem + s * nsb::STAGE;
        const int k = kt * nsb::TK;
        sm90::mbar_expect_tx(&full[s], bytes);
        sm90::tma_load_3d(stage, &map_a, &full[s], k, m0, z);
        if constexpr (B_MN) {
          for (int j = 0; j < b_boxes; ++j)
            sm90::tma_load_3d(stage + nsb::A_BYTES + j * nsb::BOX, &map_b,
                              &full[s], n0 + 64 * j, k, z);
        } else {
          sm90::tma_load_3d(stage + nsb::A_BYTES, &map_b, &full[s], k, n0, z);
        }
      }
    }
    return;
  }

  const int wg = threadIdx.x / 128;
  const int t = threadIdx.x % 128;
  const int row0 = m0 + wg * 64;
  const bool live = row0 < p.M;  // rows past M feed only discarded outputs
  float acc[nsb::TN / 2];
#pragma unroll
  for (int i = 0; i < nsb::TN / 2; ++i) acc[i] = 0.f;
  for (int kt = 0; kt < k_tiles; ++kt) {
    const int s = kt % nsb::STAGES;
    sm90::mbar_wait(&full[s], (kt / nsb::STAGES) & 1);
    if (live) {
      // warpgroup wg's 64 rows of A are 8 KB into the stage
      const uint8_t* a = smem + s * nsb::STAGE + wg * 64 * 128;
      const uint8_t* b = smem + s * nsb::STAGE + nsb::A_BYTES;
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < nsb::TK / 16; ++kk) {
        sm90::wgmma_bf16<nsb::TN, 0, B_MN>(
            acc, sm90::smem_desc(a + kk * 32),
            B_MN ? sm90::smem_desc_mn(b + kk * 16 * 128, nsb::BOX)
                 : sm90::smem_desc(b + kk * 32));
      }
      sm90::wgmma_commit();
      // the previous stage's products are done: release it
      sm90::wgmma_wait<1>();
    }
    if (kt > 0) sm90::mbar_arrive(&empty[(kt - 1) % nsb::STAGES]);
  }
  const bool mirror = SYM && mt != nt;
  if (!live && !mirror) return;
  if (live) sm90::wgmma_wait<0>();

  // the epilogue on the accumulators, a pair of neighbouring columns at a
  // time (N % 8 == 0: a pair lies wholly inside or outside the matrix);
  // a mirrored tile's values also go transposed into the drained ring
  // (every stage consumed, both warpgroups' products complete)
  if (mirror) asm volatile("bar.sync 1, 256;\n" ::: "memory");
  bf16* tile_t = reinterpret_cast<bf16*>(smem);
  const size_t base = (size_t)z * p.M * p.N;
#pragma unroll
  for (int i = 0; i < nsb::TN / 2; i += 2) {
    const int row = row0 + acc_row(t, i);
    const int col = n0 + acc_col(t, i);
    if (!live || row >= p.M || col >= p.N) continue;
    const size_t o = base + (size_t)row * p.N + col;
    float y0 = acc[i], y1 = acc[i + 1];
    if constexpr (EPI != NS_GRAM) {
      const float2 v = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(p.aux + o));
      if constexpr (EPI == NS_H) {  // b G + c bf16(G G^T)
        const float2 g2 = __bfloat1622float2(__floats2bfloat162_rn(y0, y1));
        y0 = __fadd_rn(__fmul_rn(p.ca, v.x), __fmul_rn(p.cb, g2.x));
        y1 = __fadd_rn(__fmul_rn(p.ca, v.y), __fmul_rn(p.cb, g2.y));
      } else if constexpr (EPI == NS_QUINTIC_Y) {  // a X + H X
        y0 = __fadd_rn(__fmul_rn(p.ca, v.x), y0);
        y1 = __fadd_rn(__fmul_rn(p.ca, v.y), y1);
      } else {  // 1.5 X - 0.5 (G X)
        y0 = __fadd_rn(__fmul_rn(1.5f, v.x), __fmul_rn(-0.5f, y0));
        y1 = __fadd_rn(__fmul_rn(1.5f, v.y), __fmul_rn(-0.5f, y1));
      }
    }
    const __nv_bfloat162 y = __floats2bfloat162_rn(y0, y1);
    *reinterpret_cast<__nv_bfloat162*>(p.out + o) = y;
    if (mirror) {
      const int rl = row - m0, cl = col - n0;
      tile_t[cl * nsb::T_LD + rl] = y.x;
      tile_t[(cl + 1) * nsb::T_LD + rl] = y.y;
    }
  }
  if (!mirror) return;
  asm volatile("bar.sync 1, 256;\n" ::: "memory");
  // tile (nt, mt): row n0 + cl of the output is column cl of the tile
  for (int i = threadIdx.x; i < nsb::TN * (nsb::TM / 8); i += nsb::CONSUMERS) {
    const int cl = i / (nsb::TM / 8);
    const int rl = (i % (nsb::TM / 8)) * 8;
    if (n0 + cl >= p.N || m0 + rl >= p.M) continue;
    *reinterpret_cast<uint4*>(p.out + base + (size_t)(n0 + cl) * p.N + m0 + rl) =
        *reinterpret_cast<const uint4*>(tile_t + cl * nsb::T_LD + rl);
  }
}

// The f32 Frobenius prescale of each matrix (one CTA a matrix): the norm
// summed in a fixed order, then x scaled and rounded into X_0.
__global__ void __launch_bounds__(nsb::PRESCALE_THREADS)
    ns_prescale_kernel(const float* __restrict__ x, bf16* __restrict__ x0,
                       int rc) {
  __shared__ float red[nsb::PRESCALE_THREADS / 32];
  const float* xm = x + blockIdx.x * (size_t)rc;
  bf16* om = x0 + blockIdx.x * (size_t)rc;
  const int tid = threadIdx.x;
  float s = 0.f;
  for (int i = 4 * tid; i < rc; i += 4 * nsb::PRESCALE_THREADS) {
    const float4 v = *reinterpret_cast<const float4*>(xm + i);
    s += v.x * v.x + v.y * v.y + v.z * v.z + v.w * v.w;
  }
  s = warp_sum(s);
  if (tid % 32 == 0) red[tid / 32] = s;
  __syncthreads();
  float norm2 = 0.f;
  for (int w = 0; w < nsb::PRESCALE_THREADS / 32; ++w) norm2 += red[w];
  const float inv = rsqrtf(norm2 + 1e-30f);
  for (int i = 8 * tid; i < rc; i += 8 * nsb::PRESCALE_THREADS) {
    const float4 lo = *reinterpret_cast<const float4*>(xm + i);
    const float4 hi = *reinterpret_cast<const float4*>(xm + i + 4);
    __nv_bfloat162 h[4] = {
        __floats2bfloat162_rn(__fmul_rn(lo.x, inv), __fmul_rn(lo.y, inv)),
        __floats2bfloat162_rn(__fmul_rn(lo.z, inv), __fmul_rn(lo.w, inv)),
        __floats2bfloat162_rn(__fmul_rn(hi.x, inv), __fmul_rn(hi.y, inv)),
        __floats2bfloat162_rn(__fmul_rn(hi.z, inv), __fmul_rn(hi.w, inv))};
    *reinterpret_cast<uint4*>(om + i) = *reinterpret_cast<uint4*>(h);
  }
}

template <int EPI, bool B_MN>
int launch_product(const CUtensorMap& a, const CUtensorMap& b,
                   const NsProduct& p, int batch, cudaStream_t st) {
  static const cudaError_t attr = cudaFuncSetAttribute(
      ns_batched_kernel<EPI, B_MN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      nsb::SMEM);
  if (attr != cudaSuccess) return (int)attr;
  const int tiles_m = (p.M + nsb::TM - 1) / nsb::TM;
  const dim3 grid = symmetric_epi<EPI>()
                        ? dim3(tiles_m * (tiles_m + 1) / 2, 1, batch)
                        : dim3((p.N + nsb::TN - 1) / nsb::TN, tiles_m, batch);
  ns_batched_kernel<EPI, B_MN><<<grid, nsb::THREADS, nsb::SMEM, st>>>(a, b, p);
  BASD_CHECK_LAUNCH();
  return 0;
}

}  // namespace basd

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

// The batched variant. x: (batch, r, c) f32 with r <= c, r % 8 == 0,
// c % 128 == 0, 16-byte aligned; out: (batch, r, c) bf16; ws: batch *
// (2 r c + 2 r r) bf16 (X twice, G, H).
extern "C" int basd_ns_polar_batched(const float* x, void* out, void* ws,
                                     int batch, int r, int c, void* stream) {
  using namespace basd;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (r <= 0 || r > c || r % 8 != 0 || c % 128 != 0 || batch > 65535)
    return (int)cudaErrorInvalidValue;
  if (batch == 0) return 0;
  const size_t rc = (size_t)r * c;
  bf16* xs[2] = {static_cast<bf16*>(ws), static_cast<bf16*>(ws) + batch * rc};
  bf16* g = xs[1] + batch * rc;
  bf16* h = g + (size_t)batch * r * r;
  // each X as A and as B of the Gram (K-major, 128-row boxes) and as B of
  // the Y products (MN-major, 64 x 64 boxes); G as A and B; H as A
  CUtensorMap x_k[2], x_mn[2], g_k, h_k;
  int e = 0;
  for (int i = 0; i < 2 && !e; ++i) {
    e = sm90::tensor_map_3d(&x_k[i], xs[i], batch, r, c, nsb::TM);
    if (!e) e = sm90::tensor_map_3d(&x_mn[i], xs[i], batch, r, c, nsb::TK);
  }
  if (!e) e = sm90::tensor_map_3d(&g_k, g, batch, r, r, nsb::TM);
  if (!e) e = sm90::tensor_map_3d(&h_k, h, batch, r, r, nsb::TM);
  if (e) return e;

  ns_prescale_kernel<<<batch, nsb::PRESCALE_THREADS, 0, st>>>(x, xs[0], (int)rc);
  BASD_CHECK_LAUNCH();
  int cur = 0;
  for (int step = 0; step < 5 + NUM_CUBIC; ++step) {
    // G = X X^T; for a quintic step H = b G + c G G^T, then a X + H X; for
    // a cubic one 1.5 X - 0.5 G X
    e = launch_product<NS_GRAM, false>(
        x_k[cur], x_k[cur], NsProduct{g, nullptr, r, r, c, 0.f, 0.f}, batch, st);
    if (!e && step < 5)
      e = launch_product<NS_H, false>(
          g_k, g_k,
          NsProduct{h, g, r, r, r, QUINTIC_HOST[step][1], QUINTIC_HOST[step][2]},
          batch, st);
    if (e) return e;
    bf16* dst = step == 4 + NUM_CUBIC ? static_cast<bf16*>(out) : xs[1 - cur];
    e = step < 5 ? launch_product<NS_QUINTIC_Y, true>(
                       h_k, x_mn[cur],
                       NsProduct{dst, xs[cur], r, c, r, QUINTIC_HOST[step][0], 0.f},
                       batch, st)
                 : launch_product<NS_CUBIC_Y, true>(
                       g_k, x_mn[cur], NsProduct{dst, xs[cur], r, c, r, 0.f, 0.f},
                       batch, st);
    if (e) return e;
    cur = 1 - cur;
  }
  return 0;
}
