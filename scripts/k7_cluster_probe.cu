// A thread-block-cluster design of K7 for r > 192, measured against the
// port's batched variant: its exchange alone, then the whole kernel below
// (scripts/k7_probe.py builds this file on its own; the port's library
// does not contain it: the batched variant measured faster).
//
// The design it stands for: S CTAs a matrix, each owning a 64-row panel of
// G (r = 64 S); X chunks would arrive by TMA multicast, and for G G^T each
// CTA needs every other CTA's panel of G, a quintic step's exchange over
// distributed shared memory. This kernel does only that exchange: each
// CTA fills its panel, then for each of `steps` steps copies the S - 1
// other panels one after another from their owners' shared memory into a
// ring of two panels of its own (16-byte loads of the remote window, a
// CTA barrier after each panel, where the design would run that panel's
// product), and the cluster meets at a barrier at the end of each step
// before the owners may write the next step's panels. No product runs.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

constexpr int PANEL_ROWS = 64;
constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS)
    exchange_kernel(int r, int steps, unsigned int* sink) {
  extern __shared__ uint4 smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int S = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int panel = PANEL_ROWS * r * 2 / 16;  // 16-byte words of a panel
  uint4* own = smem;
  uint4* ring = smem + panel;
  for (int i = threadIdx.x; i < panel; i += THREADS)
    own[i] = make_uint4(rank, i, blockIdx.x, 0);
  cluster.sync();
  unsigned int acc = 0;
  for (int step = 0; step < steps; ++step) {
    for (int q = 1; q < S; ++q) {
      const uint4* src = cluster.map_shared_rank(own, (rank + q) % S);
      uint4* dst = ring + (q & 1) * panel;
      for (int i = threadIdx.x; i < panel; i += THREADS) dst[i] = src[i];
      __syncthreads();
      acc ^= dst[(threadIdx.x * 7) % panel].y;
    }
    cluster.sync();
  }
  if (acc == 0xFFFFFFFFu) sink[0] = acc;  // keeps the loads
}

// nb matrices of r = 64 S rows: nb clusters of S CTAs, `steps` exchanges.
extern "C" int k7_cluster_exchange(int nb, int s, int steps, void* sink,
                                   void* stream) {
  const int r = PANEL_ROWS * s;
  const int smem = 3 * PANEL_ROWS * r * 2;
  cudaError_t e = cudaFuncSetAttribute(
      exchange_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(nb * s);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = s;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, exchange_kernel, r, steps,
                         static_cast<unsigned int*>(sink));
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// Clusters of S CTAs of this kernel that can be resident at once.
extern "C" int k7_cluster_occupancy(int s, int* clusters) {
  const int smem = 3 * PANEL_ROWS * PANEL_ROWS * s * 2;
  cudaError_t e = cudaFuncSetAttribute(
      exchange_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(s * 64);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = s;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return (int)cudaOccupancyMaxActiveClusters(clusters, exchange_kernel, &cfg);
}

// ---------------------------------------------------------------------------
// The whole cluster design, to time it against the batched variant of
// basd_tpu_torch/csrc/ns_polar.cu on the same inputs (same rounding points;
// chip_smoke.k7_check's bounds hold it to the plain version).
//
// S CTAs a matrix (r padded to RP = 64 S rows), CTA s owning rows [64 s,
// 64 s + 64) of G/H (its panel, in shared memory) and of each X. A step:
//   A  G[s] = X[s] X^T: X's 64-column chunks arrive in a ring, each CTA
//      loading its own 64 rows of the chunk by TMA multicast to the whole
//      cluster; the two warpgroups split G[s]'s columns;
//   B  (quintic) G[s] to device memory, a cluster barrier, then each
//      panel G[q] multicast by its owner into the ring; block q of
//      G[s] G^T (m64n32 per warpgroup); H = b G + c bf16(G G^T) in place;
//   C  X chunks through the ring again, each warpgroup every other chunk:
//      X_next[s, chunk] = a X + H X (1.5 X - 0.5 G X) to device memory;
//      a cluster barrier before the next step reads X_next.
// A slot is freed when every CTA of the cluster has consumed it: the
// consumer arrives on the slot's empty barrier in every CTA (mapa).

#include "common.cuh"
#include "tma.cuh"
#include "wgmma.cuh"

namespace k7c {
using basd::bf16;
namespace sm90 = basd::sm90;

constexpr int THREADS = 288;  // two consumer warpgroups and a producer warp
constexpr int BLK = 64 * 128;  // a 64-row block of 64 bf16 columns
__constant__ float QUINTIC[5][3] = {
    {4.0848f, -6.8946f, 2.9270f}, {3.9505f, -6.3029f, 2.6377f},
    {3.7418f, -5.5913f, 2.3037f}, {2.8769f, -3.1427f, 1.2046f},
    {2.8366f, -3.0525f, 1.2012f}};

template <int S>
struct Cfg {
  static constexpr int RP = 64 * S;
  static constexpr int SLOT = S * BLK;      // an RP x 64 chunk or a panel
  static constexpr int NST = S <= 5 ? 4 : 2;  // ring slots
  static constexpr int SMEM = 1024 + SLOT /*G panel*/ + NST * SLOT +
                              2 * NST * 8 + 64;
};

__device__ __forceinline__ void wgmma_n32(float* d, uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "l"(a), "l"(b), "r"(1));
}

__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n"
               "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

__device__ __forceinline__ void remote_arrive(uint64_t* bar, uint32_t cta) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(remote) : "r"(sm90::smem_u32(bar)), "r"(cta));
  asm volatile("mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];\n"
               ::"r"(remote) : "memory");
}

__device__ __forceinline__ void tma_multicast(void* dst, const CUtensorMap* map,
                                              uint64_t* bar, int c0, int c1,
                                              int c2, uint16_t mask) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes.multicast::cluster [%0], [%1, {%3, %4, %5}], [%2], %6;\n" ::"r"(
          sm90::smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(sm90::smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2), "h"(mask)
      : "memory");
}

__device__ __forceinline__ int acc_row(int t, int i) {
  return 16 * (t / 32) + (t % 32) / 4 + 8 * ((i / 2) % 2);
}
__device__ __forceinline__ int acc_col(int t, int i) {
  return 8 * (i / 4) + 2 * (t % 4);
}

// A warpgroup's 64 x N accumulators rounded into the panel at column col0
// (and into the panel's rows of G in device memory).
template <int N>
__device__ __forceinline__ void put_g(const float* acc, uint8_t* gs, bf16* gz,
                                      int rp, int col0, int t, bool global) {
#pragma unroll
  for (int i = 0; i < N / 2; i += 2) {
    const int row = acc_row(t, i), col = col0 + acc_col(t, i);
    const __nv_bfloat162 v = __floats2bfloat162_rn(acc[i], acc[i + 1]);
    *reinterpret_cast<__nv_bfloat162*>(gs + sm90::swizzle_offset(row, col, BLK)) = v;
    if (global) *reinterpret_cast<__nv_bfloat162*>(gz + (size_t)row * rp + col) = v;
  }
}

// X (batch, r, c) bf16 twice, G (batch, RP, RP) bf16 in ws.
template <int S>
__global__ void __launch_bounds__(THREADS, 1)
    cluster_kernel(const __grid_constant__ CUtensorMap map_x0,
                   const __grid_constant__ CUtensorMap map_x1,
                   const __grid_constant__ CUtensorMap map_g,
                   const float* __restrict__ x, bf16* __restrict__ out,
                   bf16* __restrict__ xs0, bf16* __restrict__ xs1,
                   bf16* __restrict__ gws, int r, int c) {
  using C = Cfg<S>;
  constexpr int RP = C::RP;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint8_t* gs = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* ring = gs + C::SLOT;
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + C::NST * C::SLOT);
  uint64_t* empty = full + C::NST;
  float* red = reinterpret_cast<float*>(empty + C::NST);
  const int s = (int)cluster_rank();
  const int z = blockIdx.x / S;
  const int tid = threadIdx.x;
  const int wg = tid / 128;
  const int t = tid % 128;
  const int nch = c / 64;
  const uint16_t all = (uint16_t)((1u << S) - 1);
  const size_t rc = (size_t)r * c;

  if (tid == 0) {
    for (int i = 0; i < C::NST; ++i) {
      sm90::mbar_init(&full[i], 1);
      sm90::mbar_init(&empty[i], S);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }

  // prescale: this CTA's rows' sum of squares, summed over the cluster in
  // rank order
  float sq = 0.f;
  const float* xm = x + z * rc;
  for (int row = 64 * s; row < min(r, 64 * s + 64); ++row)
    for (int col = 4 * tid; col < c; col += 4 * THREADS) {
      const float4 v = *reinterpret_cast<const float4*>(xm + (size_t)row * c + col);
      sq += v.x * v.x + v.y * v.y + v.z * v.z + v.w * v.w;
    }
  sq = basd::warp_sum(sq);
  if (tid % 32 == 0) red[1 + tid / 32] = sq;
  __syncthreads();
  if (tid == 0) {
    float v = 0.f;
    for (int w = 0; w < THREADS / 32; ++w) v += red[1 + w];
    red[0] = v;
  }
  cluster_sync();
  float norm2 = 0.f;
  for (int q = 0; q < S; ++q) {
    uint32_t remote;
    asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
                 : "=r"(remote) : "r"(sm90::smem_u32(red)), "r"(q));
    float v;
    asm volatile("ld.shared::cluster.f32 %0, [%1];\n" : "=f"(v) : "r"(remote));
    norm2 += v;
  }
  const float inv = rsqrtf(norm2 + 1e-30f);
  for (int i = tid; i < 64 * (c / 8); i += THREADS) {
    const int row = 64 * s + i / (c / 8);
    const int col = (i % (c / 8)) * 8;
    if (row >= r) continue;
    const float* src = xm + (size_t)row * c + col;
    const float4 lo = *reinterpret_cast<const float4*>(src);
    const float4 hi = *reinterpret_cast<const float4*>(src + 4);
    __nv_bfloat162 h[4] = {
        __floats2bfloat162_rn(__fmul_rn(lo.x, inv), __fmul_rn(lo.y, inv)),
        __floats2bfloat162_rn(__fmul_rn(lo.z, inv), __fmul_rn(lo.w, inv)),
        __floats2bfloat162_rn(__fmul_rn(hi.x, inv), __fmul_rn(hi.y, inv)),
        __floats2bfloat162_rn(__fmul_rn(hi.z, inv), __fmul_rn(hi.w, inv))};
    *reinterpret_cast<uint4*>(xs0 + z * rc + (size_t)row * c + col) =
        *reinterpret_cast<uint4*>(h);
  }
  asm volatile("fence.proxy.async.global;\n" ::: "memory");
  cluster_sync();

  int it = 0;  // ring iterations so far: the same sequence in every role
  for (int step = 0; step < 7; ++step) {
    const bool quintic = step < 5;
    const CUtensorMap* xmap = (step % 2 == 0) ? &map_x0 : &map_x1;
    bf16* xnext = step == 6 ? out + z * rc : ((step % 2 == 0) ? xs1 : xs0) + z * rc;
    const int it_a = it, it_b = it + nch, it_c = it + nch + (quintic ? S : 0);
    it = it_c + nch;
    if (tid >= 256) {
      // the producer warp: lane 0 issues, the whole warp meets the
      // cluster barriers
      auto issue = [&](int i, bool panel, int j) {
        const int slot = i % C::NST;
        if (i >= C::NST) sm90::mbar_wait(&empty[slot], ((i / C::NST) - 1) & 1);
        sm90::mbar_expect_tx(&full[slot], C::SLOT);
        uint8_t* dst = ring + slot * C::SLOT;
        if (!panel) {  // X chunk j: this CTA's 64 rows, to every CTA
          tma_multicast(dst + s * BLK, xmap, &full[slot], 64 * j, 64 * s, z, all);
        } else if (j == s) {  // panel s of G: its S blocks, to every CTA
          for (int kb = 0; kb < S; ++kb)
            tma_multicast(dst + kb * BLK, &map_g, &full[slot], 64 * kb, 64 * s, z,
                          all);
        }
      };
      if (tid == 256)
        for (int j = 0; j < nch; ++j) issue(it_a + j, false, j);
      if (quintic) {
        __syncwarp();
        cluster_sync();  // every CTA's G in device memory
        if (tid == 256)
          for (int q = 0; q < S; ++q) issue(it_b + q, true, q);
      }
      if (tid == 256)
        for (int j = 0; j < nch; ++j) issue(it_c + j, false, j);
      __syncwarp();
      cluster_sync();  // X_next whole
      continue;
    }

    // A: G[s] = X[s] X^T, warpgroup wg the columns [wg HALF, (wg + 1) HALF)
    constexpr int HALF = RP / 2;
    constexpr int P2 = HALF - 128;  // 32 at S = 5, 128 at S = 8
    float g1[64], g2[P2 / 2];
#pragma unroll
    for (int i = 0; i < 64; ++i) g1[i] = 0.f;
#pragma unroll
    for (int i = 0; i < P2 / 2; ++i) g2[i] = 0.f;
    for (int j = 0; j < nch; ++j) {
      const int i = it_a + j;
      const int slot = i % C::NST;
      sm90::mbar_wait(&full[slot], (i / C::NST) & 1);
      const uint8_t* ch = ring + slot * C::SLOT;
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint64_t a = sm90::smem_desc(ch + s * BLK + kk * 32);
        sm90::wgmma_bf16<128, 0, 0>(g1, a, sm90::smem_desc(ch + wg * HALF * 128 + kk * 32));
        const uint64_t b2 = sm90::smem_desc(ch + (wg * HALF + 128) * 128 + kk * 32);
        if constexpr (P2 == 32) {
          wgmma_n32(g2, a, b2);
        } else {
          sm90::wgmma_bf16<128, 0, 0>(g2, a, b2);
        }
      }
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      asm volatile("bar.sync 1, 256;\n" ::: "memory");
      if (tid == 0)
        for (int q = 0; q < S; ++q) remote_arrive(&empty[slot], q);
    }
    // G[s] rounded into the panel (and, for the exchange, device memory)
    bf16* gz = gws + (size_t)z * RP * RP + (size_t)64 * s * RP;
    put_g<128>(g1, gs, gz, RP, wg * HALF, t, quintic);
    put_g<P2>(g2, gs, gz, RP, wg * HALF + 128, t, quintic);
    sm90::fence_proxy_async();
    if (quintic) {
      asm volatile("fence.proxy.async.global;\n" ::: "memory");
      cluster_sync();
      // B: block q of G[s] G^T from panel q, warpgroup wg its 32 columns
      float h[S][16];
#pragma unroll
      for (int q = 0; q < S; ++q)
#pragma unroll
        for (int i = 0; i < 16; ++i) h[q][i] = 0.f;
#pragma unroll
      for (int q = 0; q < S; ++q) {
        const int i = it_b + q;
        const int slot = i % C::NST;
        sm90::mbar_wait(&full[slot], (i / C::NST) & 1);
        const uint8_t* pn = ring + slot * C::SLOT;
        sm90::wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < RP / 16; ++ks) {
          const int off = (ks >> 2) * BLK + (ks & 3) * 32;
          wgmma_n32(h[q], sm90::smem_desc(gs + off),
                    sm90::smem_desc(pn + off + wg * 32 * 128));
        }
        sm90::wgmma_commit();
        sm90::wgmma_wait<0>();
        asm volatile("bar.sync 1, 256;\n" ::: "memory");
        if (tid == 0)
          for (int p = 0; p < S; ++p) remote_arrive(&empty[slot], p);
      }
      // H = b G + c bf16(G G^T) over G (every read of G as A is done)
      const float b = QUINTIC[step][1], cq = QUINTIC[step][2];
#pragma unroll
      for (int q = 0; q < S; ++q)
#pragma unroll
        for (int i = 0; i < 16; i += 2) {
          const int row = acc_row(t, i), col = 64 * q + 32 * wg + acc_col(t, i);
          __nv_bfloat162* pg = reinterpret_cast<__nv_bfloat162*>(
              gs + sm90::swizzle_offset(row, col, BLK));
          const float2 gv = __bfloat1622float2(*pg);
          const float2 g2v = __bfloat1622float2(__floats2bfloat162_rn(h[q][i], h[q][i + 1]));
          *pg = __floats2bfloat162_rn(__fadd_rn(__fmul_rn(b, gv.x), __fmul_rn(cq, g2v.x)),
                                      __fadd_rn(__fmul_rn(b, gv.y), __fmul_rn(cq, g2v.y)));
        }
      sm90::fence_proxy_async();
    }
    asm volatile("bar.sync 1, 256;\n" ::: "memory");

    // C: X_next[s, chunk j] for j = wg, wg + 2, ...
    const float ca = quintic ? QUINTIC[step][0] : 1.5f;
    const float cm = quintic ? 1.f : -0.5f;
    for (int j = wg; j < nch; j += 2) {
      const int i = it_c + j;
      const int slot = i % C::NST;
      sm90::mbar_wait(&full[slot], (i / C::NST) & 1);
      uint8_t* ch = ring + slot * C::SLOT;
      float y[32];
#pragma unroll
      for (int k = 0; k < 32; ++k) y[k] = 0.f;
      sm90::wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < RP / 16; ++ks)
        sm90::wgmma_bf16<64, 0, 1>(
            y, sm90::smem_desc(gs + (ks >> 2) * BLK + (ks & 3) * 32),
            sm90::smem_desc_mn(ch + ks * 16 * 128, C::SLOT));
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
#pragma unroll
      for (int k = 0; k < 32; k += 2) {
        const int row = acc_row(t, k), col = acc_col(t, k);
        const float2 xv = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
            ch + sm90::swizzle_offset(64 * s + row, col, C::SLOT)));
        const float y0 = __fadd_rn(__fmul_rn(ca, xv.x), __fmul_rn(cm, y[k]));
        const float y1 = __fadd_rn(__fmul_rn(ca, xv.y), __fmul_rn(cm, y[k + 1]));
        if (64 * s + row < r)
          *reinterpret_cast<__nv_bfloat162*>(xnext + (size_t)(64 * s + row) * c +
                                             64 * j + col) =
              __floats2bfloat162_rn(y0, y1);
      }
      asm volatile("bar.sync %0, 128;\n" ::"r"(2 + wg) : "memory");
      if (t == 0)
        for (int q = 0; q < S; ++q) remote_arrive(&empty[slot], q);
    }
    asm volatile("fence.proxy.async.global;\n" ::: "memory");
    cluster_sync();
  }
  cluster_sync();  // no CTA leaves while a peer may still signal it
}

template <int S>
int launch_cluster(const float* x, bf16* out, bf16* ws, int batch, int r,
                   int c, cudaStream_t st) {
  using C = Cfg<S>;
  const size_t rc = (size_t)r * c;
  bf16* xs0 = ws;
  bf16* xs1 = ws + batch * rc;
  bf16* gws = xs1 + batch * rc;
  CUtensorMap mx0, mx1, mg;
  int e = sm90::tensor_map_3d(&mx0, xs0, batch, r, c, 64);
  if (!e) e = sm90::tensor_map_3d(&mx1, xs1, batch, r, c, 64);
  if (!e) e = sm90::tensor_map_3d(&mg, gws, batch, C::RP, C::RP, 64);
  if (e) return e;
  cudaError_t err = cudaFuncSetAttribute(
      cluster_kernel<S>, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(batch * S);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = C::SMEM;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = S;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, cluster_kernel<S>, mx0, mx1, mg, x, out, xs0,
                           xs1, gws, r, c);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace k7c

// The cluster design of K7: x (batch, r, c) f32, r in (256, 320] (S = 5)
// or (448, 512] (S = 8), c % 64 == 0; out (batch, r, c) bf16; ws: batch *
// (2 r c + RP RP) bf16.
extern "C" int k7_cluster_polar(const float* x, void* out, void* ws, int batch,
                                int r, int c, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  k7c::bf16* o = static_cast<k7c::bf16*>(out);
  k7c::bf16* w = static_cast<k7c::bf16*>(ws);
  if (c % 64 != 0 || r % 8 != 0 || r > c) return (int)cudaErrorInvalidValue;
  if (r > 256 && r <= 320) return k7c::launch_cluster<5>(x, o, w, batch, r, c, st);
  if (r > 448 && r <= 512) return k7c::launch_cluster<8>(x, o, w, batch, r, c, st);
  return (int)cudaErrorInvalidValue;
}
