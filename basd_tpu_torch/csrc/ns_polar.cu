// K7: hybrid Newton-Schulz polar factor on Hopper.
//
// Replaces basd_tpu/ops/pallas/ns_polar.py:ns_polar_hybrid (_ns_kernel):
// for each (r, c) matrix (r <= c), an f32 Frobenius prescale, then the 5
// quintic steps of _QUINTIC_SCHEDULE
//     G = X X^T,  H = b G + c G G^T,  X <- a X + H X
// and 2 cubic steps  X <- 1.5 X - 0.5 (X X^T) X, with bf16 operands, f32
// accumulation and every intermediate rounded to bf16, as the TPU kernel
// does.
//
// What bounds it on the H100: at the Procrustes batch (P*B = 512 matrices
// of 192 x 384 at B=128) the iteration is ~240 GFLOP (counted from the
// shapes), ~0.25 ms at the bf16 tensor-core peak; the per-matrix operands
// (X 147 KB, G and H 74 KB each in bf16) do not fit one block's 227 KB of
// shared memory together. This first version gives each matrix one block
// that walks the whole iteration, keeping X (ping-pong), G and H in a
// per-matrix device-memory workspace that the caller allocates (~0.44 MB
// a matrix, read back through L2) and staging 64 x 64
// tiles through shared memory for the WMMA products. One launch for the
// whole iteration; 512 independent blocks fill the 132 SMs. Keeping the
// operands on chip (clusters with distributed shared memory, or fp32
// accumulators in registers across steps) is later work.

#include "common.cuh"

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

}  // namespace basd

// x: (batch, r, c) f32 with r <= c, r % 8 == 0, c % 8 == 0; out: (batch,
// r, c) bf16; ws: batch * (2 r c + 2 r r) bf16.
extern "C" int basd_ns_polar_hybrid(const float* x, void* out, void* ws,
                                    int batch, int r, int c, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  basd::ns_polar_hybrid_kernel<<<batch, basd::TILE_THREADS, 0, st>>>(
      x, static_cast<basd::bf16*>(out), static_cast<basd::bf16*>(ws), r, c);
  BASD_CHECK_LAUNCH();
  return 0;
}
