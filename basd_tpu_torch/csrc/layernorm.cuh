// The row LayerNorm forward on Hopper: K5a (csrc/layernorm.cu) and the
// LayerNorm inside K1, K2, K3a, K4a and the recomputes of K3b and K4b
// (block_kernels.cuh's callers), one kernel for all of them.
//
// K5a replaces basd_tpu/ops/pallas/layernorm.py:_fwd (_fwd_kernel): f32
// two-pass statistics of each row (sum, mean, sum of centred squares,
// rsqrt, as kernels/layernorm.py:ln_stats_plain), out = T(xhat * scale +
// bias) in x's type, and the row mean and rstd in f32 when asked.
//
// What bounds it on the H100: one read and one write of the activation
// slab (the student's (128, 197, 192) bf16 is 9.7 MB each way, 5.8 us at
// 3.35 TB/s) and a handful of f32 operations an element: bytes.
//
// Design: a fixed group of G lanes (a power of two) owns a row and holds
// it in registers between the passes, as loaded (16-byte chunks, widened
// to f32 in each pass), so the row crosses device memory once each way,
// in 16-byte loads and stores. G is the least power of two that leaves
// each lane at most LN_CHUNKS chunks (ln_group): at D = 192 in bf16 that
// is 24 chunks on 4 lanes, 6 each, so no lane idles (a warp a row left a
// quarter of its lanes idle; the Triton forward it replaces masked a
// quarter of a 256-wide block). The group's sums are
// xor-shuffles within its lanes. A row whose width is not a whole number
// of 16-byte chunks, rows wider than 32 x LN_NV chunks, or unaligned
// pointers take the scalar loop of the same kernel: a warp a row, x read
// from memory in each pass.
//
// Constants, from basd_tpu_torch/tune.py on an H100 80GB HBM3 at 700 W:
// LN_CHUNKS = 6, with 8 the fastest of 2-8 chunks a lane at (128, 197,
// 192) and (128, 197, 384) (0.0090 / 0.018 ms, 2.2 TB/s counting each byte
// once; 3 chunks 0.0098 / 0.0205, 2 chunks 0.0147 / 0.032). The Triton
// forward it replaced took 0.0060 / 0.0143 ms on the card in the same
// sweep, and lost back to back to its launcher. Capping the kernel at 64
// registers (it takes 98) spilled and was slower (0.0128); so was a group
// normalising 4 rows at once to share scale and bias loads (174
// registers, 0.0127).
#pragma once

#include "common.cuh"

namespace basd {

constexpr int LN_NV = 8;      // 16-byte chunks a lane holds at most
constexpr int LN_CHUNKS = 6;  // chunks a lane aims for (ln_group)
constexpr int LN_THREADS = 256;

// Sum over the g lanes of a row's group (g a power of two, mask its lanes).
__device__ __forceinline__ float group_sum(float v, int g, unsigned mask) {
  for (int o = g / 2; o > 0; o >>= 1) v += __shfl_xor_sync(mask, v, o);
  return v;
}

// group: lanes a row (a power of two up to 32), or 0 for the scalar loop
// with a warp a row.
template <typename T>
static __global__ void __launch_bounds__(LN_THREADS)
    layernorm_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                     const float* __restrict__ bias, T* __restrict__ out,
                     float* __restrict__ mu_out, float* __restrict__ rstd_out,
                     int rows, int d, float eps, int group) {
  const int g = group ? group : 32;
  const int lane = threadIdx.x % 32;
  const int lg = lane % g;
  const int row = (blockIdx.x * blockDim.x + threadIdx.x) / g;
  if (row >= rows) return;  // a group leaves together
  const unsigned mask =
      g == 32 ? 0xffffffffu : ((1u << g) - 1u) << (lane - lg);
  const T* xr = x + (size_t)row * d;
  T* orow = out + (size_t)row * d;
  const float inv_d = 1.f / (float)d;
  float mu, rstd;
  if (group) {
    // the row's 16-byte chunks stay in registers as loaded (four 32-bit
    // registers a chunk, at bf16 as at f32) and widen to f32 in each pass
    constexpr int W = epi_width<T>();
    const int cw = d / W;
    Vec16<T> v[LN_NV];
#pragma unroll
    for (int i = 0; i < LN_NV; ++i) {
      const int c = lg + i * g;
      if (c < cw) v[i] = reinterpret_cast<const Vec16<T>*>(xr)[c];
    }
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < LN_NV; ++i) {
      if (lg + i * g < cw) {
#pragma unroll
        for (int j = 0; j < W; ++j) s += to_f(v[i].v[j]);
      }
    }
    mu = group_sum(s, g, mask) * inv_d;
    float sq = 0.f;
#pragma unroll
    for (int i = 0; i < LN_NV; ++i) {
      if (lg + i * g < cw) {
#pragma unroll
        for (int j = 0; j < W; ++j) {
          const float c = to_f(v[i].v[j]) - mu;
          sq += c * c;
        }
      }
    }
    rstd = rsqrtf(group_sum(sq, g, mask) * inv_d + eps);
#pragma unroll
    for (int i = 0; i < LN_NV; ++i) {
      const int c = lg + i * g;
      if (c < cw) {
        float sc[W], bi[W];
#pragma unroll
        for (int j = 0; j < W; j += 4) {
          *reinterpret_cast<float4*>(sc + j) =
              *reinterpret_cast<const float4*>(scale + c * W + j);
          *reinterpret_cast<float4*>(bi + j) =
              *reinterpret_cast<const float4*>(bias + c * W + j);
        }
        Vec16<T> o;
#pragma unroll
        for (int j = 0; j < W; ++j)
          o.v[j] = from_f<T>((to_f(v[i].v[j]) - mu) * rstd * sc[j] + bi[j]);
        reinterpret_cast<Vec16<T>*>(orow)[c] = o;
      }
    }
  } else {
    float s = 0.f;
    for (int i = lane; i < d; i += 32) s += to_f(xr[i]);
    mu = warp_sum(s) * inv_d;
    float sq = 0.f;
    for (int i = lane; i < d; i += 32) {
      const float c = to_f(xr[i]) - mu;
      sq += c * c;
    }
    rstd = rsqrtf(warp_sum(sq) * inv_d + eps);
    for (int i = lane; i < d; i += 32) {
      orow[i] = from_f<T>((to_f(xr[i]) - mu) * rstd * scale[i] + bias[i]);
    }
  }
  if (mu_out != nullptr && lg == 0) {
    mu_out[row] = mu;
    rstd_out[row] = rstd;
  }
}

// The kernel's lanes a row: the least power of two leaving each lane at
// most `chunks` 16-byte chunks of the row (32 lanes, up to LN_NV chunks
// each, for wider rows), or 0 (the scalar loop) when the row is not a
// whole number of chunks, is wider than 32 LN_NV chunks, or a pointer is
// not 16-byte aligned.
template <typename T>
inline int ln_group(int d, const void* x, const void* out, const float* scale,
                    const float* bias, int chunks) {
  constexpr int W = epi_width<T>();
  for (const void* p : {x, out, (const void*)scale, (const void*)bias})
    if (reinterpret_cast<uintptr_t>(p) % 16 != 0) return 0;
  if (d <= 0 || d % W != 0) return 0;
  const int cw = d / W;
  for (int g = 1; g <= 32; g *= 2)
    if ((cw + g - 1) / g <= chunks) return g;
  return (cw + 31) / 32 <= LN_NV ? 32 : 0;
}

// chunks: the chunks a lane aims for (ln_group), LN_CHUNKS unless a sweep
// sets it (1..LN_NV).
template <typename T>
static int launch_layernorm(const T* x, const float* s, const float* b,
                            T* out, float* mu, float* rstd, int rows, int d,
                            float eps, cudaStream_t st,
                            int chunks = LN_CHUNKS) {
  if (chunks < 1 || chunks > LN_NV) return (int)cudaErrorInvalidValue;
  const int group = ln_group<T>(d, x, out, s, b, chunks);
  const int lanes = group ? group : 32;
  const int blocks =
      (int)(((size_t)rows * lanes + LN_THREADS - 1) / LN_THREADS);
  layernorm_kernel<T><<<blocks, LN_THREADS, 0, st>>>(x, s, b, out, mu, rstd,
                                                     rows, d, eps, group);
  BASD_CHECK_LAUNCH();
  return 0;
}

}  // namespace basd
