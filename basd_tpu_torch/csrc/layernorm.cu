// K5a: the LayerNorm forward on Hopper, layernorm.cuh's kernel behind a C
// entry (kernels/layernorm.py:layernorm_fwd). The same kernel serves the
// LayerNorm inside K1, K2, K3a, K4a and the recomputes of K3b and K4b
// (block_kernels.cuh's callers). K5b, the backward, stays in Triton
// (kernels/layernorm.py).
//
// Every entry returns the first non-zero cudaGetLastError() after its
// launch, or 0. Nothing here allocates or synchronises.

#include "layernorm.cuh"

using basd::bf16;

// K5a. x, out: (rows, d) bf16 (f32 for the _f32 entry); scale, bias (d)
// f32; mu, rstd (rows) f32. chunks: the 16-byte chunks a lane aims for,
// 0 for layernorm.cuh's LN_CHUNKS (a sweep sets others).
extern "C" int basd_layernorm_fwd(const void* x, const float* scale,
                                  const float* bias, void* out, float* mu,
                                  float* rstd, int rows, int d, float eps,
                                  int chunks, void* stream) {
  return basd::launch_layernorm(static_cast<const bf16*>(x), scale, bias,
                                static_cast<bf16*>(out), mu, rstd, rows, d,
                                eps, static_cast<cudaStream_t>(stream),
                                chunks ? chunks : basd::LN_CHUNKS);
}
extern "C" int basd_layernorm_fwd_f32(const void* x, const float* scale,
                                      const float* bias, void* out, float* mu,
                                      float* rstd, int rows, int d, float eps,
                                      int chunks, void* stream) {
  return basd::launch_layernorm(static_cast<const float*>(x), scale, bias,
                                static_cast<float*>(out), mu, rstd, rows, d,
                                eps, static_cast<cudaStream_t>(stream),
                                chunks ? chunks : basd::LN_CHUNKS);
}
