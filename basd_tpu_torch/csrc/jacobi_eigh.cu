// K8: batched symmetric eigensolver, cyclic parallel (Brent-Luk) Jacobi,
// on Hopper.
//
// Replaces basd_tpu/ops/pallas/jacobi_eigh.py:jacobi_eigh (_jacobi_kernel):
// `sweeps` sweeps of n - 1 rounds over each symmetric (n, n) f32 matrix
// (n even), each round rotating n/2 disjoint index pairs at once, with the
// TPU kernel's rotation formula and guard, eigenvectors accumulated as
// V <- V J. The pairs of each round come from a host-built table that
// replays the TPU kernel's slot rule (kernels/jacobi_eigh.py:pair_table),
// so the same pairs turn in the same order and orientation, one Givens
// rotation per pair. The caller
// sorts the eigenvalues, as the JAX package does outside its kernel.
//
// What bounds it on the H100: a round is an O(n^2) elementwise pass (the
// two-sided update of A, ~6 n^2 flops, and the column update of V, ~3 n^2)
// and rounds depend on each other, so the 6 (n - 1) rounds of a matrix run
// in sequence. At (48, 96, 96) the work is ~2.3 GFLOP of f32 on CUDA
// cores, ~0.034 ms at the 67 TFLOP/s peak, but the 570 rounds each end on
// a block barrier: the kernel is bound by round latency, not by either
// peak. Design: the TPU kernel turns each round into three dense products
// against constant matrices, which suits its matrix unit; here one block
// owns one matrix, A lives in shared memory (36 KB at n = 96, 144 KB at
// n = 192), V too where both fit (n <= 168), else in the output buffer
// (L2-resident); each round is: n/2 threads compute their pair's rotation
// (c, s), one barrier, every 2 x 2 block of A and every column
// pair of V updated in one pass, one barrier. Full f32 on CUDA cores, no
// TF32 and no tensor cores (the spectral path's precision policy). Several
// matrices per block for small n, or a cluster split for large n, are
// later work.

#include <cuda_runtime.h>

namespace basd {

constexpr int JACOBI_THREADS = 512;
constexpr float JACOBI_EPS = 1e-30f;
// a block's shared memory on sm_90 (227 KB)
constexpr int MAX_SMEM = 232448;

// (c, s) of a pair: tau = (a_qq - a_pp) / (2 a_pq),
// t = sign(tau) / (|tau| + sqrt(1 + tau^2)), no rotation where
// |a_pq| <= eps (sign(0) = 0, as jnp.sign). The bottom slot takes (c, -s),
// so J is orthogonal to rounding (kernels/jacobi_eigh.py says why the TPU
// kernel's second evaluation from a_qp is not kept).
__device__ __forceinline__ void pair_rotation(float app, float aqq, float apq,
                                              float& c, float& s) {
  float t = 0.f;
  if (fabsf(apq) > JACOBI_EPS) {
    const float tau = (aqq - app) / (2.f * apq);
    const float sg = tau > 0.f ? 1.f : (tau < 0.f ? -1.f : 0.f);
    t = sg / (fabsf(tau) + sqrtf(1.f + tau * tau));
  }
  c = 1.f / sqrtf(1.f + t * t);
  s = t * c;
}

// One block per matrix. A in shared memory when A_SMEM, else in the
// caller's workspace; V in shared memory when V_SMEM, else in the output.
template <bool A_SMEM, bool V_SMEM>
__global__ void __launch_bounds__(JACOBI_THREADS)
    jacobi_eigh_kernel(const float* __restrict__ a_in, float* __restrict__ w_out,
                       float* __restrict__ v_out, float* __restrict__ a_ws,
                       const int2* __restrict__ pairs, int n, int sweeps) {
  extern __shared__ __align__(16) float smem[];
  const int m = n / 2;
  const size_t nn = (size_t)n * n;
  float* cs = smem;  // c, s: 2 m floats
  int* idx = reinterpret_cast<int*>(cs + 2 * m);  // p, q: 2 m ints
  float* tail = reinterpret_cast<float*>(idx + 2 * m);
  float* A = A_SMEM ? tail : a_ws + blockIdx.x * nn;
  float* V = V_SMEM ? tail + (A_SMEM ? nn : 0) : v_out + blockIdx.x * nn;
  float* C = cs;
  float* S = cs + m;
  int* P = idx;
  int* Q = idx + m;

  const float* src = a_in + blockIdx.x * nn;
  for (size_t i = threadIdx.x; i < nn; i += blockDim.x) {
    A[i] = src[i];
    V[i] = (i / n == i % n) ? 1.f : 0.f;
  }
  int2 pr = make_int2(0, 0);
  if (threadIdx.x < m) pr = pairs[threadIdx.x];
  __syncthreads();

  const int rounds = n - 1;
  const int total = sweeps * rounds;
  for (int it = 0; it < total; ++it) {
    if (threadIdx.x < m) {
      const int p = pr.x;
      const int q = pr.y;
      // the next round's pair, loaded while this round runs
      pr = pairs[((it + 1) % rounds) * m + threadIdx.x];
      float c, s;
      pair_rotation(A[(size_t)p * n + p], A[(size_t)q * n + q],
                    A[(size_t)p * n + q], c, s);
      C[threadIdx.x] = c;
      S[threadIdx.x] = s;
      P[threadIdx.x] = p;
      Q[threadIdx.x] = q;
    }
    __syncthreads();
    // A <- J^T A J, one 2 x 2 block (pair k rows, pair l columns) a step:
    // columns first, then rows, as the TPU kernel's (A Jt) then Jt^T (.)
    for (int i = threadIdx.x; i < m * m; i += blockDim.x) {
      const int k = i / m;
      const int l = i - k * m;
      const size_t pk = (size_t)P[k] * n, qk = (size_t)Q[k] * n;
      const int pl = P[l], ql = Q[l];
      const float cl = C[l], sl = S[l];
      const float a_pp = A[pk + pl], a_pq = A[pk + ql];
      const float a_qp = A[qk + pl], a_qq = A[qk + ql];
      const float b_pp = cl * a_pp - sl * a_pq;
      const float b_pq = sl * a_pp + cl * a_pq;
      const float b_qp = cl * a_qp - sl * a_qq;
      const float b_qq = sl * a_qp + cl * a_qq;
      const float ck = C[k], sk = S[k];
      A[pk + pl] = ck * b_pp - sk * b_qp;
      A[qk + pl] = sk * b_pp + ck * b_qp;
      A[pk + ql] = ck * b_pq - sk * b_qq;
      A[qk + ql] = sk * b_pq + ck * b_qq;
    }
    // V <- V J, one row's column pair a step
    for (int i = threadIdx.x; i < n * m; i += blockDim.x) {
      const int row = i / m;
      const int l = i - row * m;
      float* vr = V + (size_t)row * n;
      const int pl = P[l], ql = Q[l];
      const float v_p = vr[pl], v_q = vr[ql];
      vr[pl] = C[l] * v_p - S[l] * v_q;
      vr[ql] = S[l] * v_p + C[l] * v_q;
    }
    __syncthreads();
  }

  // after whole sweeps every slot holds its own index again, so the
  // diagonal and V's columns are in the TPU kernel's (unsorted) order
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    w_out[blockIdx.x * (size_t)n + i] = A[(size_t)i * n + i];
  }
  if constexpr (V_SMEM) {
    float* dst = v_out + blockIdx.x * nn;
    for (size_t i = threadIdx.x; i < nn; i += blockDim.x) dst[i] = V[i];
  }
}

template <bool A_SMEM, bool V_SMEM>
int launch_jacobi(const float* a, float* w, float* v, float* ws,
                  const int2* pairs, int batch, int n, int sweeps,
                  size_t smem, cudaStream_t st) {
  auto kernel = jacobi_eigh_kernel<A_SMEM, V_SMEM>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<batch, JACOBI_THREADS, smem, st>>>(a, w, v, ws, pairs, n, sweeps);
  err = cudaGetLastError();
  return (int)err;
}

// Dynamic shared memory for n: the round's rotations and pairs (2 n
// words), A when a_smem, V when v_smem. kernels/jacobi_eigh.py mirrors it
// to decide whether to pass a workspace.
inline long long jacobi_smem_bytes(int n, bool a_smem, bool v_smem) {
  const long long nn = (long long)n * n;
  return 4LL * (2LL * n + (a_smem ? nn : 0) + (v_smem ? nn : 0));
}

}  // namespace basd

// a: (batch, n, n) f32 symmetric, n even; w: (batch, n) f32; v: (batch, n,
// n) f32; ws: (batch, n, n) f32 workspace, used only when A does not fit
// in shared memory (may be null otherwise); pairs: (n - 1, n / 2) int2.
extern "C" int basd_jacobi_eigh(const float* a, float* w, float* v, float* ws,
                                const void* pairs, int batch, int n, int sweeps,
                                void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int2* pr = static_cast<const int2*>(pairs);
  const long long both = basd::jacobi_smem_bytes(n, true, true);
  const long long a_only = basd::jacobi_smem_bytes(n, true, false);
  if (both <= basd::MAX_SMEM) {
    return basd::launch_jacobi<true, true>(a, w, v, ws, pr, batch, n, sweeps,
                                           (size_t)both, st);
  }
  if (a_only <= basd::MAX_SMEM) {
    return basd::launch_jacobi<true, false>(a, w, v, ws, pr, batch, n, sweeps,
                                            (size_t)a_only, st);
  }
  if (ws == nullptr) return (int)cudaErrorInvalidValue;
  return basd::launch_jacobi<false, false>(
      a, w, v, ws, pr, batch, n, sweeps,
      (size_t)basd::jacobi_smem_bytes(n, false, false), st);
}
