// K8: batched symmetric eigensolver, cyclic parallel (Brent-Luk) Jacobi,
// on Hopper.
//
// Replaces basd_tpu/ops/pallas/jacobi_eigh.py:jacobi_eigh (_jacobi_kernel):
// `sweeps` sweeps of n - 1 rounds over each symmetric (n, n) f32 matrix
// (n even), each round rotating n/2 disjoint index pairs at once, with the
// TPU kernel's rotation formula and guard, eigenvectors accumulated as
// V <- V J. The same pairs turn in the same order and orientation as the
// TPU kernel's slot rule (kernels/jacobi_eigh.py:pair_table), one Givens
// rotation per pair from the top slot. The caller sorts the eigenvalues,
// as the JAX package does outside its kernel. Full f32 on CUDA cores: no
// TF32 and no tensor cores (the spectral path's precision policy).
//
// What bounds it on the H100: a round is an O(n^2) elementwise pass (the
// two-sided update of A, ~6 n^2 flops, and the column update of V, ~3 n^2)
// and rounds depend on each other, so the 6 (n - 1) rounds of a matrix run
// in sequence. At (48, 96, 96) the work is ~2.3 GFLOP, ~0.034 ms at the
// 67 TFLOP/s f32 peak; what bounds it is the time of a round on the one SM
// that owns the matrix. The design shortens that round:
//
// - Pairs computed, not loaded. Indices are relabelled by the slot
//   permutation's cycle: index 0 keeps label 0, and the indices that slots
//   1, 2, ..., m-1, n-1, n-2, ..., m hold at round 0 take labels 1 ... n-1
//   (cycle positions 0 ... n-2, plus one). In round r (of a sweep) pair t
//   is (p, q) = (0, 1 + u0) for t = 0, else (1 + (u0 + t) mod (n - 1),
//   1 + (u0 - t) mod (n - 1)), with u0 = n - 2 - r; p is the top slot's
//   index (kernels/jacobi_eigh.py:label_pairs; the tests hold it to
//   pair_table). A (and V's columns) is stored in label order, permuted on
//   load and back on store, so a warp over consecutive pairs t reads
//   consecutive labels: no bank conflicts and no pair table.
// - V in its own pass, beside the rounds. A never reads V, so the rounds
//   kernel writes each round's (c, s) to a rotation log (sweeps (n - 1)
//   n/2 float2 a matrix, 219 KB at n = 96) and jacobi_vectors_kernel
//   applies the log to V's rows: rows are independent, so they spread over
//   the card with no block barrier between rounds. The rounds occupy one
//   SM per matrix (48 of 132 at (48, 96, 96)), so the vectors pass runs at
//   the same time on the rest: it is a programmatic dependent launch (the
//   rounds let it start at once) and follows the log through a count of
//   rounds written per matrix, which the rounds publish every
//   PUBLISH_ROUNDS rounds with release semantics and the pass reads with
//   acquire semantics. The pass starts only once every block of the
//   rounds has started (each lets it at its start), so its waiting keeps
//   no rounds block off the card.
// - Each rotation computed once a round: threads t < n/2 compute the
//   round's rotations from A's diagonal into shared memory, a barrier, and
//   every warp updates its row pairs' 2 x 2 blocks in place (A in shared
//   memory up to n = 240, else in a device-memory workspace, L2-resident),
//   a barrier.
//
// On an H100 this took less time than designs with one barrier a round
// (every warp computing every rotation it needs, or the next round's
// rotations computed during the current one, A double-buffered), than
// loading two row pairs' blocks before any store, and than 256 or 1024
// threads (PERF.md). Approximate division and square roots would save a
// few percent and are not taken.

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace basd {

constexpr int JACOBI_THREADS = 512;
constexpr float JACOBI_EPS = 1e-30f;
// a block's shared memory on sm_90 (227 KB)
constexpr int JACOBI_MAX_SMEM = 232448;
// the rounds kernel's variants (kernels/jacobi_eigh.py:ROUNDS_VARIANTS)
enum JacobiRounds { ROUNDS_SMEM = 0, ROUNDS_GLOBAL = 1 };
// the vectors pass: rows of V a warp (lane = row % 8 + 8 (pair group)),
// warps a block, and the pairs a lane rotates between its loads and its
// stores
constexpr int VEC_RPW = 8;
constexpr int VEC_WARPS = 2;
constexpr int VEC_ROWS = VEC_RPW * VEC_WARPS;
constexpr int VEC_BATCH = 12;
// bytes of the rotation log a block of the vectors pass stages at once
constexpr int VEC_LOG_BYTES = 12288;
// the rounds publish their progress to the vectors pass every this many
// rounds (and after the last)
constexpr int PUBLISH_ROUNDS = 16;

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

// The index that label l stands for (kernels/jacobi_eigh.py:label_perm).
__device__ __forceinline__ int label_index(int l, int n) {
  const int m = n / 2;
  if (l == 0) return 0;
  const int k = l - 1;
  return k < m - 1 ? k + 1 : n + m - 2 - k;
}

// Labels (p, q) of pair t in round r of a sweep, p the top slot's.
__device__ __forceinline__ void round_pair(int r, int t, int n, int& p,
                                           int& q) {
  const int L = n - 1;
  const int u0 = n - 2 - r;
  int up = u0 + t;
  if (up >= L) up -= L;
  int uq = u0 - t;
  if (uq < 0) uq += L;
  p = t == 0 ? 0 : 1 + up;
  q = 1 + uq;
}

// Rounds of matrix b whose log is written, as the rounds kernel publishes
// it: an acquire load, so the log entries it covers are visible after it.
__device__ __forceinline__ int progress_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.s32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

// Waits until `need` rounds are published; a count that never comes (a
// rounds kernel that failed) traps after ~2^34 cycles (~10 s) instead of
// hanging the card.
__device__ __forceinline__ void wait_progress(const int* p, int need) {
  const long long start = clock64();
  while (progress_acquire(p) < need) {
    __nanosleep(256);
    if (clock64() - start > (1ll << 34)) __trap();
  }
}

// x' = c x - s y, y' = s x + c y (the compiler fuses a product into the
// sum, as in the rounds' other arithmetic).
__device__ __forceinline__ void rotate(float c, float s, float x, float y,
                                       float& xo, float& yo) {
  xo = c * x - s * y;
  yo = s * x + c * y;
}

// The same with every product rounded before the sum, as the plain version
// (kernels/jacobi_eigh.py) computes it: the vectors pass, which thus
// equals its plain mirror on the same rotation log bit for bit.
__device__ __forceinline__ void rotate_rn(float c, float s, float x, float y,
                                          float& xo, float& yo) {
  xo = __fsub_rn(__fmul_rn(c, x), __fmul_rn(s, y));
  yo = __fadd_rn(__fmul_rn(s, x), __fmul_rn(c, y));
}

// One block per matrix: the rounds of A and the rotation log. Each round,
// the first n/2 threads compute the round's rotations from A's diagonal
// into shared memory (and the log); after a barrier, lane l of every warp
// takes the rotations of column pairs l + 32 j (j < J) and warp w updates
// the 2 x 2 blocks of row pairs w, w + 16, ... in place; a barrier ends
// the round.
template <int J, bool SMEM>
__global__ void __launch_bounds__(JACOBI_THREADS)
    jacobi_rounds_kernel(const float* __restrict__ a_in, float* __restrict__ w_out,
                         float2* __restrict__ log, float* __restrict__ a_ws,
                         int* __restrict__ progress, int n, int sweeps) {
  // let the vectors pass, launched next on the stream, start beside the
  // rounds (programmatic dependent launch): it waits on `progress`
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
  extern __shared__ __align__(16) float smem[];
  const int m = n / 2;
  const int L = n - 1;
  const size_t nn = (size_t)n * n;
  float2* rot = reinterpret_cast<float2*>(smem);
  float* A = SMEM ? smem + 2 * m : a_ws + blockIdx.x * nn;
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  constexpr int WARPS = JACOBI_THREADS / 32;

  const float* src = a_in + blockIdx.x * nn;
  for (size_t i = threadIdx.x; i < nn; i += JACOBI_THREADS) {
    const int l1 = (int)(i / n);
    const int l2 = (int)(i % n);
    A[i] = src[(size_t)label_index(l1, n) * n + label_index(l2, n)];
  }
  __syncthreads();

  float2* lg = log + (size_t)blockIdx.x * sweeps * L * m;
  const int total = sweeps * L;
  int r = 0;  // the round within the sweep
  for (int it = 0; it < total; ++it) {
    for (int t = threadIdx.x; t < m; t += JACOBI_THREADS) {
      int p, q;
      round_pair(r, t, n, p, q);
      float c, s;
      pair_rotation(A[(size_t)p * n + p], A[(size_t)q * n + q],
                    A[(size_t)p * n + q], c, s);
      rot[t] = make_float2(c, s);
      lg[(size_t)it * m + t] = make_float2(c, s);
    }
    __syncthreads();  // the rotations are read before A changes
    // the log entries written before the barrier, device-wide (a release
    // is cumulative: it covers the other threads' writes the barrier
    // ordered before it)
    if (((it + 1) % PUBLISH_ROUNDS == 0 || it + 1 == total) && threadIdx.x == 0) {
      asm volatile("st.release.gpu.global.s32 [%0], %1;" ::"l"(progress + blockIdx.x),
                   "r"(it + 1)
                   : "memory");
    }
    float2 cs[J];
    int pl[J], ql[J];
#pragma unroll
    for (int j = 0; j < J; ++j) {
      const int t = lane + 32 * j;
      cs[j] = make_float2(1.f, 0.f);
      pl[j] = ql[j] = 0;
      if (t < m) {
        round_pair(r, t, n, pl[j], ql[j]);
        cs[j] = rot[t];
      }
    }
    for (int k = warp; k < m; k += WARPS) {
      const float2 ck = rot[k];
      int pk, qk;
      round_pair(r, k, n, pk, qk);
      float* ap = A + (size_t)pk * n;
      float* aq = A + (size_t)qk * n;
#pragma unroll
      for (int j = 0; j < J; ++j) {
        if (lane + 32 * j < m) {
          // A <- J^T A J on the block (rows pk, qk; columns pl, ql):
          // columns first, then rows, as the TPU kernel's (A Jt) then
          // Jt^T (.)
          float b_pp, b_pq, b_qp, b_qq, o_pp, o_qp, o_pq, o_qq;
          rotate(cs[j].x, cs[j].y, ap[pl[j]], ap[ql[j]], b_pp, b_pq);
          rotate(cs[j].x, cs[j].y, aq[pl[j]], aq[ql[j]], b_qp, b_qq);
          rotate(ck.x, ck.y, b_pp, b_qp, o_pp, o_qp);
          rotate(ck.x, ck.y, b_pq, b_qq, o_pq, o_qq);
          ap[pl[j]] = o_pp;
          aq[pl[j]] = o_qp;
          ap[ql[j]] = o_pq;
          aq[ql[j]] = o_qq;
        }
      }
    }
    __syncthreads();
    if (++r == L) r = 0;
  }

  // after whole sweeps every slot holds its own index again; the diagonal
  // goes out in index order (the TPU kernel's, unsorted)
  for (int l = threadIdx.x; l < n; l += JACOBI_THREADS) {
    w_out[blockIdx.x * (size_t)n + label_index(l, n)] = A[(size_t)l * n + l];
  }
}

// V = J_1 J_2 ... J_T from the rotation log. Block (x, b) holds rows
// VEC_ROWS x .. VEC_ROWS x + VEC_ROWS - 1 (labels) of matrix b's V in
// shared memory, starting from the identity's, VEC_RPW rows a warp stored
// label-major (row i's entry l at l VEC_RPW + i); lane (i, g) = (lane %
// VEC_RPW, lane / VEC_RPW) rotates row i at pairs t = g, g + 4, ..., so
// the lanes of a warp touch 4 consecutive pairs of 8 rows: 32 consecutive
// words. It loads VEC_BATCH pairs' entries and rotations, then rotates and
// stores them (the pairs of a round are disjoint; a store may alias a
// later load as far as the compiler knows), stages `chunk` rounds of the log at
// a time (a barrier per chunk) and has only a warp barrier between rounds.
__global__ void __launch_bounds__(VEC_WARPS * 32)
    jacobi_vectors_kernel(const float2* __restrict__ log, float* __restrict__ v_out,
                          const int* __restrict__ progress, int n, int total,
                          int chunk) {
  extern __shared__ __align__(16) float smem[];
  constexpr int THREADS = VEC_WARPS * 32;
  constexpr int GROUPS = 32 / VEC_RPW;
  const int m = n / 2;
  const int L = n - 1;
  float2* lg_s = reinterpret_cast<float2*>(smem);
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int i = lane % VEC_RPW;
  const int g = lane / VEC_RPW;
  const int row = blockIdx.x * VEC_ROWS + warp * VEC_RPW + i;
  float* vr = smem + 2 * (size_t)chunk * m + (size_t)warp * VEC_RPW * n + i;
  for (int l = g; l < n; l += GROUPS) vr[l * VEC_RPW] = l == row ? 1.f : 0.f;
  const float2* lg = log + (size_t)blockIdx.y * total * m;
  for (int c0 = 0; c0 < total; c0 += chunk) {
    const int count = min(chunk, total - c0);
    __syncthreads();  // the previous chunk is consumed
    if (progress != nullptr && threadIdx.x == 0) {
      wait_progress(progress + blockIdx.y, c0 + count);
    }
    __syncthreads();
    // count * m float2 (through L2: another SM wrote them), as float4s
    // where the source is 16-byte aligned
    const float2* src = lg + (size_t)c0 * m;
    if ((reinterpret_cast<uintptr_t>(src) & 15) == 0 && (count * m) % 2 == 0) {
      const float4* src4 = reinterpret_cast<const float4*>(src);
      float4* dst4 = reinterpret_cast<float4*>(lg_s);
#pragma unroll 8
      for (int k = threadIdx.x; k < count * m / 2; k += THREADS) dst4[k] = __ldcg(src4 + k);
    } else {
      for (int k = threadIdx.x; k < count * m; k += THREADS) lg_s[k] = __ldcg(src + k);
    }
    __syncthreads();
    int r = c0 % L;
    for (int q = 0; q < count; ++q) {
      const int u0 = n - 2 - r;
      const float2* cs_r = lg_s + q * m;
      for (int b0 = 0; b0 < m; b0 += GROUPS * VEC_BATCH) {
        float x[VEC_BATCH], y[VEC_BATCH];
        float2 cs[VEC_BATCH];
        int px[VEC_BATCH], py[VEC_BATCH];
#pragma unroll
        for (int k = 0; k < VEC_BATCH; ++k) {
          const int t = b0 + GROUPS * k + g;
          int up = u0 + t;
          if (up >= L) up -= L;
          int uq = u0 - t;
          if (uq < 0) uq += L;
          px[k] = (t == 0 ? 0 : 1 + up) * VEC_RPW;
          py[k] = (1 + uq) * VEC_RPW;
          if (t < m) {
            x[k] = vr[px[k]];
            y[k] = vr[py[k]];
            cs[k] = cs_r[t];
          }
        }
#pragma unroll
        for (int k = 0; k < VEC_BATCH; ++k) {
          const int t = b0 + GROUPS * k + g;
          if (t < m) {
            float xo, yo;
            rotate_rn(cs[k].x, cs[k].y, x[k], y[k], xo, yo);
            vr[px[k]] = xo;
            vr[py[k]] = yo;
          }
        }
      }
      __syncwarp();
      if (++r == L) r = 0;
    }
  }
  if (row < n) {
    float* out = v_out + ((size_t)blockIdx.y * n + label_index(row, n)) * n;
    for (int l = g; l < n; l += GROUPS) out[label_index(l, n)] = vr[l * VEC_RPW];
  }
  // complete after the rounds kernel (its eigenvalues), so that the next
  // launch on the stream sees both
  asm volatile("griddepcontrol.wait;" ::: "memory");
}

// Dynamic shared memory of the rounds kernel's variant: the round's
// rotations, and A in the shared-memory variant.
// kernels/jacobi_eigh.py:rounds_variant mirrors the limit.
inline long long rounds_smem_bytes(int n, int variant) {
  return 4LL * n + (variant == ROUNDS_SMEM ? 4LL * n * n : 0);
}

// Rounds of the log a block of the vectors pass stages at once.
inline int vectors_chunk(int n, int total) {
  const int per = VEC_LOG_BYTES / (8 * (n / 2));
  const int chunk = per < total ? per : total;
  return chunk > 0 ? chunk : 1;
}

template <int J, bool SMEM>
int launch_rounds(const float* a, float* w, float2* log, float* ws, int* progress,
                  int batch, int n, int sweeps, cudaStream_t st) {
  auto kernel = jacobi_rounds_kernel<J, SMEM>;
  const long long smem = rounds_smem_bytes(n, SMEM ? ROUNDS_SMEM : ROUNDS_GLOBAL);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<batch, JACOBI_THREADS, smem, st>>>(a, w, log, ws, progress, n, sweeps);
  return (int)cudaGetLastError();
}

template <bool SMEM>
int launch_rounds_j(int j, const float* a, float* w, float2* log, float* ws,
                    int* progress, int batch, int n, int sweeps, cudaStream_t st) {
  auto go = [&](auto kernel_j) {
    return launch_rounds<decltype(kernel_j)::value, SMEM>(a, w, log, ws, progress,
                                                          batch, n, sweeps, st);
  };
  if (j <= 1) return go(std::integral_constant<int, 1>{});
  if (j <= 2) return go(std::integral_constant<int, 2>{});
  if (j <= 3) return go(std::integral_constant<int, 3>{});
  if (j <= 4) return go(std::integral_constant<int, 4>{});
  if (j <= 8) return go(std::integral_constant<int, 8>{});
  return go(std::integral_constant<int, 16>{});
}

}  // namespace basd

// The rounds. a: (batch, n, n) f32 symmetric, n even, 2 <= n <= 1024;
// w: (batch, n) f32, unsorted; log: (batch, sweeps (n - 1), n / 2) float2;
// ws: (batch, n, n) f32, used by the global variant only (may be null
// otherwise); progress: (batch) int32, zero, the rounds whose log is
// written; variant: kernels/jacobi_eigh.py:rounds_variant's.
extern "C" int basd_jacobi_rounds(const float* a, float* w, void* log, float* ws,
                                  void* progress, int batch, int n, int sweeps,
                                  int variant, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float2* lg = static_cast<float2*>(log);
  int* prog = static_cast<int*>(progress);
  if (n < 2 || n % 2 || n > 1024 || sweeps < 0 || prog == nullptr)
    return (int)cudaErrorInvalidValue;
  if (batch == 0) return 0;
  const int j = (n / 2 + 31) / 32;
  if (variant == basd::ROUNDS_SMEM &&
      basd::rounds_smem_bytes(n, variant) <= basd::JACOBI_MAX_SMEM)
    return basd::launch_rounds_j<true>(j, a, w, lg, ws, prog, batch, n, sweeps,
                                       st);
  if (variant == basd::ROUNDS_GLOBAL && ws != nullptr)
    return basd::launch_rounds_j<false>(j, a, w, lg, ws, prog, batch, n, sweeps,
                                        st);
  return (int)cudaErrorInvalidValue;
}

// The vectors pass. log: (batch, rounds, n / 2) float2 from the rounds;
// v: (batch, n, n) f32, V's columns in the unsorted order of w; progress:
// the rounds' (batch) counts when the rounds launched just before on the
// same stream (the pass then starts beside them, a programmatic dependent
// launch, and waits on the counts), or null for a log already written.
extern "C" int basd_jacobi_vectors(const void* log, float* v, const void* progress,
                                   int batch, int n, int rounds, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n < 2 || n % 2 || rounds < 0) return (int)cudaErrorInvalidValue;
  if (batch == 0) return 0;
  const int chunk = basd::vectors_chunk(n, rounds);
  const long long smem =
      8LL * chunk * (n / 2) + 4LL * basd::VEC_ROWS * n;
  cudaError_t err = cudaFuncSetAttribute(
      basd::jacobi_vectors_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((n + basd::VEC_ROWS - 1) / basd::VEC_ROWS, batch);
  cfg.blockDim = dim3(basd::VEC_WARPS * 32);
  cfg.dynamicSmemBytes = (size_t)smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = progress != nullptr ? 1 : 0;
  err = cudaLaunchKernelEx(&cfg, basd::jacobi_vectors_kernel,
                           static_cast<const float2*>(log), v,
                           static_cast<const int*>(progress), n, rounds, chunk);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
