// K8 converged: batched symmetric eigensolver, cyclic parallel (Brent-Luk)
// Jacobi run to convergence on the card, on Hopper.
//
// K8's rotations (csrc/jacobi_eigh.cu: the pairs of round_pair, one Givens
// rotation per pair from the top slot, the 1e-30 guard; sign(0) = 1), swept
// until a whole sweep finds no pair with |a_pq| > TOL sqrt(|a_pp a_qq|), at
// most MAX_SWEEPS sweeps, eigenvectors accumulated as V <- V J. A pair at or
// under the bar is not rotated (threshold Jacobi); a rotated pair's 2 x 2
// diagonal block takes a_pp - t a_pq, a_qq + t a_pq and exact zeros, and V
// takes each rotation in Rutishauser's form x - s (y + tau x), tau = s / (1
// + c), whose rounding keeps V orthogonal to f32 accuracy over thousands of
// rotations a column (c x - s y loses ~1e-5 at n = 64).
// kernels/converged_eigh.py:converged_eigh_plain is the same in plain
// PyTorch. One launch does the whole call: the input is symmetrised as (A +
// A^T) / 2 on load; a zero row (a principal-angle Gram's beyond its masked
// rank) is an eigenpair (0, e_i) as it stands, and the rotations run on
// the other rows alone, in their order, an odd count padded by a zero row
// and column (its eigenpair never rotates and is dropped); the eigenvalues
// leave sorted ascending (stable over the index) with V's columns in their
// order. No value crosses to the host, so the call runs inside a CUDA-graph
// capture. Full f32 on CUDA cores.
//
// What bounds it on the H100: a round is an O(n^2) pass over A (two-sided,
// ~6 n^2 flops) and V (~3 n^2) that depends on the round before. K8 keeps a
// matrix on one SM: at n = 320, A alone (400 KB) no longer fits its shared
// memory, and its device-memory rounds run at 0.1% of their bound. Here a
// thread-block cluster of C blocks on neighbouring SMs holds one matrix:
//
// - Rows of A move along a ring, a few a round. Index labels as in K8
//   (label_index). In round r pair t is (top, bottom) = (p_t, q_t); block k
//   owns pairs [t_k, t_k+1) and holds the rows of both their slots, so a
//   pair's two rows are local and its 2 x 2 blocks need no other block.
//   From round to round the row at p_t moves to p_t+1 (at p_m-1: q_m-1) and
//   the row at q_t to q_t-1 (at q_0: p_1); label 0 stays. A block's
//   p-slots and q-slots are FIFOs in ring buffers with one spare slot each:
//   a round sends at most two rows to its neighbours' spare slots (np floats
//   each, through distributed shared memory) instead of moving A.
// - Rotations computed everywhere. After its update a block publishes, for
//   each row it holds, a_xx and (where x is the next round's top slot) the
//   a_xy of its next pair into every block's shared memory; once they have
//   all arrived each block computes all n/2 rotations of the next round and
//   the convergence test from the same numbers, so every block takes the
//   same decisions, the stop included, with no further exchange.
// - V's rows are split among the blocks and never move: V <- V J rotates
//   columns, which every block has the rotations for.
// - One cluster barrier a round, V's update between its arrive and its wait
//   (where the blocks would otherwise idle); the published numbers and the
//   rotations double-buffered by round, and a spare slot written one round
//   after its row left. (Asynchronous stores completing on mbarriers, with
//   no barrier, cost as much and gave other bits now and then where two
//   processes shared the card.)
//
// The cluster size C comes from (batch, n) (basd_ceigh_plan): the blocks
// a matrix needs for A and V to fit their shared memory, then more while the
// batch still fills the card in fewer waves.
//
// n is at most 512, where cuSOLVER's own f32 eigh stops using Jacobi
// (syevj) and takes divide and conquer (syevd), ~10x more accurate than f32
// Jacobi and, at (2, 768), 14x faster than these rounds with A and V in
// device memory; the 'xla' route leaves wider matrices to it.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <map>
#include <mutex>
#include <tuple>

namespace cg = cooperative_groups;

namespace basd {
namespace ceigh {

constexpr int THREADS = 512;
constexpr int WARPS = THREADS / 32;
// no rotation where |a_pq| <= this (K8's guard)
constexpr float GUARD = 1e-30f;
// the convergence bar, 2^-21: kernels/converged_eigh.py:TOL says why
constexpr float TOL = 4.76837158203125e-07f;
constexpr int MAX_SWEEPS = 30;
constexpr int MAX_N = 512;
constexpr int MAX_CLUSTER = 16;
// a block's dynamic shared memory on sm_90 (227 KB)
constexpr int SMEM_LIMIT = 232448;
// shared memory a block of a cluster asks for at least, so that no two
// blocks share an SM (an SM has 228 KB)
constexpr int ONE_BLOCK_PER_SM = 116 * 1024;
// the plan's cost model, in shared-memory wavefronts of one block's round:
// the fixed part of a round (exchange, wait, rotations)
constexpr int ROUND_OVERHEAD = 2500;

__host__ __device__ inline int pmod(int x, int y) {
  const int r = x % y;
  return r < 0 ? r + y : r;
}

// n padded to even (n = 1 to 2)
__host__ __device__ inline int padded(int n) { return n < 2 ? 2 : n + (n & 1); }

// first pair of block k of C
__host__ __device__ inline int pair_begin(int k, int m, int C) {
  return k * m / C;
}

// Block k's share: pairs [a, b); its p-slots p_t, t in [pa, b) (P of them;
// p_0 is label 0, in block 0) and q-slots q_t, t in [a, b) (Q); A's rows in
// slots: q-FIFO [0, Q], p-FIFO [Q + 1, Q + P + 1], label 0 at zslot (block
// 0); V's rows [v0, v1).
struct Layout {
  int a, b, pa, P, Q, zslot, rows, v0, v1;
};

__host__ __device__ inline Layout layout(int k, int m, int np, int C) {
  Layout l;
  l.a = pair_begin(k, m, C);
  l.b = pair_begin(k + 1, m, C);
  l.pa = l.a > 1 ? l.a : 1;
  l.P = l.b > l.pa ? l.b - l.pa : 0;
  l.Q = l.b - l.a;
  l.zslot = l.Q + l.P + 2;
  l.rows = l.zslot + (k == 0 ? 1 : 0);
  l.v0 = k * np / C;
  l.v1 = (k + 1) * np / C;
  return l;
}

// the slot of the row at q_t / p_t in round `it` (absolute round count): a
// row enters its FIFO at the head and leaves it at the tail one place a
// round, the FIFO's ring buffer advancing one slot a round
__device__ __forceinline__ int q_slot(const Layout& l, int it, int t) {
  return pmod(it - (l.b - 1 - t), l.Q + 1);
}
__device__ __forceinline__ int p_slot(const Layout& l, int it, int t) {
  return l.Q + 1 + pmod(it - (t - l.pa), l.P + 1);
}

// The index that label l stands for (kernels/jacobi_eigh.py:label_perm).
__device__ __forceinline__ int label_index(int l, int n) {
  const int m = n / 2;
  if (l == 0) return 0;
  const int k = l - 1;
  return k < m - 1 ? k + 1 : n + m - 2 - k;
}

// Labels (p, q) of pair t in round r of a sweep, p the top slot's
// (csrc/jacobi_eigh.cu:round_pair).
__device__ __forceinline__ void round_pair(int r, int t, int n, int& p, int& q) {
  const int L = n - 1;
  const int u0 = n - 2 - r;
  int up = u0 + t;
  if (up >= L) up -= L;
  int uq = u0 - t;
  if (uq < 0) uq += L;
  p = t == 0 ? 0 : 1 + up;
  q = 1 + uq;
}

// Row item i of a block in round `it`: its slot and its label (items: the
// q-slots, the p-slots, label 0).
__device__ __forceinline__ void row_item(const Layout& l, int it, int i, int np,
                                         int& slot, int& label) {
  const int L = np - 1;
  const int u0 = np - 2 - it % L;
  if (i < l.Q) {
    const int t = l.a + i;
    slot = q_slot(l, it, t);
    label = 1 + pmod(u0 - t, L);
  } else if (i < l.Q + l.P) {
    const int t = l.pa + i - l.Q;
    slot = p_slot(l, it, t);
    label = 1 + pmod(u0 + t, L);
  } else {
    slot = l.zslot;
    label = 0;
  }
}

// x' = c x - s y, y' = s x + c y
__device__ __forceinline__ void rotate(float c, float s, float x, float y,
                                       float& xo, float& yo) {
  xo = c * x - s * y;
  yo = s * x + c * y;
}

__device__ __forceinline__ bool less_nan_last(float x, float y) {
  return x < y || (isnan(y) && !isnan(x));
}

// Small arrays at the head of shared memory, in floats, each in two
// buffers by round: the rotations (c, s, tau, t) a pair, the pairs over the
// bar, the published numbers (a float2 a label: a_xx, and a_xy where x is
// the top slot of pair (x, y)); then four int arrays of np: the original
// index of each output column, the original index of each live row, each
// original index's live position (or -1), the label of each live
// position. A and V follow, 16-byte aligned.
__host__ __device__ inline int small_floats(int np) {
  const int m = np / 2;
  const int n = 2 * (4 * m + m + 2 * np) + 4 * np;
  return (n + 3) / 4 * 4;
}

// A block's rows of A and of V at most, over the live counts a matrix of n
// = np may have: at np's layout, or at two or three pairs a block where the
// live rows are fewer than 2 C pairs
__host__ inline void sizes(int np, int C, int& rows_max, int& vrows_max) {
  rows_max = 9;
  vrows_max = 6;
  for (int k = 0; k < C; ++k) {
    const Layout l = layout(k, np / 2, np, C);
    rows_max = rows_max > l.rows ? rows_max : l.rows;
    vrows_max = vrows_max > l.v1 - l.v0 ? vrows_max : l.v1 - l.v0;
  }
}

// One cluster of C blocks per matrix (blockIdx.x = matrix C + rank). J: the
// column pairs a lane takes in a round (m <= 32 J).
template <int J>
__global__ void __launch_bounds__(THREADS, 1)
    cluster_jacobi_kernel(const float* __restrict__ a_in, float* __restrict__ w_out,
                          float* __restrict__ v_out, int* __restrict__ sweeps_out,
                          int n, int ld, int C_launch, int rows_max) {
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ __align__(16) float smem[];
  const int k = (int)cluster.block_rank();
  const int mat = blockIdx.x / C_launch;
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int ml = ld / 2;

  float4* rots = reinterpret_cast<float4*>(smem);
  int* overs = reinterpret_cast<int*>(smem + 8 * ml);
  float2* pub = reinterpret_cast<float2*>(smem + 10 * ml);
  int* inv = reinterpret_cast<int*>(pub + 2 * ld);
  int* live_index = inv + ld;
  int* live_of = live_index + ld;
  int* label_of = live_of + ld;
  float* A = smem + small_floats(ld);
  float* V = A + (size_t)rows_max * ld;

  // The live rows: those with a nonzero entry of (A + A^T) / 2. A zero row
  // is an eigenpair (0, e_i) as it stands; the rotations run on the live
  // rows alone (np of them padded to even, in their order), held by the
  // first C blocks (at least two pairs each); the others (where the live
  // rows are few) take the published numbers and keep step with no rows.
  const float* src = a_in + (size_t)mat * n * n;
  for (int i = warp; i < n; i += WARPS) {
    bool nz = false;
    for (int j = lane; j < n && !nz; j += 32)
      nz = (src[(size_t)i * n + j] + src[(size_t)j * n + i]) * 0.5f != 0.f;
    nz = __any_sync(0xffffffffu, nz);
    if (lane == 0) live_of[i] = nz;
  }
  __syncthreads();
  if (warp == 0) {
    int base = 0;
    for (int i0 = 0; i0 < n; i0 += 32) {
      const int i = i0 + lane;
      const bool nz = i < n && live_of[i];
      const unsigned ballot = __ballot_sync(0xffffffffu, nz);
      const int pos = base + __popc(ballot & ((1u << lane) - 1));
      if (i < n) live_of[i] = nz ? pos : -1;
      if (nz) live_index[pos] = i;
      base += __popc(ballot);
    }
  }
  __syncthreads();
  int live = 0;
  for (int i = 0; i < n; ++i) live += live_of[i] >= 0;
  const int np = padded(live);
  const int m = np / 2;
  const int L = np - 1;
  const int C = m / 2 < C_launch ? (m / 2 > 1 ? m / 2 : 1) : C_launch;
  for (int l = threadIdx.x; l < np; l += THREADS) label_of[label_index(l, np)] = l;

  const bool active = k < C;
  const Layout me = active ? layout(k, m, np, C) : Layout{0, 0, 1, 0, 0, 0, 0, 0, 0};
  const int items = active ? me.Q + me.P + (k == 0 ? 1 : 0) : 0;
  // the neighbours' FIFO sizes, for the rows sent to them
  const int prev_q = active && k > 0 ? layout(k - 1, m, np, C).Q : 0;
  const Layout nb = active && k + 1 < C ? layout(k + 1, m, np, C) : me;

  // the rows of round 0, symmetrised, and V's rows of the identity
  for (int i = warp; i < items; i += WARPS) {
    int slot, label;
    row_item(me, 0, i, np, slot, label);
    const int rc = label_index(label, np);
    const int ri = rc < live ? live_index[rc] : -1;
    float* dst = A + (size_t)slot * ld;
    for (int l = lane; l < np; l += 32) {
      const int cc = label_index(l, np);
      const int ci = cc < live ? live_index[cc] : -1;
      dst[l] = (ri >= 0 && ci >= 0)
                   ? (src[(size_t)ri * n + ci] + src[(size_t)ci * n + ri]) * 0.5f
                   : 0.f;
    }
  }
  for (int rr = me.v0 + warp; rr < me.v1; rr += WARPS) {
    float* dst = V + (size_t)(rr - me.v0) * ld;
    for (int l = lane; l < np; l += 32) dst[l] = label_index(l, np) == rr ? 1.f : 0.f;
  }
  __syncthreads();

  // The departing rows of round `it` (which = 0: q_a's, 1: p_b-1's, if
  // any) and the spare slots of round it + 1 they go to: q_a's to q_a-1
  // (block k - 1's q head) or, from q_0, to p_1 (this block's p head);
  // p_b-1's to p_b (block k + 1's p head) or, from p_m-1, to q_m-1 (this
  // block's q head).
  auto departure = [&](int it, int which, int& src_slot, int& dst_rank, int& dst_slot) {
    const int nx = it + 1;
    if (which == 0) {
      src_slot = q_slot(me, it, me.a);
      if (me.a > 0) {
        dst_rank = k - 1;
        dst_slot = pmod(nx, prev_q + 1);
      } else if (m == 1) {
        dst_rank = k;
        dst_slot = pmod(nx, me.Q + 1);
      } else {
        dst_rank = k;
        dst_slot = me.Q + 1 + pmod(nx, me.P + 1);
      }
    } else {
      src_slot = p_slot(me, it, me.b - 1);
      if (me.b < m) {
        dst_rank = k + 1;
        dst_slot = nb.Q + 1 + pmod(nx, nb.P + 1);
      } else {
        dst_rank = k;
        dst_slot = pmod(nx, me.Q + 1);
      }
    }
  };

  // Publish the rows held in round `it` (after its update, or as loaded)
  // into every block's buffer of round `next`: for each row x, (a_xx, a_xy)
  // where x is that round's top slot of pair (x, y), else (a_xx, 0); with
  // `send`, copy the departing rows to their spare slots of round it + 1.
  // Stores into the other blocks' shared memory, destination-major so that a warp's stores go to one block; the cluster
  // barrier that ends the round makes them visible.
  const int npub = items * C_launch;
  const int vw = np % 4 == 0 ? 4 : 2;
  const int per_row = np / vw;
  auto exchange = [&](int it, int next, bool send) {
    const int nrow = send && active ? per_row * (me.P > 0 ? 2 : 1) : 0;
    for (int e = threadIdx.x; e < nrow; e += THREADS) {
      const int which = e / per_row;
      const int at = (e - which * per_row) * vw;
      int src_slot, dst_rank, dst_slot;
      departure(it, which, src_slot, dst_rank, dst_slot);
      const float* from = A + (size_t)src_slot * ld + at;
      float* to = cluster.map_shared_rank(A, dst_rank) + (size_t)dst_slot * ld + at;
      if (vw == 4) {
        *reinterpret_cast<float4*>(to) = *reinterpret_cast<const float4*>(from);
      } else {
        *reinterpret_cast<float2*>(to) = *reinterpret_cast<const float2*>(from);
      }
    }
    const int un = np - 2 - next % L;
    for (int idx = threadIdx.x; idx < npub; idx += THREADS) {
      const int dst = idx / items;
      const int i = idx - dst * items;
      int slot, x;
      row_item(me, it, i, np, slot, x);
      const float* row = A + (size_t)slot * ld;
      int y = -1;
      if (x == 0) {
        y = 1 + un;
      } else {
        const int d = pmod(x - 1 - un, L);
        if (d >= 1 && d <= m - 1) y = 1 + pmod(un - d, L);
      }
      cluster.map_shared_rank(pub, dst)[(next & 1) * ld + x] =
          make_float2(row[x], y >= 0 ? row[y] : 0.f);
    }
  };

  // the rotations of round `it` from its published numbers; whether any
  // pair was over the bar (the same in every block)
  auto rotations = [&](int it) -> int {
    const int r = it % L;
    float4* rot = rots + (it & 1) * ml;
    int* over = overs + (it & 1) * ml;
    const float2* pb = pub + (it & 1) * ld;
    int any = 0;
    for (int t = threadIdx.x; t < m; t += THREADS) {
      int p, q;
      round_pair(r, t, np, p, q);
      const float2 xp = pb[p];
      const float app = xp.x, aqq = pb[q].x, apq = xp.y;
      const bool ov = fabsf(apq) > TOL * (sqrtf(fabsf(app)) * sqrtf(fabsf(aqq)));
      float c = 1.f, s = 0.f, tau = 0.f, tt = 0.f;
      if (ov) {
        if (fabsf(apq) > GUARD) {
          const float th = (aqq - app) / (2.f * apq);
          // sign(0) = 1: a tie a_pp == a_qq takes the 45-degree rotation
          // (kernels/converged_eigh.py:_rotations)
          const float sg = th >= 0.f ? 1.f : -1.f;
          tt = sg / (fabsf(th) + sqrtf(1.f + th * th));
        }
        c = 1.f / sqrtf(1.f + tt * tt);
        s = tt * c;
        tau = s / (1.f + c);
      }
      rot[t] = make_float4(c, s, tau, tt);
      over[t] = ov;
      any |= ov;
    }
    return __syncthreads_or(any);
  };

  // the column pairs a lane takes in round `it`: labels and rotations
  auto lane_pairs = [&](int it, float* cj, float* sj, float* tj, int* pl, int* ql) {
    const int r = it % L;
    const float4* rot = rots + (it & 1) * ml;
#pragma unroll
    for (int j = 0; j < J; ++j) {
      const int t = lane + 32 * j;
      cj[j] = 1.f;
      sj[j] = tj[j] = 0.f;
      pl[j] = ql[j] = 0;
      if (t < m) {
        round_pair(r, t, np, pl[j], ql[j]);
        const float4 R = rot[t];
        cj[j] = R.x;
        sj[j] = R.y;
        tj[j] = R.z;
      }
    }
  };

  // A <- J^T A J on the block's pairs of rows for round `it`, a warp a pair:
  // a lane loads its 2 x 2 blocks of the pair, then rotates and stores them
  // (no load waits on a store)
  auto update_a = [&](int it) {
    float cj[J], sj[J], tj[J];
    int pl[J], ql[J];
    lane_pairs(it, cj, sj, tj, pl, ql);
    const float4* rot = rots + (it & 1) * ml;
    const int* over = overs + (it & 1) * ml;
    for (int t = me.a + warp; t < me.b; t += WARPS) {
      const int top = t == 0 ? me.zslot : p_slot(me, it, t);
      float* ap = A + (size_t)top * ld;
      float* aq = A + (size_t)q_slot(me, it, t) * ld;
      const float4 rk = rot[t];
      float a_pp[J], a_pq[J], a_qp[J], a_qq[J];
#pragma unroll
      for (int j = 0; j < J; ++j) {
        if (lane + 32 * j < m) {
          a_pp[j] = ap[pl[j]];
          a_pq[j] = ap[ql[j]];
          a_qp[j] = aq[pl[j]];
          a_qq[j] = aq[ql[j]];
        }
      }
#pragma unroll
      for (int j = 0; j < J; ++j) {
        const int tc = lane + 32 * j;
        if (tc >= m) continue;
        if (tc == t) {
          // the pair's own block: a_pp - t a_pq, a_qq + t a_pq, zeros
          if (over[t]) {
            ap[pl[j]] = a_pp[j] - rk.w * a_pq[j];
            aq[ql[j]] = a_qq[j] + rk.w * a_pq[j];
            ap[ql[j]] = 0.f;
            aq[pl[j]] = 0.f;
          }
          continue;
        }
        // columns first, then rows, as K8
        float b_pp, b_pq, b_qp, b_qq, o_pp, o_qp, o_pq, o_qq;
        rotate(cj[j], sj[j], a_pp[j], a_pq[j], b_pp, b_pq);
        rotate(cj[j], sj[j], a_qp[j], a_qq[j], b_qp, b_qq);
        rotate(rk.x, rk.y, b_pp, b_qp, o_pp, o_qp);
        rotate(rk.x, rk.y, b_pq, b_qq, o_pq, o_qq);
        ap[pl[j]] = o_pp;
        aq[pl[j]] = o_qp;
        ap[ql[j]] = o_pq;
        aq[ql[j]] = o_qq;
      }
    }
  };

  // V <- V J on the block's rows of V for round `it` in Rutishauser's form,
  // a warp two rows at a time, loads first
  auto update_v = [&](int it) {
    float cj[J], sj[J], tj[J];
    int pl[J], ql[J];
    lane_pairs(it, cj, sj, tj, pl, ql);
    const int rows = me.v1 - me.v0;
    for (int r0 = 2 * warp; r0 < rows; r0 += 2 * WARPS) {
      float* v0 = V + (size_t)r0 * ld;
      float* v1 = r0 + 1 < rows ? v0 + ld : v0;
      float x0[J], y0[J], x1[J], y1[J];
#pragma unroll
      for (int j = 0; j < J; ++j) {
        if (lane + 32 * j < m) {
          x0[j] = v0[pl[j]];
          y0[j] = v0[ql[j]];
          x1[j] = v1[pl[j]];
          y1[j] = v1[ql[j]];
        }
      }
#pragma unroll
      for (int j = 0; j < J; ++j) {
        if (lane + 32 * j >= m) continue;
        v0[pl[j]] = x0[j] - sj[j] * (y0[j] + tj[j] * x0[j]);
        v0[ql[j]] = y0[j] + sj[j] * (x0[j] - tj[j] * y0[j]);
        if (r0 + 1 < rows) {
          v1[pl[j]] = x1[j] - sj[j] * (y1[j] + tj[j] * x1[j]);
          v1[ql[j]] = y1[j] + sj[j] * (x1[j] - tj[j] * y1[j]);
        }
      }
    }
  };

  cluster.sync();  // every block has started: its shared memory may be written
  exchange(0, 0, false);
  cluster.sync();
  int sweeps = 0;
  int it = 0;
  int sweep_over = rotations(0);
  // A round: A's update; the numbers and rows for the next round sent; V's
  // update (which nothing else reads) between the cluster barrier's arrive
  // and its wait; the next round's rotations.
  for (;; ++it) {
    update_a(it);
    __syncthreads();
    const bool sweep_end = (it + 1) % L == 0;
    const bool stop = sweep_end && (!sweep_over || sweeps + 1 == MAX_SWEEPS);
    exchange(it, it + 1, !stop);
    asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
    update_v(it);
    asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
    if (stop) {
      ++sweeps;
      break;
    }
    if (sweep_end) {
      ++sweeps;
      sweep_over = 0;
    }
    sweep_over |= rotations(it + 1);
  }
  __syncthreads();  // V's last update
  if (!active) return;

  // ascending, stable over the original index: inv[c] is the original
  // index of output column c; a zero row's eigenvalue is 0
  const float2* dfin = pub + ((it + 1) & 1) * ld;
  auto value = [&](int i) {
    const int c = live_of[i];
    return c >= 0 ? dfin[label_of[c]].x : 0.f;
  };
  for (int i = threadIdx.x; i < n; i += THREADS) {
    const float d = value(i);
    int rank = 0;
    for (int i2 = 0; i2 < n; ++i2) {
      const float d2 = value(i2);
      rank += less_nan_last(d2, d) || (!less_nan_last(d, d2) && i2 < i);
    }
    inv[rank] = i;
  }
  __syncthreads();
  if (k == 0) {
    for (int c = threadIdx.x; c < n; c += THREADS) w_out[(size_t)mat * n + c] = value(inv[c]);
    if (threadIdx.x == 0) sweeps_out[mat] = sweeps;
  }
  // a live row of V from the block that holds it (its live position in
  // [v0, v1)), a zero row e_i^T from block i mod C
  for (int rr = warp; rr < n; rr += WARPS) {
    const int c = live_of[rr];
    const bool mine = c >= 0 ? c >= me.v0 && c < me.v1 : rr % C == k;
    if (!mine) continue;
    float* out = v_out + ((size_t)mat * n + rr) * n;
    if (c >= 0) {
      const float* row = V + (size_t)(c - me.v0) * ld;
      for (int cc = lane; cc < n; cc += 32) {
        const int j = live_of[inv[cc]];
        out[cc] = j >= 0 ? row[label_of[j]] : 0.f;
      }
    } else {
      for (int cc = lane; cc < n; cc += 32) out[cc] = inv[cc] == rr ? 1.f : 0.f;
    }
  }
}

struct Plan {
  int cluster, smem, active, rows_max;
};

template <int J>
cudaError_t prepare(const void*& fn) {
  auto kernel = cluster_jacobi_kernel<J>;
  fn = reinterpret_cast<const void*>(kernel);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_LIMIT);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
}

// the kernel of J, its attributes set (m <= MAX_N / 2 = 32 x 8)
inline cudaError_t kernel_for(int m, const void*& fn) {
  const int j = (m + 31) / 32;
  if (j <= 1) return prepare<1>(fn);
  if (j <= 2) return prepare<2>(fn);
  if (j <= 3) return prepare<3>(fn);
  if (j <= 4) return prepare<4>(fn);
  if (j <= 5) return prepare<5>(fn);
  if (j <= 6) return prepare<6>(fn);
  return prepare<8>(fn);
}

inline cudaLaunchConfig_t config(int batch, int C, int smem, cudaStream_t st,
                                 cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)batch * C);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = (size_t)smem;
  cfg.stream = st;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// The plan of cluster size C: shared memory, clusters the card holds at
// once (0 if none, or if a block's rows of A and V do not fit).
inline cudaError_t plan_for(int batch, int np, int C, Plan& p) {
  int rows_max, vrows_max;
  sizes(np, C, rows_max, vrows_max);
  const long long bytes = 4LL * (small_floats(np) + (long long)(rows_max + vrows_max) * np);
  p.cluster = C;
  p.rows_max = rows_max;
  p.smem = p.active = 0;
  if (bytes > SMEM_LIMIT) return cudaSuccess;
  p.smem = (int)bytes;
  if (C > 1 && p.smem < ONE_BLOCK_PER_SM) p.smem = ONE_BLOCK_PER_SM;
  const void* fn;
  cudaError_t err = kernel_for(np / 2, fn);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg = config(batch > 0 ? batch : 1, C, p.smem, 0, attr);
  int active = 0;
  err = cudaOccupancyMaxActiveClusters(&active, fn, &cfg);
  if (err != cudaSuccess) {
    (void)cudaGetLastError();
    active = 0;
  }
  p.active = active;
  return cudaSuccess;
}

// Chooses C (or takes `request` > 0, which may not fit: active 0): the
// least estimated time, waves of clusters the card holds at once times a
// round's cost (ROUND_OVERHEAD plus the shared-memory wavefronts of a
// block's A and V rows).
inline cudaError_t make_plan(int batch, int n, int request, Plan& best) {
  const int np = padded(n);
  const int m = np / 2;
  const int jw = (m + 31) / 32;
  int max_c = m / 2 < MAX_CLUSTER ? m / 2 : MAX_CLUSTER;
  if (max_c < 1) max_c = 1;
  if (request > max_c) return cudaErrorInvalidValue;
  if (request > 0) return plan_for(batch, np, request, best);
  int dev, sms;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  long long best_cost = -1;
  for (int C = 1; C <= max_c; ++C) {
    Plan p;
    err = plan_for(batch, np, C, p);
    if (err != cudaSuccess) return err;
    if (p.active <= 0) continue;
    const long long q = (m + C - 1) / C, v = (np + C - 1) / C;
    const long long work = (8 * q + 4 * v) * jw;
    // a lone block an SM, or blocks sharing one (C = 1)
    const long long slots = C == 1 ? sms : p.active;
    const long long waves = (batch + slots - 1) / slots;
    const long long cost = (waves > 0 ? waves : 1) * (ROUND_OVERHEAD + work);
    if (best_cost < 0 || cost < best_cost) {
      best_cost = cost;
      best = p;
    }
  }
  return best_cost < 0 ? cudaErrorInvalidConfiguration : cudaSuccess;
}

// plans by (device, batch, n, request)
inline cudaError_t cached_plan(int batch, int n, int request, Plan& p) {
  static std::mutex mu;
  static std::map<std::tuple<int, int, int, int>, Plan> plans;
  int dev;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const auto key = std::make_tuple(dev, batch, n, request);
  std::lock_guard<std::mutex> lock(mu);
  auto found = plans.find(key);
  if (found != plans.end()) {
    p = found->second;
    return cudaSuccess;
  }
  err = make_plan(batch, n, request, p);
  if (err == cudaSuccess) plans[key] = p;
  return err;
}

}  // namespace ceigh
}  // namespace basd

// The plan of a call: out[0] the cluster size, out[1] a block's dynamic
// shared memory in bytes, out[2] the clusters the card holds at once.
// request: a cluster size, or 0 for the plan's choice.
extern "C" int basd_ceigh_plan(int batch, int n, int request, void* out) {
  if (n < 1 || n > basd::ceigh::MAX_N || batch < 0 || request < 0)
    return (int)cudaErrorInvalidValue;
  basd::ceigh::Plan p;
  const cudaError_t err = basd::ceigh::cached_plan(batch, n, request, p);
  if (err != cudaSuccess) return (int)err;
  long long* o = static_cast<long long*>(out);
  o[0] = p.cluster;
  o[1] = p.smem;
  o[2] = p.active;
  return 0;
}

// The solve. a: (batch, n, n) f32 (symmetrised on load), 1 <= n <= 512;
// w: (batch, n) f32, ascending; v: (batch, n, n) f32, column c the
// eigenvector of w[c]; sweeps: (batch) int32, the sweeps each matrix took;
// request as basd_ceigh_plan's.
extern "C" int basd_ceigh(const float* a, float* w, float* v, int* sweeps, int batch,
                          int n, int request, void* stream) {
  using namespace basd::ceigh;
  if (n < 1 || n > MAX_N || batch < 0 || request < 0) return (int)cudaErrorInvalidValue;
  if (batch == 0) return 0;
  Plan p;
  cudaError_t err = cached_plan(batch, n, request, p);
  if (err != cudaSuccess) return (int)err;
  if (p.active <= 0) return (int)cudaErrorInvalidConfiguration;
  int np = padded(n);
  const void* fn;
  err = kernel_for(np / 2, fn);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg =
      config(batch, p.cluster, p.smem, static_cast<cudaStream_t>(stream), attr);
  int C = p.cluster, rows = p.rows_max;
  void* args[] = {&a, &w, &v, &sweeps, &n, &np, &C, &rows};
  err = cudaLaunchKernelExC(&cfg, fn, args);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
