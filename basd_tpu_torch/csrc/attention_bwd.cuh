// The backward attention core of the port: per-(image, head) attention
// gradients over a packed (B, N, 3D) qkv slab, shared by K3b
// (csrc/block_train.cu, after its recomputed qkv and dattn GEMMs) and K10b
// (csrc/flash_attention.cu, on the caller's slab), as csrc/attention.cuh's
// forward is shared by K1, K3a, K10a and K10c.
//
// It replaces the attention of basd_tpu/ops/pallas/flash_attention.py
// (_bwd_kernel) and fused_block_attn.py (_bwd_train_kernel), with their
// rounding points:
//   s = scale q k^T (f32), p = exp(s - lse) (f32);
//   flash (K10b): delta = sum f32(do) f32(o) from the saved o,
//     dv = bf16(p)^T do;
//   block (K3b):  o = bf16(p) v (f32), attn = bf16(o),
//     delta = sum f32(dattn) o, do = bf16(dattn), dv = bf16(p)^T do;
//   dp = do v^T, ds = bf16(p (dp - delta) scale), dq = ds k, dk = ds^T q;
// every sum in f32, every output rounded once to the slab's type; block
// mode also writes the f32 column sums of dq, dk and dv per (image, tile)
// into part, which launch_reduce then adds in a fixed order (db_qkv).
//
// What bounds it on the H100: at the student's slab (B=128, N=197, D=192,
// 3 heads) K10b moves ~78 MB (0.0232 ms at 3.35 TB/s) for 10 B N^2 D = 9.5
// GFLOP (0.0096 ms at 989 TFLOP/s); K3b's attention moves ~88 MB (qkv,
// f32 dattn, lse, attn and dqkv: 0.026 ms) for ~18 B N^2 D = 17.2 GFLOP.
// Bytes bind both. The design below recomputes S once more (14 B N^2 D for
// K10b), which costs nothing while bytes bind.
//
// Two kernels per phase, chosen before launch by the slab's type and head
// width (launch_attention_bwd; kernels/block_attn.py:attn_bwd_variant
// mirrors the rule for the wrappers' per-variant launch counts):
// - tensor cores, bf16 slabs with E % 16 == 0 and 16 <= E <= 128 (every
//   preset of models/registry.py has E = 64). Two launches on the stream:
//   * phase A, attn_bwd_q_tc_kernel: one CTA of four warps per (image,
//     head, 64-query tile), each warp 16 query rows whose Q and dO stay in
//     mma A fragments. It walks 64-key blocks of K and V, staged by
//     cp.async into two alternating buffers (rows E + 8 wide, zero-filled
//     past N), computes S = Q K^T and dP = dO V^T with
//     mma.sync.m16n8k16 bf16 -> f32, builds dS in the accumulator registers
//     and packs it straight into the A fragments of dQ += dS K (K through
//     ldmatrix.trans: the m16n8 C layout of two key tiles is the m16k16 A
//     layout, as P.V in the forward). It writes delta (B, H, N) to a
//     workspace: flash from the saved o, block after a first walk over
//     the key blocks that forms o = bf16(p) V (and writes attn).
//   * phase B, attn_bwd_kv_tc_kernel: one CTA per (image, head, 64-key
//     tile) holding its K and V; it walks 64-query blocks of Q, dO, lse and
//     delta (two alternating buffers). Each warp recomputes S and dP for 16
//     query rows with the same function, operands and order as phase A
//     (tc_qk), so every score is bit-identical between the phases, and
//     writes bf16(p) and dS into 64 x 64 shared tiles; each warp then adds
//     dV += P^T dO and dK += dS^T Q for its own 16 keys, reading P^T and
//     dS^T through ldmatrix.trans.
//   Shared memory is fixed (~37 KB and ~75 KB at E = 64), whatever N.
// - CUDA cores, any other even E and every f32 slab (K10b at f32): the
//   same two phases, one block of eight warps per (image, head), one warp
//   per query row (phase A, holding K and V) or per key row (phase B,
//   holding Q and dO), scores as ordered CUDA-core dot products (dot_rows)
//   in both phases. Shared memory grows with N: ~159 KB at f32, N = 257,
//   E = 64.
// No atomics: every cross-block sum is a per-block partial added in a
// fixed order, so two calls on the same inputs give the same bits. Key
// rows >= N score -inf (p = 0); query rows >= N have zero Q and dO, an
// infinite lse and a zero delta, so their p and dS are 0, and are not
// stored.
#pragma once

#include "attention.cuh"

namespace basd {

// One attention backward; pointers not used by a mode are null.
struct AttnBwd {
  const void* qkv;     // (B, N, 3D) in T
  const float* lse;    // (B, H, N) from the forward
  const void* o;       // flash: the saved o (B, N, D) in T
  const void* dout;    // flash: do (B, N, D) in T
  const float* dattn;  // block: dattn (B, N, D) f32
  void* attn;          // block: out, attn (B, N, D) bf16
  void* dqkv;          // out, (B, N, 3D) in T
  float* delta;        // workspace (B, H, N) f32
  float* part;         // block: out, column-sum partials (B * tiles, 3D)
  int B, N, D, H;
  float scale;
};

constexpr int BW_TILE = 64;  // query rows (phase A) or keys (phase B) a CTA
constexpr int BW_THREADS = 128;
constexpr int BW_PLD = BW_TILE + 8;  // row stride of the P and dS tiles

__device__ __forceinline__ float2 unpack_bf16(uint32_t u) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u));
}

// A fragments of the 16 rows r0 = q0 + g, r0 + 8 (g = lane / 4, t = lane %
// 4) of a row-major bf16 matrix with row stride ld, columns col0 ..
// col0 + E; zero for rows >= n.
template <int E>
__device__ __forceinline__ void rows_to_a(uint32_t (&a)[E / 16][4],
                                          const bf16* m, size_t ld, int r0,
                                          int n, int col0, int t) {
  const int r1 = r0 + 8;
#pragma unroll
  for (int kt = 0; kt < E / 16; ++kt) {
    const int c = col0 + kt * 16 + 2 * t;
    a[kt][0] = r0 < n ? load_u32(m + r0 * ld + c) : 0u;
    a[kt][1] = r1 < n ? load_u32(m + r1 * ld + c) : 0u;
    a[kt][2] = r0 < n ? load_u32(m + r0 * ld + c + 8) : 0u;
    a[kt][3] = r1 < n ? load_u32(m + r1 * ld + c + 8) : 0u;
  }
}

// The same from an f32 matrix, each value rounded to bf16.
template <int E>
__device__ __forceinline__ void rows_to_a(uint32_t (&a)[E / 16][4],
                                          const float* m, size_t ld, int r0,
                                          int n, int col0, int t) {
  const int r1 = r0 + 8;
  auto pk = [&](int r, int c) -> uint32_t {
    if (r >= n) return 0u;
    const float2 v = *reinterpret_cast<const float2*>(m + r * ld + c);
    return pack_bf16(v.x, v.y);
  };
#pragma unroll
  for (int kt = 0; kt < E / 16; ++kt) {
    const int c = col0 + kt * 16 + 2 * t;
    a[kt][0] = pk(r0, c);
    a[kt][1] = pk(r1, c);
    a[kt][2] = pk(r0, c + 8);
    a[kt][3] = pk(r1, c + 8);
  }
}

// d[j] = A B^T over the rows 8j .. 8j + 7 of B (j < nt, nt even): A the
// warp's 16 rows as fragments, B rows E + 8 wide in shared memory. Both
// phases compute S and dP with this one function, so their scores agree
// to the bit. Accumulator layout (m16n8): d[j][0..1] at row g, columns
// 8j + 2t + {0, 1}; d[j][2..3] at row g + 8.
template <int E>
__device__ __forceinline__ void tc_qk(float (&d)[BW_TILE / 8][4],
                                      const uint32_t (&a)[E / 16][4],
                                      const bf16* bs, int nt, int lane) {
  constexpr int LDS = E + 8;
  const int mi = lane / 8;
  const int r = lane % 8;
#pragma unroll
  for (int j = 0; j < BW_TILE / 8; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) d[j][i] = 0.f;
#pragma unroll
  for (int jp = 0; jp < BW_TILE / 16; ++jp) {
    if (2 * jp < nt) {
      const bf16* row = bs + (16 * jp + r + (mi / 2) * 8) * LDS + (mi % 2) * 8;
#pragma unroll
      for (int kt = 0; kt < E / 16; ++kt) {
        uint32_t bk[4];
        ldmatrix_x4(bk, row + kt * 16);
        mma_16816(d[2 * jp], a[kt], bk[0], bk[1]);
        mma_16816(d[2 * jp + 1], a[kt], bk[2], bk[3]);
      }
    }
  }
}

// acc[et] += A . B for the k16 step kp: A the fragment pa (packed from
// the accumulators of two 8-column tiles, or read through ldmatrix.trans),
// B the rows 16kp .. 16kp + 15 of a row-major (k, E) matrix in shared
// memory, read through ldmatrix.trans.
template <int E>
__device__ __forceinline__ void tc_acc_pv(float (&acc)[E / 8][4],
                                          const uint32_t (&pa)[4],
                                          const bf16* bs, int kp, int lane) {
  constexpr int LDS = E + 8;
  const int mi = lane / 8;
  const int r = lane % 8;
  // matrices: k rows +0..7 / +8..15 at columns 16ep, then 16ep + 8
  const bf16* row = bs + (16 * kp + r + (mi % 2) * 8) * LDS + (mi / 2) * 8;
#pragma unroll
  for (int ep = 0; ep < E / 16; ++ep) {
    uint32_t bv[4];
    ldmatrix_x4_trans(bv, row + ep * 16);
    mma_16816(acc[2 * ep], pa, bv[0], bv[1]);
    mma_16816(acc[2 * ep + 1], pa, bv[2], bv[3]);
  }
}

// The A fragment of k16 step kp from m16n8 accumulators (rounded to bf16).
__device__ __forceinline__ void pack_a(uint32_t (&pa)[4],
                                       const float (&s)[BW_TILE / 8][4],
                                       int kp) {
  pa[0] = pack_bf16(s[2 * kp][0], s[2 * kp][1]);
  pa[1] = pack_bf16(s[2 * kp][2], s[2 * kp][3]);
  pa[2] = pack_bf16(s[2 * kp + 1][0], s[2 * kp + 1][1]);
  pa[3] = pack_bf16(s[2 * kp + 1][2], s[2 * kp + 1][3]);
}

// p = exp(scale s - lse) for the keys kb + 8j + 2t (+1) of rows g, g + 8:
// keys >= N give 0. The same rounding in both phases.
__device__ __forceinline__ void probs(float (&s)[BW_TILE / 8][4], int kb,
                                      int nt, int N, float scale, float lse0,
                                      float lse1, int t) {
#pragma unroll
  for (int j = 0; j < BW_TILE / 8; ++j) {
    if (j < nt) {
      const int key = kb + 8 * j + 2 * t;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const bool in = key + (i & 1) < N;
        const float sc = in ? __fmul_rn(s[j][i], scale) : -INFINITY;
        s[j][i] = expf(__fsub_rn(sc, i < 2 ? lse0 : lse1));
      }
    }
  }
}

// ds = bf16(p (dp - delta) scale), in place of dp.
__device__ __forceinline__ void dscores(float (&dp)[BW_TILE / 8][4],
                                        const float (&p)[BW_TILE / 8][4],
                                        int nt, float delta0, float delta1,
                                        float scale) {
#pragma unroll
  for (int j = 0; j < BW_TILE / 8; ++j) {
    if (j < nt) {
#pragma unroll
      for (int i = 0; i < 4; ++i)
        dp[j][i] = round_bf(__fmul_rn(
            __fmul_rn(p[j][i], __fsub_rn(dp[j][i], i < 2 ? delta0 : delta1)),
            scale));
    }
  }
}

// Sum of x over the quad of lanes that share a row (g).
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  x += __shfl_xor_sync(0xffffffffu, x, 2);
  return x;
}

// The column sums of a warp's 16 x E accumulator tile (rows g, g + 8 of
// every lane), over the rows: in lanes g == 0 at columns 8et + 2t (+1),
// into cs[0 .. E) of this warp.
template <int E>
__device__ __forceinline__ void warp_col_sums(const float (&acc)[E / 8][4],
                                              float* cs, int lane) {
  const int g = lane / 4;
  const int t = lane % 4;
#pragma unroll
  for (int et = 0; et < E / 8; ++et) {
    float c0 = acc[et][0] + acc[et][2];
    float c1 = acc[et][1] + acc[et][3];
#pragma unroll
    for (int o = 4; o < 32; o <<= 1) {
      c0 += __shfl_xor_sync(0xffffffffu, c0, o);
      c1 += __shfl_xor_sync(0xffffffffu, c1, o);
    }
    if (g == 0) {
      cs[8 * et + 2 * t] = c0;
      cs[8 * et + 2 * t + 1] = c1;
    }
  }
}

// Stores a warp's 16 x E accumulator tile, rows r0 and r0 + 8 (< N), as
// bf16 at out[row * ld + col0 ..].
template <int E>
__device__ __forceinline__ void store_rows(const float (&acc)[E / 8][4],
                                           bf16* out, size_t ld, int r0,
                                           int N, int col0, int t) {
  bf16* o0 = out + r0 * ld + col0 + 2 * t;
  bf16* o1 = o0 + 8 * ld;
#pragma unroll
  for (int et = 0; et < E / 8; ++et) {
    if (r0 < N)
      *reinterpret_cast<__nv_bfloat162*>(o0 + 8 * et) =
          __floats2bfloat162_rn(acc[et][0], acc[et][1]);
    if (r0 + 8 < N)
      *reinterpret_cast<__nv_bfloat162*>(o1 + 8 * et) =
          __floats2bfloat162_rn(acc[et][2], acc[et][3]);
  }
}

// Phase A on tensor cores: attn and delta (block) or delta (flash), dq.
template <bool BLOCK, int E>
__global__ void __launch_bounds__(BW_THREADS)
    attn_bwd_q_tc_kernel(const AttnBwd a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int LDS = E + 8;
  constexpr int KT = E / 16;
  constexpr int ET = E / 8;
  constexpr int CH = E / 8;  // 16-byte chunks per staged row
  constexpr int NJ = BW_TILE / 8;
  constexpr int STAGE = 2 * BW_TILE * LDS;  // K then V of one key block
  bf16* kv = reinterpret_cast<bf16*>(smem_raw);
  float* colsum = reinterpret_cast<float*>(kv + 2 * STAGE);  // [4][E]

  const int N = a.N, D = a.D, H = a.H;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const size_t ld3 = 3 * (size_t)D;
  const bf16* base = static_cast<const bf16*>(a.qkv) + (size_t)b * N * ld3;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const int npad = (N + 15) & ~15;
  const int nblk = (N + BW_TILE - 1) / BW_TILE;

  // K and V of the key block at kb into a stage, rows N..npad-1 zeroed
  auto load_kv = [&](int stage, int kb) {
    bf16* ks = kv + stage * STAGE;
    const int rows = min(BW_TILE, npad - kb);
    for (int i = threadIdx.x; i < 2 * rows * CH; i += BW_THREADS) {
      const int part = i / (rows * CH);  // 0: K, 1: V
      const int n = (i % (rows * CH)) / CH;
      const int c = (i % CH) * 8;
      bf16* dst = ks + part * BW_TILE * LDS + n * LDS + c;
      if (kb + n < N) {
        cp_async16(dst, base + (size_t)(kb + n) * ld3 + (1 + part) * D +
                            h * E + c);
      } else {
        *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
      }
    }
    cp_async_commit();
  };
  load_kv(0, 0);

  const int q0 = blockIdx.x * BW_TILE + warp * 16;
  const bool active = q0 < N;
  const int r0 = q0 + g;
  const int r1 = r0 + 8;
  const float* lse_row = a.lse + (size_t)bh * N;
  const float lse0 = r0 < N ? lse_row[r0] : INFINITY;
  const float lse1 = r1 < N ? lse_row[r1] : INFINITY;
  uint32_t qa[KT][4], da[KT][4];
  rows_to_a<E>(qa, base, ld3, r0, N, h * E, t);
  float delta0 = 0.f, delta1 = 0.f;
  if constexpr (BLOCK) {
    rows_to_a<E>(da, a.dattn + (size_t)b * N * D, D, r0, N, h * E, t);
  } else {
    const size_t off = (size_t)b * N * D;
    const bf16* ob = static_cast<const bf16*>(a.o) + off;
    rows_to_a<E>(da, static_cast<const bf16*>(a.dout) + off, D, r0, N,
                 h * E, t);
    uint32_t oa[KT][4];
    rows_to_a<E>(oa, ob, D, r0, N, h * E, t);
#pragma unroll
    for (int kt = 0; kt < KT; ++kt) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float2 dv = unpack_bf16(da[kt][i]);
        const float2 ov = unpack_bf16(oa[kt][i]);
        const float x = dv.x * ov.x + dv.y * ov.y;
        if (i % 2 == 0) {
          delta0 += x;
        } else {
          delta1 += x;
        }
      }
    }
    delta0 = quad_sum(delta0);
    delta1 = quad_sum(delta1);
    if (t == 0 && active) {
      if (r0 < N) a.delta[(size_t)bh * N + r0] = delta0;
      if (r1 < N) a.delta[(size_t)bh * N + r1] = delta1;
    }
  }

  // block mode walks the key blocks twice: o first, then dq
  const int total = (BLOCK ? 2 : 1) * nblk;
  float acc[ET][4];
#pragma unroll
  for (int et = 0; et < ET; ++et)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[et][i] = 0.f;
  float s[NJ][4], dp[NJ][4];
  for (int it = 0; it < total; ++it) {
    const int blk = it % nblk;
    const bool o_pass = BLOCK && it < nblk;
    const int kb = blk * BW_TILE;
    if (it + 1 < total) {
      load_kv((it + 1) & 1, ((it + 1) % nblk) * BW_TILE);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* ks = kv + (it & 1) * STAGE;
    const bf16* vs = ks + BW_TILE * LDS;
    const int nt = min(BW_TILE, npad - kb) / 8;
    if (active) {
      tc_qk<E>(s, qa, ks, nt, lane);
      probs(s, kb, nt, N, a.scale, lse0, lse1, t);
      if (o_pass) {  // o += bf16(p) V
#pragma unroll
        for (int kp = 0; kp < NJ / 2; ++kp) {
          if (2 * kp < nt) {
            uint32_t pa[4];
            pack_a(pa, s, kp);
            tc_acc_pv<E>(acc, pa, vs, kp, lane);
          }
        }
      } else {  // dP = dO V^T, dS, dQ += dS K
        tc_qk<E>(dp, da, vs, nt, lane);
        dscores(dp, s, nt, delta0, delta1, a.scale);
#pragma unroll
        for (int kp = 0; kp < NJ / 2; ++kp) {
          if (2 * kp < nt) {
            uint32_t pa[4];
            pack_a(pa, dp, kp);
            tc_acc_pv<E>(acc, pa, ks, kp, lane);
          }
        }
      }
    }
    if constexpr (BLOCK) {
      if (o_pass && blk == nblk - 1 && active) {
        // o is complete: attn = bf16(o), delta = sum f32(dattn) o
        const float* dr0 = a.dattn + ((size_t)b * N + r0) * D + h * E + 2 * t;
        const float* dr1 = dr0 + 8 * (size_t)D;
#pragma unroll
        for (int et = 0; et < ET; ++et) {
          if (r0 < N) {
            const float2 v = *reinterpret_cast<const float2*>(dr0 + 8 * et);
            delta0 += v.x * acc[et][0] + v.y * acc[et][1];
          }
          if (r1 < N) {
            const float2 v = *reinterpret_cast<const float2*>(dr1 + 8 * et);
            delta1 += v.x * acc[et][2] + v.y * acc[et][3];
          }
        }
        delta0 = quad_sum(delta0);
        delta1 = quad_sum(delta1);
        if (t == 0) {
          if (r0 < N) a.delta[(size_t)bh * N + r0] = delta0;
          if (r1 < N) a.delta[(size_t)bh * N + r1] = delta1;
        }
        store_rows<E>(acc, static_cast<bf16*>(a.attn) + (size_t)b * N * D,
                      D, r0, N, h * E, t);
#pragma unroll
        for (int et = 0; et < ET; ++et)
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[et][i] = 0.f;
      }
    }
    __syncthreads();  // every warp is done with this stage before its refill
  }

  bf16* dq = static_cast<bf16*>(a.dqkv) + (size_t)b * N * ld3;
  if (active) store_rows<E>(acc, dq, ld3, r0, N, h * E, t);
  if constexpr (BLOCK) {  // the tile's column sums of dq, warps in order
    warp_col_sums<E>(acc, colsum + warp * E, lane);
    __syncthreads();
    float* part = a.part + ((size_t)b * gridDim.x + blockIdx.x) * ld3 + h * E;
    for (int c = threadIdx.x; c < E; c += BW_THREADS)
      part[c] = ((colsum[c] + colsum[E + c]) + colsum[2 * E + c]) +
                colsum[3 * E + c];
  }
}

// Phase B on tensor cores: dk and dv of one 64-key tile.
template <bool BLOCK, int E>
__global__ void __launch_bounds__(BW_THREADS)
    attn_bwd_kv_tc_kernel(const AttnBwd a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int LDS = E + 8;
  constexpr int KT = E / 16;
  constexpr int ET = E / 8;
  constexpr int CH = E / 8;
  constexpr int NJ = BW_TILE / 8;
  constexpr int STAGE = 2 * BW_TILE * LDS;  // Q then dO of one query block
  bf16* ks = reinterpret_cast<bf16*>(smem_raw);
  bf16* vs = ks + BW_TILE * LDS;
  bf16* qd = vs + BW_TILE * LDS;     // two stages
  bf16* pt = qd + 2 * STAGE;         // bf16(p) [query][key]
  bf16* dss = pt + BW_TILE * BW_PLD;  // dS [query][key]
  float* ld_s = reinterpret_cast<float*>(dss + BW_TILE * BW_PLD);  // 2 x (lse, delta)
  float* colsum = ld_s + 4 * BW_TILE;  // [4][2E]

  const int N = a.N, D = a.D, H = a.H;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const size_t ld3 = 3 * (size_t)D;
  const bf16* base = static_cast<const bf16*>(a.qkv) + (size_t)b * N * ld3;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const int mi = lane / 8;
  const int r = lane % 8;
  const int npad = (N + 15) & ~15;
  const int nblk = (N + BW_TILE - 1) / BW_TILE;
  const int k0 = blockIdx.x * BW_TILE;
  const int ntk = min(BW_TILE, npad - k0) / 8;  // 8-key tiles staged

  for (int i = threadIdx.x; i < 2 * ntk * 8 * CH; i += BW_THREADS) {
    const int part = i / (ntk * 8 * CH);  // 0: K, 1: V
    const int n = (i % (ntk * 8 * CH)) / CH;
    const int c = (i % CH) * 8;
    bf16* dst = ks + part * BW_TILE * LDS + n * LDS + c;
    if (k0 + n < N) {
      cp_async16(dst, base + (size_t)(k0 + n) * ld3 + (1 + part) * D + h * E + c);
    } else {
      *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
    }
  }
  cp_async_commit();

  // Q, dO, lse and delta of the query block at qb into a stage
  const float* lse_row = a.lse + (size_t)bh * N;
  const float* delta_row = a.delta + (size_t)bh * N;
  auto load_qd = [&](int stage, int qb) {
    bf16* qs = qd + stage * STAGE;
    bf16* dos = qs + BW_TILE * LDS;
    const int rows = min(BW_TILE, npad - qb);
    for (int i = threadIdx.x; i < 2 * rows * CH; i += BW_THREADS) {
      const int part = i / (rows * CH);  // 0: Q, 1: dO
      const int n = (i % (rows * CH)) / CH;
      const int c = (i % CH) * 8;
      const int row = qb + n;
      bf16* dst = (part ? dos : qs) + n * LDS + c;
      if (row >= N) {
        *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
      } else if (part == 0) {
        cp_async16(dst, base + (size_t)row * ld3 + h * E + c);
      } else if constexpr (BLOCK) {  // bf16(dattn), rounded on the way
        const float* src = a.dattn + ((size_t)b * N + row) * D + h * E + c;
        const float4 x0 = *reinterpret_cast<const float4*>(src);
        const float4 x1 = *reinterpret_cast<const float4*>(src + 4);
        *reinterpret_cast<uint4*>(dst) =
            make_uint4(pack_bf16(x0.x, x0.y), pack_bf16(x0.z, x0.w),
                       pack_bf16(x1.x, x1.y), pack_bf16(x1.z, x1.w));
      } else {
        cp_async16(dst, static_cast<const bf16*>(a.dout) +
                            ((size_t)b * N + row) * D + h * E + c);
      }
    }
    float* ls = ld_s + stage * 2 * BW_TILE;
    for (int i = threadIdx.x; i < BW_TILE; i += BW_THREADS) {
      const int row = qb + i;
      ls[i] = row < N ? lse_row[row] : INFINITY;
      ls[BW_TILE + i] = row < N ? delta_row[row] : 0.f;
    }
    cp_async_commit();
  };
  load_qd(0, 0);

  float dk[ET][4], dv[ET][4];
#pragma unroll
  for (int et = 0; et < ET; ++et)
#pragma unroll
    for (int i = 0; i < 4; ++i) dk[et][i] = dv[et][i] = 0.f;
  float s[NJ][4], dp[NJ][4];
  for (int it = 0; it < nblk; ++it) {
    const int qb = it * BW_TILE;
    if (it + 1 < nblk) {
      load_qd((it + 1) & 1, qb + BW_TILE);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* qs = qd + (it & 1) * STAGE;
    const bf16* dos = qs + BW_TILE * LDS;
    const float* ls = ld_s + (it & 1) * 2 * BW_TILE;
    const int nq = min(BW_TILE, npad - qb);  // query rows staged

    // this warp's 16 query rows against the tile's keys: p and dS
    if (16 * warp < nq) {
      uint32_t qa[KT][4], da[KT][4];
      const bf16* qrow = qs + (16 * warp + r + (mi % 2) * 8) * LDS + (mi / 2) * 8;
      const bf16* drow = dos + (16 * warp + r + (mi % 2) * 8) * LDS + (mi / 2) * 8;
#pragma unroll
      for (int kt = 0; kt < KT; ++kt) {
        ldmatrix_x4(qa[kt], qrow + kt * 16);
        ldmatrix_x4(da[kt], drow + kt * 16);
      }
      const int lr0 = 16 * warp + g;
      tc_qk<E>(s, qa, ks, ntk, lane);
      probs(s, k0, ntk, N, a.scale, ls[lr0], ls[lr0 + 8], t);
      tc_qk<E>(dp, da, vs, ntk, lane);
      dscores(dp, s, ntk, ls[BW_TILE + lr0], ls[BW_TILE + lr0 + 8], a.scale);
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        if (j < ntk) {
          const int c = 8 * j + 2 * t;
          *reinterpret_cast<__nv_bfloat162*>(pt + lr0 * BW_PLD + c) =
              __floats2bfloat162_rn(s[j][0], s[j][1]);
          *reinterpret_cast<__nv_bfloat162*>(pt + (lr0 + 8) * BW_PLD + c) =
              __floats2bfloat162_rn(s[j][2], s[j][3]);
          *reinterpret_cast<__nv_bfloat162*>(dss + lr0 * BW_PLD + c) =
              __floats2bfloat162_rn(dp[j][0], dp[j][1]);
          *reinterpret_cast<__nv_bfloat162*>(dss + (lr0 + 8) * BW_PLD + c) =
              __floats2bfloat162_rn(dp[j][2], dp[j][3]);
        }
      }
    }
    __syncthreads();

    // this warp's 16 keys: dV += P^T dO, dK += dS^T Q
    if (16 * warp < ntk * 8) {
      for (int kq = 0; kq < nq / 16; ++kq) {
        // P^T and dS^T fragments: matrices (queries +0 / +8) x (keys +0 / +8)
        const int off = (16 * kq + (mi / 2) * 8 + r) * BW_PLD + 16 * warp +
                        (mi % 2) * 8;
        uint32_t pa[4], sa[4];
        ldmatrix_x4_trans(pa, pt + off);
        ldmatrix_x4_trans(sa, dss + off);
        tc_acc_pv<E>(dv, pa, dos, kq, lane);
        tc_acc_pv<E>(dk, sa, qs, kq, lane);
      }
    }
    __syncthreads();  // the tiles and this stage are free again
  }

  const int key0 = k0 + 16 * warp + g;
  if (16 * warp < ntk * 8) {
    bf16* out = static_cast<bf16*>(a.dqkv) + (size_t)b * N * ld3;
    store_rows<E>(dk, out, ld3, key0, N, D + h * E, t);
    store_rows<E>(dv, out, ld3, key0, N, 2 * D + h * E, t);
  }
  if constexpr (BLOCK) {  // the tile's column sums of dk and dv
    warp_col_sums<E>(dk, colsum + warp * 2 * E, lane);
    warp_col_sums<E>(dv, colsum + warp * 2 * E + E, lane);
    __syncthreads();
    float* part = a.part + ((size_t)b * gridDim.x + blockIdx.x) * ld3 + h * E;
    for (int c = threadIdx.x; c < 2 * E; c += BW_THREADS) {
      const float v = ((colsum[c] + colsum[2 * E + c]) + colsum[4 * E + c]) +
                      colsum[6 * E + c];
      part[(1 + c / E) * D + c % E] = v;
    }
  }
}

// ---- CUDA-core kernels (f32, and bf16 at other even head widths) ------

constexpr int BW_SIMT_THREADS = 256;

// Phase A on CUDA cores, one block per (image, head), one warp per query
// row: K and V in shared memory (rows e + 2 wide), the warp's q and do
// rows, two f32 rows of N (p, then ds; dp) and the column sums of dq.
template <bool BLOCK, typename T>
__global__ void attn_bwd_q_simt_kernel(const AttnBwd a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int N = a.N, D = a.D, H = a.H;
  const int e = D / H;
  const int ldk = e + 2;
  const int nwarps = blockDim.x / 32;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  T* ks = reinterpret_cast<T*>(smem_raw);
  T* vs = ks + N * ldk;
  T* q_row = vs + N * ldk + warp * 2 * ldk;
  T* do_row = q_row + ldk;
  float* rows = reinterpret_cast<float*>(vs + N * ldk + nwarps * 2 * ldk);
  float* row_a = rows + warp * 2 * N;
  float* row_b = row_a + N;
  float* colp = rows + nwarps * 2 * N;  // e per warp

  const int b = blockIdx.x / H;
  const int h = blockIdx.x % H;
  const int bh = blockIdx.x;
  const size_t ld3 = 3 * (size_t)D;
  const T* base = static_cast<const T*>(a.qkv) + (size_t)b * N * ld3;
  for (int i = threadIdx.x; i < N * e; i += blockDim.x) {
    const int n = i / e;
    const int c = i % e;
    ks[n * ldk + c] = base[n * ld3 + D + h * e + c];
    vs[n * ldk + c] = base[n * ld3 + 2 * D + h * e + c];
  }
  for (int i = threadIdx.x; i < nwarps * e; i += blockDim.x) colp[i] = 0.f;
  __syncthreads();

  float* cp = colp + warp * e;
  T* dq = static_cast<T*>(a.dqkv);
  for (int i = warp; i < N; i += nwarps) {
    const size_t row = (size_t)b * N + i;
    for (int c = lane; c < e; c += 32) {
      q_row[c] = base[(size_t)i * ld3 + h * e + c];
      if constexpr (BLOCK) {
        do_row[c] = from_f<T>(a.dattn[row * D + h * e + c]);
      } else {
        do_row[c] = static_cast<const T*>(a.dout)[row * D + h * e + c];
      }
    }
    __syncwarp();
    const float lse_i = a.lse[(size_t)bh * N + i];
    for (int j = lane; j < N; j += 32) {
      const float s = __fmul_rn(dot_rows(q_row, ks + j * ldk, e), a.scale);
      row_a[j] = expf(__fsub_rn(s, lse_i));
      row_b[j] = dot_rows(do_row, vs + j * ldk, e);
    }
    __syncwarp();
    float dpart = 0.f;
    if constexpr (BLOCK) {  // o = bf16(p) v -> attn; delta = sum dattn o
      for (int c2 = lane; c2 < e / 2; c2 += 32) {
        float a0 = 0.f, a1 = 0.f;
        for (int j = 0; j < N; ++j) {
          const float pb = round_t<T>(row_a[j]);
          const float2 v = load2(vs + j * ldk + 2 * c2);
          a0 += pb * v.x;
          a1 += pb * v.y;
        }
        T* o = static_cast<T*>(a.attn) + row * D + h * e + 2 * c2;
        o[0] = from_f<T>(a0);
        o[1] = from_f<T>(a1);
        dpart += a.dattn[row * D + h * e + 2 * c2] * a0 +
                 a.dattn[row * D + h * e + 2 * c2 + 1] * a1;
      }
    } else {  // delta = sum f32(do) f32(o) from the saved o
      const T* o = static_cast<const T*>(a.o) + row * D + h * e;
      for (int c = lane; c < e; c += 32) dpart += to_f(do_row[c]) * to_f(o[c]);
    }
    const float delta = warp_sum(dpart);
    if (lane == 0) a.delta[(size_t)bh * N + i] = delta;
    for (int j = lane; j < N; j += 32) {
      row_a[j] = round_t<T>(
          __fmul_rn(__fmul_rn(row_a[j], __fsub_rn(row_b[j], delta)), a.scale));
    }
    __syncwarp();
    for (int c2 = lane; c2 < e / 2; c2 += 32) {
      float a0 = 0.f, a1 = 0.f;
      for (int j = 0; j < N; ++j) {
        const float ds = row_a[j];
        const float2 k = load2(ks + j * ldk + 2 * c2);
        a0 += ds * k.x;
        a1 += ds * k.y;
      }
      dq[row * ld3 + h * e + 2 * c2] = from_f<T>(a0);
      dq[row * ld3 + h * e + 2 * c2 + 1] = from_f<T>(a1);
      cp[2 * c2] += a0;
      cp[2 * c2 + 1] += a1;
    }
    __syncwarp();
  }
  if constexpr (BLOCK) {  // this image's column sums of dq, warps in order
    __syncthreads();
    for (int c = threadIdx.x; c < e; c += blockDim.x) {
      float acc = 0.f;
      for (int w = 0; w < nwarps; ++w) acc += colp[w * e + c];
      a.part[(size_t)b * ld3 + h * e + c] = acc;
    }
  }
}

// Phase B on CUDA cores, one block per (image, head), one warp per key
// row: Q and dO in shared memory, lse and delta, the warp's k and v rows,
// two f32 rows of N (bf16(p); ds) and the column sums of dk and dv.
template <bool BLOCK, typename T>
__global__ void attn_bwd_kv_simt_kernel(const AttnBwd a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int N = a.N, D = a.D, H = a.H;
  const int e = D / H;
  const int ldk = e + 2;
  const int nwarps = blockDim.x / 32;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  T* qs = reinterpret_cast<T*>(smem_raw);
  T* dos = qs + N * ldk;
  float* lse_s = reinterpret_cast<float*>(dos + N * ldk);
  float* delta_s = lse_s + N;
  T* k_row = reinterpret_cast<T*>(delta_s + N) + warp * 2 * ldk;
  T* v_row = k_row + ldk;
  float* rows =
      reinterpret_cast<float*>(reinterpret_cast<T*>(delta_s + N) + nwarps * 2 * ldk);
  float* row_a = rows + warp * 2 * N;
  float* row_b = row_a + N;
  float* colp = rows + nwarps * 2 * N;  // 2e per warp

  const int b = blockIdx.x / H;
  const int h = blockIdx.x % H;
  const int bh = blockIdx.x;
  const size_t ld3 = 3 * (size_t)D;
  const T* base = static_cast<const T*>(a.qkv) + (size_t)b * N * ld3;
  for (int i = threadIdx.x; i < N * e; i += blockDim.x) {
    const int n = i / e;
    const int c = i % e;
    const size_t row = (size_t)b * N + n;
    qs[n * ldk + c] = base[n * ld3 + h * e + c];
    if constexpr (BLOCK) {
      dos[n * ldk + c] = from_f<T>(a.dattn[row * D + h * e + c]);
    } else {
      dos[n * ldk + c] = static_cast<const T*>(a.dout)[row * D + h * e + c];
    }
  }
  for (int i = threadIdx.x; i < N; i += blockDim.x) {
    lse_s[i] = a.lse[(size_t)bh * N + i];
    delta_s[i] = a.delta[(size_t)bh * N + i];
  }
  for (int i = threadIdx.x; i < nwarps * 2 * e; i += blockDim.x) colp[i] = 0.f;
  __syncthreads();

  float* cp = colp + warp * 2 * e;
  T* dkv = static_cast<T*>(a.dqkv);
  for (int j = warp; j < N; j += nwarps) {
    for (int c = lane; c < e; c += 32) {
      k_row[c] = base[(size_t)j * ld3 + D + h * e + c];
      v_row[c] = base[(size_t)j * ld3 + 2 * D + h * e + c];
    }
    __syncwarp();
    for (int i = lane; i < N; i += 32) {
      const float s = __fmul_rn(dot_rows(qs + i * ldk, k_row, e), a.scale);
      const float p = expf(__fsub_rn(s, lse_s[i]));
      const float dp = dot_rows(dos + i * ldk, v_row, e);
      row_a[i] = round_t<T>(p);
      row_b[i] = round_t<T>(
          __fmul_rn(__fmul_rn(p, __fsub_rn(dp, delta_s[i])), a.scale));
    }
    __syncwarp();
    const size_t krow = ((size_t)b * N + j) * ld3 + h * e;
    for (int c2 = lane; c2 < e / 2; c2 += 32) {
      float k0 = 0.f, k1 = 0.f, v0 = 0.f, v1 = 0.f;
      for (int i = 0; i < N; ++i) {
        const float ds = row_b[i];
        const float pb = row_a[i];
        const float2 q = load2(qs + i * ldk + 2 * c2);
        const float2 d = load2(dos + i * ldk + 2 * c2);
        k0 += ds * q.x;
        k1 += ds * q.y;
        v0 += pb * d.x;
        v1 += pb * d.y;
      }
      dkv[krow + D + 2 * c2] = from_f<T>(k0);
      dkv[krow + D + 2 * c2 + 1] = from_f<T>(k1);
      dkv[krow + 2 * D + 2 * c2] = from_f<T>(v0);
      dkv[krow + 2 * D + 2 * c2 + 1] = from_f<T>(v1);
      cp[2 * c2] += k0;
      cp[2 * c2 + 1] += k1;
      cp[e + 2 * c2] += v0;
      cp[e + 2 * c2 + 1] += v1;
    }
    __syncwarp();
  }
  if constexpr (BLOCK) {  // this image's column sums of dk, dv
    __syncthreads();
    for (int c = threadIdx.x; c < 2 * e; c += blockDim.x) {
      float acc = 0.f;
      for (int w = 0; w < nwarps; ++w) acc += colp[w * 2 * e + c];
      a.part[(size_t)b * ld3 + (1 + c / e) * D + h * e + c % e] = acc;
    }
  }
}

// ---- launch ------------------------------------------------------------

// Dynamic shared memory of the two phases, bytes (kernels/block_attn.py:
// _attn_bwd_smem computes the larger of the two, phase B's).
inline size_t attn_bwd_tc_smem(int e, bool phase_b) {
  const size_t lds = e + 8;
  if (!phase_b) return 4 * BW_TILE * lds * 2 + 4 * (size_t)e * 4;
  return 6 * BW_TILE * lds * 2 + 2 * BW_TILE * BW_PLD * 2 + 4 * BW_TILE * 4 +
         8 * (size_t)e * 4;
}
inline size_t attn_bwd_simt_smem(int N, int e, size_t itemsize, bool phase_b) {
  const int warps = BW_SIMT_THREADS / 32;
  const size_t ldk = e + 2;
  const size_t common = 2 * N * ldk * itemsize + warps * 2 * ldk * itemsize +
                        (size_t)warps * 2 * N * 4;
  if (!phase_b) return common + (size_t)warps * e * 4;
  return common + 2 * (size_t)N * 4 + (size_t)warps * 2 * e * 4;
}

template <typename K>
static int set_smem(K kernel, size_t bytes) {
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <bool BLOCK, int E>
static int launch_attention_bwd_tc(const AttnBwd& a, cudaStream_t st) {
  const size_t sa = attn_bwd_tc_smem(E, false);
  const size_t sb = attn_bwd_tc_smem(E, true);
  int rc = set_smem(attn_bwd_q_tc_kernel<BLOCK, E>, sa);
  if (rc) return rc;
  rc = set_smem(attn_bwd_kv_tc_kernel<BLOCK, E>, sb);
  if (rc) return rc;
  const dim3 grid((a.N + BW_TILE - 1) / BW_TILE, a.B * a.H);
  attn_bwd_q_tc_kernel<BLOCK, E><<<grid, BW_THREADS, sa, st>>>(a);
  BASD_CHECK_LAUNCH();
  attn_bwd_kv_tc_kernel<BLOCK, E><<<grid, BW_THREADS, sb, st>>>(a);
  BASD_CHECK_LAUNCH();
  return 0;
}

// launch_attention_bwd_tc<BLOCK, E> for the runtime head width e, one of
// 16, 32, ..., 128.
template <bool BLOCK, int E = 16>
static int launch_attention_bwd_tc_e(int e, const AttnBwd& a,
                                     cudaStream_t st) {
  if constexpr (E <= 128) {
    if (e == E) return launch_attention_bwd_tc<BLOCK, E>(a, st);
    return launch_attention_bwd_tc_e<BLOCK, E + 16>(e, a, st);
  } else {
    return (int)cudaErrorInvalidValue;
  }
}

// The attention backward of the slab, phase A then phase B on the stream:
// the tensor-core kernels for a bf16 slab whose head width they take (its
// rows, and flash's do, must start 16-byte aligned), the CUDA-core ones
// otherwise. Decided here, before any launch. Block mode writes its column
// sums into *part_rows rows of a.part (B * 64-query tiles, or B).
template <bool BLOCK, typename T>
static int launch_attention_bwd(const AttnBwd& a, int* part_rows,
                                cudaStream_t st) {
  const int e = a.D / a.H;
  if constexpr (std::is_same_v<T, bf16>) {
    if (attention_tc_ok(e)) {
      if (!vec_ok(a.qkv, 3 * a.D) || (!BLOCK && !vec_ok(a.dout, a.D)))
        return (int)cudaErrorMisalignedAddress;
      if (a.B * a.H > 65535) return (int)cudaErrorInvalidConfiguration;
      if (part_rows) *part_rows = a.B * ((a.N + BW_TILE - 1) / BW_TILE);
      return launch_attention_bwd_tc_e<BLOCK>(e, a, st);
    }
  }
  const size_t sa = attn_bwd_simt_smem(a.N, e, sizeof(T), false);
  const size_t sb = attn_bwd_simt_smem(a.N, e, sizeof(T), true);
  int rc = set_smem(attn_bwd_q_simt_kernel<BLOCK, T>, sa);
  if (rc) return rc;
  rc = set_smem(attn_bwd_kv_simt_kernel<BLOCK, T>, sb);
  if (rc) return rc;
  if (part_rows) *part_rows = a.B;
  attn_bwd_q_simt_kernel<BLOCK, T><<<a.B * a.H, BW_SIMT_THREADS, sa, st>>>(a);
  BASD_CHECK_LAUNCH();
  attn_bwd_kv_simt_kernel<BLOCK, T><<<a.B * a.H, BW_SIMT_THREADS, sb, st>>>(a);
  BASD_CHECK_LAUNCH();
  return 0;
}

}  // namespace basd
