// K9: the three integer line shifts of the TrivialAugmentWide geometric
// ops (shear x/y, translate x/y, rotate by three shears) on Hopper, each
// image held in shared memory.
//
// Replaces basd_tpu/ops/pallas/geom_shift.py:geom_shift3 (_geom_kernel):
// rows by r1, then columns by r2, then rows by r3, each with zero fill,
//     pass 1: out[y, x] = in[y, x - r1[y]]
//     pass 2: out[y, x] = in[y - r2[x], x]
//     pass 3: out[y, x] = in[y, x - r3[y]]
// and, folded in, the 180-degree pre-flip of the rotations beyond 90
// degrees that the reference does in XLA before its kernel
// (basd_tpu/data/augment.py:352-354): with big[g] set, image g is read at
// (H-1-y, W-1-x). Pure data movement, so the result is the reference's to
// the bit for any element type.
//
// What bounds it on the H100: one read and one write of the image slab
// and nothing else (the shift tables are 2.7 KB an image). At the train
// step's geometric slice, (46, 224, 224, 3) uint8, that is 6.9 MB each
// way, 4.1 us at 3.35 TB/s; at a whole batch of 128, 11.5 us.
//
// The TPU kernel keeps a block of channel-folded planes in VMEM and runs
// three 8-step roll-and-select cascades there. Here each output pixel
// composes the three passes backwards into one source pixel,
//     x1 = xo - r3[yo];  y2 = yo - r2[x1];  x3 = x1 - r1[y2]
// (zero where any pass filled), and reads that pixel's C elements:
// - Variant SMEM: a CTA of 32 warps holds its image in shared memory
//   (150,528 bytes at 224 px, 3 channels, uint8), brought in by bulk
//   copies (cp.async.bulk ... mbarrier::complete_tx) whose bytes complete
//   one mbarrier; the image starts at the source's address mod 16, so a
//   ragged head or tail (an image size or base not a multiple of 16)
//   takes plain loads. The shift tables sit beside it.
// - A warp takes a chunk of an output row at a time, up to 7 segments of
//   32 pixels (a 224 px row is one chunk), a lane a pixel of each
//   segment: consecutive lanes read consecutive table entries and, where
//   the shifts are locally constant, consecutive source pixels. The chain
//   of each pixel (two dependent table reads, then the pixel) is run for
//   all 7 segments a step at a time, without branches (an index is
//   clamped to 0 where a pass filled), so 7 reads are in flight where one
//   would be. The lanes write their pixels into the warp's staging buffer;
//   the warp then stores the chunk with 16-byte stores (st.global.v4)
//   where the output rows are 16-byte aligned, element by element
//   otherwise.
// - The channel count is a compile-time 1 or 3 (else a runtime C) and
//   the element a 1-, 2-, 4- or 8-byte integer (any dtype moves as its
//   bits), so pixel -> element offsets are multiplies and shifts.
// - The card is filled by `split` CTAs an image, each holding the whole
//   image (L2 serves the repeated read) and writing 1/split of the output
//   rows (geom_shift.py:geom_shift3_split: at 46 images 2, a CTA pair on
//   92 of the 132 SMs).
// - Variant GLOBAL, for images that do not fit a CTA's shared memory
//   (e.g. 320 px), reads the source pixels from device memory with the
//   same composition, tables in shared memory and staged row stores.
// Tried and not kept (PERF.md, PR 10): an image's rows split over a
// thread-block cluster, read through distributed shared memory (slower at
// every split); rows padded to an odd number of words against bank
// conflicts, loaded by every thread; a 3-channel pixel held as one word.
//
// Every entry returns the first non-zero cudaGetLastError() after its
// launch, or 0. Nothing here allocates or synchronises.

#include <cuda_runtime.h>
#include <stdint.h>

#include "wgmma.cuh"  // smem_u32 and the mbarrier helpers

namespace basd {
namespace geom {

constexpr int WARPS = 32;
constexpr int THREADS = 32 * WARPS;
constexpr int SEGS = 7;             // 32-pixel segments of a warp's chunk:
constexpr int CHUNK = 32 * SEGS;    // a 224 px row is one chunk
constexpr int SMEM_LIMIT = 232448;  // a block's dynamic shared memory, sm_90
constexpr int COPY_CHUNK = 16384;   // bytes a bulk copy

enum Variant { SMEM = 0, GLOBAL = 1 };

struct Args {
  const uint8_t* x;  // (G, H, W, C) elements of `esize` bytes
  const int* r1;     // (G, H)
  const int* r2;     // (G, W)
  const int* r3;     // (G, H)
  const uint8_t* big;  // (G,) or null
  uint8_t* out;        // (G, H, W, C)
  int h, w, c, esize;
  int rows_part;  // output rows of a CTA
  int vec;        // output rows 16-byte aligned: staged chunks as uint4
};

__host__ __device__ inline long long round16(long long v) {
  return (v + 15) & ~15LL;
}

// The layout of a CTA's shared memory (mirrored by geom_shift.py:
// smem_bytes): the mbarrier, the tables r3, r2, r1 (int32), the warps'
// staging (a chunk of CHUNK pixels each), then, in variant SMEM, the
// image, starting at the source's address mod 16.
__host__ __device__ inline long long stage_off(int h, int w) {
  return round16(16 + 4LL * (2LL * h + w));
}
__host__ __device__ inline long long stage_bytes(int c, int esize) {
  return round16((long long)CHUNK * c * esize);
}
__host__ __device__ inline long long image_off(int h, int w, int c, int esize) {
  return stage_off(h, w) + WARPS * stage_bytes(c, esize);
}
__host__ __device__ inline long long smem_bytes(int h, int w, int c, int esize,
                                                int image_rows) {
  return image_off(h, w, c, esize) + 16 +
         (long long)image_rows * w * c * esize;
}

// Copies n bytes at src into shared memory at dst (dst = src mod 16): the
// 16-byte-aligned middle by bulk copies whose bytes complete phase 0 of
// `bar` (thread 0 arms it and issues them), the ragged ends by plain
// loads. Every thread of the CTA calls it.
__device__ void load_bytes(uint8_t* dst, const uint8_t* src, long long n,
                           uint64_t* bar) {
  const long long head =
      min(n, (long long)((16 - (reinterpret_cast<uintptr_t>(src) & 15)) & 15));
  const long long body = (n - head) & ~15LL;
  if (threadIdx.x == 0) {
    sm90::mbar_expect_tx(bar, (int)body);
    for (long long off = head; off < head + body; off += COPY_CHUNK) {
      const int bytes = (int)min((long long)COPY_CHUNK, head + body - off);
      asm volatile(
          "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
          "[%0], [%1], %2, [%3];\n" ::"r"(sm90::smem_u32(dst + off)),
          "l"(src + off), "r"(bytes), "r"(sm90::smem_u32(bar))
          : "memory");
    }
  }
  for (long long i = threadIdx.x; i < head; i += THREADS) dst[i] = src[i];
  for (long long i = head + body + threadIdx.x; i < n; i += THREADS)
    dst[i] = src[i];
}

// One CTA: output rows [blockIdx.x * rows_part, ...) of image blockIdx.y.
template <typename T, int CC, int VARIANT>
__global__ void __launch_bounds__(THREADS, 1)
    geom_shift3_kernel(const Args a) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int h = a.h, w = a.w;
  const int c = CC ? CC : a.c;
  const int g = blockIdx.y;
  const long long row_bytes = (long long)w * c * sizeof(T);
  const uint8_t* src = a.x + (long long)g * h * row_bytes;
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem);
  int* r3s = reinterpret_cast<int*>(smem + 16);
  int* r2s = r3s + h;
  int* r1s = r2s + w;
  // the image in shared memory starts at the source's address mod 16
  uint8_t* held = smem + image_off(h, w, c, sizeof(T)) +
                  (reinterpret_cast<uintptr_t>(src) & 15);

  if constexpr (VARIANT == SMEM) {
    if (threadIdx.x == 0) {
      sm90::mbar_init(bar, 1);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
    load_bytes(held, src, h * row_bytes, bar);
  }
  for (int i = threadIdx.x; i < h; i += THREADS) {
    r3s[i] = a.r3[(long long)g * h + i];
    r1s[i] = a.r1[(long long)g * h + i];
  }
  for (int i = threadIdx.x; i < w; i += THREADS)
    r2s[i] = a.r2[(long long)g * w + i];
  const bool flip = a.big != nullptr && a.big[g] != 0;
  __syncthreads();
  if constexpr (VARIANT == SMEM) sm90::mbar_wait(bar, 0);

  const T* img = reinterpret_cast<const T*>(VARIANT == SMEM ? held : src);
  // the source pixel of (y2, x3) in the image as stored: y2 * w + x3, or
  // for a flipped image (h-1-y2) * w + (w-1-x3) = h * w - 1 - (y2 * w + x3)
  const int fsign = flip ? -1 : 1;
  const int fbase = flip ? h * w - 1 : 0;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int y_begin = min(h, (int)blockIdx.x * a.rows_part);
  const int y_end = min(h, y_begin + a.rows_part);
  const int chunks = (w + CHUNK - 1) / CHUNK;  // a warp's items: a row's chunks
  const int items = (y_end - y_begin) * chunks;
  T* stage = reinterpret_cast<T*>(smem + stage_off(h, w) +
                                  warp * stage_bytes(c, sizeof(T)));

  for (int it = warp; it < items; it += WARPS) {
    const int yo = y_begin + (chunks == 1 ? it : it / chunks);
    const int x0 = chunks == 1 ? 0 : (it % chunks) * CHUNK;
    const int n = min(CHUNK, w - x0);  // pixels of this chunk
    const int s3 = r3s[yo];
    // each step for every segment before the next step
    int x1[SEGS], y2[SEGS], px[SEGS];
    bool ok[SEGS];
#pragma unroll
    for (int s = 0; s < SEGS; ++s) {
      x1[s] = x0 + 32 * s + lane - s3;
      ok[s] = 32 * s + lane < n && (unsigned)x1[s] < (unsigned)w;
      x1[s] = ok[s] ? x1[s] : 0;
    }
#pragma unroll
    for (int s = 0; s < SEGS; ++s) y2[s] = yo - r2s[x1[s]];
#pragma unroll
    for (int s = 0; s < SEGS; ++s) {
      ok[s] = ok[s] && (unsigned)y2[s] < (unsigned)h;
      y2[s] = ok[s] ? y2[s] : 0;
    }
#pragma unroll
    for (int s = 0; s < SEGS; ++s) {
      const int x3 = x1[s] - r1s[y2[s]];
      ok[s] = ok[s] && (unsigned)x3 < (unsigned)w;
      px[s] = ok[s] ? fbase + fsign * (y2[s] * w + x3) : 0;
    }
    // < 2^31 elements an image (basd_geom_shift3 checks)
    if constexpr (CC != 0) {
      T v[SEGS][CC];
#pragma unroll
      for (int s = 0; s < SEGS; ++s)
#pragma unroll
        for (int ch = 0; ch < CC; ++ch) v[s][ch] = img[px[s] * CC + ch];
#pragma unroll
      for (int s = 0; s < SEGS; ++s)
#pragma unroll
        for (int ch = 0; ch < CC; ++ch)
          stage[(32 * s + lane) * CC + ch] = ok[s] ? v[s][ch] : T(0);
    } else {
#pragma unroll
      for (int s = 0; s < SEGS; ++s)
        for (int ch = 0; ch < c; ++ch) {
          const T e = img[px[s] * c + ch];
          stage[(32 * s + lane) * c + ch] = ok[s] ? e : T(0);
        }
    }
    __syncwarp();
    T* dst = reinterpret_cast<T*>(a.out + ((long long)g * h + yo) * row_bytes) +
             (long long)x0 * c;
    const int bytes = n * c * (int)sizeof(T);
    if (a.vec && (bytes & 15) == 0) {
      for (int i = lane; i < bytes / 16; i += 32)
        reinterpret_cast<uint4*>(dst)[i] = reinterpret_cast<const uint4*>(stage)[i];
    } else {
      for (int i = lane; i < n * c; i += 32) dst[i] = stage[i];
    }
    __syncwarp();
  }
}

template <typename T, int CC, int VARIANT>
int launch(const Args& a, int g, int split, cudaStream_t st) {
  auto* kern = geom_shift3_kernel<T, CC, VARIANT>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_LIMIT);
  if (attr != cudaSuccess) return (int)attr;
  const long long smem =
      smem_bytes(a.h, a.w, a.c, a.esize, VARIANT == SMEM ? a.h : 0);
  if (smem > SMEM_LIMIT) return (int)cudaErrorInvalidValue;
  kern<<<dim3(split, g), THREADS, (size_t)smem, st>>>(a);
  return (int)cudaGetLastError();
}

template <typename T, int VARIANT>
int launch_c(const Args& a, int g, int split, cudaStream_t st) {
  if (a.c == 3) return launch<T, 3, VARIANT>(a, g, split, st);
  if (a.c == 1) return launch<T, 1, VARIANT>(a, g, split, st);
  return launch<T, 0, VARIANT>(a, g, split, st);
}

template <int VARIANT>
int launch_variant(const Args& a, int g, int split, cudaStream_t st) {
  switch (a.esize) {
    case 1: return launch_c<uint8_t, VARIANT>(a, g, split, st);
    case 2: return launch_c<uint16_t, VARIANT>(a, g, split, st);
    case 4: return launch_c<uint32_t, VARIANT>(a, g, split, st);
    default: return launch_c<uint64_t, VARIANT>(a, g, split, st);
  }
}

}  // namespace geom
}  // namespace basd

// K9. x, out: (g, h, w, c) elements of esize bytes (1, 2, 4 or 8); r1, r3:
// (g, h) int32, r2: (g, w) int32; big: (g,) bytes, non-zero for an image
// read 180-degree flipped, or null. variant: 0 the image in each CTA's
// shared memory, 1 read from device memory (kernels/geom_shift.py:
// geom_shift3_variant); split: CTAs an image (geom_shift3_split), 1 to h.
extern "C" int basd_geom_shift3(const void* x, const int* r1, const int* r2,
                                const int* r3, const void* big, void* out,
                                int g, int h, int w, int c, int esize,
                                int variant, int split, void* stream) {
  using namespace basd::geom;
  if (g < 0 || g > 65535 || h <= 0 || w <= 0 || c <= 0 ||
      (esize != 1 && esize != 2 && esize != 4 && esize != 8) || split < 1 ||
      split > h || (variant != SMEM && variant != GLOBAL) ||
      (long long)h * w * c >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  if (g == 0) return 0;
  Args a;
  a.x = static_cast<const uint8_t*>(x);
  a.r1 = r1;
  a.r2 = r2;
  a.r3 = r3;
  a.big = static_cast<const uint8_t*>(big);
  a.out = static_cast<uint8_t*>(out);
  a.h = h;
  a.w = w;
  a.c = c;
  a.esize = esize;
  a.rows_part = (h + split - 1) / split;
  a.vec = reinterpret_cast<uintptr_t>(out) % 16 == 0 &&
          ((long long)w * c * esize) % 16 == 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return variant == SMEM ? launch_variant<SMEM>(a, g, split, st)
                         : launch_variant<GLOBAL>(a, g, split, st);
}
