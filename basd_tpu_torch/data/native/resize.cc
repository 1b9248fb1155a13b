// Native host-side image preprocessing core for the basd_tpu data
// pipeline: aspect-preserving ANTIALIASED bilinear (triangle-filter)
// resize + center crop of uint8 HWC images — PIL/torchvision Resize
// semantics (PIL always antialiases BILINEAR: filter support scales with
// the downscale factor). The host's only job in this framework is
// decode + canvas resize (everything else runs on-device inside the
// jitted train step); this kernel removes the Python-loop cost from that
// path so a single-core host can keep a TPU fed. Built lazily with g++
// (no pybind11 in the image) and called through ctypes.

#include <cstdint>
#include <cstring>
#include <algorithm>
#include <cmath>
#include <vector>

namespace {

struct Taps {
  std::vector<int> start;     // first source index per output pixel
  std::vector<int> count;     // tap count per output pixel
  std::vector<float> weight;  // packed weights, max_count per pixel
  int max_count = 0;
};

// PIL-style triangle-filter taps: out pixel x samples around
// center = (x + 0.5) * scale - 0.5 with support = max(1, scale).
Taps make_taps(int in_size, int out_size, double shift) {
  Taps t;
  const double scale = (double)in_size / out_size;
  const double support = std::max(1.0, scale);
  const int max_taps = (int)std::ceil(2 * support) + 2;
  t.start.resize(out_size);
  t.count.resize(out_size);
  t.weight.assign((size_t)out_size * max_taps, 0.f);
  t.max_count = max_taps;
  for (int x = 0; x < out_size; ++x) {
    const double center = (x + shift + 0.5) * scale - 0.5;
    int lo = (int)std::floor(center - support + 0.5);
    int hi = (int)std::floor(center + support + 0.5);
    lo = std::max(lo, 0);
    hi = std::min(hi, in_size - 1);
    double total = 0.0;
    const int cnt = hi - lo + 1;
    t.start[x] = lo;
    t.count[x] = cnt;
    float* w = &t.weight[(size_t)x * max_taps];
    for (int i = 0; i < cnt; ++i) {
      const double d = (lo + i - center) / std::max(1.0, scale);
      const double v = std::max(0.0, 1.0 - std::fabs(d));
      w[i] = (float)v;
      total += v;
    }
    if (total > 0) {
      for (int i = 0; i < cnt; ++i) w[i] = (float)(w[i] / total);
    } else {
      w[0] = 1.f;
      t.count[x] = 1;
    }
  }
  return t;
}

}  // namespace

extern "C" {

// Antialiased resize of src (h_in, w_in, 3) so its SHORT side equals
// out_size, then center-crop to (out_size, out_size, 3) into dst.
int resize_shorter_center_crop(
    const uint8_t* src, int h_in, int w_in,
    uint8_t* dst, int out_size) {
  if (h_in <= 0 || w_in <= 0 || out_size <= 0) return 1;
  const int C = 3;
  const double scale = (double)out_size / std::min(h_in, w_in);
  const int h_r = std::max(out_size, (int)std::lround(h_in * scale));
  const int w_r = std::max(out_size, (int)std::lround(w_in * scale));
  const int top = (h_r - out_size) / 2;
  const int left = (w_r - out_size) / 2;

  // crop folded into the taps via the shift parameter
  Taps tx = make_taps(w_in, w_r, 0.0);
  Taps ty = make_taps(h_in, h_r, 0.0);

  // horizontal pass on all source rows, only for cropped output columns
  std::vector<float> tmp((size_t)h_in * out_size * C);
  for (int y = 0; y < h_in; ++y) {
    const uint8_t* srow = src + (size_t)y * w_in * C;
    float* trow = &tmp[(size_t)y * out_size * C];
    for (int x = 0; x < out_size; ++x) {
      const int xs = x + left;
      const float* w = &tx.weight[(size_t)xs * tx.max_count];
      const int lo = tx.start[xs];
      const int cnt = tx.count[xs];
      float acc[3] = {0.f, 0.f, 0.f};
      for (int i = 0; i < cnt; ++i) {
        const uint8_t* p = srow + (size_t)(lo + i) * C;
        const float wi = w[i];
        acc[0] += wi * p[0];
        acc[1] += wi * p[1];
        acc[2] += wi * p[2];
      }
      trow[x * C + 0] = acc[0];
      trow[x * C + 1] = acc[1];
      trow[x * C + 2] = acc[2];
    }
  }

  // vertical pass, only for cropped output rows
  for (int y = 0; y < out_size; ++y) {
    const int ys = y + top;
    const float* w = &ty.weight[(size_t)ys * ty.max_count];
    const int lo = ty.start[ys];
    const int cnt = ty.count[ys];
    uint8_t* drow = dst + (size_t)y * out_size * C;
    for (int x = 0; x < out_size; ++x) {
      float acc[3] = {0.f, 0.f, 0.f};
      for (int i = 0; i < cnt; ++i) {
        const float* p = &tmp[((size_t)(lo + i) * out_size + x) * C];
        const float wi = w[i];
        acc[0] += wi * p[0];
        acc[1] += wi * p[1];
        acc[2] += wi * p[2];
      }
      for (int c = 0; c < C; ++c) {
        drow[x * C + c] =
            (uint8_t)std::lround(std::max(0.f, std::min(255.f, acc[c])));
      }
    }
  }
  return 0;
}

// Batched variant: n images with per-image dims (hs[i], ws[i]) packed
// back-to-back in src at byte offsets offs[i]; outputs densely packed
// (n, out, out, 3).
int resize_batch(
    const uint8_t* src, const int64_t* offs, const int* hs, const int* ws,
    int n, uint8_t* dst, int out_size) {
  const size_t ostride = (size_t)out_size * out_size * 3;
  for (int i = 0; i < n; ++i) {
    int rc = resize_shorter_center_crop(
        src + offs[i], hs[i], ws[i], dst + i * ostride, out_size);
    if (rc) return rc;
  }
  return 0;
}

}  // extern "C"
