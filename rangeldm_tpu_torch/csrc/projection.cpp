// Native range-image projection core.
//
// The per-scan CPU hot loop of the data pipeline (the reference hides its
// slow first epoch behind a 2h NCCL timeout, ldm/train_unconditional.py:127;
// here the projection is a C++ kernel called from the loader threads with
// the GIL released). Semantics match geometry/projection.py `project_np` /
// `process_miss_value_np` / `normalize_np` exactly:
//   - KITTI row assignment: argmin over |incl_b - atan2(h_b - z, ||xy||)|
//     (ldm/kitti360_range_image.py:51-61)
//   - column binning round(W - 0.5 - (azi+pi)/2pi*W) clamped
//     (ldm/dataset.py:162-166)
//   - nearest-point-wins with smallest-index tie-break, range clamped at
//     the fill value, z shifted by the beam origin height
//   - shift-by-one-azimuth hole filling + car-window mask + fill value +
//     (r - mean)/std normalization (ldm/dataset.py:187-226)
//
// This is the JAX package's rangeldm_tpu/native/projection.cpp, copied so
// that this package builds it on its own (rangeldm_tpu_torch/native):
// g++ -O3 -fPIC -shared -std=c++17 -fopenmp, at first use.

#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

extern "C" {

// Row assignment via per-beam inclination tables. pc: (n, stride) floats
// with x,y,z leading. out_rows: (n) int32.
void kitti_row_inds(const float* pc, int64_t n, int64_t stride,
                    const float* height, const float* incl, int n_beams,
                    int32_t* out_rows) {
#pragma omp parallel for schedule(static)
  for (int64_t i = 0; i < n; ++i) {
    const float x = pc[i * stride + 0];
    const float y = pc[i * stride + 1];
    const float z = pc[i * stride + 2];
    const float xy = std::sqrt(x * x + y * y);
    float best = 1e30f;
    int32_t best_b = 0;
    for (int b = 0; b < n_beams; ++b) {
      const float ang = std::atan2(height[b] - z, xy);
      const float err = std::fabs(incl[b] - ang);
      if (err < best) {
        best = err;
        best_b = b;
      }
    }
    out_rows[i] = best_b;
  }
}

// Full projection pipeline. pc: (n, stride) with x,y,z,intensity leading
// (ring channel at index 4 when row_mode==1).
// row_mode: 0 = kitti tables, 1 = ring (n_beams-1-ring), 2 = uniform zenith.
// encoding: 0 = linear, 1 = log2(r+1)/6, 2 = 1/r.
// Outputs: image (h*w*2) normalized, mask (h*w) u8, car_window (h*w) u8.
void project_scan(const float* pc, int64_t n, int64_t stride,
                  const float* height, const float* incl, int n_beams,
                  int width, int row_mode, int encoding,
                  float fov_up, float fov_down, float min_depth,
                  float range_fill, float mean, float stdv,
                  float intensity_fill,
                  float* image, uint8_t* mask, uint8_t* car_window) {
  const int h = n_beams, w = width;
  const int64_t npix = (int64_t)h * w;
  const float two_pi = 6.283185307179586f;
  const float pi = 3.14159265358979f;

  std::vector<float> best_r(npix, 1e30f);
  std::vector<int64_t> best_i(npix, -1);
  std::vector<int32_t> rows(n);
  std::vector<int32_t> cols(n);
  std::vector<float> ranges(n);

  // Windowed beam search for row_mode 0: per-beam origin heights differ by
  // <= ~0.1 m, so the exact argmin lies within a few beams of the beam whose
  // table inclination brackets atan2(h_mid - z, xy). Binary-search the
  // (monotonically decreasing) incl table, then evaluate the exact error on
  // a +-4 window — ~8 atan2 per point instead of n_beams. Falls back to a
  // full scan for very close points where the height spread can shift the
  // angle by more than the window.
  const float h_mid = 0.5f * (height[0] + height[n_beams - 1]);
  float h_spread = 0.0f;
  for (int b = 0; b < n_beams; ++b) {
    h_spread = std::max(h_spread, std::fabs(height[b] - h_mid));
  }

#pragma omp parallel for schedule(static)
  for (int64_t i = 0; i < n; ++i) {
    const float x = pc[i * stride + 0];
    const float y = pc[i * stride + 1];
    const float z = pc[i * stride + 2];
    int32_t row;
    if (row_mode == 0) {
      const float xy = std::sqrt(x * x + y * y);
      float best = 1e30f;
      row = 0;
      // beam-to-beam angular pitch (tables are uniformly-ish spaced)
      const float pitch =
          std::fabs(incl[n_beams - 1] - incl[0]) / (n_beams - 1);
      const bool near = xy < 1e-3f || (h_spread / std::max(xy, 1e-3f)) >
                                          3.0f * pitch;
      int lo = 0, hi = n_beams - 1;
      if (!near) {
        const float a0 = std::atan2(h_mid - z, xy);
        // incl is descending in b for these sensors? find the bracketing
        // index by binary search on whichever ordering holds
        const bool desc = incl[0] > incl[n_beams - 1];
        int l = 0, r = n_beams - 1;
        while (r - l > 1) {
          const int m = (l + r) / 2;
          const bool go_right = desc ? (incl[m] > a0) : (incl[m] < a0);
          if (go_right) l = m; else r = m;
        }
        // window width: the caller-side spread guard admits points with
        // angular error up to ~3x the AVERAGE beam pitch, but the KITTI
        // table's local spacing dips to ~0.6x average, so the true argmin
        // can sit up to ~5-6 indices from the bracket; +-8 makes the
        // windowed search provably cover it (numpy does the exact argmin)
        lo = std::max(0, l - 8);
        hi = std::min(n_beams - 1, r + 8);
      }
      for (int b = lo; b <= hi; ++b) {
        const float err = std::fabs(incl[b] - std::atan2(height[b] - z, xy));
        if (err < best) { best = err; row = b; }
      }
    } else if (row_mode == 1) {
      row = n_beams - 1 - (int32_t)pc[i * stride + 4];
      if (row < 0) row = 0;
      if (row >= n_beams) row = n_beams - 1;
    } else {
      const float r0 = std::sqrt(x * x + y * y + z * z);
      const float zen = std::asin(z / (r0 > 1e-12f ? r0 : 1e-12f));
      const float fov = fov_up - fov_down;
      float rf = n_beams - 0.5f - (zen - fov_down) / fov * n_beams;
      // nearbyint = round-half-to-EVEN (the numpy path's np.round);
      // lround's half-away-from-zero binned exact .5 fractions into the
      // neighbouring row/col and broke bit-parity with range_image_np
      int32_t r = (int32_t)std::nearbyintf(rf);
      row = r < 0 ? 0 : (r >= n_beams ? n_beams - 1 : r);
    }
    rows[i] = row;

    const float azi = std::atan2(y, x);
    float cf = w - 0.5f - (azi + pi) / two_pi * w;
    int32_t col = (int32_t)std::nearbyintf(cf);   // half-to-even, like np.round
    if (col >= w) col = w - 1;
    if (col < 0) col = 0;
    cols[i] = col;

    const float zs = z - height[row];
    float r = std::sqrt(x * x + y * y + zs * zs);
    if (r > range_fill) r = range_fill;
    ranges[i] = r;
  }

  // nearest-wins scatter (serial). Tie-break: the numpy path writes a
  // stable descending-range sort far-to-near, so among equal ranges the
  // LARGEST original index lands last and wins — <= reproduces that here
  // (ascending i, equal range overwrites).
  for (int64_t i = 0; i < n; ++i) {
    if (min_depth > 0.0f) {
      const float x = pc[i * stride + 0];
      const float y = pc[i * stride + 1];
      const float z = pc[i * stride + 2];
      if (std::sqrt(x * x + y * y + z * z) <= min_depth) continue;
    }
    const int64_t p = (int64_t)rows[i] * w + cols[i];
    if (ranges[i] <= best_r[p]) {
      best_r[p] = ranges[i];
      best_i[p] = i;
    }
  }

  auto encode = [&](float r) -> float {
    if (encoding == 1) return std::log2(r + 1.0f) / 6.0f;
    if (encoding == 2) return 1.0f / r;
    return r;
  };

  // rasterize; -1 = empty
  for (int64_t p = 0; p < npix; ++p) {
    if (best_i[p] >= 0) {
      image[p * 2 + 0] = encode(best_r[p]);
      image[p * 2 + 1] = pc[best_i[p] * stride + 3];
    } else {
      image[p * 2 + 0] = -1.0f;
      image[p * 2 + 1] = -1.0f;
    }
  }

  // hole filling: copy from azimuth col+1 (wrapping); mask before fill
  std::vector<uint8_t> miss(npix);
  for (int64_t p = 0; p < npix; ++p) {
    mask[p] = image[p * 2] > 0.0f ? 1 : 0;
    miss[p] = image[p * 2] == -1.0f ? 1 : 0;
  }
  // snapshot so the shift reads pre-fill values (numpy fancy-index
  // semantics: data[miss] = shifted[miss] uses a consistent source)
  std::vector<float> img0(image, image + npix * 2);
  std::vector<uint8_t> mask0(mask, mask + npix);
  for (int r = 0; r < h; ++r) {
    for (int c = 0; c < w; ++c) {
      const int64_t p = (int64_t)r * w + c;
      if (miss[p]) {
        const int64_t q = (int64_t)r * w + ((c + 1) % w);
        image[p * 2 + 0] = img0[q * 2 + 0];
        image[p * 2 + 1] = img0[q * 2 + 1];
        mask[p] = mask0[q];
      }
    }
  }

  // car-window mask on remaining holes + fill value + normalize
  const float fill_r = encode(range_fill);
  for (int r = 0; r < h; ++r) {
    for (int c = 0; c < w; ++c) {
      const int64_t p = (int64_t)r * w + c;
      const bool still = image[p * 2] == -1.0f;
      if (still) {
        const int rd = (r - 2 + h) % h, ru = (r + 2) % h;
        const int cr = (c - 2 + w) % w, cl = (c + 2) % w;
        const bool neigh =
            image[((int64_t)rd * w + c) * 2] != -1.0f ||
            image[((int64_t)ru * w + c) * 2] != -1.0f ||
            image[((int64_t)r * w + cr) * 2] != -1.0f ||
            image[((int64_t)r * w + cl) * 2] != -1.0f;
        car_window[p] = neigh ? 1 : 0;
      } else {
        car_window[p] = 0;
      }
    }
  }
  for (int64_t p = 0; p < npix; ++p) {
    if (image[p * 2] == -1.0f) {
      image[p * 2 + 0] = fill_r;
      image[p * 2 + 1] = intensity_fill;
    }
  }
  if (encoding == 0) {
    for (int64_t p = 0; p < npix; ++p) {
      image[p * 2] = (image[p * 2] - mean) / stdv;
    }
  }
}

}  // extern "C"
