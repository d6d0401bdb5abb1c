// Host-side native runtime of retinanet_tpu_torch: the port's own copy of
// the JAX package's native/retinanet_host.cc, the same code, built by
// retinanet_tpu_torch/native.py into build/host/.
//
// The reference delegates its host data path to the TensorFlow C++ runtime
// (tf.data generator bridge, parallel map, JPEG decode/resize).  The device
// path runs elsewhere; the host hot loops are implemented here:
//
//   * rn_resize_normalize: fused bilinear resize + [0,1] scaling + mean/std
//     normalization + pad-to-canvas, writing the float32 canvas in one pass
//     (the Python pipeline otherwise does 3 full-image passes and 2 temps)
//   * rn_nms: greedy IoU suppression for host-side evaluation tooling
//   * rn_iou_matrix: pairwise IoU for the mAP evaluator's matching loop
//
// Exposed as a plain C ABI consumed via ctypes (no pybind11 in this image).
// The port binds rn_resize_normalize only; the other two stay as the JAX
// package has them.
// Threading: row-parallel OpenMP-free std::thread pool sized by the caller.

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

extern "C" {

// Bilinear resize uint8 HWC -> float32 canvas with normalization and
// top-left padding.  src: [sh, sw, 3] uint8 (RGB); dst: [ch, cw, 3] float32
// canvas, already zeroed or not (we overwrite every pixel, padding included).
// Resized content occupies [0:nh, 0:nw]; the rest is filled with
// (0 - mean) / std to match the Python pipeline's zero-pixel padding.
void rn_resize_normalize(const uint8_t* src, int sh, int sw,
                         float* dst, int ch, int cw,
                         int nh, int nw,
                         const float* mean, const float* std_,
                         int num_threads) {
  const float inv255 = 1.0f / 255.0f;
  const float inv_std[3] = {1.0f / std_[0], 1.0f / std_[1], 1.0f / std_[2]};
  const float pad_val[3] = {(0.0f - mean[0]) * inv_std[0],
                            (0.0f - mean[1]) * inv_std[1],
                            (0.0f - mean[2]) * inv_std[2]};
  // Align-corners=false bilinear (cv2.INTER_LINEAR semantics).
  const float sy = nh > 0 ? static_cast<float>(sh) / nh : 0.f;
  const float sx = nw > 0 ? static_cast<float>(sw) / nw : 0.f;

  auto process_rows = [&](int row_begin, int row_end) {
    for (int y = row_begin; y < row_end; ++y) {
      float* out_row = dst + (static_cast<int64_t>(y) * cw) * 3;
      if (y >= nh) {
        for (int x = 0; x < cw; ++x) {
          out_row[x * 3 + 0] = pad_val[0];
          out_row[x * 3 + 1] = pad_val[1];
          out_row[x * 3 + 2] = pad_val[2];
        }
        continue;
      }
      const float fy = (y + 0.5f) * sy - 0.5f;
      const int y0 = std::max(0, std::min(sh - 1, static_cast<int>(
          std::floor(fy))));
      const int y1 = std::min(sh - 1, y0 + 1);
      const float wy = std::min(1.f, std::max(0.f, fy - y0));
      const uint8_t* row0 = src + static_cast<int64_t>(y0) * sw * 3;
      const uint8_t* row1 = src + static_cast<int64_t>(y1) * sw * 3;
      for (int x = 0; x < cw; ++x) {
        if (x >= nw) {
          out_row[x * 3 + 0] = pad_val[0];
          out_row[x * 3 + 1] = pad_val[1];
          out_row[x * 3 + 2] = pad_val[2];
          continue;
        }
        const float fx = (x + 0.5f) * sx - 0.5f;
        const int x0 = std::max(0, std::min(sw - 1, static_cast<int>(
            std::floor(fx))));
        const int x1 = std::min(sw - 1, x0 + 1);
        const float wx = std::min(1.f, std::max(0.f, fx - x0));
        for (int c = 0; c < 3; ++c) {
          const float v00 = row0[x0 * 3 + c], v01 = row0[x1 * 3 + c];
          const float v10 = row1[x0 * 3 + c], v11 = row1[x1 * 3 + c];
          const float top = v00 + (v01 - v00) * wx;
          const float bot = v10 + (v11 - v10) * wx;
          const float v = (top + (bot - top) * wy) * inv255;
          out_row[x * 3 + c] = (v - mean[c]) * inv_std[c];
        }
      }
    }
  };

  const int threads = std::max(1, std::min(num_threads, ch));
  if (threads == 1) {
    process_rows(0, ch);
    return;
  }
  std::vector<std::thread> pool;
  const int rows_per = (ch + threads - 1) / threads;
  for (int t = 0; t < threads; ++t) {
    const int b = t * rows_per;
    const int e = std::min(ch, b + rows_per);
    if (b < e) pool.emplace_back(process_rows, b, e);
  }
  for (auto& th : pool) th.join();
}

// Pairwise IoU: a [n,4], b [m,4] (t,l,b,r) -> out [n,m].
void rn_iou_matrix(const float* a, int n, const float* b, int m, float* out) {
  std::vector<float> area_b(m);
  for (int j = 0; j < m; ++j) {
    area_b[j] = (b[j * 4 + 2] - b[j * 4 + 0]) * (b[j * 4 + 3] - b[j * 4 + 1]);
  }
  for (int i = 0; i < n; ++i) {
    const float at = a[i * 4], al = a[i * 4 + 1];
    const float ab = a[i * 4 + 2], ar = a[i * 4 + 3];
    const float area_a = (ab - at) * (ar - al);
    float* row = out + static_cast<int64_t>(i) * m;
    for (int j = 0; j < m; ++j) {
      const float t = std::max(at, b[j * 4 + 0]);
      const float l = std::max(al, b[j * 4 + 1]);
      const float bb = std::min(ab, b[j * 4 + 2]);
      const float r = std::min(ar, b[j * 4 + 3]);
      const float ih = bb - t, iw = r - l;
      if (ih <= 0 || iw <= 0) { row[j] = 0.f; continue; }
      const float inter = ih * iw;
      const float uni = area_a + area_b[j] - inter;
      row[j] = uni > 0 ? inter / uni : 0.f;
    }
  }
}

// Greedy NMS over score-DESCENDING-sorted boxes [n,4]; writes keep flags
// (0/1) and returns number kept.
int rn_nms(const float* boxes, int n, float iou_threshold, uint8_t* keep) {
  std::vector<float> area(n);
  for (int i = 0; i < n; ++i) {
    area[i] = (boxes[i * 4 + 2] - boxes[i * 4 + 0]) *
              (boxes[i * 4 + 3] - boxes[i * 4 + 1]);
    keep[i] = 1;
  }
  int kept = 0;
  for (int i = 0; i < n; ++i) {
    if (!keep[i]) continue;
    ++kept;
    const float it = boxes[i * 4], il = boxes[i * 4 + 1];
    const float ib = boxes[i * 4 + 2], ir = boxes[i * 4 + 3];
    for (int j = i + 1; j < n; ++j) {
      if (!keep[j]) continue;
      const float t = std::max(it, boxes[j * 4 + 0]);
      const float l = std::max(il, boxes[j * 4 + 1]);
      const float bb = std::min(ib, boxes[j * 4 + 2]);
      const float r = std::min(ir, boxes[j * 4 + 3]);
      const float ih = bb - t, iw = r - l;
      if (ih <= 0 || iw <= 0) continue;
      const float inter = ih * iw;
      const float uni = area[i] + area[j] - inter;
      if (uni > 0 && inter / uni > iou_threshold) keep[j] = 0;
    }
  }
  return kept;
}

}  // extern "C"
