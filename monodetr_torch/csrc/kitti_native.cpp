// Native host-side kernels of monodetr_torch's loader and evaluator, loaded
// via ctypes (monodetr_torch/native.py).
#include <vector>
//
// 1. warp_affine_normalize: the data-loader hot path — bilinear affine warp
//    of an RGB uint8 image to the fixed network resolution, fused with
//    /255 + ImageNet mean/std normalization, emitting float32 NHWC.
//    Replaces PIL Image.transform(AFFINE) + numpy normalize (the reference's
//    per-worker python warp, kitti_dataset.py:154-163).  PIL semantics:
//    output pixel (x, y) samples the source at
//      (a*(x+0.5) + b*(y+0.5) + c - 0.5,  d*(x+0.5) + e*(y+0.5) + f - 0.5)
//    with bilinear weights and zero fill outside.
//
// 2. rotated_iou: pairwise rotated-rectangle BEV overlap via
//    Sutherland-Hodgman clipping — the evaluator kernel the reference runs
//    in numba-CUDA (rotate_iou.py).  criterion: -1 IoU, 0 inter/area1,
//    1 inter/area2, 2 raw intersection area.
//
// 3. match_image: the evaluator's per-image greedy matching (below).
//
// Build: monodetr_torch/_build.py:build_host, at first use (g++ -O3
// -march=native -funroll-loops -shared -fPIC -std=c++17).

#include <cmath>
#include <cstdint>
#include <cstring>
#include <algorithm>

extern "C" {

// General (rotated) path: per-pixel bilinear with bounds checks.
static void warp_affine_normalize_general(
    const uint8_t* src, int src_h, int src_w,
    const double* inv, float* dst, int dst_h, int dst_w,
    const float* scale, const float* bias) {
  const double a = inv[0], b = inv[1], c = inv[2];
  const double d = inv[3], e = inv[4], f = inv[5];

  for (int y = 0; y < dst_h; ++y) {
    const double yc = y + 0.5;
    float* row = dst + (size_t)y * dst_w * 3;
    for (int x = 0; x < dst_w; ++x) {
      const double xc = x + 0.5;
      const double sx = a * xc + b * yc + c - 0.5;
      const double sy = d * xc + e * yc + f - 0.5;

      const int x0 = (int)std::floor(sx);
      const int y0 = (int)std::floor(sy);
      const float wx = (float)(sx - x0);
      const float wy = (float)(sy - y0);

      float acc[3] = {0.f, 0.f, 0.f};
      for (int dy = 0; dy < 2; ++dy) {
        const int yy = y0 + dy;
        if (yy < 0 || yy >= src_h) continue;
        const float wyv = dy ? wy : 1.f - wy;
        const uint8_t* srow = src + (size_t)yy * src_w * 3;
        for (int dx = 0; dx < 2; ++dx) {
          const int xx = x0 + dx;
          if (xx < 0 || xx >= src_w) continue;
          const float w = wyv * (dx ? wx : 1.f - wx);
          const uint8_t* p = srow + (size_t)xx * 3;
          acc[0] += w * p[0];
          acc[1] += w * p[1];
          acc[2] += w * p[2];
        }
      }
      row[x * 3 + 0] = acc[0] * scale[0] + bias[0];
      row[x * 3 + 1] = acc[1] * scale[1] + bias[1];
      row[x * 3 + 2] = acc[2] * scale[2] + bias[2];
    }
  }
}

void warp_affine_normalize(
    const uint8_t* src, int src_h, int src_w,
    const double* inv,   // 2x3 row-major dst->src affine
    float* dst, int dst_h, int dst_w,
    const float* mean, const float* std_) {
  // fold /255 + (v - mean) / std into one fused multiply-add per channel
  float scale[3], bias[3];
  for (int ch = 0; ch < 3; ++ch) {
    scale[ch] = 1.0f / (255.0f * std_[ch]);
    bias[ch] = -mean[ch] / std_[ch];
  }

  const double a = inv[0], b = inv[1], c = inv[2];
  const double d = inv[3], e = inv[4], f = inv[5];
  if (b != 0.0 || d != 0.0) {  // rotation: rare (the pipeline warps rot=0)
    warp_affine_normalize_general(src, src_h, src_w, inv, dst, dst_h, dst_w,
                                  scale, bias);
    return;
  }

  // Axis-aligned fast path (sx depends only on x, sy only on y), two-pass
  // separable bilinear: (1) blend the two source rows for this dst row into
  // a contiguous float buffer — a long sequential FMA the compiler
  // vectorizes; (2) horizontal lerp with per-column precomputed x0/wx.
  // PIL zero-fill outside the source is reproduced by clamping the
  // contributing taps' weights to zero.
  int* x0s = new int[dst_w];
  float* wxs = new float[dst_w];
  int x_lo = dst_w, x_hi = -1;  // span where both x-taps are in range
  for (int x = 0; x < dst_w; ++x) {
    const double sx = a * (x + 0.5) + c - 0.5;
    int x0 = (int)std::floor(sx);
    x0s[x] = x0;
    wxs[x] = (float)(sx - x0);
    if (x0 >= 0 && x0 + 1 < src_w) {
      if (x < x_lo) x_lo = x;
      if (x > x_hi) x_hi = x;
    }
  }

  const int rw = src_w * 3;
  float* rowbuf = new float[rw];

  for (int y = 0; y < dst_h; ++y) {
    const double sy = e * (y + 0.5) + f - 0.5;
    const int y0 = (int)std::floor(sy);
    const float wy = (float)(sy - y0);
    float* out = dst + (size_t)y * dst_w * 3;

    const bool r0 = (y0 >= 0 && y0 < src_h);
    const bool r1 = (y0 + 1 >= 0 && y0 + 1 < src_h);
    if (!r0 && !r1) {
      for (int ch = 0, x = 0; x < dst_w; ++x)
        for (ch = 0; ch < 3; ++ch) out[x * 3 + ch] = bias[ch];
      continue;
    }

    const uint8_t* row0 = src + (size_t)(r0 ? y0 : 0) * rw;
    const uint8_t* row1 = src + (size_t)(r1 ? y0 + 1 : 0) * rw;
    const float w0 = r0 ? 1.f - wy : 0.f;
    const float w1 = r1 ? wy : 0.f;
    for (int i = 0; i < rw; ++i)
      rowbuf[i] = w0 * row0[i] + w1 * row1[i];

    // borders (an x-tap out of range): per-tap zero-weight masks.
    // rowbuf values are in [0, 255] units, so out = v*scale + bias
    // (scale already folds the /255).
    auto border = [&](int xa, int xb) {
      for (int x = xa; x < xb; ++x) {
        const int x0 = x0s[x];
        const float wx = wxs[x];
        const float wa = (x0 >= 0 && x0 < src_w) ? 1.f - wx : 0.f;
        const float wb = (x0 + 1 >= 0 && x0 + 1 < src_w) ? wx : 0.f;
        const float* pa = rowbuf + (x0 >= 0 && x0 < src_w ? x0 * 3 : 0);
        const float* pb = rowbuf + (x0 + 1 >= 0 && x0 + 1 < src_w ? (x0 + 1) * 3 : 0);
        for (int ch = 0; ch < 3; ++ch)
          out[x * 3 + ch] = (wa * pa[ch] + wb * pb[ch]) * scale[ch] + bias[ch];
      }
    };
    border(0, x_lo);
    border(x_hi + 1, dst_w);

    // interior: branch-free lerp
    for (int x = x_lo; x <= x_hi; ++x) {
      const float* p = rowbuf + x0s[x] * 3;
      const float wx = wxs[x];
      const float cw = 1.f - wx;
      out[x * 3 + 0] = (cw * p[0] + wx * p[3]) * scale[0] + bias[0];
      out[x * 3 + 1] = (cw * p[1] + wx * p[4]) * scale[1] + bias[1];
      out[x * 3 + 2] = (cw * p[2] + wx * p[5]) * scale[2] + bias[2];
    }
  }

  delete[] rowbuf;
  delete[] wxs;
  delete[] x0s;
}

// ---------------- rotated IoU ----------------

struct Pt { double x, z; };

static inline double polygon_area(const Pt* p, int n) {
  double s = 0;
  for (int i = 0; i < n; ++i) {
    const Pt& u = p[i];
    const Pt& v = p[(i + 1) % n];
    s += u.x * v.z - v.x * u.z;
  }
  return std::abs(s) * 0.5;
}

// clip convex polygon (p, n) against half-plane left of directed edge a->b
static int clip_edge(const Pt* p, int n, Pt a, Pt b, Pt* out) {
  const double dx = b.x - a.x, dz = b.z - a.z;
  int m = 0;
  for (int i = 0; i < n; ++i) {
    const Pt& cur = p[i];
    const Pt& nxt = p[(i + 1) % n];
    const double dc = dx * (cur.z - a.z) - dz * (cur.x - a.x);
    const double dn = dx * (nxt.z - a.z) - dz * (nxt.x - a.x);
    if (dc >= 0) out[m++] = cur;
    if ((dc >= 0) != (dn >= 0)) {
      const double t = dc / (dc - dn);
      out[m++] = {cur.x + (nxt.x - cur.x) * t, cur.z + (nxt.z - cur.z) * t};
    }
  }
  return m;
}

static void box_corners(const double* box, Pt* c) {
  // box: cx, cz, l, w, ry
  const double cx = box[0], cz = box[1], hl = box[2] / 2, hw = box[3] / 2;
  const double co = std::cos(box[4]), si = std::sin(box[4]);
  const double dx[4] = {hl, hl, -hl, -hl};
  const double dz[4] = {hw, -hw, -hw, hw};
  for (int i = 0; i < 4; ++i) {
    c[i].x = cx + dx[i] * co + dz[i] * si;
    c[i].z = cz - dx[i] * si + dz[i] * co;
  }
}

static double rect_intersection(const double* b1, const double* b2) {
  Pt subj[16], clip[4], buf[16];
  box_corners(b1, subj);
  int n = 4;
  box_corners(b2, clip);
  // ensure counter-clockwise clip polygon
  double cross = (clip[1].x - clip[0].x) * (clip[2].z - clip[0].z) -
                 (clip[1].z - clip[0].z) * (clip[2].x - clip[0].x);
  if (cross < 0) std::swap(clip[1], clip[3]);
  for (int e = 0; e < 4 && n > 0; ++e) {
    n = clip_edge(subj, n, clip[e], clip[(e + 1) % 4], buf);
    std::memcpy(subj, buf, sizeof(Pt) * n);
  }
  return n > 0 ? polygon_area(subj, n) : 0.0;
}

void rotated_iou(const double* boxes, int n, const double* qboxes, int m,
                 int criterion, float* out) {
  for (int i = 0; i < n; ++i) {
    const double* b1 = boxes + i * 5;
    const double area1 = b1[2] * b1[3];
    for (int j = 0; j < m; ++j) {
      const double* b2 = qboxes + j * 5;
      const double inter = rect_intersection(b1, b2);
      double denom;
      switch (criterion) {
        case -1: denom = area1 + b2[2] * b2[3] - inter; break;
        case 0: denom = area1; break;
        case 1: denom = b2[2] * b2[3]; break;
        default: out[i * m + j] = (float)inter; continue;
      }
      out[i * m + j] = denom > 0 ? (float)(inter / denom) : 0.f;
    }
  }
}

}  // extern "C"

// ---------------- evaluator matching ----------------
//
// Per-image TP/FP/FN/similarity statistics for T score thresholds — a direct
// C++ transliteration of the sequential greedy matching the reference runs
// under numba (compute_statistics_jit, kitti_eval_python/eval.py:233-350).
// overlaps: [D, G] row-major (detections x ground truth).

extern "C" void match_image(
    const double* overlaps, int D, int G,
    const double* dt_scores, const double* dt_alphas, const double* gt_alphas,
    const double* dt_bboxes,           // [D, 4] (for DontCare suppression)
    const long long* ignored_gt, const long long* ignored_det,
    const double* dc_bboxes, int n_dc, // [n_dc, 4]
    int metric, double min_overlap,
    const double* threshs, int T,
    int compute_fp, int compute_aos,
    long long* tp_out, long long* fp_out, long long* fn_out, double* sim_out,
    double* tp_scores_out,             // [T, G] padded
    long long* tp_counts_out) {
  const double NO_DETECTION = -10000000.0;
  std::vector<char> assigned(D);
  std::vector<char> ign_thresh(D);

  for (int t = 0; t < T; ++t) {
    std::fill(assigned.begin(), assigned.end(), 0);
    std::fill(ign_thresh.begin(), ign_thresh.end(), 0);
    if (compute_fp) {
      for (int j = 0; j < D; ++j)
        if (dt_scores[j] < threshs[t]) ign_thresh[j] = 1;
    }
    long long tp = 0, fp = 0, fn = 0;
    double sim = 0.0;
    long long n_scores = 0;
    long long n_delta = 0;
    double* scores_row = tp_scores_out + (size_t)t * G;

    for (int i = 0; i < G; ++i) {
      if (ignored_gt[i] == -1) continue;
      int det_idx = -1;
      double valid_detection = NO_DETECTION;
      double max_overlap = 0.0;
      bool assigned_ignored_det = false;

      for (int j = 0; j < D; ++j) {
        if (ignored_det[j] == -1 || assigned[j] || ign_thresh[j]) continue;
        const double overlap = overlaps[(size_t)j * G + i];
        const double score = dt_scores[j];
        if (!compute_fp && overlap > min_overlap && score > valid_detection) {
          det_idx = j;
          valid_detection = score;
        } else if (compute_fp && overlap > min_overlap &&
                   (overlap > max_overlap || assigned_ignored_det) &&
                   ignored_det[j] == 0) {
          max_overlap = overlap;
          det_idx = j;
          valid_detection = 1;
          assigned_ignored_det = false;
        } else if (compute_fp && overlap > min_overlap &&
                   valid_detection == NO_DETECTION && ignored_det[j] == 1) {
          det_idx = j;
          valid_detection = 1;
          assigned_ignored_det = true;
        }
      }

      if (valid_detection == NO_DETECTION && ignored_gt[i] == 0) {
        fn += 1;
      } else if (valid_detection != NO_DETECTION &&
                 (ignored_gt[i] == 1 || ignored_det[det_idx] == 1)) {
        assigned[det_idx] = 1;
      } else if (valid_detection != NO_DETECTION) {
        tp += 1;
        scores_row[n_scores++] = dt_scores[det_idx];
        if (compute_aos) {
          sim += (1.0 + std::cos(gt_alphas[i] - dt_alphas[det_idx])) / 2.0;
          n_delta += 1;
        }
        assigned[det_idx] = 1;
      }
    }

    if (compute_fp) {
      for (int j = 0; j < D; ++j)
        if (!(assigned[j] || ignored_det[j] == -1 || ignored_det[j] == 1 ||
              ign_thresh[j]))
          fp += 1;
      if (metric == 0 && n_dc > 0) {
        long long nstuff = 0;
        for (int c = 0; c < n_dc; ++c) {
          const double* dc = dc_bboxes + (size_t)c * 4;
          const double dc_area_x = dc[2] - dc[0];
          (void)dc_area_x;
          for (int j = 0; j < D; ++j) {
            if (assigned[j] || ignored_det[j] == -1 || ignored_det[j] == 1 ||
                ign_thresh[j])
              continue;
            const double* b = dt_bboxes + (size_t)j * 4;
            const double iw = std::min(b[2], dc[2]) - std::max(b[0], dc[0]);
            const double ih = std::min(b[3], dc[3]) - std::max(b[1], dc[1]);
            double ov = 0.0;
            if (iw > 0 && ih > 0) {
              // criterion 0: intersection / detection area
              const double area = (b[2] - b[0]) * (b[3] - b[1]);
              ov = iw * ih / area;
            }
            if (ov > min_overlap) {
              assigned[j] = 1;
              nstuff += 1;
            }
          }
        }
        fp -= nstuff;
      }
      if (compute_aos) {
        sim = (tp > 0 || fp > 0) ? sim : -1.0;
      }
    }
    tp_out[t] = tp;
    fp_out[t] = fp;
    fn_out[t] = fn;
    sim_out[t] = sim;
    tp_counts_out[t] = n_scores;
  }
}
