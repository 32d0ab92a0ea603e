// Host mask paste of the COCO segm evaluation (evaluation/masks.py
// paste_masks_np, built by ops/_build.py HostLibrary).
// paste_masks: inverse-bilinear paste of (n, m, m) box-space mask
// probabilities into (n, H, W) image-space byte masks with exact
// grid_sample(align_corners=False, padding_mode='zeros') semantics
// (reference layers/mask_ops.py _do_paste_mask): pixel centers at +0.5,
// UNCLAMPED sample coords (out-of-range taps contribute zero, fading the
// value across the half-source-pixel band at the box edge), v >= threshold
// (mask_ops.py:137). Only the pixel window where the value can be nonzero
// is evaluated (requires threshold > 0; evaluation/masks.py
// paste_masks_full_grid evaluates the same function on the full H x W grid).
#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>

extern "C" void paste_masks(
    long long n, long long m, long long H, long long W,
    const float* masks,      // (n, m, m)
    const double* boxes,     // (n, 4) XYXY image coords
    double threshold,
    unsigned char* out)      // (n, H, W), pre-zeroed by the caller
{
  for (long long k = 0; k < n; ++k) {
    const float* mk = masks + k * m * m;
    unsigned char* o = out + k * H * W;
    const double x1 = boxes[4 * k], y1 = boxes[4 * k + 1];
    const double x2 = boxes[4 * k + 2], y2 = boxes[4 * k + 3];
    const double w = std::max(x2 - x1, 1e-3);
    const double h = std::max(y2 - y1, 1e-3);
    // nonzero values require the sample coord in (-1, m): pixel centers in
    // (y1 - h/(2m), y2 + h/(2m)) — the box plus the half-source-pixel fade
    const long long i0 = std::max(0LL, (long long)std::ceil(y1 - h / (2.0 * m) - 0.5));
    const long long i1 = std::min(H - 1, (long long)std::floor(y2 + h / (2.0 * m) - 0.5));
    const long long j0 = std::max(0LL, (long long)std::ceil(x1 - w / (2.0 * m) - 0.5));
    const long long j1 = std::min(W - 1, (long long)std::floor(x2 + w / (2.0 * m) - 0.5));
    for (long long i = i0; i <= i1; ++i) {
      const double ys = ((i + 0.5) - y1) / h * m - 0.5;
      const long long f0 = (long long)std::floor(ys);
      const double ly = ys - (double)f0;
      const bool in_r0 = f0 >= 0 && f0 <= m - 1;
      const bool in_r1 = f0 + 1 >= 0 && f0 + 1 <= m - 1;
      const double wy0 = in_r0 ? (1 - ly) : 0.0;
      const double wy1 = in_r1 ? ly : 0.0;
      const float* row0 = mk + std::min(std::max(f0, 0LL), m - 1) * m;
      const float* row1 = mk + std::min(std::max(f0 + 1, 0LL), m - 1) * m;
      for (long long j = j0; j <= j1; ++j) {
        const double xs = ((j + 0.5) - x1) / w * m - 0.5;
        const long long g0 = (long long)std::floor(xs);
        const double lx = xs - (double)g0;
        const double wx0 = (g0 >= 0 && g0 <= m - 1) ? (1 - lx) : 0.0;
        const double wx1 = (g0 + 1 >= 0 && g0 + 1 <= m - 1) ? lx : 0.0;
        const long long c0 = std::min(std::max(g0, 0LL), m - 1);
        const long long c1 = std::min(std::max(g0 + 1, 0LL), m - 1);
        const double v = row0[c0] * wy0 * wx0 + row0[c1] * wy0 * wx1
                       + row1[c0] * wy1 * wx0 + row1[c1] * wy1 * wx1;
        o[i * W + j] = v >= threshold;
      }
    }
  }
}
