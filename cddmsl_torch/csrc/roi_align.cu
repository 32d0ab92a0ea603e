// Kernels K1 (RoIAlign forward) and K3 (its gradient with respect to the
// map) over a batched channels-last feature map (B, H, W, C).
//
//   out[r, p, q, c]  = sum_h sum_w Wy[r, p, h] * Wx[r, q, w] * F[b(r), h, w, c]
//   dF[b, h, w, c]   = sum_{r: b(r) = b} sum_p sum_q Wy[r, p, h] * Wx[r, q, w] * g[r, p, q, c]
//
// Wy and Wx average the bilinear weights of the S sample points of each bin
// (S = 2 when sampling_ratio is 0). A sample point counts only if it lies in
// (-1, dim); its coordinate is clamped to [0, dim - 1]. So each bin row p
// touches at most 2S map rows and each bin column q at most 2S map columns:
// the kernels keep those taps and their weights instead of the dense
// interpolation matrices. Coordinates are rounded step by step as the plain
// versions (cddmsl_torch/ops/roi_align.py) round them. Sums are fp32 and
// rounded once to the map's dtype. Both kernels move 16 bytes per thread:
// they need C % 8 == 0.
//
// Sample coordinates are monotone in (p + (s + 0.5) / S): each rounding step
// is monotone. Two facts follow that both kernels use: the taps of an ROI
// lie between the taps of its first and its last sample, and the distinct
// taps of any run of consecutive bins form a contiguous run of the ROI's
// sorted distinct taps, at most 2S long for one bin.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>

namespace {

constexpr int kMaxSamples = 8;  // samples per bin axis
constexpr int kMaxPooled = 64;  // PH and PW
constexpr int kVecsPerPixel = 8;  // 16-byte vectors per pixel of a channel tile: 128 bytes of channels

// 16-byte vectors of N channels, unpacked to fp32.
template <typename T>
struct Vec;

template <>
struct Vec<float> {
  static constexpr int N = 4;
  __device__ static void unpack(uint4 u, float* f) {
    f[0] = __uint_as_float(u.x);
    f[1] = __uint_as_float(u.y);
    f[2] = __uint_as_float(u.z);
    f[3] = __uint_as_float(u.w);
  }
  __device__ static uint4 pack(const float* f) {
    return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]), __float_as_uint(f[2]), __float_as_uint(f[3]));
  }
};

template <>
struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ static void unpack(uint4 u, float* f) {
    const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      f[2 * i] = __uint_as_float(w[i] << 16);
      f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
  __device__ static unsigned pack2(float a, float b) {
    const __nv_bfloat162 h = __float22bfloat162_rn(make_float2(a, b));
    return *reinterpret_cast<const unsigned*>(&h);
  }
  __device__ static uint4 pack(const float* f) {
    return make_uint4(pack2(f[0], f[1]), pack2(f[2], f[3]), pack2(f[4], f[5]), pack2(f[6], f[7]));
  }
};

// An ROI's first sample corner and bin sizes in map coordinates.
struct Frame {
  float x1, y1, bin_w, bin_h;
};

// A box with a non-finite coordinate gets a NaN frame, so all of its samples
// fall outside the map: it pools zeros and gets no gradient, aligned or not.
__device__ Frame roi_frame(const float* __restrict__ box, int PH, int PW, float spatial_scale, int aligned) {
  if (!(isfinite(box[0]) && isfinite(box[1]) && isfinite(box[2]) && isfinite(box[3]))) {
    const float nan = __int_as_float(0x7fffffff);
    return {nan, nan, nan, nan};
  }
  const float offset = aligned ? 0.5f : 0.0f;
  const float x1 = __fsub_rn(__fmul_rn(box[0], spatial_scale), offset);
  const float y1 = __fsub_rn(__fmul_rn(box[1], spatial_scale), offset);
  const float x2 = __fsub_rn(__fmul_rn(box[2], spatial_scale), offset);
  const float y2 = __fsub_rn(__fmul_rn(box[3], spatial_scale), offset);
  float roi_w = __fsub_rn(x2, x1);
  float roi_h = __fsub_rn(y2, y1);
  if (!aligned) {  // legacy ROIAlign forces malformed ROIs to be 1px
    roi_w = fmaxf(roi_w, 1.0f);
    roi_h = fmaxf(roi_h, 1.0f);
  }
  return {x1, y1, __fdiv_rn(roi_w, static_cast<float>(PW)), __fdiv_rn(roi_h, static_cast<float>(PH))};
}

// The offset of sample s inside its bin, in bins, and the coordinate of that
// sample of bin p along one axis.
__device__ __forceinline__ float sample_frac(int s, int S) {
  return __fdiv_rn(__fadd_rn(static_cast<float>(s), 0.5f), static_cast<float>(S));
}

__device__ __forceinline__ float sample_coord(float start, float bin, int p, float frac) {
  return __fadd_rn(start, __fmul_rn(__fadd_rn(static_cast<float>(p), frac), bin));
}

// The two taps of a sample at `coord`, with the weights of ops/roi_align.py
// `_interp_matrix`: max(0, 1 - |cc - g|) on the grid rows g = floor(cc) and
// floor(cc) + 1, divided by S. A sample outside (-1, dim), NaN included,
// gets tap -1 and weight 0 on both; inside, w[0] > 0.
__device__ __forceinline__ void sample_taps(float coord, int S, int dim, int* idx, float* w) {
  if (!(coord > -1.0f && coord < static_cast<float>(dim))) {
    idx[0] = idx[1] = -1;
    w[0] = w[1] = 0.0f;
    return;
  }
  const float cc = fminf(fmaxf(coord, 0.0f), static_cast<float>(dim - 1));
  const int lo = static_cast<int>(floorf(cc));
  const float scale = 1.0f / static_cast<float>(S);
  idx[0] = lo;
  w[0] = fmaxf(0.0f, 1.0f - fabsf(cc - static_cast<float>(lo))) * scale;
  idx[1] = lo + 1 < dim ? lo + 1 : lo;
  w[1] = lo + 1 < dim ? fmaxf(0.0f, 1.0f - fabsf(cc - static_cast<float>(lo + 1))) * scale : 0.0f;
}

// Whether any tap of the ROI along one axis can fall in [t0, t1]: the taps
// lie between those of the first and the last sample. False for an ROI whose
// samples are all outside (-1, dim), NaN ones included, so a NaN coordinate
// never becomes an integer bound.
__device__ bool footprint_meets(float start, float bin, int P, int S, int dim, int t0, int t1) {
  const float a = sample_coord(start, bin, 0, sample_frac(0, S));
  const float b = sample_coord(start, bin, P - 1, sample_frac(S - 1, S));
  const float lo = fminf(a, b), hi = fmaxf(a, b);
  if (!(a == a && b == b) || !(hi > -1.0f) || !(lo < static_cast<float>(dim))) return false;
  const int first = static_cast<int>(floorf(fminf(fmaxf(lo, 0.0f), static_cast<float>(dim - 1))));
  const int last = min(static_cast<int>(floorf(fminf(fmaxf(hi, 0.0f), static_cast<float>(dim - 1)))) + 1, dim - 1);
  return first <= t1 && last >= t0;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(gmem));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\n" ::);
  asm volatile("cp.async.wait_group 0;\n" ::);
}

// ---------------------------------------------------------------------------
// Kernel K1: RoIAlign forward.
//
// Replaces the TPU kernels of cddmsl_tpu/ops/pallas/roi_align_pallas.py:
// `_fwd_kernel` (wrapper `_fwd`) and `_fwd_kernel_v2` (wrapper `_fwd_v2`),
// which compute the same function. The plain PyTorch version it is held
// against is `roi_align_batched_plain` in cddmsl_torch/ops/roi_align.py.
//
// What bounds it on an H100: bytes, above all the output (1000-1024 ROIs x
// 14 x 14 x 1024 bf16, about 0.4 GB) while the 4-17 MB map stays in the
// 50 MB L2. About 16 multiply-adds per output value are far below the card's
// operations-per-byte line.
//
// Design: one block per (ROI, channel tile of 128 bytes). The block computes
// the ROI's y and x taps once, sorts out its distinct tap rows and columns,
// and stages the map pixels at (distinct row, distinct column) for its
// channel tile into shared memory with 16-byte cp.async copies, at most
// kStageRows x kStageCols pixels at a time: bins are taken in runs whose
// taps fit, so each map value an ROI needs crosses from L2 about once per
// (ROI, channel tile), not once per tap per output. A bin's taps have
// consecutive ranks, so its S samples' weights are summed into one dense
// vector over its rank range: a bin of a small ROI has fewer than 2S taps,
// and the loop reads staged pixels at a constant stride. Each output vector
// is then summed from shared memory separably, x taps first, and stored as
// one 16-byte store along the channels.
constexpr int kStageRows = 16;  // >= 2 * kMaxSamples: one bin's distinct taps always fit
constexpr int kStageCols = 16;
constexpr int kFwdThreads = 256;

// Sorts the distinct taps of one axis (stored in `slot` as map indices) into
// `vals`, ascending, replaces each tap by its rank in `vals` and writes each
// bin's first and last rank (INT_MAX, -1 for a bin without a sample inside
// the map). `ascending` says whether the samples' coordinates grow with
// their index (a non-negative bin size).
__device__ void rank_taps(int* slot, int P, int S, bool ascending, int* vals, int* span) {
  const int n = P * S;
  int cnt = 0, last = -1;
  for (int k = 0; k < n; ++k) {
    const int e = 2 * (ascending ? k : n - 1 - k);
    if (slot[e] < 0) continue;  // outside the map
    for (int j = 0; j < 2; ++j) {
      const int v = slot[e + j];
      if (v > last) {
        vals[cnt] = v;
        slot[e + j] = cnt++;
        last = v;
      } else {  // v is one of the last two distinct taps, which are consecutive
        slot[e + j] = cnt - 1 - (last - v);
      }
    }
  }
  for (int p = 0; p < P; ++p) {
    int mn = INT_MAX, mx = -1;
    for (int e = 2 * p * S; e < 2 * (p + 1) * S; ++e) {
      if (slot[e] >= 0) {
        mn = min(mn, slot[e]);
        mx = max(mx, slot[e]);
      }
    }
    span[2 * p] = mn;
    span[2 * p + 1] = mx;
  }
}

// The end of the run of bins from `a` whose ranks span at most `limit`;
// [lo, hi] is the run's rank range (hi = -1 when no bin of it meets the map).
__device__ int bin_run(const int* span, int a, int P, int limit, int& lo, int& hi) {
  lo = INT_MAX;
  hi = -1;
  int b = a;
  for (; b < P; ++b) {
    const int mn = min(lo, span[2 * b]), mx = max(hi, span[2 * b + 1]);
    if (mx >= 0 && mx - mn >= limit) break;
    lo = mn;
    hi = mx;
  }
  return b;
}

// Bin p's weights summed by rank, over its rank range: dense[k] for rank
// span[2p] + k.
__device__ void dense_weights(const int* slot, const float* w, const int* span, int p, int S, float* dense) {
  const int taps = 2 * S;
  for (int k = 0; k < taps; ++k) dense[p * taps + k] = 0.0f;
  for (int e = p * taps; e < (p + 1) * taps; ++e)
    if (slot[e] >= 0) dense[p * taps + slot[e] - span[2 * p]] += w[e];
}

size_t fwd_smem_bytes(int PH, int PW, int S) {
  const size_t taps = 2 * static_cast<size_t>(S) * (PH + PW);
  return static_cast<size_t>(kStageRows) * kStageCols * kVecsPerPixel * 16  // staged pixels
         + taps * (4 + 4 + 4 + 4)                                           // rank, weight, distinct tap, dense
         + 2 * static_cast<size_t>(PH + PW) * 4;                            // each bin's rank range
}

template <typename T>
__global__ void __launch_bounds__(kFwdThreads)
    roi_align_fwd_kernel(const T* __restrict__ feat, const int* __restrict__ batch_idx,
                         const float* __restrict__ boxes, T* __restrict__ out, int B, int H, int W, int C, int PH,
                         int PW, float spatial_scale, int S, int aligned) {
  constexpr int N = Vec<T>::N;
  extern __shared__ uint4 smem[];
  uint4* stage = smem;  // [kStageRows][kStageCols][kVecsPerPixel]
  const int ny = 2 * S * PH, nx = 2 * S * PW;
  int* y_slot = reinterpret_cast<int*>(stage + kStageRows * kStageCols * kVecsPerPixel);
  float* y_w = reinterpret_cast<float*>(y_slot + ny);
  int* x_slot = reinterpret_cast<int*>(y_w + ny);
  float* x_w = reinterpret_cast<float*>(x_slot + nx);
  int* y_val = reinterpret_cast<int*>(x_w + nx);
  int* x_val = y_val + ny;
  int* y_span = x_val + nx;
  int* x_span = y_span + 2 * PH;
  float* y_dense = reinterpret_cast<float*>(x_span + 2 * PW);
  float* x_dense = y_dense + ny;

  const int r = blockIdx.x;
  const int c0 = blockIdx.y * kVecsPerPixel * N;
  const int b = batch_idx[r];
  const bool in_batch = b >= 0 && b < B;  // an image index outside the batch pools nothing
  const Frame f = roi_frame(boxes + 4 * static_cast<size_t>(r), PH, PW, spatial_scale, aligned);

  for (int t = threadIdx.x; t < (PH + PW) * S; t += blockDim.x) {
    const bool is_y = t < PH * S;
    const int u = is_y ? t : t - PH * S;
    int* idx = (is_y ? y_slot : x_slot) + 2 * u;
    float* w = (is_y ? y_w : x_w) + 2 * u;
    if (in_batch) {
      const float coord = sample_coord(is_y ? f.y1 : f.x1, is_y ? f.bin_h : f.bin_w, u / S, sample_frac(u % S, S));
      sample_taps(coord, S, is_y ? H : W, idx, w);
    } else {
      idx[0] = idx[1] = -1;
      w[0] = w[1] = 0.0f;
    }
  }
  __syncthreads();
  if (threadIdx.x == 0) rank_taps(y_slot, PH, S, !(f.bin_h < 0.0f), y_val, y_span);
  if (threadIdx.x == 32) rank_taps(x_slot, PW, S, !(f.bin_w < 0.0f), x_val, x_span);
  __syncthreads();
  for (int t = threadIdx.x; t < PH + PW; t += blockDim.x) {
    if (t < PH) dense_weights(y_slot, y_w, y_span, t, S, y_dense);
    else dense_weights(x_slot, x_w, x_span, t - PH, S, x_dense);
  }
  __syncthreads();

  const T* img = feat + static_cast<size_t>(in_batch ? b : 0) * H * W * C;
  const int taps = 2 * S;
  for (int qa = 0; qa < PW;) {
    int cmin, cmax;
    const int qb = bin_run(x_span, qa, PW, kStageCols, cmin, cmax);
    for (int pa = 0; pa < PH;) {
      int rmin, rmax;
      const int pb = bin_run(y_span, pa, PH, kStageRows, rmin, rmax);
      if (rmax >= 0 && cmax >= 0) {
        const int nr = rmax - rmin + 1, nc = cmax - cmin + 1;
        for (int i = threadIdx.x; i < nr * nc * kVecsPerPixel; i += blockDim.x) {
          const int v = i % kVecsPerPixel, pix = i / kVecsPerPixel;
          const int jr = pix / nc, jc = pix % nc;
          const int c = c0 + v * N;
          if (c < C)
            cp_async16(stage + (jr * kStageCols + jc) * kVecsPerPixel + v,
                       img + (static_cast<size_t>(y_val[rmin + jr]) * W + x_val[cmin + jc]) * C + c);
        }
        cp_async_wait_all();
      }
      __syncthreads();
      const int nq = qb - qa;
      const int n_out = (pb - pa) * nq;
      for (int i = threadIdx.x; i < n_out * kVecsPerPixel; i += blockDim.x) {
        const int v = i % kVecsPerPixel, o = i / kVecsPerPixel;
        const int p = pa + o / nq, q = qa + o % nq;
        const int c = c0 + v * N;
        if (c >= C) continue;
        float acc[N];
#pragma unroll
        for (int k = 0; k < N; ++k) acc[k] = 0.0f;
        const int y0 = y_span[2 * p], x0 = x_span[2 * q];
        const int n_y = y_span[2 * p + 1] - y0 + 1, n_x = x_span[2 * q + 1] - x0 + 1;  // <= 0 outside the map
        const float* wys = y_dense + p * taps;
        const float* wxs = x_dense + q * taps;
        const uint4* corner = stage + v;
        if (n_y > 0 && n_x > 0) corner += ((y0 - rmin) * kStageCols + (x0 - cmin)) * kVecsPerPixel;
        for (int iy = 0; iy < n_y && n_x > 0; ++iy) {
          const float wy = wys[iy];
          if (wy == 0.0f) continue;
          const uint4* row = corner + iy * kStageCols * kVecsPerPixel;
          float racc[N];
#pragma unroll
          for (int k = 0; k < N; ++k) racc[k] = 0.0f;
          for (int jx = 0; jx < n_x; ++jx) {
            const float wx = wxs[jx];
            if (wx == 0.0f) continue;
            float val[N];
            Vec<T>::unpack(row[jx * kVecsPerPixel], val);
#pragma unroll
            for (int k = 0; k < N; ++k) racc[k] = fmaf(wx, val[k], racc[k]);
          }
#pragma unroll
          for (int k = 0; k < N; ++k) acc[k] = fmaf(wy, racc[k], acc[k]);
        }
        *reinterpret_cast<uint4*>(out + ((static_cast<size_t>(r) * PH + p) * PW + q) * C + c) = Vec<T>::pack(acc);
      }
      __syncthreads();  // the next run restages
      pa = pb;
    }
    qa = qb;
  }
}

// ---------------------------------------------------------------------------
// Kernel K3: RoIAlign backward, the gradient of K1 with respect to the map.
//
// Replaces the TPU kernel `_bwd_kernel_v2` (wrapper `_bwd_rule_v2`) of
// cddmsl_tpu/ops/pallas/roi_align_pallas.py, and the XLA einsums of the v1
// backward `_bwd_rule`. The plain PyTorch version it is held against is
// `roi_align_backward_plain` in cddmsl_torch/ops/roi_align.py. The ROIs get
// no gradient.
//
// What bounds it on an H100: bytes, above all g (1024 ROIs x 14 x 14 x 1024
// bf16, about 0.41 GB in the training step); the work is 16 multiply-adds
// per gradient value at S = 2.
//
// Design: a gather, with no atomics and no scratch. The TPU kernel keeps an
// fp32 sum of its channel tile in VMEM while the ROIs stream past in a
// sequential grid; here a loop inside the block takes the grid's place. One
// block per (image, kTileH x kTileW map tile, channel tile of 256 bytes)
// holds the fp32 sums of its tile in registers, two 16-byte channel vectors
// of one pixel per thread. The block walks the ROIs in index order, skipping
// those of other images and those whose tap footprint misses the tile. For
// each ROI left, one warp per tile row (and per tile column) lists the bins
// with a nonzero weight on that row, the S samples of a bin summed, with one
// lane per bin and a ballot to keep the list in bin order. The block stages
// the g vectors of the bins those lists name, at most kStageBins x
// kStageBins at a time, into shared memory with 16-byte cp.async copies, and
// each thread adds Wy * Wx * g over its row's and its column's lists. The
// lists are the same for every channel tile, so the channel tile is wide:
// the per-ROI work of a block (lists, staging, barriers) is paid once for
// 256 bytes of channels. dF is written once, in the map's dtype, zeros where
// no ROI reaches. The order of every sum is fixed, so dF is the same bit for
// bit from run to run.
constexpr int kTileH = 8;
constexpr int kTileW = 8;
constexpr int kLists = kTileH + kTileW;
constexpr int kBwdVecs = 16;  // 16-byte vectors per pixel of a channel tile: 256 bytes of channels
constexpr int kBwdThreads = kTileH * kTileW * kBwdVecs / 2;  // 512, two vectors each: one warp per list
constexpr int kStageBins = 16;
constexpr size_t kBwdStageBytes = static_cast<size_t>(kStageBins) * kStageBins * kBwdVecs * 16;
static_assert(kBwdThreads / 32 == kLists, "one warp per list");

struct BinWeight {
  int bin;
  float w;
};

template <typename T>
__global__ void __launch_bounds__(kBwdThreads, 2)
    roi_align_bwd_kernel(const T* __restrict__ grad, const int* __restrict__ batch_idx,
                         const float* __restrict__ boxes, T* __restrict__ dfeat, int H, int W, int C, int R, int PH,
                         int PW, float spatial_scale, int S, int aligned, int tiles_w) {
  constexpr int N = Vec<T>::N;
  extern __shared__ uint4 stage[];  // [kStageBins][kStageBins][kBwdVecs] vectors of g
  __shared__ int hit_roi[kBwdThreads];
  __shared__ Frame hit_frame[kBwdThreads];
  __shared__ int warp_hits[kBwdThreads / 32];
  __shared__ float frac[kMaxSamples];
  __shared__ BinWeight lists[kLists][kMaxPooled];  // per tile row, then per tile column
  __shared__ int list_len[kLists];
  __shared__ int2 list_ends[kLists];  // each list's first and last bin; (INT_MAX, -1) when empty

  const int h0 = (blockIdx.x / tiles_w) * kTileH, w0 = (blockIdx.x % tiles_w) * kTileW;
  const int c0 = blockIdx.y * kBwdVecs * N;
  const int b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int v = tid % (kBwdVecs / 2), pix = tid / (kBwdVecs / 2);  // vectors v and v + kBwdVecs / 2
  const int ty = pix / kTileW, tx = pix % kTileW;
  const int h = h0 + ty, w = w0 + tx;
  const int c_lo = c0 + v * N, c_hi = c_lo + kBwdVecs / 2 * N;
  const bool in_map = h < H && w < W;
  const int h1 = min(h0 + kTileH, H) - 1, w1 = min(w0 + kTileW, W) - 1;
  // this warp's list: a tile row, or a tile column
  const bool list_is_y = warp < kTileH;
  const int list_at = list_is_y ? h0 + warp : w0 + warp - kTileH;
  const int list_dim = list_is_y ? H : W, list_bins = list_is_y ? PH : PW;
  if (tid < S) frac[tid] = sample_frac(tid, S);

  float acc[2][N];
#pragma unroll
  for (int k = 0; k < N; ++k) acc[0][k] = acc[1][k] = 0.0f;

  for (int base = 0; base < R; base += kBwdThreads) {
    // the ROIs of this chunk that reach the tile, compacted in index order
    const int r = base + tid;
    bool hit = false;
    Frame f{};
    if (r < R && batch_idx[r] == b) {
      f = roi_frame(boxes + 4 * static_cast<size_t>(r), PH, PW, spatial_scale, aligned);
      hit = footprint_meets(f.y1, f.bin_h, PH, S, H, h0, h1) && footprint_meets(f.x1, f.bin_w, PW, S, W, w0, w1);
    }
    const unsigned ballot = __ballot_sync(0xffffffffu, hit);
    if (lane == 0) warp_hits[warp] = __popc(ballot);
    __syncthreads();
    int offset = 0, n_hits = 0;
    for (int i = 0; i < kBwdThreads / 32; ++i) {
      offset += i < warp ? warp_hits[i] : 0;
      n_hits += warp_hits[i];
    }
    if (hit) {
      const int at = offset + __popc(ballot & ((1u << lane) - 1u));
      hit_roi[at] = r;
      hit_frame[at] = f;
    }
    __syncthreads();

    for (int k = 0; k < n_hits; ++k) {
      // this warp's list for the ROI
      const Frame fr = hit_frame[k];
      int len = 0;
      if (list_at < list_dim) {  // uniform across the warp
        const float start = list_is_y ? fr.y1 : fr.x1, bin = list_is_y ? fr.bin_h : fr.bin_w;
        for (int p0 = 0; p0 < list_bins; p0 += 32) {
          const int p = p0 + lane;
          float wsum = 0.0f;
          if (p < list_bins) {
            for (int s = 0; s < S; ++s) {
              int idx[2];
              float wt[2];
              sample_taps(sample_coord(start, bin, p, frac[s]), S, list_dim, idx, wt);
              if (idx[0] == list_at) wsum += wt[0];
              if (idx[1] == list_at) wsum += wt[1];
            }
          }
          const unsigned m = __ballot_sync(0xffffffffu, wsum != 0.0f);
          if (wsum != 0.0f) lists[warp][len + __popc(m & ((1u << lane) - 1u))] = {p, wsum};
          len += __popc(m);
        }
      }
      if (lane == 0) {
        list_len[warp] = len;
        list_ends[warp] = len ? make_int2(lists[warp][0].bin, lists[warp][len - 1].bin) : make_int2(INT_MAX, -1);
      }
      __syncthreads();

      // the bins the lists name: rows of bins [pa, pb] from lanes 0-7, columns [qa, qb] from lanes 8-15
      int2 e = list_ends[lane % kLists];
#pragma unroll
      for (int d = 1; d < kTileH; d *= 2) {
        e.x = min(e.x, __shfl_xor_sync(0xffffffffu, e.x, d));
        e.y = max(e.y, __shfl_xor_sync(0xffffffffu, e.y, d));
      }
      const int pa = __shfl_sync(0xffffffffu, e.x, 0), pb = __shfl_sync(0xffffffffu, e.y, 0);
      const int qa = __shfl_sync(0xffffffffu, e.x, kTileH), qb = __shfl_sync(0xffffffffu, e.y, kTileH);
      const T* g_roi = grad + static_cast<size_t>(hit_roi[k]) * PH * PW * C;
      for (int pc = pa; pc <= pb; pc += kStageBins) {
        for (int qc = qa; qc <= qb; qc += kStageBins) {
          const int np = min(kStageBins, pb - pc + 1), nq = min(kStageBins, qb - qc + 1);
          for (int i = tid; i < np * kStageBins * kBwdVecs; i += kBwdThreads) {
            const int vi = i % kBwdVecs, qq = (i / kBwdVecs) % kStageBins, pp = i / (kBwdVecs * kStageBins);
            const int ci = c0 + vi * N;
            if (qq < nq && ci < C)
              cp_async16(stage + i, g_roi + (static_cast<size_t>(pc + pp) * PW + qc + qq) * C + ci);
          }
          cp_async_wait_all();
          __syncthreads();
          if (in_map) {
            const int ny = list_len[ty], nx = list_len[kTileH + tx];
            for (int i = 0; i < ny; ++i) {
              const BinWeight py = lists[ty][i];
              if (py.bin < pc || py.bin >= pc + np) continue;
              const uint4* row = stage + (py.bin - pc) * kStageBins * kBwdVecs + v;
              for (int j = 0; j < nx; ++j) {
                const BinWeight qx = lists[kTileH + tx][j];
                if (qx.bin < qc || qx.bin >= qc + nq) continue;
                const uint4* at = row + (qx.bin - qc) * kBwdVecs;
                const uint4 raw[2] = {at[0], at[kBwdVecs / 2]};
                const float wgt = py.w * qx.w;
#pragma unroll
                for (int u = 0; u < 2; ++u) {
                  float val[N];
                  Vec<T>::unpack(raw[u], val);
#pragma unroll
                  for (int t = 0; t < N; ++t) acc[u][t] = fmaf(wgt, val[t], acc[u][t]);
                }
              }
            }
          }
          __syncthreads();  // the next run restages
        }
      }
      __syncthreads();  // the next ROI rewrites the lists (a no-op barrier when no bin was staged)
    }
  }
  if (in_map) {
    T* px = dfeat + ((static_cast<size_t>(b) * H + h) * W + w) * C;
    if (c_lo < C) *reinterpret_cast<uint4*>(px + c_lo) = Vec<T>::pack(acc[0]);
    if (c_hi < C) *reinterpret_cast<uint4*>(px + c_hi) = Vec<T>::pack(acc[1]);
  }
}

bool valid_shape(int B, int H, int W, int C, int R, int PH, int PW, int S) {
  return R >= 0 && PH > 0 && PH <= kMaxPooled && PW > 0 && PW <= kMaxPooled && S >= 1 && S <= kMaxSamples &&
         C > 0 && C % 8 == 0 && H > 0 && W > 0 && B > 0;
}

template <typename T>
int launch_fwd(const void* feat, const int* bi, const float* bx, void* out, int B, int H, int W, int C, int R,
               int PH, int PW, float spatial_scale, int S, int aligned, cudaStream_t st) {
  const size_t smem = fwd_smem_bytes(PH, PW, S);
  cudaError_t err = cudaFuncSetAttribute(roi_align_fwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int per_block = kVecsPerPixel * Vec<T>::N;
  const dim3 grid(static_cast<unsigned>(R), static_cast<unsigned>((C + per_block - 1) / per_block));
  roi_align_fwd_kernel<T><<<grid, kFwdThreads, smem, st>>>(static_cast<const T*>(feat), bi, bx,
                                                           static_cast<T*>(out), B, H, W, C, PH, PW,
                                                           spatial_scale, S, aligned);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_bwd(const void* grad, const int* bi, const float* bx, void* out, int B, int H, int W, int C, int R,
               int PH, int PW, float spatial_scale, int S, int aligned, cudaStream_t st) {
  const int per_block = kBwdVecs * Vec<T>::N;
  const int tiles_w = (W + kTileW - 1) / kTileW;
  const int tiles_h = (H + kTileH - 1) / kTileH;
  const dim3 grid(static_cast<unsigned>(tiles_h * tiles_w), static_cast<unsigned>((C + per_block - 1) / per_block),
                  static_cast<unsigned>(B));
  cudaError_t err = cudaFuncSetAttribute(roi_align_bwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(kBwdStageBytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  roi_align_bwd_kernel<T><<<grid, kBwdThreads, kBwdStageBytes, st>>>(
      static_cast<const T*>(grad), bi, bx, static_cast<T*>(out), H, W, C, R, PH, PW, spatial_scale, S, aligned,
      tiles_w);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Every pointer must be 16-byte aligned.
// Returns the cudaError_t of the launch.
extern "C" int cddmsl_roi_align_fwd(const void* feat, int dtype, const void* batch_idx, const void* boxes,
                                    void* out, int B, int H, int W, int C, int R, int PH, int PW,
                                    float spatial_scale, int S, int aligned, void* stream) {
  if (R <= 0 || !valid_shape(B, H, W, C, R, PH, PW, S)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* bi = static_cast<const int*>(batch_idx);
  const float* bx = static_cast<const float*>(boxes);
  if (dtype == 0) return launch_fwd<float>(feat, bi, bx, out, B, H, W, C, R, PH, PW, spatial_scale, S, aligned, st);
  if (dtype == 1)
    return launch_fwd<__nv_bfloat16>(feat, bi, bx, out, B, H, W, C, R, PH, PW, spatial_scale, S, aligned, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The gradient of cddmsl_roi_align_fwd with respect to the map: writes every
// value of `out` (B, H, W, C) in the map's dtype. Returns the cudaError_t of
// the launch.
extern "C" int cddmsl_roi_align_bwd(const void* grad, int dtype, const void* batch_idx, const void* boxes, void* out,
                                    int B, int H, int W, int C, int R, int PH, int PW, float spatial_scale, int S,
                                    int aligned, void* stream) {
  if (!valid_shape(B, H, W, C, R, PH, PW, S)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* bi = static_cast<const int*>(batch_idx);
  const float* bx = static_cast<const float*>(boxes);
  if (dtype == 0) return launch_bwd<float>(grad, bi, bx, out, B, H, W, C, R, PH, PW, spatial_scale, S, aligned, st);
  if (dtype == 1)
    return launch_bwd<__nv_bfloat16>(grad, bi, bx, out, B, H, W, C, R, PH, PW, spatial_scale, S, aligned, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
