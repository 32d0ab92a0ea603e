// Kernel K1: RoIAlign forward over a batched channels-last feature map.
//
// Replaces the TPU kernels of cddmsl_tpu/ops/pallas/roi_align_pallas.py:
// `_fwd_kernel` (wrapper `_fwd`) and `_fwd_kernel_v2` (wrapper `_fwd_v2`),
// which compute the same function. The plain PyTorch version it is held
// against is `roi_align_batched_plain` in cddmsl_torch/ops/roi_align.py.
//
//   out[r, p, q, c] = sum_h sum_w Wy[r, p, h] * Wx[r, q, w] * F[b(r), h, w, c]
//
// Wy and Wx average the bilinear weights of the S sample points of each bin
// (S = 2 when sampling_ratio is 0). A sample point counts only if it lies in
// (-1, dim); its coordinate is clamped to [0, dim - 1]. So each output row p
// touches at most 2S map rows and each output column q at most 2S map
// columns: the kernel keeps those taps and their weights instead of the
// dense interpolation matrices.
//
// What bounds it on an H100: bytes. At the flagship shapes (1000 ROIs,
// 14 x 14 bins, 1024 channels, bf16) the output alone is about 401 MB, while
// the 40 x 50 x 1024 map (4 MB) stays resident in the 50 MB L2. The work is
// about 16 multiply-adds per output value, far below the card's
// operations-per-byte line.
//
// Design: one block per (ROI, output row p). The block first computes the
// y taps of row p and the x taps of every output column into shared memory.
// Threads then run along the channels, two channels per thread, so every
// tap is a coalesced 4-byte (bf16) or 8-byte (fp32) load and every store of
// out[r, p, q, :] is coalesced. Sums are taken in fp32 and rounded once to
// the map's dtype. No tensor cores, TMA or wgmma yet.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxSamples = 8;  // samples per bin axis
constexpr int kMaxTaps = 2 * kMaxSamples;
constexpr int kMaxPooled = 64;  // PW

__device__ __forceinline__ float2 load2(const float* p) { return *reinterpret_cast<const float2*>(p); }

__device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

__device__ __forceinline__ void store2(float* p, float2 v) { *reinterpret_cast<float2*>(p) = v; }

__device__ __forceinline__ void store2(__nv_bfloat16* p, float2 v) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __float22bfloat162_rn(v);
}

// The two taps of sample s of bin p along one axis, with the weights of
// ops/roi_align.py `_interp_matrix`: max(0, 1 - |cc - g|) on the grid rows
// g = floor(cc) and floor(cc) + 1, zero outside (-1, dim), divided by S.
// The coordinate is rounded step by step as the plain version rounds it.
__device__ void sample_taps(float start, float bin, int p, int s, int S, int dim, int* idx, float* w) {
  const float frac = __fdiv_rn(__fadd_rn(static_cast<float>(s), 0.5f), static_cast<float>(S));
  const float coord = __fadd_rn(start, __fmul_rn(__fadd_rn(static_cast<float>(p), frac), bin));
  const bool in_range = coord > -1.0f && coord < static_cast<float>(dim);
  const float cc = fminf(fmaxf(coord, 0.0f), static_cast<float>(dim - 1));
  const int lo = static_cast<int>(floorf(cc));
  const int hi = lo + 1 < dim ? lo + 1 : lo;
  const float scale = in_range ? 1.0f / static_cast<float>(S) : 0.0f;
  idx[0] = lo;
  w[0] = fmaxf(0.0f, 1.0f - fabsf(cc - static_cast<float>(lo))) * scale;
  idx[1] = hi;
  w[1] = lo + 1 < dim ? fmaxf(0.0f, 1.0f - fabsf(cc - static_cast<float>(lo + 1))) * scale : 0.0f;
}

template <typename T>
__global__ void roi_align_fwd_kernel(const T* __restrict__ feat, const int* __restrict__ batch_idx,
                                     const float* __restrict__ boxes, T* __restrict__ out, int B, int H,
                                     int W, int C, int PH, int PW, float spatial_scale, int S,
                                     int aligned) {
  __shared__ int x_idx[kMaxPooled * kMaxTaps];
  __shared__ float x_w[kMaxPooled * kMaxTaps];
  __shared__ int y_idx[kMaxTaps];
  __shared__ float y_w[kMaxTaps];

  const int r = blockIdx.x / PH;
  const int p = blockIdx.x % PH;
  const int taps = 2 * S;

  const float offset = aligned ? 0.5f : 0.0f;
  const float* box = boxes + 4 * static_cast<size_t>(r);
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
  const float bin_w = __fdiv_rn(roi_w, static_cast<float>(PW));
  const float bin_h = __fdiv_rn(roi_h, static_cast<float>(PH));

  for (int t = threadIdx.x; t < PW * S; t += blockDim.x) {
    const int q = t / S, s = t % S;
    sample_taps(x1, bin_w, q, s, S, W, &x_idx[q * taps + 2 * s], &x_w[q * taps + 2 * s]);
  }
  for (int s = threadIdx.x; s < S; s += blockDim.x) {
    sample_taps(y1, bin_h, p, s, S, H, &y_idx[2 * s], &y_w[2 * s]);
  }
  __syncthreads();

  T* out_row = out + (static_cast<size_t>(r) * PH + p) * PW * C;
  const int b = batch_idx[r];
  const int half_c = C / 2;
  if (b < 0 || b >= B) {  // an image index outside the batch pools nothing
    for (int c2 = threadIdx.x; c2 < half_c; c2 += blockDim.x)
      for (int q = 0; q < PW; ++q) store2(out_row + static_cast<size_t>(q) * C + 2 * c2, make_float2(0.f, 0.f));
    return;
  }
  const T* img = feat + static_cast<size_t>(b) * H * W * C;

  for (int c2 = threadIdx.x; c2 < half_c; c2 += blockDim.x) {
    const int c = 2 * c2;
    for (int q = 0; q < PW; ++q) {
      float2 acc = make_float2(0.f, 0.f);
      for (int i = 0; i < taps; ++i) {
        const float wy = y_w[i];
        if (wy == 0.0f) continue;  // uniform across the block
        const T* row = img + static_cast<size_t>(y_idx[i]) * W * C + c;
        for (int j = 0; j < taps; ++j) {
          const float wx = x_w[q * taps + j];
          if (wx == 0.0f) continue;
          const float wgt = wy * wx;
          const float2 v = load2(row + static_cast<size_t>(x_idx[q * taps + j]) * C);
          acc.x += wgt * v.x;
          acc.y += wgt * v.y;
        }
      }
      store2(out_row + static_cast<size_t>(q) * C + c, acc);
    }
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Returns the cudaError_t of the launch.
extern "C" int cddmsl_roi_align_fwd(const void* feat, int dtype, const void* batch_idx, const void* boxes,
                                    void* out, int B, int H, int W, int C, int R, int PH, int PW,
                                    float spatial_scale, int S, int aligned, void* stream) {
  if (R <= 0 || PH <= 0 || PW <= 0 || PW > kMaxPooled || S < 1 || S > kMaxSamples || C <= 0 || C % 2 ||
      H <= 0 || W <= 0 || B <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int half_c = C / 2;
  int threads = ((half_c + 31) / 32) * 32;
  if (threads > 256) threads = 256;
  const dim3 grid(static_cast<unsigned>(R) * static_cast<unsigned>(PH));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* bi = static_cast<const int*>(batch_idx);
  const float* bx = static_cast<const float*>(boxes);
  if (dtype == 0) {
    roi_align_fwd_kernel<float><<<grid, threads, 0, st>>>(static_cast<const float*>(feat), bi, bx,
                                                          static_cast<float*>(out), B, H, W, C, PH, PW,
                                                          spatial_scale, S, aligned);
  } else if (dtype == 1) {
    roi_align_fwd_kernel<__nv_bfloat16><<<grid, threads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(feat), bi, bx, static_cast<__nv_bfloat16*>(out), B, H, W, C, PH,
        PW, spatial_scale, S, aligned);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
