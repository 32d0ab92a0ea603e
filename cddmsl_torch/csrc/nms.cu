// Kernel K4: greedy non-maximum suppression with a fixed-size output.
//
// Replaces the XLA kernel of cddmsl_tpu/ops/nms.py `nms` (kept-buffer tiles
// plus the `_resolve_tile` fixpoint) and, through the coordinate shift of
// `batched_nms`, its class-aware form. The plain PyTorch version it is held
// against is `nms_plain` in cddmsl_torch/ops/nms.py.
//
// The wrapper sorts each image's boxes by score (stable, descending, invalid
// rows last) and passes them in that order. Then:
//   1. nms_mask_kernel writes the upper-triangular suppression bitmask over
//      64-box column blocks: bit j of word (i, j / 64) is iou(i, j) > thr
//      for j > i.
//   2. nms_reduce_kernel, one block per image, walks the rows in score order
//      on the device. It skips rows that are suppressed or invalid, ORs each
//      kept row's words into the removed set, and stops once max_out boxes
//      are kept. It writes the kept rows' original indices, padded with 0,
//      and a validity mask. Nothing returns to the host.
//
// Exactness: the IoU is computed with the operation order of
// structures/boxes.py `pairwise_iou` (inter, then a1 + a2 - inter, then
// inter / union with the union > 0 guard), each step rounded on its own
// (__fmul_rn / __fadd_rn / __fsub_rn / __fdiv_rn, and -fmad=false for this
// file), so the kernel and the plain version agree bit for bit on every
// threshold test.
//
// What bounds it on an H100: neither bytes nor operations. The mask pass is
// N^2 / 2 IoUs (18 M at N = 6000), a few microseconds of the card's fp32
// rate. The walk is sequential: one block, one step per kept box, each a
// global load and two barriers. Its design keeps that walk short: the
// invalid rows are folded into the removed set up front, and runs of
// removed rows are skipped 64 at a time with a bit scan.

#include <cuda_runtime.h>

namespace {

constexpr int kBlock = 64;
constexpr int kReduceThreads = 128;

__device__ __forceinline__ float iou_rn(const float* a, const float* b) {
  const float lt_x = fmaxf(a[0], b[0]);
  const float lt_y = fmaxf(a[1], b[1]);
  const float rb_x = fminf(a[2], b[2]);
  const float rb_y = fminf(a[3], b[3]);
  const float w = fmaxf(__fsub_rn(rb_x, lt_x), 0.0f);
  const float h = fmaxf(__fsub_rn(rb_y, lt_y), 0.0f);
  const float inter = __fmul_rn(w, h);
  const float a1 = __fmul_rn(__fsub_rn(a[2], a[0]), __fsub_rn(a[3], a[1]));
  const float a2 = __fmul_rn(__fsub_rn(b[2], b[0]), __fsub_rn(b[3], b[1]));
  const float uni = __fsub_rn(__fadd_rn(a1, a2), inter);
  return uni > 0.0f ? __fdiv_rn(inter, uni) : 0.0f;
}

// grid (col_blocks, col_blocks, B), block kBlock threads: one 64 x 64 tile.
__global__ void nms_mask_kernel(const float* __restrict__ boxes, int N, int col_blocks, float thr,
                                unsigned long long* __restrict__ mask) {
  const int b = blockIdx.z;
  const int row_block = blockIdx.y;
  const int col_block = blockIdx.x;
  if (col_block < row_block) return;  // strictly lower tiles are never read
  __shared__ float cols[kBlock * 4];
  const float* img = boxes + static_cast<size_t>(b) * N * 4;
  const int n_cols = min(N - col_block * kBlock, kBlock);
  const int n_rows = min(N - row_block * kBlock, kBlock);
  if (threadIdx.x < n_cols) {
    const float* src = img + static_cast<size_t>(col_block * kBlock + threadIdx.x) * 4;
#pragma unroll
    for (int k = 0; k < 4; ++k) cols[threadIdx.x * 4 + k] = src[k];
  }
  __syncthreads();
  if (threadIdx.x >= n_rows) return;
  const int row = row_block * kBlock + threadIdx.x;
  float a[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) a[k] = img[static_cast<size_t>(row) * 4 + k];
  unsigned long long bits = 0;
  const int first = col_block == row_block ? threadIdx.x + 1 : 0;
  for (int j = first; j < n_cols; ++j) {
    if (iou_rn(a, &cols[j * 4]) > thr) bits |= 1ULL << j;
  }
  mask[(static_cast<size_t>(b) * N + row) * col_blocks + col_block] = bits;
}

// grid (B,), block kReduceThreads, dynamic shared memory col_blocks words.
__global__ void nms_reduce_kernel(const unsigned long long* __restrict__ mask,
                                  const unsigned char* __restrict__ valid, const long long* __restrict__ order,
                                  int N, int col_blocks, int max_out, long long* __restrict__ out_idx,
                                  unsigned char* __restrict__ out_valid) {
  extern __shared__ unsigned long long removed[];
  const int b = blockIdx.x;
  const unsigned char* vb = valid + static_cast<size_t>(b) * N;
  const unsigned long long* mb = mask + static_cast<size_t>(b) * N * col_blocks;
  const long long* ob = order + static_cast<size_t>(b) * N;
  long long* idx = out_idx + static_cast<size_t>(b) * max_out;
  unsigned char* ok = out_valid + static_cast<size_t>(b) * max_out;

  // invalid rows and the padding past N start out removed
  for (int w = threadIdx.x; w < col_blocks; w += blockDim.x) {
    unsigned long long word = 0;
    for (int k = 0; k < 64; ++k) {
      const int i = w * 64 + k;
      if (i >= N || !vb[i]) word |= 1ULL << k;
    }
    removed[w] = word;
  }
  __syncthreads();

  int count = 0;
  int w = 0;
  while (count < max_out && w < col_blocks) {
    const unsigned long long live = ~removed[w];
    if (live == 0) {
      ++w;
      continue;
    }
    const int bit = __ffsll(static_cast<long long>(live)) - 1;
    const int i = w * 64 + bit;
    __syncthreads();  // every thread has read removed[w] before it changes
    const unsigned long long* row = mb + static_cast<size_t>(i) * col_blocks;
    for (int k = w + threadIdx.x; k < col_blocks; k += blockDim.x) {
      unsigned long long v = row[k];
      if (k == w) v |= 1ULL << bit;  // row i itself is done
      removed[k] |= v;
    }
    if (threadIdx.x == 0) {
      idx[count] = ob[i];
      ok[count] = 1;
    }
    ++count;
    __syncthreads();
  }
  for (int k = count + threadIdx.x; k < max_out; k += blockDim.x) {
    idx[k] = 0;
    ok[k] = 0;
  }
}

}  // namespace

// boxes (B, N, 4) float32 and valid (B, N) uint8 in score order, order
// (B, N) int64 original index of each sorted row, mask (B, N, ceil(N/64))
// uint64 scratch; writes out_idx (B, max_out) int64 and out_valid
// (B, max_out) uint8. Returns the cudaError_t of the launches.
extern "C" int cddmsl_nms(const void* boxes, const void* valid, const void* order, void* mask, void* out_idx,
                          void* out_valid, int B, int N, float thr, int max_out, void* stream) {
  if (B <= 0 || N <= 0 || max_out <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int col_blocks = (N + kBlock - 1) / kBlock;
  const size_t smem = static_cast<size_t>(col_blocks) * sizeof(unsigned long long);
  if (col_blocks > 65535 || B > 65535 || smem > 48 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto* m = static_cast<unsigned long long*>(mask);
  const dim3 grid(col_blocks, col_blocks, B);
  nms_mask_kernel<<<grid, kBlock, 0, st>>>(static_cast<const float*>(boxes), N, col_blocks, thr, m);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  nms_reduce_kernel<<<B, kReduceThreads, smem, st>>>(
      m, static_cast<const unsigned char*>(valid), static_cast<const long long*>(order), N, col_blocks, max_out,
      static_cast<long long*>(out_idx), static_cast<unsigned char*>(out_valid));
  return static_cast<int>(cudaGetLastError());
}
