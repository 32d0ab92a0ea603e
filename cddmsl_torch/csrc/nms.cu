// Kernel K4: greedy non-maximum suppression with a fixed-size output.
//
// Replaces the XLA kernel of cddmsl_tpu/ops/nms.py `nms` (kept-buffer tiles
// plus the `_resolve_tile` fixpoint) and, through the coordinate shift of
// `batched_nms`, its class-aware form. The plain PyTorch version it is held
// against is `nms_plain` in cddmsl_torch/ops/nms.py.
//
// The wrapper sorts each image's scores (stable, descending, invalid rows
// last) and passes the order; boxes and validity stay in their own order and
// are read through it. Rows are taken in 64-row blocks. Then:
//   1. nms_mask_kernel, 64 threads a (image, row block <= column block) tile
//      of the upper triangle, tiles taken from a linear index, writes
//      the suppression words column-block-major: word (column block k, row i)
//      has bit j set when iou(i, 64 k + j) > thr. A row block's 64 words of
//      one column block are 512 contiguous bytes. The diagonal tile writes
//      its block's words column-wise (bit i of column j's word: row i < j
//      suppresses row j), 512 contiguous bytes the walk reads in one piece,
//      and the block's start-out removed word: invalid rows and the padding
//      past N.
//   2. nms_walk_kernel, one block per image, walks the row blocks in order.
//      Warp 0 resolves block s from registers: lane l holds the column words
//      of rows l and l + 32, and the warp iterates keep <- live &
//      ~suppressed_by(keep), one ballot a round, to its fixpoint, which is
//      the greedy answer (row j is final after j + 1 rounds; the round count
//      is the longest chain of suppressions in the block, not the rows
//      kept). The block's last kept rows are dropped past max_out. Warp 0
//      writes the kept rows' original indices and validity. Meanwhile the
//      other warps pull what block s + 1 needs from the rows decided before
//      block s (the kept rows' words of column block s + 1, contiguous,
//      OR-reduced into shared memory) and prefetch block s + 1's diagonal
//      and the words block s adds to it, 1 KB, with cp.async. One barrier a
//      block; once max_out rows are kept, every thread stops.
//
// Exactness: the threshold test is that of structures/boxes.py
// `pairwise_iou` (inter, then a1 + a2 - inter, then inter / union with the
// union > 0 guard), each step rounded on its own (__fmul_rn / __fadd_rn /
// __fsub_rn / __fdiv_rn, and -fmad=false for this file), so the kernel and
// the plain version agree bit for bit on every decision. For thr >= 2^-100
// the division is skipped only where its result cannot change the
// comparison: e = fma(-thr, union, inter) has the exact sign of inter - thr *
// union, so e < 0 (every pair that does not intersect) means iou <= thr, and
// e above 2^-20 * thr * union means the rounded quotient is above thr. Every
// other pair, and every pair at a smaller threshold, divides.
//
// What bounds it on an H100: neither bytes nor operations (the work the
// greedy answer needs is well under a microsecond of the card). The limit is
// the greedy walk's chain of dependent steps. A walk that takes one step per
// kept box, each a load of that box's row of the mask (mostly L2 misses)
// between two barriers, waits on about 2000 dependent misses per image at
// training. This walk takes one step per 64-row block (188 at N = 12000),
// resolves the block from registers, and keeps global loads off the chain:
// what block s + 1 needs is gathered and prefetched while block s is
// resolved. The mask pass is compute-bound on the IoU tests (about 30
// instructions a pair), so it uses the whole card and launches no tile below
// the diagonal.

#include <cuda_runtime.h>

namespace {

constexpr int kBlock = 64;
constexpr int kWalkThreads = 512;
constexpr int kMaxWalkSmem = 220 * 1024;

typedef unsigned long long u64;

__device__ __forceinline__ float box_area(const float4 b) {
  return __fmul_rn(__fsub_rn(b.z, b.x), __fsub_rn(b.w, b.y));
}

// iou(a, b) > thr, exactly as pairwise_iou rounds it (a is the earlier row).
// fast (thr >= 2^-100, the same in every thread): decide without the
// division where it cannot matter; thr_m = thr * 2^-20, a normal float then.
__device__ __forceinline__ bool above(const float4 a, float a_area, const float4 b, float b_area, float thr,
                                      bool fast, float thr_m) {
  const float w = fmaxf(__fsub_rn(fminf(a.z, b.z), fmaxf(a.x, b.x)), 0.0f);
  const float h = fmaxf(__fsub_rn(fminf(a.w, b.w), fmaxf(a.y, b.y)), 0.0f);
  const float inter = __fmul_rn(w, h);
  const float uni = __fsub_rn(__fadd_rn(a_area, b_area), inter);
  if (fast) {
    const float e = __fmaf_rn(-thr, uni, inter);  // the exact sign of inter - thr * uni
    const float margin = __fmul_rn(thr_m, uni);
    const bool yes = e > margin && margin >= 1.17549435e-38f;
    if (e < 0.0f || yes) return yes;  // e < 0 implies uni > 0
  }
  return (uni > 0.0f ? __fdiv_rn(inter, uni) : 0.0f) > thr;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(gmem));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\n" ::);
  asm volatile("cp.async.wait_group 0;\n" ::);
}

__device__ __forceinline__ u64 warp_or(u64 v) {
  const unsigned lo = __reduce_or_sync(0xffffffffu, static_cast<unsigned>(v));
  const unsigned hi = __reduce_or_sync(0xffffffffu, static_cast<unsigned>(v >> 32));
  return (static_cast<u64>(hi) << 32) | lo;
}

// grid (nb (nb + 1) / 2, B), kBlock threads: block (t, b) computes tile
// t = cb (cb + 1) / 2 + rb of image b, row block rb <= column block cb.
// mask is (B, nb, nb * 64) words, mask[b][cb][row]: thread r of an
// off-diagonal tile writes row 64 rb + r's bits over the column block. A
// diagonal tile writes the block's words column-wise instead: thread j's word
// has bit i set when row i < j suppresses row j (the same test, the earlier
// row first), and the block's start-out removed word into removed0 (B, nb).
__global__ void __launch_bounds__(kBlock) nms_mask_kernel(
    const float4* __restrict__ boxes, const unsigned char* __restrict__ valid, const long long* __restrict__ order,
    int N, int nb, float thr, u64* __restrict__ mask, u64* __restrict__ removed0) {
  __shared__ float4 cols[kBlock];
  __shared__ float col_area[kBlock];
  __shared__ unsigned live_half[2];
  const long long t = blockIdx.x;
  const int b = blockIdx.y;
  int cb = static_cast<int>((sqrt(8.0 * static_cast<double>(t) + 1.0) - 1.0) * 0.5);
  while (static_cast<long long>(cb) * (cb + 1) / 2 > t) --cb;
  while (static_cast<long long>(cb + 1) * (cb + 2) / 2 <= t) ++cb;
  const int rb = static_cast<int>(t - static_cast<long long>(cb) * (cb + 1) / 2);
  const int tid = threadIdx.x;
  const long long* ob = order + static_cast<size_t>(b) * N;
  const float4* bb = boxes + static_cast<size_t>(b) * N;
  const int n_cols = min(N - cb * kBlock, kBlock);
  const int n_rows = min(N - rb * kBlock, kBlock);
  if (tid < n_cols) {
    const float4 c = bb[ob[cb * kBlock + tid]];
    cols[tid] = c;
    col_area[tid] = box_area(c);
  }
  if (rb == cb) {  // invalid rows and the padding past N
    const bool live = tid < n_rows && valid[static_cast<size_t>(b) * N + ob[rb * kBlock + tid]];
    const unsigned ballot = __ballot_sync(0xffffffffu, live);
    if ((tid & 31) == 0) live_half[tid >> 5] = ballot;
  }
  __syncthreads();
  if (tid >= n_rows) return;
  const bool fast = thr >= 0x1p-100f;
  const float thr_m = __fmul_rn(thr, 0x1p-20f);
  u64 bits = 0;
  if (rb == cb) {
    if (tid == 0) removed0[static_cast<size_t>(b) * nb + rb] = ~((static_cast<u64>(live_half[1]) << 32) | live_half[0]);
    const float4 me = cols[tid];
    const float me_area = col_area[tid];
    for (int i = 0; i < tid; ++i)
      if (above(cols[i], col_area[i], me, me_area, thr, fast, thr_m)) bits |= 1ULL << i;
  } else {
    const float4 a = bb[ob[rb * kBlock + tid]];
    const float a_area = box_area(a);
    if (n_cols == kBlock) {
#pragma unroll
      for (int j = 0; j < kBlock; ++j)
        if (above(a, a_area, cols[j], col_area[j], thr, fast, thr_m)) bits |= 1ULL << j;
    } else {
      for (int j = 0; j < n_cols; ++j)
        if (above(a, a_area, cols[j], col_area[j], thr, fast, thr_m)) bits |= 1ULL << j;
    }
  }
  mask[(static_cast<size_t>(b) * nb + cb) * nb * kBlock + rb * kBlock + tid] = bits;
}

// grid (B,), block kWalkThreads, dynamic shared memory 2 nb words.
__global__ void __launch_bounds__(kWalkThreads) nms_walk_kernel(
    const u64* __restrict__ mask, const u64* __restrict__ removed0, const long long* __restrict__ order,
    const float* __restrict__ sorted_scores, int N, int nb, int max_out, long long* __restrict__ out_idx,
    unsigned char* __restrict__ out_valid) {
  extern __shared__ u64 smem[];
  u64* kept = smem;  // kept rows of each decided block
  u64* start_removed = smem + nb;
  // buf[p][0, 64): column s's words of block s - 1's rows; buf[p][64, 128): block s's diagonal
  __shared__ __align__(16) u64 buf[2][2 * kBlock];
  __shared__ u64 pulled[2];  // column s's words of the kept rows of blocks < s - 1
  __shared__ int done, n_kept;

  const int b = blockIdx.x;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const size_t npad = static_cast<size_t>(nb) * kBlock;
  const u64* mb = mask + static_cast<size_t>(b) * nb * npad;
  const long long* ob = order + static_cast<size_t>(b) * N;
  const float* sb = sorted_scores == nullptr ? nullptr : sorted_scores + static_cast<size_t>(b) * N;
  long long* idx = out_idx + static_cast<size_t>(b) * max_out;
  unsigned char* ok = out_valid + static_cast<size_t>(b) * max_out;

  for (int i = tid; i < nb; i += kWalkThreads) start_removed[i] = removed0[static_cast<size_t>(b) * nb + i];
  if (tid == 0) {
    pulled[0] = pulled[1] = 0;
    done = 0;
  }
  if (warp == 1) {  // block 0's diagonal
    cp_async16(&buf[0][kBlock + 2 * lane], mb + 2 * lane);
    cp_async_wait_all();
  }
  __syncthreads();

  int count = 0;  // warp 0's, the same in every lane
  for (int s = 0; s < nb; ++s) {
    const int cur = s & 1;
    if (warp == 0) {
      u64 add = 0;  // what block s - 1's kept rows remove from block s
      if (s > 0) {
        const u64 k = kept[s - 1];
        add = warp_or(((k >> lane) & 1 ? buf[cur][lane] : 0) | ((k >> (lane + 32)) & 1 ? buf[cur][lane + 32] : 0));
      }
      const u64 live = ~(start_removed[s] | pulled[cur] | add);
      // resolve the block: lane l holds the words of columns l and l + 32 (which earlier rows of the block
      // suppress them); iterate keep <- live & ~suppressed_by(keep) to its fixpoint, the greedy answer, since
      // row j's value is final after j + 1 rounds
      const u64 c_lo = buf[cur][kBlock + lane], c_hi = buf[cur][kBlock + 32 + lane];
      u64 keep = live;
      while (true) {
        const unsigned s_lo = __ballot_sync(0xffffffffu, (c_lo & keep) != 0);
        const unsigned s_hi = __ballot_sync(0xffffffffu, (c_hi & keep) != 0);
        const u64 next = live & ~((static_cast<u64>(s_hi) << 32) | s_lo);
        if (next == keep) break;
        keep = next;
      }
      while (__popcll(keep) > max_out - count) keep &= ~(1ULL << (63 - __clzll(keep)));  // stop at max_out
      const int c = count + __popcll(keep);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int j = lane + 32 * h;
        if ((keep >> j) & 1) {
          const int pos = count + __popcll(keep & ((1ULL << j) - 1));
          const int i = s * kBlock + j;
          const bool real = sb == nullptr || sb[i] > -__int_as_float(0x7f800000);
          idx[pos] = real ? ob[i] : 0;
          ok[pos] = real;
        }
      }
      count = c;
      __syncwarp();  // every lane has read pulled[cur]
      if (lane == 0) {
        kept[s] = keep;
        pulled[cur] = 0;
        if (c >= max_out || s + 1 == nb) {
          done = 1;
          n_kept = c;
        }
      }
    } else if (s + 1 < nb) {
      const u64* col = mb + static_cast<size_t>(s + 1) * npad;
      if (warp == 1) {  // 1 KB: column s + 1's words of block s's rows, then block s + 1's diagonal
        const u64* src = col + static_cast<size_t>(s) * kBlock;
        cp_async16(&buf[cur ^ 1][2 * lane], src + 2 * lane);
        cp_async16(&buf[cur ^ 1][kBlock + 2 * lane], src + kBlock + 2 * lane);
      }
      u64 acc = 0;
      const int rows = s * kBlock;
#pragma unroll 4
      for (int r = tid - 32; r < rows; r += kWalkThreads - 32)
        if ((kept[r >> 6] >> (r & 63)) & 1) acc |= col[r];
      acc = warp_or(acc);
      if (lane == 0 && acc != 0) atomicOr(&pulled[cur ^ 1], acc);
      if (warp == 1) cp_async_wait_all();
    }
    __syncthreads();
    if (done) break;
  }
  for (int k = n_kept + tid; k < max_out; k += kWalkThreads) {
    idx[k] = 0;
    ok[k] = 0;
  }
}

}  // namespace

// int64 words of the scratch cddmsl_nms needs: the mask (B, nb, 64 nb) and
// the start-out removed words (B, nb), nb = ceil(N / 64).
extern "C" long long cddmsl_nms_scratch_words(int B, int N) {
  const long long nb = (N + kBlock - 1) / kBlock;
  return static_cast<long long>(B) * nb * (kBlock * nb + 1);
}

// boxes (B, N, 4) float32, 16-byte aligned, and valid (B, N) bool in their
// own order; order (B, N) int64, each image's rows in descending score order,
// invalid last; sorted_scores (B, N) float32, the masked scores in that
// order, or null: when given, a kept row whose score is not above -inf is
// written as index 0 and invalid (JAX's rule for max_out >= N). scratch
// holds cddmsl_nms_scratch_words(B, N) words. Writes out_idx (B, max_out)
// int64 and out_valid (B, max_out) bool. Launches the mask pass over the
// whole upper triangle, then the walk. Returns the cudaError_t of the
// launches.
extern "C" int cddmsl_nms(const void* boxes, const void* valid, const void* order, const void* sorted_scores,
                          void* scratch, void* out_idx, void* out_valid, int B, int N, float thr, int max_out,
                          void* stream) {
  if (B <= 0 || B > 65535 || N <= 0 || max_out <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int nb = (N + kBlock - 1) / kBlock;
  const size_t smem = static_cast<size_t>(2) * nb * sizeof(u64);
  if (smem > kMaxWalkSmem) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(nms_walk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto* mask = static_cast<u64*>(scratch);
  u64* removed0 = mask + static_cast<size_t>(B) * nb * nb * kBlock;
  const auto* ob = static_cast<const long long*>(order);
  const dim3 tiles(static_cast<unsigned>(static_cast<long long>(nb) * (nb + 1) / 2), static_cast<unsigned>(B));
  nms_mask_kernel<<<tiles, kBlock, 0, st>>>(static_cast<const float4*>(boxes), static_cast<const unsigned char*>(valid),
                                            ob, N, nb, thr, mask, removed0);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  nms_walk_kernel<<<B, kWalkThreads, smem, st>>>(mask, removed0, ob, static_cast<const float*>(sorted_scores), N, nb,
                                                 max_out, static_cast<long long*>(out_idx),
                                                 static_cast<unsigned char*>(out_valid));
  return static_cast<int>(cudaGetLastError());
}
