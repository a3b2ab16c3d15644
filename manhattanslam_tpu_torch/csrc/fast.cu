// Dense FAST-9/16 corner score for every pyramid level of B images, in
// one launch.
//
// Replaces the Pallas TPU kernels _fast_kernel and _fast_kernel_batched
// (manhattanslam_tpu/ops/fast_pallas.py).  score(p) = max(0, max over the
// 16 rotations r of min_{k<9} d[(r+k)%16]) over the bright differences
// d_k = I(p + o_k) - I(p) and the dark ones -d_k; the 3-px border is 0.
// Bit-identical with the plain PyTorch version: float32 subtraction is
// monotone, so min_k (v_k - c) = (min_k v_k) - c exactly, and
// max_r min_k (c - v) = c - min_r max_k v; min and max are exact in any
// grouping.  So the kernel takes the arc minima and maxima of the circle
// values v_k themselves and subtracts the centre c once per polarity.
//
// Bound on the H100: per interior pixel one 4-byte read and one 4-byte
// write (2.4 ps/pixel at 3.35 TB/s) against 118 float ops (1.8 ps/pixel
// at 67 TFLOP/s fp32): the bytes bound it.  In practice the min/max
// instructions likely hold it: they issue at half the rate of an FMA lane
// and count one op each, where the peak counts an FMA as two.  One
// frame's 8 TUM1 levels are 951k pixels, a few microseconds of either, so
// one launch covers every level and stream.
//
// Design:
// - The level table (image and output pointers, h, w, tile counts and
//   their prefix, all from the wrapper) is one by-value __grid_constant__
//   parameter: no device-side table, no copy launch.
// - The grid is a flat list of 32x32 tiles over (level, stream, tile row,
//   tile column): block i finds its level in the prefix, so the small
//   levels run beside the large ones.  (A persistent grid that walked the
//   list with a double-buffered prefetch measured no faster on the card.)
// - A block stages its tile and the 3-px halo (38x38 floats) in shared
//   memory with 4-byte cp.async copies, rows and columns indexed in 2-D
//   with no divide per element.
// - Each thread scores a vertical strip of 8 pixels from one 14x7 register
//   window, so neighbouring pixels share their circle reads.
// - The 16 arc minima (and maxima) of one polarity take 42 min (max) ops
//   with van Herk / Gil-Werman prefix and suffix runs over blocks of 9,
//   against 128 for the direct form; 15 more reduce the 16 rotations.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kMaxLevels = 8;
constexpr int kTW = 32;                 // tile columns = threads in x
constexpr int kTY = 4;                  // threads in y
constexpr int kStrip = 8;               // pixels per thread, vertical
constexpr int kTH = kTY * kStrip;       // tile rows
constexpr int kHalo = 3;
constexpr int kSW = kTW + 2 * kHalo;    // staged columns
constexpr int kSH = kTH + 2 * kHalo;    // staged rows

struct FastTable {
  const float* img[kMaxLevels];   // (batch, h, w) per level
  float* out[kMaxLevels];         // (batch, h, w) per level
  int h[kMaxLevels];
  int w[kMaxLevels];
  int tiles_x[kMaxLevels];        // tile columns of one image
  int tiles_img[kMaxLevels];      // tiles of one image
  int tile_start[kMaxLevels + 1]; // prefix over levels of batch * tiles_img
  int n_levels;
};

// Bresenham circle of radius 3, clockwise from 12 o'clock, as in
// ops/fast.py CIRCLE_OFFSETS (k is a constant after unrolling).
__device__ __forceinline__ int circle_dy(int k) {
  const int dy[16] = {-3, -3, -2, -1, 0, 1, 2, 3, 3, 3, 2, 1, 0, -1, -2, -3};
  return dy[k];
}
__device__ __forceinline__ int circle_dx(int k) {
  const int dx[16] = {0, 1, 2, 3, 3, 3, 2, 1, 0, -1, -2, -3, -3, -3, -2, -1};
  return dx[k];
}

struct MinOp {
  __device__ __forceinline__ float operator()(float a, float b) const { return fminf(a, b); }
};
struct MaxOp {
  __device__ __forceinline__ float operator()(float a, float b) const { return fmaxf(a, b); }
};

// m[r] = op over the 9-arc v[r..r+8] (indices mod 16) for r = 0..15: the
// arcs [1..8] join a suffix run of v[0..8] and a prefix run of v[9..17];
// the arcs [10..15] a suffix run of v[10..17] and a prefix run of
// v[18..23].  42 ops.
template <class Op>
__device__ __forceinline__ void arc9(const float (&v)[16], float (&m)[16], Op op) {
  float s0[9];  // s0[r] = op(v[r..8])
  s0[8] = v[8];
#pragma unroll
  for (int r = 7; r >= 0; --r) s0[r] = op(v[r], s0[r + 1]);
  float p1[9];  // p1[j] = op(v[9..9+j])
  p1[0] = v[9];
#pragma unroll
  for (int j = 1; j < 9; ++j) p1[j] = op(p1[j - 1], v[(9 + j) & 15]);
  m[0] = s0[0];
#pragma unroll
  for (int r = 1; r <= 8; ++r) m[r] = op(s0[r], p1[r - 1]);
  m[9] = p1[8];
  float s1[8];  // s1[r - 10] = op(v[r..17]) for r = 10..17
  s1[7] = v[1];
#pragma unroll
  for (int r = 16; r >= 10; --r) s1[r - 10] = op(v[r & 15], s1[r - 9]);
  float p2[6];  // p2[j] = op(v[18..18+j]) = op(v[2..2+j])
  p2[0] = v[2];
#pragma unroll
  for (int j = 1; j < 6; ++j) p2[j] = op(p2[j - 1], v[2 + j]);
#pragma unroll
  for (int r = 10; r < 16; ++r) m[r] = op(s1[r - 10], p2[r - 10]);
}

// FAST-9 score of centre c from its 16 circle values v:
// max(0, max_r min(v[r..r+8]) - c, c - min_r max(v[r..r+8])).
__device__ __forceinline__ float score16(const float (&v)[16], float c) {
  float lo[16], hi[16];
  arc9(v, lo, MinOp());
  arc9(v, hi, MaxOp());
  float bright = lo[0];
  float dark = hi[0];
#pragma unroll
  for (int i = 1; i < 16; ++i) {
    bright = fmaxf(bright, lo[i]);
    dark = fminf(dark, hi[i]);
  }
  return fmaxf(fmaxf(__fsub_rn(bright, c), __fsub_rn(c, dark)), 0.f);
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src));
}

__global__ void __launch_bounds__(kTW * kTY)
fast_score_levels_kernel(const __grid_constant__ FastTable t) {
  __shared__ float tile[kSH][kSW];
  // the tile: its level from the prefix, then image, tile row and column
  const int idx = blockIdx.x;
  int l = 0;
#pragma unroll
  for (int j = 1; j < kMaxLevels; ++j) {
    if (j < t.n_levels && idx >= t.tile_start[j]) l = j;
  }
  const int r = idx - t.tile_start[l];
  const int img_i = r / t.tiles_img[l];
  const int q = r - img_i * t.tiles_img[l];
  const int ty = q / t.tiles_x[l];
  const int h = t.h[l];
  const int w = t.w[l];
  const int x0 = (q - ty * t.tiles_x[l]) * kTW;
  const int y0 = ty * kTH;
  const size_t plane = static_cast<size_t>(img_i) * h * w;
  const float* img = t.img[l] + plane;
  float* out = t.out[l] + plane;

  // stage the tile and its halo; positions outside the image stay
  // unwritten: only border pixels, whose score is 0, would read them
  for (int sr = threadIdx.y; sr < kSH; sr += kTY) {
    const int gy = y0 + sr - kHalo;
    if (gy < 0 || gy >= h) continue;
    const float* row = img + static_cast<size_t>(gy) * w;
    for (int sc = threadIdx.x; sc < kSW; sc += kTW) {
      const int gx = x0 + sc - kHalo;
      if (gx >= 0 && gx < w) cp_async4(&tile[sr][sc], row + gx);
    }
  }
  asm volatile("cp.async.wait_all;\n" ::);
  __syncthreads();

  // the thread's strip: kStrip pixels of one column from one register window
  const int r0 = threadIdx.y * kStrip;
  float win[kStrip + 2 * kHalo][2 * kHalo + 1];
#pragma unroll
  for (int i = 0; i < kStrip + 2 * kHalo; ++i) {
#pragma unroll
    for (int j = 0; j < 2 * kHalo + 1; ++j) win[i][j] = tile[r0 + i][threadIdx.x + j];
  }
  const int x = x0 + threadIdx.x;
  if (x >= w) return;
  const bool col_in = x >= kHalo && x < w - kHalo;
#pragma unroll
  for (int s = 0; s < kStrip; ++s) {
    const int y = y0 + r0 + s;
    if (y >= h) break;
    float score = 0.f;
    if (col_in && y >= kHalo && y < h - kHalo) {
      float v[16];
#pragma unroll
      for (int k = 0; k < 16; ++k) v[k] = win[s + kHalo + circle_dy(k)][kHalo + circle_dx(k)];
      score = score16(v, win[s + kHalo][kHalo]);
    }
    out[static_cast<size_t>(y) * w + x] = score;
  }
}

}  // namespace

// img[l], out[l]: level l's (batch, h[l], w[l]) float32 images and score
// maps, contiguous on the device; tiles_x, tiles_img, tile_start: the
// wrapper's tile table (ops/fast.py fast_tile_table), tile_start with
// n_levels + 1 prefix entries.  All arrays are host arrays.  Returns the
// cudaError_t of the launch (0 on success), or cudaErrorInvalidValue for
// more than 8 levels.
extern "C" int mslam_fast_score_levels(const void* const* img, void* const* out, const int* h,
                                       const int* w, const int* tiles_x, const int* tiles_img,
                                       const int* tile_start, int n_levels, void* stream) {
  if (n_levels < 0 || n_levels > kMaxLevels) return static_cast<int>(cudaErrorInvalidValue);
  FastTable t{};
  for (int l = 0; l < n_levels; ++l) {
    t.img[l] = static_cast<const float*>(img[l]);
    t.out[l] = static_cast<float*>(out[l]);
    t.h[l] = h[l];
    t.w[l] = w[l];
    t.tiles_x[l] = tiles_x[l];
    t.tiles_img[l] = tiles_img[l];
  }
  for (int l = 0; l <= n_levels; ++l) t.tile_start[l] = tile_start[l];
  t.n_levels = n_levels;
  const int total = t.tile_start[n_levels];
  if (total == 0) return 0;
  fast_score_levels_kernel<<<total, dim3(kTW, kTY), 0, static_cast<cudaStream_t>(stream)>>>(t);
  return static_cast<int>(cudaGetLastError());
}
