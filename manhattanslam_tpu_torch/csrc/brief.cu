// Steered BRIEF for every pyramid level of B images, in one launch, with
// the integer-rounded Gaussian blur it samples computed inside.
//
// Replaces the Pallas TPU kernels _make_brief_kernel and
// _make_brief_kernel_batched (manhattanslam_tpu/ops/orb_pallas.py) plus
// the compare-and-pack of its wrapper brief_descriptors_pallas, and the
// blur in front of them (frontend/frame.py: round(gaussian_blur(level,
// 7, 2.0))).  For each keypoint and pattern point (py, px):
// rx = px*cos - py*sin, ry = px*sin + py*cos, sample at
// clip(round(x + rx), 0, w-1), clip(round(y + ry), 0, h-1) of the
// integer-rounded blur; bit j of word i is
// sample[2*(32i+j)] < sample[2*(32i+j)+1].
//
// Bit-exact with the plain PyTorch version (ops/orb.py brief_levels_plain):
// - the blur is ops/image.py gaussian_blur: a vertical then a horizontal
//   7-tap pass with reflect-101 borders (F.pad mode "reflect"), each
//   summed in tap order as out = w0*x0, out = out + wi*xi, with every
//   product and sum rounded on its own (__fmul_rn/__fadd_rn: nvcc
//   contracts nothing into a fused multiply-add), then rintf, which
//   rounds half to even like torch.round;
// - cos/sin come in from the caller (torch), so both see the same values.
//
// Bound on the H100: per keypoint 256 pairs of ~29 float ops, 32 bytes
// out, and the blur of the pixels its samples touch (26 ops each, from
// the raw pixels within 3 of them); a frame's ~1000 keypoints read under
// a megabyte, so the launch's fixed cost, the latency of its dependent
// phases and the blur's arithmetic (products and sums apart, no FMA) set
// its time.  Design:
// - Keypoints are level-major, [level][stream][n_l], as csrc/ic_angle.cu
//   takes them: keypoint k's level follows from the prefix of batch * n_l
//   in one by-value __grid_constant__ table that also holds each level's
//   image pointer, h and w, and the 7 blur weights (no upload, capturable
//   in a CUDA graph).
// - kThreads per keypoint, chosen by the caller (ops/orb.py
//   brief_threads): a block of 128 for one stream's ~1000 keypoints,
//   which leave most of the card idle, so a keypoint's shorter chain
//   wins; one warp, four keypoints to a block, for B streams, which fill
//   it.  The blurred window is the 29x29 pixels within the sample radius
//   14 of the keypoint's floor; it is computed padded to 30 rows and 32
//   columns (the padding reads mapped pixels and is never sampled), in
//   tasks that the keypoint's threads take in turn:
//   1. vertical pass from global memory into registers: each task takes
//      one of 38 columns and one of 3 bands of 10 output rows, loads the
//      band's 16 raw rows (neighbouring threads read neighbouring
//      columns; reflect-101 indices only for a window that crosses the
//      border, where the index arithmetic doubles the pass's
//      instructions) and writes 10 sums to shared memory;
//   2. horizontal pass: each task takes one of 30 rows and one of 4
//      runs of 8 columns, reads 14 vertical sums and writes 8 rounded
//      pixels (row strides 39 and 33 keep the banks at most 2-way);
//   3. the keypoint's warps take the 8 words in turn, lane j pair 32i+j
//      of word i: its pattern row by __ldg from global memory as one
//      16-byte load (the 32 lanes read 32 entries, which __constant__
//      memory would serialize), its two samples from shared memory, and
//      __ballot_sync packs the 32 comparisons into the word.
//   So no pixel of the level is blurred that no sample is near, and the
//   blurred pixels never leave shared memory.
// - The window is centred on the keypoint's floor, clamped to the image:
//   every clipped sample then lies within kSampleR of it (a clip moves a
//   sample toward the image, which holds the centre).  A keypoint's words
//   depend on nothing but its own window, so a launch over many levels
//   and streams is bitwise equal to one per level or per stream.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kMaxLevels = 8;
constexpr int kTaps = 7;                  // blur taps
constexpr int kBlurR = kTaps / 2;         // 3
constexpr int kSampleR = 14;              // ops/orb.py BRIEF_SAMPLE_RADIUS
constexpr int kWinR = kSampleR + kBlurR;  // 17: raw window radius
constexpr int kBand = 10;                 // vertical pass: output rows per task
constexpr int kRows = 30;                 // blurred rows, 2 * kSampleR + 1 padded to 3 bands
constexpr int kRun = 8;                   // horizontal pass: output columns per task
constexpr int kCols = 32;                 // blurred columns, 2 * kSampleR + 1 padded to 4 runs
constexpr int kVCols = kCols + 2 * kBlurR;  // 38 columns of vertical sums
constexpr int kVStride = kVCols + 1;      // 39: odd, so 30 rows fall in 30 banks
constexpr int kBStride = kCols + 1;       // 33
constexpr int kBlock = 128;               // threads per block

struct BriefTable {
  const float* img[kMaxLevels];  // (batch, h, w) per level, raw intensities
  int h[kMaxLevels];
  int w[kMaxLevels];
  int n[kMaxLevels];             // keypoints of one image at the level
  int kp_start[kMaxLevels + 1];  // prefix over levels of batch * n
  float weight[kTaps];           // ops/image.py gauss_kernel1d(7, 2.0)
  int n_levels;
};

// reflect-101 (F.pad mode "reflect"): -1 -> 1, n -> n-2.  One reflection
// is exact for -n < i < 2n-1; indices farther out feed no sample and are
// only clamped into the image.
__device__ __forceinline__ int reflect101(int i, int n) {
  i = i < 0 ? -i : i;
  i = i >= n ? 2 * (n - 1) - i : i;
  return min(max(i, 0), n - 1);
}

template <int kThreads>
__device__ __forceinline__ void sync_group() {
  if constexpr (kThreads == 32) {
    __syncwarp();
  } else {
    __syncthreads();
  }
}

template <int kThreads>
__global__ void __launch_bounds__(kBlock)
brief_levels_kernel(const __grid_constant__ BriefTable t, const float* __restrict__ xy,
                    const float* __restrict__ cosa, const float* __restrict__ sina,
                    const int4* __restrict__ pattern, int* __restrict__ desc) {
  constexpr int kGroups = kBlock / kThreads;  // keypoints per block
  __shared__ float vert[kGroups][kRows * kVStride];  // vertical sums
  __shared__ float blur[kGroups][kRows * kBStride];  // the rounded blur
  const int g = threadIdx.x / kThreads;
  const int tid = threadIdx.x % kThreads;
  const int k = blockIdx.x * kGroups + g;
  if (k >= t.kp_start[t.n_levels]) return;  // uniform per group
  int l = 0;
#pragma unroll
  for (int j = 1; j < kMaxLevels; ++j) {
    if (j < t.n_levels && k >= t.kp_start[j]) l = j;
  }
  const int h = t.h[l];
  const int w = t.w[l];
  const float* img = t.img[l] + static_cast<size_t>((k - t.kp_start[l]) / t.n[l]) * h * w;
  const float kx = xy[2 * k];
  const float ky = xy[2 * k + 1];
  const int cx = min(max(static_cast<int>(floorf(kx)), 0), w - 1);
  const int cy = min(max(static_cast<int>(floorf(ky)), 0), h - 1);
  float* vb = vert[g];
  float* bl = blur[g];

  // vertical sums: vb[r][c] at image row cy - kSampleR + r, column
  // cx - kWinR + c; a window inside the image (every valid keypoint's
  // but near the right border) needs no reflection
  const bool inside = cy >= kWinR && cy - kWinR + kRows + 2 * kBlurR <= h && cx >= kWinR &&
                      cx - kWinR + kVCols <= w;
  for (int task = tid; task < kVCols * (kRows / kBand); task += kThreads) {
    const int c = task % kVCols;
    const int r0 = (task / kVCols) * kBand;
    float x[kBand + kTaps - 1];
    if (inside) {
      const float* p = img + static_cast<size_t>(cy - kWinR + r0) * w + cx - kWinR + c;
#pragma unroll
      for (int i = 0; i < kBand + kTaps - 1; ++i) x[i] = __ldg(p + static_cast<size_t>(i) * w);
    } else {
      const float* col = img + reflect101(cx - kWinR + c, w);
#pragma unroll
      for (int i = 0; i < kBand + kTaps - 1; ++i) {
        x[i] = __ldg(col + static_cast<size_t>(reflect101(cy - kWinR + r0 + i, h)) * w);
      }
    }
#pragma unroll
    for (int i = 0; i < kBand; ++i) {
      float acc = __fmul_rn(t.weight[0], x[i]);
#pragma unroll
      for (int j = 1; j < kTaps; ++j) acc = __fadd_rn(acc, __fmul_rn(t.weight[j], x[i + j]));
      vb[(r0 + i) * kVStride + c] = acc;
    }
  }
  sync_group<kThreads>();
  // rounded blur: bl[r][c] at image row cy - kSampleR + r, column
  // cx - kSampleR + c
  for (int task = tid; task < kRows * (kCols / kRun); task += kThreads) {
    const int r = task % kRows;
    const int c0 = (task / kRows) * kRun;
    float v[kRun + kTaps - 1];
#pragma unroll
    for (int i = 0; i < kRun + kTaps - 1; ++i) v[i] = vb[r * kVStride + c0 + i];
#pragma unroll
    for (int i = 0; i < kRun; ++i) {
      float acc = __fmul_rn(t.weight[0], v[i]);
#pragma unroll
      for (int j = 1; j < kTaps; ++j) acc = __fadd_rn(acc, __fmul_rn(t.weight[j], v[i + j]));
      bl[r * kBStride + c0 + i] = rintf(acc);
    }
  }
  sync_group<kThreads>();

  const float c = cosa[k];
  const float s = sina[k];
  const float x_max = static_cast<float>(w - 1);
  const float y_max = static_cast<float>(h - 1);
  const int lane = tid & 31;
  auto sample = [&](int py, int px) {
    const float fpx = static_cast<float>(px);
    const float fpy = static_cast<float>(py);
    const float rx = __fsub_rn(__fmul_rn(fpx, c), __fmul_rn(fpy, s));
    const float ry = __fadd_rn(__fmul_rn(fpx, s), __fmul_rn(fpy, c));
    const float sx = fminf(fmaxf(rintf(__fadd_rn(kx, rx)), 0.f), x_max);
    const float sy = fminf(fmaxf(rintf(__fadd_rn(ky, ry)), 0.f), y_max);
    // within kSampleR of the centre for any finite keypoint; the clamp
    // only keeps a non-finite one inside the window
    const int wx = min(max(static_cast<int>(sx) - cx + kSampleR, 0), 2 * kSampleR);
    const int wy = min(max(static_cast<int>(sy) - cy + kSampleR, 0), 2 * kSampleR);
    return bl[wy * kBStride + wx];
  };
#pragma unroll
  for (int word = tid >> 5; word < 8; word += kThreads / 32) {
    // pattern is (256, 2, 2) int32 as (pair, point, (y, x))
    const int4 p = __ldg(pattern + word * 32 + lane);
    const bool bit = sample(p.x, p.y) < sample(p.z, p.w);
    const unsigned bits = __ballot_sync(0xffffffffu, bit);
    if (lane == 0) desc[k * 8 + word] = static_cast<int>(bits);
  }
}

}  // namespace

// img[l]: level l's (batch, h[l], w[l]) float32 raw images; n[l]
// keypoints of each image at level l; kp_start: n_levels + 1 prefix of
// batch * n; weight: the 7 blur weights; all host arrays.  sample_radius
// must be kSampleR (ops/orb.py BRIEF_SAMPLE_RADIUS) and threads_per_keypoint
// 32 (one warp) or 128 (one block).  xy: (kp_start[n_levels], 2) float32
// (x, y) level-major; cosa, sina: (kp_start[n_levels],) float32; pattern:
// (256, 2, 2) int32, 16-byte aligned; desc: the (kp_start[n_levels], 8)
// int32 output (the uint32 words' bits); all contiguous on the device.
// Returns the cudaError_t of the launch (0 on success), or
// cudaErrorInvalidValue for an argument out of range.
extern "C" int mslam_brief_levels(const void* const* img, const int* h, const int* w,
                                  const int* n, const int* kp_start, const float* weight,
                                  int n_levels, int sample_radius, int threads_per_keypoint,
                                  const float* xy, const float* cosa, const float* sina,
                                  const int* pattern, int* desc, void* stream) {
  if (n_levels < 0 || n_levels > kMaxLevels || sample_radius != kSampleR ||
      (threads_per_keypoint != 32 && threads_per_keypoint != kBlock)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  BriefTable t{};
  for (int l = 0; l < n_levels; ++l) {
    t.img[l] = static_cast<const float*>(img[l]);
    t.h[l] = h[l];
    t.w[l] = w[l];
    t.n[l] = n[l];
  }
  for (int l = 0; l <= n_levels; ++l) t.kp_start[l] = kp_start[l];
  for (int j = 0; j < kTaps; ++j) t.weight[j] = weight[j];
  t.n_levels = n_levels;
  const int total = t.kp_start[n_levels];
  if (total == 0) return 0;
  const auto* pat = reinterpret_cast<const int4*>(pattern);
  auto* s = static_cast<cudaStream_t>(stream);
  if (threads_per_keypoint == 32) {
    constexpr int per_block = kBlock / 32;
    brief_levels_kernel<32><<<(total + per_block - 1) / per_block, kBlock, 0, s>>>(
        t, xy, cosa, sina, pat, desc);
  } else {
    brief_levels_kernel<kBlock><<<total, kBlock, 0, s>>>(t, xy, cosa, sina, pat, desc);
  }
  return static_cast<int>(cudaGetLastError());
}
