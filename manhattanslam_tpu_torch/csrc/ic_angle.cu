// Intensity-centroid orientation of ORB keypoints (IC_Angle) for every
// pyramid level of B images, in one launch.
//
// Replaces the Pallas TPU kernels _make_moments_kernel and
// _make_moments_kernel_batched (manhattanslam_tpu/ops/orb_pallas.py):
// the first moments m01 = sum dy*I and m10 = sum dx*I over the radius-15
// circular patch (row half-widths UMAX), then atan2(m01, m10).  Equal to
// the plain PyTorch version up to float32 summation order.
//
// Bound on the H100: each keypoint reads its ~709-pixel disc once (about
// 2.8 KB) and writes 4 bytes against ~4 float ops per pixel, so the bytes
// bound it; a frame's 1000 keypoints are about a microsecond of memory
// traffic, so one launch covers every level's keypoints of all B streams.
//
// Design:
// - Keypoints are level-major, [level][stream][n_l]: keypoint k's level
//   follows from the prefix of batch * n_l held, with each level's image
//   pointer, h and w, in one by-value __grid_constant__ parameter.
// - One warp per keypoint, lane = column offset dx, so each row of the
//   disc is one coalesced 124-byte read.  The disc rows of column dx are
//   the contiguous range |dy| <= vmax[|dx|] (UMAX is non-increasing); the
//   lane takes vmax from the parameter, and a fully unrolled loop over
//   the 31 rows issues predicated loads with no branch, so all of a
//   lane's loads are in flight together.
// - A warp-shuffle tree reduces the two moments.  A keypoint's summation
//   order depends on nothing but its own pixels, so a launch over many
//   levels and streams is bitwise equal to one per level or per stream.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kMaxLevels = 8;
constexpr int kR = 15;  // HALF_PATCH
constexpr int kWarps = 8;

struct IcTable {
  const float* img[kMaxLevels];  // (batch, h, w) per level
  int h[kMaxLevels];
  int w[kMaxLevels];
  int n[kMaxLevels];              // keypoints of one image at the level
  int kp_start[kMaxLevels + 1];   // prefix over levels of batch * n
  int vmax[kR + 1];               // disc rows of column |dx|: |dy| <= vmax
  int n_levels;
};

__global__ void __launch_bounds__(32 * kWarps)
ic_angle_levels_kernel(const __grid_constant__ IcTable t, const float* __restrict__ xy,
                       float* __restrict__ angle) {
  const int k = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (k >= t.kp_start[t.n_levels]) return;  // uniform per warp
  int l = 0;
#pragma unroll
  for (int j = 1; j < kMaxLevels; ++j) {
    if (j < t.n_levels && k >= t.kp_start[j]) l = j;
  }
  const int img_i = (k - t.kp_start[l]) / t.n[l];
  const int h = t.h[l];
  const int w = t.w[l];
  // centre: truncation toward zero, then clipped so the disc stays inside
  int x0 = static_cast<int>(xy[2 * k]);
  int y0 = static_cast<int>(xy[2 * k + 1]);
  x0 = min(max(x0, kR), w - kR - 1);
  y0 = min(max(y0, kR), h - kR - 1);
  const int dx = lane - kR;
  const int vm = lane < 2 * kR + 1 ? t.vmax[min(abs(dx), kR)] : -1;
  const float* col = t.img[l] + static_cast<size_t>(img_i) * h * w +
                     static_cast<size_t>(y0) * w + x0 + dx;
  float m01 = 0.f;
  float sum = 0.f;
#pragma unroll
  for (int dy = -kR; dy <= kR; ++dy) {
    float v = 0.f;
    if (dy >= -vm && dy <= vm) v = __ldg(col + dy * w);
    m01 += static_cast<float>(dy) * v;
    sum += v;
  }
  float m10 = static_cast<float>(dx) * sum;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    m01 += __shfl_down_sync(0xffffffffu, m01, off);
    m10 += __shfl_down_sync(0xffffffffu, m10, off);
  }
  if (lane == 0) angle[k] = atan2f(m01, m10);
}

}  // namespace

// img[l]: level l's (batch, h[l], w[l]) float32 images; n[l] keypoints
// of each image at level l; kp_start: n_levels + 1 prefix of batch * n;
// vmax: 16 row extents (ops/orb.py IC_ROW_EXTENT); all host arrays.  xy:
// (kp_start[n_levels], 2) float32 (x, y) level-major; angle: its
// (kp_start[n_levels],) float32 output; both contiguous on the device.
// Returns the cudaError_t of the launch (0 on success), or
// cudaErrorInvalidValue for more than 8 levels.
extern "C" int mslam_ic_angle_levels(const void* const* img, const int* h, const int* w,
                                     const int* n, const int* kp_start, const int* vmax,
                                     int n_levels, const float* xy, float* angle,
                                     void* stream) {
  if (n_levels < 0 || n_levels > kMaxLevels) return static_cast<int>(cudaErrorInvalidValue);
  IcTable t{};
  for (int l = 0; l < n_levels; ++l) {
    t.img[l] = static_cast<const float*>(img[l]);
    t.h[l] = h[l];
    t.w[l] = w[l];
    t.n[l] = n[l];
  }
  for (int l = 0; l <= n_levels; ++l) t.kp_start[l] = kp_start[l];
  for (int i = 0; i <= kR; ++i) t.vmax[i] = vmax[i];
  t.n_levels = n_levels;
  const int total = t.kp_start[n_levels];
  if (total == 0) return 0;
  const int grid = (total + kWarps - 1) / kWarps;
  ic_angle_levels_kernel<<<grid, 32 * kWarps, 0, static_cast<cudaStream_t>(stream)>>>(
      t, xy, angle);
  return static_cast<int>(cudaGetLastError());
}
