// Intensity-centroid orientation of ORB keypoints (IC_Angle).
//
// Replaces the Pallas TPU kernels _make_moments_kernel and
// _make_moments_kernel_batched (manhattanslam_tpu/ops/orb_pallas.py):
// the first moments m01 = sum dy*I and m10 = sum dx*I over the radius-15
// circular patch (row half-widths UMAX), then atan2(m01, m10).  Equal to
// the plain PyTorch version up to float32 summation order.
//
// Bound on the H100: each keypoint reads its ~709-pixel disc once (about
// 2.8 KB) and writes 4 bytes against ~4 float ops per pixel, so the bytes
// bound it; at one frame's ~1000 keypoints that is a few microseconds of
// memory traffic and the launch dominates.  Design: one warp per keypoint
// of the flat (B * n) batch (keypoint k belongs to image k / n), so one
// launch serves the single stream (B = 1) and the batched replay; the
// warp reads the 31x31 disc directly (lane = column offset, so each row
// is one coalesced 124-byte read) with no patch staging or alignment
// padding, and a warp-shuffle tree reduces the two moments.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kR = 15;  // HALF_PATCH

__global__ void ic_angle_kernel(const float* __restrict__ img,
                                const float* __restrict__ xy,
                                const int* __restrict__ umax,
                                float* __restrict__ angle, int total, int n, int h,
                                int w) {
  const int k = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (k >= total) return;  // uniform per warp
  img += static_cast<size_t>(k / n) * h * w;
  // centre: truncation toward zero, then clipped so the disc stays inside
  int x0 = static_cast<int>(xy[2 * k]);
  int y0 = static_cast<int>(xy[2 * k + 1]);
  x0 = min(max(x0, kR), w - kR - 1);
  y0 = min(max(y0, kR), h - kR - 1);
  const int dx = lane - kR;
  float m01 = 0.f;
  float m10 = 0.f;
  if (lane < 2 * kR + 1) {
    const int adx = abs(dx);
    for (int dy = -kR; dy <= kR; ++dy) {
      if (adx <= umax[abs(dy)]) {
        const float v = img[(y0 + dy) * w + x0 + dx];
        m01 += static_cast<float>(dy) * v;
        m10 += static_cast<float>(dx) * v;
      }
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    m01 += __shfl_down_sync(0xffffffffu, m01, off);
    m10 += __shfl_down_sync(0xffffffffu, m10, off);
  }
  if (lane == 0) angle[k] = atan2f(m01, m10);
}

}  // namespace

// img: (batch, h, w) float32; xy: (batch, n, 2) float32 (x, y); umax:
// (16,) int32; angle: (batch, n) float32 out.  All contiguous on the
// device.  Returns the cudaError_t of the launch (0 on success).
extern "C" int mslam_ic_angle(const float* img, const float* xy, const int* umax,
                              float* angle, int batch, int n, int h, int w, void* stream) {
  const int total = batch * n;
  if (total == 0) return 0;
  const int warps_per_block = 4;
  const int grid = (total + warps_per_block - 1) / warps_per_block;
  ic_angle_kernel<<<grid, 32 * warps_per_block, 0, static_cast<cudaStream_t>(stream)>>>(
      img, xy, umax, angle, total, n, h, w);
  return static_cast<int>(cudaGetLastError());
}
