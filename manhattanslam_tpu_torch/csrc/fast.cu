// Dense FAST-9/16 corner score for one pyramid level of B images.
//
// Replaces the Pallas TPU kernels _fast_kernel and _fast_kernel_batched
// (manhattanslam_tpu/ops/fast_pallas.py): grid z runs over the B images of
// a (B, h, w) stack, so one launch serves the single stream (B = 1) and
// the batched replay.  score(p) = max(0, max over the 16 rotations r of
// min_{k<9} d[(r+k)%16]) over the bright differences d_k = I(p + o_k) -
// I(p) and the dark ones -d_k; the 3-px border is 0.
// Bit-identical with the plain PyTorch version: the same float32
// subtractions, then exact min/max.
//
// Bound on the H100: per interior pixel one 4-byte read and one 4-byte
// write against ~306 float ops (16 subtractions, 2x16x8 arc mins, 2x16
// maxes, 2 final maxes), so at 67 TFLOP/s fp32 the ops (4.6 ps/pixel)
// outweigh the bytes (2.4 ps/pixel at 3.35 TB/s).  Design: a 32x8 block
// stages its tile plus the 3-pixel halo in shared memory once, so each
// image byte is read from device memory about 1.5 times instead of 17;
// each thread keeps its 16 differences in registers (the loops are fully
// unrolled) and writes one coalesced score.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kTW = 32;
constexpr int kTH = 8;
constexpr int kHalo = 3;
constexpr int kArc = 9;

// Bresenham circle of radius 3, clockwise from 12 o'clock, as in
// ops/fast.py CIRCLE_OFFSETS.
__device__ __forceinline__ int circle_dy(int k) {
  const int dy[16] = {-3, -3, -2, -1, 0, 1, 2, 3, 3, 3, 2, 1, 0, -1, -2, -3};
  return dy[k];
}
__device__ __forceinline__ int circle_dx(int k) {
  const int dx[16] = {0, 1, 2, 3, 3, 3, 2, 1, 0, -1, -2, -3, -3, -3, -2, -1};
  return dx[k];
}

__global__ void fast_score_kernel(const float* __restrict__ img,
                                  float* __restrict__ out, int h, int w) {
  const size_t plane = static_cast<size_t>(blockIdx.z) * h * w;
  img += plane;
  out += plane;
  __shared__ float tile[kTH + 2 * kHalo][kTW + 2 * kHalo];
  const int x0 = blockIdx.x * kTW;
  const int y0 = blockIdx.y * kTH;
  const int tid = threadIdx.y * kTW + threadIdx.x;
  for (int i = tid; i < (kTH + 2 * kHalo) * (kTW + 2 * kHalo); i += kTW * kTH) {
    const int ty = i / (kTW + 2 * kHalo);
    const int tx = i % (kTW + 2 * kHalo);
    const int gy = y0 + ty - kHalo;
    const int gx = x0 + tx - kHalo;
    tile[ty][tx] = (gy >= 0 && gy < h && gx >= 0 && gx < w) ? img[gy * w + gx] : 0.f;
  }
  __syncthreads();

  const int x = x0 + threadIdx.x;
  const int y = y0 + threadIdx.y;
  if (x >= w || y >= h) return;
  float score = 0.f;
  if (y >= kHalo && y < h - kHalo && x >= kHalo && x < w - kHalo) {
    const int cy = threadIdx.y + kHalo;
    const int cx = threadIdx.x + kHalo;
    const float c = tile[cy][cx];
    float d[16];
#pragma unroll
    for (int k = 0; k < 16; ++k) d[k] = tile[cy + circle_dy(k)][cx + circle_dx(k)] - c;
    float bright = -INFINITY;
    float dark = -INFINITY;
#pragma unroll
    for (int r = 0; r < 16; ++r) {
      float mb = d[r];
      float md = -d[r];
#pragma unroll
      for (int k = 1; k < kArc; ++k) {
        mb = fminf(mb, d[(r + k) & 15]);
        md = fminf(md, -d[(r + k) & 15]);
      }
      bright = fmaxf(bright, mb);
      dark = fmaxf(dark, md);
    }
    score = fmaxf(fmaxf(bright, dark), 0.f);
  }
  out[y * w + x] = score;
}

}  // namespace

// img, out: (batch, h, w) float32, contiguous, on the device.  Returns the
// cudaError_t of the launch (0 on success).
extern "C" int mslam_fast_score(const float* img, float* out, int batch, int h, int w,
                                void* stream) {
  if (batch == 0) return 0;
  const dim3 block(kTW, kTH);
  const dim3 grid((w + kTW - 1) / kTW, (h + kTH - 1) / kTH, batch);
  fast_score_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(img, out, h, w);
  return static_cast<int>(cudaGetLastError());
}
