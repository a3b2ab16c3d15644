// Steered BRIEF: 256 rotated intensity comparisons packed into 8 words.
//
// Replaces the Pallas TPU kernels _make_brief_kernel and
// _make_brief_kernel_batched (manhattanslam_tpu/ops/orb_pallas.py) plus
// the compare-and-pack of its wrapper brief_descriptors_pallas.  For each
// keypoint and pattern point (py, px): rx = px*cos - py*sin,
// ry = px*sin + py*cos, sample at clip(round(x + rx), 0, w-1),
// clip(round(y + ry), 0, h-1) of the integer-rounded blur; bit j of word
// i is sample[2*(32i+j)] < sample[2*(32i+j)+1].  Bit-exact with the plain
// PyTorch version: cos/sin come in from the caller, every product and sum
// is rounded on its own (__fmul_rn/__fadd_rn: no fused multiply-add) and
// rintf rounds half to even like torch.round.
//
// Bound on the H100: each keypoint gathers 512 scattered 4-byte samples
// (at most 2 KB) and writes 32 bytes against ~20 float ops per pair, so
// the (scattered) bytes bound it; a frame's ~1000 keypoints are a few
// microseconds of traffic and the launch dominates.  Design: one warp per
// keypoint of the flat (B * n) batch (keypoint k belongs to image k / n,
// so one launch serves the single stream and the batched replay), lane j
// evaluates pair 32i+j of word i, and __ballot_sync packs the 32
// comparisons into the word in one instruction, so the 512 samples never
// leave registers (the TPU kernel's one-hot MXU row select, patch
// DMA and 8/128-aligned corners have no counterpart here).

#include <cuda_runtime.h>
#include <math.h>

namespace {

__device__ __forceinline__ float sample(const float* __restrict__ img, int h, int w,
                                        float kx, float ky, float c, float s, int py,
                                        int px) {
  const float fpx = static_cast<float>(px);
  const float fpy = static_cast<float>(py);
  const float rx = __fsub_rn(__fmul_rn(fpx, c), __fmul_rn(fpy, s));
  const float ry = __fadd_rn(__fmul_rn(fpx, s), __fmul_rn(fpy, c));
  float sx = rintf(__fadd_rn(kx, rx));
  float sy = rintf(__fadd_rn(ky, ry));
  sx = fminf(fmaxf(sx, 0.f), static_cast<float>(w - 1));
  sy = fminf(fmaxf(sy, 0.f), static_cast<float>(h - 1));
  return img[static_cast<int>(sy) * w + static_cast<int>(sx)];
}

__global__ void brief_kernel(const float* __restrict__ img, const float* __restrict__ xy,
                             const float* __restrict__ cosa, const float* __restrict__ sina,
                             const int* __restrict__ pattern, int* __restrict__ desc,
                             int total, int n, int h, int w) {
  const int k = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (k >= total) return;  // uniform per warp
  img += static_cast<size_t>(k / n) * h * w;
  const float kx = xy[2 * k];
  const float ky = xy[2 * k + 1];
  const float c = cosa[k];
  const float s = sina[k];
#pragma unroll
  for (int word = 0; word < 8; ++word) {
    // pattern is (256, 2, 2) int32 as (pair, point, (y, x))
    const int* p = pattern + (word * 32 + lane) * 4;
    const float a = sample(img, h, w, kx, ky, c, s, p[0], p[1]);
    const float b = sample(img, h, w, kx, ky, c, s, p[2], p[3]);
    const unsigned bits = __ballot_sync(0xffffffffu, a < b);
    if (lane == 0) desc[k * 8 + word] = static_cast<int>(bits);
  }
}

}  // namespace

// img: (batch, h, w) float32 integer-rounded blur; xy: (batch, n, 2)
// float32 (x, y); cosa, sina: (batch, n) float32; pattern: (256, 2, 2)
// int32; desc: (batch, n, 8) int32 out (the uint32 words' bits).  All
// contiguous on the device.  Returns the cudaError_t of the launch (0 on
// success).
extern "C" int mslam_brief(const float* img, const float* xy, const float* cosa,
                           const float* sina, const int* pattern, int* desc, int batch,
                           int n, int h, int w, void* stream) {
  const int total = batch * n;
  if (total == 0) return 0;
  const int warps_per_block = 4;
  const int grid = (total + warps_per_block - 1) / warps_per_block;
  brief_kernel<<<grid, 32 * warps_per_block, 0, static_cast<cudaStream_t>(stream)>>>(
      img, xy, cosa, sina, pattern, desc, total, n, h, w);
  return static_cast<int>(cudaGetLastError());
}
