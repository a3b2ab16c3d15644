// The pose solve of ops/lm.py (solve_pose) over point, line and plane
// rows, the whole round schedule of a batch of problems in one launch.
//
// Replaces no TPU kernel: the JAX package leaves solve_pose to XLA, which
// fuses each round of its while loops into a few device programs.  The
// port's plain PyTorch version issues ~600 small operations an iteration
// (~11.8k for the final solve of a frame, ~15.7k for the step's three
// solves), and at ~1.3 us a CUDA graph node they were ~78% of the fused
// step's launches and ~80% of its device time.  This kernel is added for
// that: the solve is one graph node.
//
// Bound on the H100: a problem is tiny (at most ~1,024 point rows, 128
// line endpoints and 24 planes: ~40 KB of inputs, under a MFLOP an
// iteration for the 6x6 normal system), and every iteration depends on
// the last, so the solve is bound by latency: per iteration one pass
// over the rows, one block reduction and one serial 6x6 factor, step and
// retraction.  Neither bytes (~40 KB at 3.35 TB/s is ~12 ns) nor FLOPs
// bound it.
//
// Design:
// - One block of 256 threads per problem (the grid is the batch).  Point
//   and line rows are strided over the threads, plane observations are
//   taken from the last thread down, so any row count is taken.  The rows
//   are read from global memory on every pass (L1-resident after the
//   first); the current inlier masks live in the output mask buffers, each
//   row always owned by the same thread.
// - Per iteration each thread sums its rows' upper triangle of H, g and
//   the cost in registers; a warp-shuffle tree and then the warps'
//   partials in shared memory, in a fixed order with no atomics, give the
//   block's sums, so a launch repeats itself bit for bit, and a problem's
//   result does not depend on the batch it is solved in.
// - Thread 0 factors the damped system (Cholesky: a pivot that is not
//   finite and > 0 fails it and gives a non-finite step, which GN rejects
//   and LM zeroes, as the plain version does with a non-finite step),
//   steps, retracts (exp_se3(xi) @ T, or a translation add) and hands the
//   pose to the block through shared memory.
// - The dof (6, or 3 with the rotation frozen) is a template parameter;
//   GN or LM, the line and plane families, the rounds and iterations are
//   uniform arguments.
// - float32 throughout, IEEE division and square roots, full-precision
//   atan2f / sinf / cosf (no fast-math): the configuration's precision.
//   Every residual, closed-form Jacobian and guard is the plain version's
//   (_safe_z, the 1e-12 clamps, the sign flips of the plane transform and
//   normalization, the par flip and the ver 90-degree turn of the frame
//   normal, the masked-row guard, the Huber weights, the chi2 re-gate
//   against the original masks), written out in the same order of
//   operations where an order is defined, so the two agree to float32
//   rounding.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kFam = 3;                 // plane families: pl, par, ver
constexpr int kMaxSums = 21 + 6 + 1;    // upper H, g, cost at 6 dof
constexpr float kClamp = 1e-12f;        // _normalize / _angles / Huber floor

struct Params {
  // inputs, batch-major, contiguous; bool as bytes
  const float* pt_xw;
  const float* pt_obs;
  const float* pt_info;
  const uint8_t* pt_stereo;
  const uint8_t* pt_mask;
  const float* pl_w[kFam];
  const float* pl_obs[kFam];
  const uint8_t* pl_mask[kFam];
  const float* ln_xw;
  const float* ln_eq;
  const float* ln_info;
  const uint8_t* ln_mask;
  const float* T0;  // (B, 4, 4)
  const float* K;   // (3, 3)
  // outputs
  float* T;
  uint8_t* in_pt;
  uint8_t* in_ln;
  uint8_t* in_pl[kFam];
  long long* n_inliers;
  float* chi2;
  int n_pt, n_ln, n_pl[kFam];
  int n_ln_out, n_pl_out[kFam];  // the output masks' widths (zeroed when a family is off)
  int n_rounds, n_iters;
  int gauss_newton, use_lines, use_planes;
  float bf;
  float pl_info[3];      // the pl rows' (angle, angle, distance) information
  float sq_pl_info[3];   // and their square roots
  float fam_info[kFam];  // par / ver information (entry 0 unused)
  float sq_fam_info[kFam];
  float gate[kFam];      // Plane.Chi, Plane.VPChi, Plane.VPChi
  float delta[kFam];     // their square roots (the Huber deltas)
  float ln_delta;        // sqrt(7.815)
  float ln_gate;         // 2 x 5.991
};

struct Shared {
  float T[16];
  float red[kWarps][kMaxSums];
  float sum[kMaxSums];
  // LM state (thread 0)
  float T_acc[16];
  float H_acc[21];
  float g_acc[6];
  float c_acc;
  float lam;
};

struct Cam {
  float fx, fy, cx, cy, bf;
};

template <int D>
struct Sums {
  static constexpr int kH = D * (D + 1) / 2;
  static constexpr int kN = kH + D + 1;  // upper H, g, cost
};

__device__ __forceinline__ float safe_z(float z) { return fabsf(z) < 1e-9f ? 1e-9f : z; }

// torch.clamp(x, min=lo): NaN stays NaN
__device__ __forceinline__ float clamp_min(float x, float lo) { return x < lo ? lo : x; }

__device__ __forceinline__ float huber_w(float c2, float delta, bool mask, bool on) {
  float w = 1.f;
  if (on) {
    const float e = sqrtf(clamp_min(c2, kClamp));
    w = e <= delta ? 1.f : sqrtf(delta / e);
  }
  return mask ? w : 0.f;
}

// one weighted row (its Jacobian J and residual r) into the sums
template <int D>
__device__ __forceinline__ void add_row(float* s, const float* J, float r) {
  int k = 0;
#pragma unroll
  for (int i = 0; i < D; ++i) {
#pragma unroll
    for (int j = i; j < D; ++j) s[k++] += J[i] * J[j];
  }
#pragma unroll
  for (int i = 0; i < D; ++i) s[Sums<D>::kH + i] += J[i] * r;
  s[Sums<D>::kN - 1] += r * r;
}

__device__ __forceinline__ void cam_point(const float* T, const float* xw, float* pc) {
#pragma unroll
  for (int i = 0; i < 3; ++i)
    pc[i] = xw[0] * T[4 * i] + xw[1] * T[4 * i + 1] + xw[2] * T[4 * i + 2] + T[4 * i + 3];
}

// a @ [I | -hat(pc)] (6 dof) or a (translation only): the pose derivative
// of a row whose derivative wrt the camera point is a
template <int D>
__device__ __forceinline__ void pose_row(const float* a, const float* pc, float* out) {
  out[0] = a[0];
  out[1] = a[1];
  out[2] = a[2];
  if (D == 6) {
    // -hat(pc) = [[0, z, -y], [-z, 0, x], [y, -x, 0]]
    out[3] = a[0] * 0.f + a[1] * -pc[2] + a[2] * pc[1];
    out[4] = a[0] * pc[2] + a[1] * 0.f + a[2] * -pc[0];
    out[5] = a[0] * -pc[1] + a[1] * pc[0] + a[2] * 0.f;
  }
}

// ------------------------------------------------------------ point rows
// kJ: the row into the system sums (H, g, cost); else its cost alone
template <int D, bool kJ>
__device__ void point_row(const float* T, const Cam& cam, const float* xw, const float* obs,
                          float info, bool stereo, bool mask, bool huber, float* s) {
  float pc[3];
  cam_point(T, xw, pc);
  const float zs = safe_z(pc[2]);
  const float u = pc[0] / zs * cam.fx + cam.cx;
  const float v = pc[1] / zs * cam.fy + cam.cy;
  const float ur = u - cam.bf / zs;
  const float cm[3] = {1.f, 1.f, stereo ? 1.f : 0.f};
  const float r[3] = {(obs[0] - u) * cm[0], (obs[1] - v) * cm[1], (obs[2] - ur) * cm[2]};
  const float chi = (r[0] * r[0] + r[1] * r[1] + r[2] * r[2]) * info;
  const float th = stereo ? 7.815f : 5.991f;
  const float w = huber_w(chi, sqrtf(th), mask, huber) * sqrtf(info);
  if (!kJ) {
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const float rw = r[c] * w;
      s[Sums<D>::kN - 1] += rw * rw;
    }
    return;
  }
  const float zi = 1.f / zs;
  // rows u, v and uR of d(u, v, uR) / d pc
  float A[3][3] = {{cam.fx * zi, 0.f, -cam.fx * pc[0] * zi * zi},
                   {0.f, cam.fy * zi, -cam.fy * pc[1] * zi * zi}};
#pragma unroll
  for (int k = 0; k < 3; ++k) A[2][k] = A[0][k] + (k == 2 ? cam.bf * zi * zi : 0.f);
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    float J[D];
    pose_row<D>(A[c], pc, J);
#pragma unroll
    for (int k = 0; k < D; ++k) J[k] = -J[k] * cm[c] * w;
    add_row<D>(s, J, r[c] * w);
  }
}

__device__ __forceinline__ float point_chi(const float* T, const Cam& cam, const float* xw,
                                           const float* obs, float info, bool stereo) {
  float pc[3];
  cam_point(T, xw, pc);
  const float zs = safe_z(pc[2]);
  const float u = pc[0] / zs * cam.fx + cam.cx;
  const float v = pc[1] / zs * cam.fy + cam.cy;
  const float ur = u - cam.bf / zs;
  const float r0 = (obs[0] - u) * 1.f, r1 = (obs[1] - v) * 1.f;
  const float r2 = (obs[2] - ur) * (stereo ? 1.f : 0.f);
  return (r0 * r0 + r1 * r1 + r2 * r2) * info;
}

// ------------------------------------------------------------- line rows
__device__ __forceinline__ float line_res(const float* T, const Cam& cam, const float* xw,
                                          const float* eq, float* pc) {
  cam_point(T, xw, pc);
  const float zs = safe_z(pc[2]);
  const float u = pc[0] / zs * cam.fx + cam.cx;
  const float v = pc[1] / zs * cam.fy + cam.cy;
  return eq[0] * u + eq[1] * v + eq[2];
}

template <int D, bool kJ>
__device__ void line_row(const float* T, const Cam& cam, const float* xw, const float* eq,
                         float info, bool mask, bool huber, float ln_delta, float* s) {
  float pc[3];
  const float r = line_res(T, cam, xw, eq, pc);
  const float w = huber_w(r * r * info, ln_delta, mask, huber) * sqrtf(info);
  if (!kJ) {
    const float rw = r * w;
    s[Sums<D>::kN - 1] += rw * rw;
    return;
  }
  const float zi = 1.f / safe_z(pc[2]);
  const float au[3] = {cam.fx * zi, 0.f, -cam.fx * pc[0] * zi * zi};
  const float av[3] = {0.f, cam.fy * zi, -cam.fy * pc[1] * zi * zi};
  float l[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) l[i] = eq[0] * au[i] + eq[1] * av[i];
  float J[D];
  pose_row<D>(l, pc, J);
#pragma unroll
  for (int k = 0; k < D; ++k) J[k] *= w;
  add_row<D>(s, J, r * w);
}

// ------------------------------------------------------------ plane rows
__device__ __forceinline__ void cross3(const float* a, const float* b, float* out) {
  out[0] = a[1] * b[2] - a[2] * b[1];
  out[1] = a[2] * b[0] - a[0] * b[2];
  out[2] = a[0] * b[1] - a[1] * b[0];
}

__device__ __forceinline__ float norm3(const float* a) {
  return sqrtf(a[0] * a[0] + a[1] * a[1] + a[2] * a[2]);
}

// _normalize of the observed plane (value only)
__device__ __forceinline__ void normalize_obs(const float* p, float* q) {
  const float s = clamp_min(norm3(p), kClamp);
#pragma unroll
  for (int i = 0; i < 4; ++i) q[i] = p[i] / s;
  if (q[3] < 0.f) {
#pragma unroll
    for (int i = 0; i < 4; ++i) q[i] = -q[i];
  }
}

// _angles: azimuth and elevation of v, and (kT) their tangents from dv
template <int D, bool kT>
__device__ __forceinline__ void angles(const float* v, const float (*dv)[D], float& az,
                                       float& el, float* daz, float* del) {
  const float nn = sqrtf(v[0] * v[0] + v[1] * v[1]);
  const float r = clamp_min(nn, kClamp);
  az = atan2f(v[1], v[0]);
  el = atan2f(v[2], r);
  if (kT) {
#pragma unroll
    for (int k = 0; k < D; ++k) {
      const float dr = nn > kClamp ? (v[0] * dv[0][k] + v[1] * dv[1][k]) / r : 0.f;
      daz[k] = (v[0] * dv[1][k] - v[1] * dv[0][k]) / (v[0] * v[0] + v[1] * v[1]);
      del[k] = (r * dv[2][k] - v[2] * dr) / (r * r + v[2] * v[2]);
    }
  }
}

// The raw rows of one plane observation of family `kind` (0 pl: 3 rows,
// 1 par and 2 ver: 2 rows) at pose T, and with kJ their Jacobian (D
// columns) wrt the retraction increment; translation only (D == 3) the
// normals do not move and only the distance row has a tangent.
template <int D, bool kJ>
__device__ void plane_rows(int kind, const float* T, const float* pw, const float* po,
                           float* r, float (*J)[D]) {
  constexpr bool kT = kJ && D == 6;  // the normals' tangents
  // _transform: the map plane moved into the camera, w >= 0
  float n2[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) n2[i] = pw[0] * T[4 * i] + pw[1] * T[4 * i + 1] + pw[2] * T[4 * i + 2];
  const float d2 = pw[3] - (T[3] * n2[0] + T[7] * n2[1] + T[11] * n2[2]);
  float p[4] = {n2[0], n2[1], n2[2], d2};
  float dp[4][D];
  if (kJ) {
    if (D == 3) {
#pragma unroll
      for (int i = 0; i < 3; ++i) {
#pragma unroll
        for (int k = 0; k < D; ++k) dp[i][k] = 0.f;
      }
#pragma unroll
      for (int k = 0; k < D; ++k) dp[3][k] = -n2[k];
    } else {
      // [[0 | -hat(n2)], [-n2 | 0]]
      const float mh[3][3] = {{0.f, n2[2], -n2[1]}, {-n2[2], 0.f, n2[0]}, {n2[1], -n2[0], 0.f}};
#pragma unroll
      for (int i = 0; i < 3; ++i) {
#pragma unroll
        for (int k = 0; k < 3; ++k) {
          dp[i][k] = 0.f;
          dp[i][3 + k] = mh[i][k];
        }
      }
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        dp[3][k] = -n2[k];
        dp[3][3 + k] = 0.f;
      }
    }
  }
  if (d2 < 0.f) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      p[i] = -p[i];
      if (kJ) {
#pragma unroll
        for (int k = 0; k < D; ++k) dp[i][k] = -dp[i][k];
      }
    }
  }
  // _normalize with its tangent
  const float nn = norm3(p);
  const float sn = clamp_min(nn, kClamp);
  float q[4], dq[4][D];
#pragma unroll
  for (int i = 0; i < 4; ++i) q[i] = p[i] / sn;
  if (kJ) {
#pragma unroll
    for (int k = 0; k < D; ++k) {
      const float ds = nn > kClamp ? (p[0] * dp[0][k] + p[1] * dp[1][k] + p[2] * dp[2][k]) / sn : 0.f;
#pragma unroll
      for (int i = 0; i < 4; ++i) dq[i][k] = dp[i][k] / sn - q[i] * (ds / sn);
    }
  }
  if (q[3] < 0.f) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      q[i] = -q[i];
      if (kJ) {
#pragma unroll
        for (int k = 0; k < D; ++k) dq[i][k] = -dq[i][k];
      }
    }
  }
  float o[4];
  normalize_obs(po, o);
  // _frame_normal
  float nor[3], dnor[3][D];
  if (kind == 0) {
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      nor[i] = q[i];
      if (kT) {
#pragma unroll
        for (int k = 0; k < D; ++k) dnor[i][k] = dq[i][k];
      }
    }
  } else if (kind == 1) {
    const bool flip = (o[0] * q[0] + o[1] * q[1] + o[2] * q[2]) < 0.f;
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      nor[i] = flip ? -q[i] : q[i];
      if (kT) {
#pragma unroll
        for (int k = 0; k < D; ++k) dnor[i][k] = flip ? -dq[i][k] : dq[i][k];
      }
    }
  } else {
    // the normal turned 90 deg toward o's about their common perpendicular:
    // (I + sin W + (1 - cos) W W) ns, both coefficients 1 in float32
    float v[3], vn[3];
    cross3(q, o, v);
    const float vnn = norm3(v);
    const float sv = clamp_min(vnn, kClamp);
#pragma unroll
    for (int i = 0; i < 3; ++i) vn[i] = v[i] / sv;
    const float W[3][3] = {{0.f, -vn[2], vn[1]}, {vn[2], 0.f, -vn[0]}, {-vn[1], vn[0], 0.f}};
    float M[3][3];
#pragma unroll
    for (int i = 0; i < 3; ++i) {
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        const float ww = W[i][0] * W[0][j] + W[i][1] * W[1][j] + W[i][2] * W[2][j];
        M[i][j] = ((i == j ? 1.f : 0.f) + 1.f * W[i][j]) + 1.f * ww;
      }
    }
#pragma unroll
    for (int i = 0; i < 3; ++i) nor[i] = M[i][0] * q[0] + M[i][1] * q[1] + M[i][2] * q[2];
    if (kT) {
      float w[3];
      cross3(vn, q, w);
#pragma unroll
      for (int k = 0; k < D; ++k) {
        const float dns[3] = {dq[0][k], dq[1][k], dq[2][k]};
        float c[3], dv[3], dvn[3], dw[3], t1[3], t2[3];
        cross3(o, dns, c);
#pragma unroll
        for (int i = 0; i < 3; ++i) dv[i] = -c[i];
        const float dsv = vnn > kClamp ? (v[0] * dv[0] + v[1] * dv[1] + v[2] * dv[2]) / sv : 0.f;
#pragma unroll
        for (int i = 0; i < 3; ++i) dvn[i] = dv[i] / sv - vn[i] * (dsv / sv);
        cross3(vn, dns, t1);
        cross3(q, dvn, t2);
#pragma unroll
        for (int i = 0; i < 3; ++i) dw[i] = t1[i] - t2[i];
        cross3(vn, dw, t1);
        cross3(w, dvn, t2);
#pragma unroll
        for (int i = 0; i < 3; ++i) dnor[i][k] = dns[i] + 1.f * dw[i] + 1.f * (t1[i] - t2[i]);
      }
    }
  }
  // _rotate_into: R(nor)^T o, R = Rz(azimuth) Ry(-elevation), and its tangent
  float az, el, daz[D], del[D];
  angles<D, kT>(nor, dnor, az, el, daz, del);
  const float ca = cosf(az), sa = sinf(az), ce = cosf(el), se = sinf(el);
  const float R[3][3] = {{ca * ce, -sa, -ca * se}, {sa * ce, ca, -sa * se}, {se, 0.f, ce}};
  float m[3], dm[3][D];
#pragma unroll
  for (int j = 0; j < 3; ++j) m[j] = R[0][j] * o[0] + R[1][j] * o[1] + R[2][j] * o[2];
  if (kT) {
    const float Raz[3][3] = {{-sa * ce, -ca, sa * se}, {ca * ce, -sa, -ca * se}, {0.f, 0.f, 0.f}};
    const float Rel[3][3] = {{-ca * se, 0.f, -ca * ce}, {-sa * se, 0.f, -sa * ce}, {ce, 0.f, -se}};
#pragma unroll
    for (int j = 0; j < 3; ++j) {
#pragma unroll
      for (int k = 0; k < D; ++k) {
        float acc = (Raz[0][j] * daz[k] + Rel[0][j] * del[k]) * o[0];
        acc += (Raz[1][j] * daz[k] + Rel[1][j] * del[k]) * o[1];
        acc += (Raz[2][j] * daz[k] + Rel[2][j] * del[k]) * o[2];
        dm[j][k] = acc;
      }
    }
  }
  float az2, el2, daz2[D], del2[D];
  angles<D, kT>(m, dm, az2, el2, daz2, del2);
  r[0] = az2;
  r[1] = el2;
  if (kind == 0) r[2] = (-q[3]) - (-o[3]);
  if (kJ) {
#pragma unroll
    for (int k = 0; k < D; ++k) {
      J[0][k] = kT ? daz2[k] : 0.f;
      J[1][k] = kT ? del2[k] : 0.f;
      if (kind == 0) J[2][k] = -dq[3][k];
    }
  }
}

// chi2 of one plane observation from its raw rows
__device__ __forceinline__ float plane_chi(const Params& p, int kind, const float* r) {
  if (kind == 0)
    return r[0] * r[0] * p.pl_info[0] + r[1] * r[1] * p.pl_info[1] + r[2] * r[2] * p.pl_info[2];
  return (r[0] * r[0] + r[1] * r[1]) * p.fam_info[kind];
}

template <int D, bool kJ>
__device__ void plane_obs_row(const Params& p, int kind, const float* T, const float* pw,
                              const float* po, bool huber, float* s) {
  float r[3], J[3][D];
  plane_rows<D, kJ>(kind, T, pw, po, r, J);
  const float w = huber_w(plane_chi(p, kind, r), p.delta[kind], true, huber);
  const int n = kind == 0 ? 3 : 2;
  for (int i = 0; i < n; ++i) {
    const float sc = w * (kind == 0 ? p.sq_pl_info[i] : p.sq_fam_info[kind]);
    if (kJ) {
      float Js[D];
#pragma unroll
      for (int k = 0; k < D; ++k) Js[k] = J[i][k] * sc;
      add_row<D>(s, Js, r[i] * sc);
    } else {
      const float rw = r[i] * sc;
      s[Sums<D>::kN - 1] += rw * rw;
    }
  }
}

// ------------------------------------------------------- the block's sums
template <int N>
__device__ void block_sum(float* v, Shared& sh) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < N; ++k) {
    float x = v[k];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) x += __shfl_down_sync(0xffffffffu, x, off);
    if (lane == 0) sh.red[warp][k] = x;
  }
  __syncthreads();
  if (threadIdx.x < N) {
    float s = sh.red[0][threadIdx.x];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) s += sh.red[w][threadIdx.x];
    sh.sum[threadIdx.x] = s;
  }
  __syncthreads();
}

struct Problem {
  const float *pt_xw, *pt_obs, *pt_info;
  const uint8_t *pt_stereo, *pt_mask;
  const float *ln_xw, *ln_eq, *ln_info;
  const uint8_t* ln_mask;
  const float *pl_w[kFam], *pl_obs[kFam];
  const uint8_t* pl_mask[kFam];
  uint8_t *in_pt, *in_ln, *in_pl[kFam];
};

// The plane observation a thread owns: taken from the last thread down,
// so they fall on the threads with the fewest point rows.
__device__ __forceinline__ bool plane_of(const Params& p, int g, int& kind, int& j) {
  j = g;
  for (kind = 0; kind < kFam; ++kind) {
    if (j < p.n_pl[kind]) return true;
    j -= p.n_pl[kind];
  }
  return false;
}

// kJ: every weighted row's H, g and cost into s (Sums<D>::kN); else the cost alone
template <int D, bool kJ>
__device__ void system_pass(const Params& p, const Problem& q, const Cam& cam, const float* T,
                            bool huber, float* s) {
#pragma unroll
  for (int k = 0; k < Sums<D>::kN; ++k) s[k] = 0.f;
  for (int i = threadIdx.x; i < p.n_pt; i += kThreads)
    point_row<D, kJ>(T, cam, q.pt_xw + 3 * i, q.pt_obs + 3 * i, q.pt_info[i], q.pt_stereo[i] != 0,
                     q.in_pt[i] != 0, huber, s);
  if (p.use_lines) {
    for (int i = threadIdx.x; i < p.n_ln; i += kThreads)
      line_row<D, kJ>(T, cam, q.ln_xw + 3 * i, q.ln_eq + 3 * i, q.ln_info[i], q.in_ln[i] != 0,
                      huber, p.ln_delta, s);
  }
  if (p.use_planes) {
    for (int g = kThreads - 1 - threadIdx.x;; g += kThreads) {
      int kind, j;
      if (!plane_of(p, g, kind, j)) break;
      if (q.in_pl[kind][j])  // the masked-row guard: a masked row is zero
        plane_obs_row<D, kJ>(p, kind, T, q.pl_w[kind] + 4 * j, q.pl_obs[kind] + 4 * j, huber, s);
    }
  }
}

// The re-gate against the ORIGINAL masks at T (regate), or the current
// masks as they are; v gets the inliers' count and chi2 sum.
__device__ void chi_pass(const Params& p, const Problem& q, const Cam& cam, const float* T,
                         bool regate, float* v) {
  float count = 0.f, chi = 0.f;
  for (int i = threadIdx.x; i < p.n_pt; i += kThreads) {
    const bool st = q.pt_stereo[i] != 0;
    const float c = point_chi(T, cam, q.pt_xw + 3 * i, q.pt_obs + 3 * i, q.pt_info[i], st);
    bool m = q.in_pt[i] != 0;
    if (regate) {
      m = q.pt_mask[i] != 0 && c <= (st ? 7.815f : 5.991f);
      q.in_pt[i] = m;
    }
    if (m) {
      count += 1.f;
      chi += c;
    }
  }
  if (p.use_lines) {
    for (int i = threadIdx.x; i < p.n_ln; i += kThreads) {
      float pc[3];
      const float r = line_res(T, cam, q.ln_xw + 3 * i, q.ln_eq + 3 * i, pc);
      const float c = r * r * q.ln_info[i];
      bool m = q.in_ln[i] != 0;
      if (regate) {
        m = q.ln_mask[i] != 0 && c <= p.ln_gate;
        q.in_ln[i] = m;
      }
      if (m) {
        count += 1.f;
        chi += c;
      }
    }
  }
  if (p.use_planes) {
    for (int g = kThreads - 1 - threadIdx.x;; g += kThreads) {
      int kind, j;
      if (!plane_of(p, g, kind, j)) break;
      float c = 0.f;
      if (q.pl_mask[kind][j]) {  // rows guarded by the original masks
        float r[3];
        plane_rows<6, false>(kind, T, q.pl_w[kind] + 4 * j, q.pl_obs[kind] + 4 * j, r, nullptr);
        c = plane_chi(p, kind, r);
      }
      bool m = q.in_pl[kind][j] != 0;
      if (regate) {
        m = q.pl_mask[kind][j] != 0 && c <= p.gate[kind];
        q.in_pl[kind][j] = m;
      }
      if (m) {
        count += 1.f;
        chi += c;
      }
    }
  }
  v[0] = count;
  v[1] = chi;
}

// ------------------------------------------------ thread 0: solve, retract
template <int D>
__device__ void unpack(const float* upper, float (*H)[D]) {
  int k = 0;
  for (int i = 0; i < D; ++i) {
    for (int j = i; j < D; ++j) {
      H[i][j] = upper[k];
      H[j][i] = upper[k];
      ++k;
    }
  }
}

// x = A^-1 b by Cholesky (lower factor, two triangular solves); a pivot
// that is not finite and > 0 fails the factorization: x is NaN
template <int D>
__device__ void solve_spd(float (*A)[D], const float* b, float* x) {
  float L[D][D];
  for (int j = 0; j < D; ++j) {
    float d = A[j][j];
    for (int k = 0; k < j; ++k) d -= L[j][k] * L[j][k];
    if (!(d > 0.f) || !isfinite(d)) {
      for (int i = 0; i < D; ++i) x[i] = nanf("");
      return;
    }
    L[j][j] = sqrtf(d);
    for (int i = j + 1; i < D; ++i) {
      float e = A[i][j];
      for (int k = 0; k < j; ++k) e -= L[i][k] * L[j][k];
      L[i][j] = e / L[j][j];
    }
  }
  float y[D];
  for (int i = 0; i < D; ++i) {
    float e = b[i];
    for (int k = 0; k < i; ++k) e -= L[i][k] * y[k];
    y[i] = e / L[i][i];
  }
  for (int i = D - 1; i >= 0; --i) {
    float e = y[i];
    for (int k = i + 1; k < D; ++k) e -= L[k][i] * x[k];
    x[i] = e / L[i][i];
  }
}

// se3.exp_se3(xi) @ T (6 dof) or T with xi added to its translation
template <int D>
__device__ void retract(const float* T, const float* xi, float* out) {
  if (D == 3) {
    for (int i = 0; i < 16; ++i) out[i] = T[i];
    for (int i = 0; i < 3; ++i) out[4 * i + 3] = T[4 * i + 3] + xi[i];
    return;
  }
  const float* rho = xi;
  const float* phi = xi + 3;
  const float theta2 = phi[0] * phi[0] + phi[1] * phi[1] + phi[2] * phi[2];
  const float theta = sqrtf(theta2 + 1e-16f);
  const float W[3][3] = {{0.f, -phi[2], phi[1]}, {phi[2], 0.f, -phi[0]}, {-phi[1], phi[0], 0.f}};
  float W2[3][3];
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) W2[i][j] = W[i][0] * W[0][j] + W[i][1] * W[1][j] + W[i][2] * W[2][j];
  const bool small = theta2 < 1e-8f;
  const float sn = sinf(theta), cs = cosf(theta);
  const float a = small ? 1.f - theta2 / 6.f : sn / theta;
  const float b = small ? 0.5f - theta2 / 24.f : (1.f - cs) / clamp_min(theta2, 1e-16f);
  const float c = small ? (float)(1.0 / 6.0) - theta2 / 120.f
                        : (theta - sn) / clamp_min(theta2 * theta, 1e-24f);
  float E[4][4];
  for (int i = 0; i < 3; ++i) {
    float t = 0.f;
    for (int j = 0; j < 3; ++j) {
      const float eye = i == j ? 1.f : 0.f;
      E[i][j] = eye + a * W[i][j] + b * W2[i][j];
      const float V = eye + b * W[i][j] + c * W2[i][j];
      t = j == 0 ? V * rho[0] : t + V * rho[j];
    }
    E[i][3] = t;
  }
  E[3][0] = E[3][1] = E[3][2] = 0.f;
  E[3][3] = 1.f;
  for (int i = 0; i < 4; ++i)
    for (int j = 0; j < 4; ++j)
      out[4 * i + j] = E[i][0] * T[j] + E[i][1] * T[4 + j] + E[i][2] * T[8 + j] + E[i][3] * T[12 + j];
}

template <int D>
__device__ bool all_finite(const float* x) {
  bool ok = true;
  for (int i = 0; i < D; ++i) ok = ok && isfinite(x[i]);
  return ok;
}

// damped Gauss-Newton: step = -(H + 1e-3 I)^-1 g, taken when finite and
// shorter than 1
template <int D>
__device__ void gn_update(Shared& sh) {
  float H[D][D], step[D];
  unpack<D>(sh.sum, H);
  for (int i = 0; i < D; ++i) H[i][i] = H[i][i] + 1e-3f;
  solve_spd<D>(H, sh.sum + Sums<D>::kH, step);
  float n2 = 0.f;
  for (int i = 0; i < D; ++i) {
    step[i] = -step[i];
    n2 += step[i] * step[i];
  }
  if (all_finite<D>(step) && sqrtf(n2) < 1.f) {
    float Tn[16];
    retract<D>(sh.T, step, Tn);
    for (int i = 0; i < 16; ++i) sh.T[i] = Tn[i];
  }
}

// deferred-accept LM: this evaluation adjudicates the last proposal
// against the accepted cost, then the next proposal is solved from the
// accepted system with lambda halved (accept) or x4 (reject)
template <int D>
__device__ void lm_update(Shared& sh) {
  const float c = 0.5f * sh.sum[Sums<D>::kN - 1];
  const bool ok = isfinite(c) && c < sh.c_acc;
  if (ok) {
    for (int i = 0; i < 16; ++i) sh.T_acc[i] = sh.T[i];
    for (int i = 0; i < Sums<D>::kH; ++i) sh.H_acc[i] = sh.sum[i];
    for (int i = 0; i < D; ++i) sh.g_acc[i] = sh.sum[Sums<D>::kH + i];
    sh.c_acc = c;
  }
  const float lam = ok ? sh.lam * 0.5f : sh.lam * 4.f;
  sh.lam = fminf(fmaxf(lam, 1e-8f), 1e6f);
  float H[D][D], step[D];
  unpack<D>(sh.H_acc, H);
  for (int i = 0; i < D; ++i) H[i][i] = H[i][i] + sh.lam;
  solve_spd<D>(H, sh.g_acc, step);
  for (int i = 0; i < D; ++i) step[i] = -step[i];
  if (!all_finite<D>(step))
    for (int i = 0; i < D; ++i) step[i] = 0.f;
  retract<D>(sh.T_acc, step, sh.T);
}

template <int D>
__global__ void __launch_bounds__(kThreads) lm_solve_kernel(const __grid_constant__ Params p) {
  __shared__ Shared sh;
  const int b = blockIdx.x, tid = threadIdx.x;
  Problem q;
  q.pt_xw = p.pt_xw + (size_t)b * p.n_pt * 3;
  q.pt_obs = p.pt_obs + (size_t)b * p.n_pt * 3;
  q.pt_info = p.pt_info + (size_t)b * p.n_pt;
  q.pt_stereo = p.pt_stereo + (size_t)b * p.n_pt;
  q.pt_mask = p.pt_mask + (size_t)b * p.n_pt;
  q.in_pt = p.in_pt + (size_t)b * p.n_pt;
  q.ln_xw = p.ln_xw + (size_t)b * p.n_ln * 3;
  q.ln_eq = p.ln_eq + (size_t)b * p.n_ln * 3;
  q.ln_info = p.ln_info + (size_t)b * p.n_ln;
  q.ln_mask = p.ln_mask + (size_t)b * p.n_ln;
  q.in_ln = p.in_ln + (size_t)b * p.n_ln_out;
  for (int f = 0; f < kFam; ++f) {
    q.pl_w[f] = p.pl_w[f] + (size_t)b * p.n_pl[f] * 4;
    q.pl_obs[f] = p.pl_obs[f] + (size_t)b * p.n_pl[f] * 4;
    q.pl_mask[f] = p.pl_mask[f] + (size_t)b * p.n_pl[f];
    q.in_pl[f] = p.in_pl[f] + (size_t)b * p.n_pl_out[f];
  }
  const Cam cam{p.K[0], p.K[4], p.K[2], p.K[5], p.bf};

  // the current masks start as the original ones; a family left out
  // returns no inliers
  if (tid < 16) sh.T[tid] = p.T0[(size_t)b * 16 + tid];
  for (int i = tid; i < p.n_pt; i += kThreads) q.in_pt[i] = q.pt_mask[i];
  for (int i = tid; i < p.n_ln_out; i += kThreads) q.in_ln[i] = p.use_lines ? q.ln_mask[i] : 0;
  for (int f = 0; f < kFam; ++f)
    for (int i = tid; i < p.n_pl_out[f]; i += kThreads) q.in_pl[f][i] = p.use_planes ? q.pl_mask[f][i] : 0;
  __syncthreads();

  float s[Sums<D>::kN], T[16];
  for (int rnd = 0; rnd < p.n_rounds; ++rnd) {
    const bool huber = rnd < 2;
    if (!p.gauss_newton && tid == 0) {
      for (int i = 0; i < 16; ++i) sh.T_acc[i] = sh.T[i];
      for (int i = 0; i < Sums<D>::kH; ++i) sh.H_acc[i] = 0.f;
      for (int i = 0; i < D; ++i) sh.g_acc[i] = 0.f;
      sh.c_acc = INFINITY;
      sh.lam = 1e-3f;
    }
    for (int it = 0; it < p.n_iters; ++it) {
      for (int i = 0; i < 16; ++i) T[i] = sh.T[i];
      system_pass<D, true>(p, q, cam, T, huber, s);
      block_sum<Sums<D>::kN>(s, sh);
      if (tid == 0) {
        if (p.gauss_newton) gn_update<D>(sh);
        else lm_update<D>(sh);
      }
      __syncthreads();
    }
    if (!p.gauss_newton) {
      // the last proposal left the loop unevaluated: one cost-only pass
      // decides between it and the best accepted iterate
      for (int i = 0; i < 16; ++i) T[i] = sh.T[i];
      system_pass<D, false>(p, q, cam, T, huber, s);
      block_sum<1>(s + Sums<D>::kN - 1, sh);
      if (tid == 0 && !(0.5f * sh.sum[0] < sh.c_acc))
        for (int i = 0; i < 16; ++i) sh.T[i] = sh.T_acc[i];
      __syncthreads();
    }
    // re-gate every family against the ORIGINAL masks (edges can come back)
    for (int i = 0; i < 16; ++i) T[i] = sh.T[i];
    chi_pass(p, q, cam, T, true, s);
    if (rnd == p.n_rounds - 1) block_sum<2>(s, sh);
  }
  if (p.n_rounds == 0) {
    for (int i = 0; i < 16; ++i) T[i] = sh.T[i];
    chi_pass(p, q, cam, T, false, s);
    block_sum<2>(s, sh);
  }
  if (tid < 16) p.T[(size_t)b * 16 + tid] = sh.T[tid];
  if (tid == 0) {
    p.n_inliers[b] = (long long)sh.sum[0];
    p.chi2[b] = sh.sum[1];
  }
}

}  // namespace

// in: 20 device pointers, in this order: pt_xw, pt_obs, pt_info,
// pt_stereo, pt_mask, pl_w, pl_obs, pl_mask, par_w, par_obs, par_mask,
// ver_w, ver_obs, ver_mask, ln_xw, ln_eq, ln_info, ln_mask, T0, K
// (float32 or bool, batch-major and contiguous; the families a solve
// leaves out may be null).  out: 8 device pointers: T (B, 4, 4), the
// inlier masks pt, ln, pl, par, ver (bool), n_inliers (int64), chi2.
// dims: B, n_pt, n_ln, n_pl, n_par, n_ver, then the widths of the output
// masks ln, pl, par, ver.  consts: bf, angle_info, dis_info, par_info,
// ver_info, plane_chi, vp_chi.  All three are host arrays.  Returns the
// cudaError_t of the launch (0 on success; nothing is launched for B = 0),
// or cudaErrorInvalidValue for a dof other than 3 or 6.
extern "C" int mslam_lm_solve(const void* const* in, void* const* out, const int* dims,
                              const float* consts, int dof, int gauss_newton, int use_lines,
                              int use_planes, int n_rounds, int n_iters, void* stream) {
  if ((dof != 3 && dof != 6) || n_rounds < 0 || n_iters < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p{};
  p.pt_xw = static_cast<const float*>(in[0]);
  p.pt_obs = static_cast<const float*>(in[1]);
  p.pt_info = static_cast<const float*>(in[2]);
  p.pt_stereo = static_cast<const uint8_t*>(in[3]);
  p.pt_mask = static_cast<const uint8_t*>(in[4]);
  for (int f = 0; f < kFam; ++f) {
    p.pl_w[f] = static_cast<const float*>(in[5 + 3 * f]);
    p.pl_obs[f] = static_cast<const float*>(in[6 + 3 * f]);
    p.pl_mask[f] = static_cast<const uint8_t*>(in[7 + 3 * f]);
  }
  p.ln_xw = static_cast<const float*>(in[14]);
  p.ln_eq = static_cast<const float*>(in[15]);
  p.ln_info = static_cast<const float*>(in[16]);
  p.ln_mask = static_cast<const uint8_t*>(in[17]);
  p.T0 = static_cast<const float*>(in[18]);
  p.K = static_cast<const float*>(in[19]);
  p.T = static_cast<float*>(out[0]);
  p.in_pt = static_cast<uint8_t*>(out[1]);
  p.in_ln = static_cast<uint8_t*>(out[2]);
  for (int f = 0; f < kFam; ++f) p.in_pl[f] = static_cast<uint8_t*>(out[3 + f]);
  p.n_inliers = static_cast<long long*>(out[6]);
  p.chi2 = static_cast<float*>(out[7]);
  const int batch = dims[0];
  p.n_pt = dims[1];
  p.n_ln = use_lines ? dims[2] : 0;
  for (int f = 0; f < kFam; ++f) p.n_pl[f] = use_planes ? dims[3 + f] : 0;
  p.n_ln_out = dims[6];
  for (int f = 0; f < kFam; ++f) p.n_pl_out[f] = dims[7 + f];
  p.n_rounds = n_rounds;
  p.n_iters = n_iters;
  p.gauss_newton = gauss_newton;
  p.use_lines = use_lines;
  p.use_planes = use_planes;
  p.bf = consts[0];
  const float ai = consts[1], di = consts[2], par = consts[3], ver = consts[4];
  const float plane_chi = consts[5], vp_chi = consts[6];
  p.pl_info[0] = p.pl_info[1] = ai;
  p.pl_info[2] = di;
  p.sq_pl_info[0] = p.sq_pl_info[1] = static_cast<float>(sqrt(static_cast<double>(ai)));
  p.sq_pl_info[2] = static_cast<float>(sqrt(static_cast<double>(di)));
  p.fam_info[0] = 0.f;
  p.fam_info[1] = par;
  p.fam_info[2] = ver;
  p.sq_fam_info[0] = 0.f;
  p.sq_fam_info[1] = static_cast<float>(sqrt(static_cast<double>(par)));
  p.sq_fam_info[2] = static_cast<float>(sqrt(static_cast<double>(ver)));
  p.gate[0] = plane_chi;
  p.gate[1] = p.gate[2] = vp_chi;
  p.delta[0] = static_cast<float>(sqrt(static_cast<double>(plane_chi)));
  p.delta[1] = p.delta[2] = static_cast<float>(sqrt(static_cast<double>(vp_chi)));
  p.ln_delta = static_cast<float>(sqrt(7.815));
  p.ln_gate = static_cast<float>(2.0 * 5.991);
  if (batch == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dof == 6) lm_solve_kernel<6><<<batch, kThreads, 0, s>>>(p);
  else lm_solve_kernel<3><<<batch, kThreads, 0, s>>>(p);
  return static_cast<int>(cudaGetLastError());
}
