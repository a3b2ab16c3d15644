// Agglomerative hierarchical clustering of plane-block statistics.
//
// Native implementation of the sequential min-MSE merge at the heart of the
// PEAC plane detector (reference include/peac/AHCPlaneFitter.hpp, ahCluster
// :939): the block graph is tiny (~768 nodes for 640x480 at half-res) but the
// merge loop is inherently sequential, so it runs on the host, in C++ (the
// same loop as merge_blocks_py in ops/planes.py; chip_smoke.py times both).
//
// Exposed as a C ABI for ctypes (see manhattanslam_tpu_torch/ops/native.py).
//
// Built on first use by ops/kernel_build.py: one g++ -O2 -fPIC -shared
// -std=c++17 call into build/torch_kernels/ahc_merge-<hash>.so.

#include <cmath>
#include <cstdint>
#include <cstring>
#include <functional>
#include <queue>
#include <vector>

namespace {

struct Seg {
  double n;
  double s1[3];
  double s2[9];  // row-major 3x3
  double normal[3];
  double mean[3];
  bool valid;
};

// smallest eigenvalue + eigenvector of a symmetric 3x3 matrix
// (closed form: characteristic polynomial + inverse iteration fallback)
static void eig33_smallest(const double cov[9], double* eval, double evec[3]) {
  const double a = cov[0], b = cov[4], c = cov[8];
  const double d = cov[1], e = cov[5], f = cov[2];
  const double p1 = d * d + e * e + f * f;
  if (p1 < 1e-24) {  // diagonal
    int k = 0;
    if (b < cov[k * 4]) k = 1;
    if (c < cov[k * 4]) k = 2;
    *eval = cov[k * 4];
    evec[0] = evec[1] = evec[2] = 0.0;
    evec[k] = 1.0;
    return;
  }
  const double q = (a + b + c) / 3.0;
  const double p2 =
      (a - q) * (a - q) + (b - q) * (b - q) + (c - q) * (c - q) + 2.0 * p1;
  const double p = std::sqrt(p2 / 6.0);
  // B = (cov - q I) / p
  double B[9];
  for (int i = 0; i < 9; i++) B[i] = cov[i] / p;
  B[0] -= q / p;
  B[4] -= q / p;
  B[8] -= q / p;
  const double detB =
      B[0] * (B[4] * B[8] - B[5] * B[7]) - B[1] * (B[3] * B[8] - B[5] * B[6]) +
      B[2] * (B[3] * B[7] - B[4] * B[6]);
  double r = detB / 2.0;
  if (r < -1.0) r = -1.0;
  if (r > 1.0) r = 1.0;
  const double phi = std::acos(r) / 3.0;
  const double eig1 = q + 2.0 * p * std::cos(phi);              // largest
  const double eig3 = q + 2.0 * p * std::cos(phi + 2.0943951);  // smallest
  const double eig2 = 3.0 * q - eig1 - eig3;
  *eval = eig3;
  // eigenvector: (A - eig1 I)(A - eig2 I) column with largest norm
  double M1[9], M2[9], P[9];
  std::memcpy(M1, cov, sizeof(M1));
  std::memcpy(M2, cov, sizeof(M2));
  M1[0] -= eig1; M1[4] -= eig1; M1[8] -= eig1;
  M2[0] -= eig2; M2[4] -= eig2; M2[8] -= eig2;
  for (int i = 0; i < 3; i++)
    for (int j = 0; j < 3; j++) {
      P[i * 3 + j] = 0.0;
      for (int k = 0; k < 3; k++) P[i * 3 + j] += M1[i * 3 + k] * M2[k * 3 + j];
    }
  int best = 0;
  double bestn = -1.0;
  for (int j = 0; j < 3; j++) {
    double nn = P[j] * P[j] + P[3 + j] * P[3 + j] + P[6 + j] * P[6 + j];
    if (nn > bestn) { bestn = nn; best = j; }
  }
  double nn = std::sqrt(bestn);
  if (nn < 1e-18) { evec[0] = 1; evec[1] = 0; evec[2] = 0; return; }
  evec[0] = P[best] / nn;
  evec[1] = P[3 + best] / nn;
  evec[2] = P[6 + best] / nn;
}

static void seg_plane(const Seg& s, double normal[3], double* mse) {
  double mean[3] = {s.s1[0] / s.n, s.s1[1] / s.n, s.s1[2] / s.n};
  double cov[9];
  for (int i = 0; i < 3; i++)
    for (int j = 0; j < 3; j++)
      cov[i * 3 + j] = s.s2[i * 3 + j] / s.n - mean[i] * mean[j];
  double eval;
  eig33_smallest(cov, &eval, normal);
  if (normal[0] * mean[0] + normal[1] * mean[1] + normal[2] * mean[2] > 0) {
    normal[0] = -normal[0]; normal[1] = -normal[1]; normal[2] = -normal[2];
  }
  *mse = eval > 0 ? eval : 0.0;
}

static double mse_threshold(double z) {
  const double sigma = 1.6e-6 * z * z * 1e3 + 0.008;
  return sigma * sigma;
}

// cos of the dynamic normal-deviation threshold T_ang(INIT, z)
// (reference AHCParamSet.hpp:100-128, meters): 15 deg @ 0.5 m -> 90 deg @ 4 m
static double t_ang_cos(double z) {
  const double z_near = 0.5, z_far = 4.0;
  const double a_near = 15.0 * M_PI / 180.0, a_far = 90.0 * M_PI / 180.0;
  double zc = z < z_near ? z_near : (z > z_far ? z_far : z);
  const double ang = a_near + (a_far - a_near) * (zc - z_near) / (z_far - z_near);
  return std::cos(ang);
}

struct HeapItem {
  double mse;
  int a, b;
  bool operator>(const HeapItem& o) const { return mse > o.mse; }
};

}  // namespace

extern "C" {

// n_blk: number of blocks; grid bh x bw (bh*bw == n_blk).
// n[b], s1[b*3], s2[b*9], normal[b*3], mean[b*3], valid[b] — block stats.
// out_labels[b]: -1 or segment id (0..n_segments-1).
// Returns number of segments.
int ahc_merge(int bh, int bw, const double* n, const double* s1,
              const double* s2, const double* normal, const double* mean,
              const uint8_t* valid, double angle_cos, double min_support,
              int32_t* out_labels) {
  const int B = bh * bw;
  std::vector<Seg> segs(B);
  std::vector<int> parent(B);
  for (int i = 0; i < B; i++) {
    parent[i] = i;
    segs[i].n = n[i];
    std::memcpy(segs[i].s1, s1 + i * 3, 3 * sizeof(double));
    std::memcpy(segs[i].s2, s2 + i * 9, 9 * sizeof(double));
    std::memcpy(segs[i].normal, normal + i * 3, 3 * sizeof(double));
    std::memcpy(segs[i].mean, mean + i * 3, 3 * sizeof(double));
    segs[i].valid = valid[i] != 0;
  }
  std::function<int(int)> find = [&](int a) {
    while (parent[a] != a) { parent[a] = parent[parent[a]]; a = parent[a]; }
    return a;
  };

  std::vector<std::vector<int>> nbr(B);
  auto add_edge = [&](int i, int j) {
    nbr[i].push_back(j);
    nbr[j].push_back(i);
  };
  for (int y = 0; y < bh; y++)
    for (int x = 0; x < bw; x++) {
      int i = y * bw + x;
      if (!segs[i].valid) continue;
      if (x + 1 < bw && segs[i + 1].valid) add_edge(i, i + 1);
      if (y + 1 < bh && segs[i + bw].valid) add_edge(i, i + bw);
    }

  // angle_cos < 0: dynamic T_ang(INIT, z) per pair (PEAC model); else fixed
  auto pair_cos_th = [&](int ra, int rb) {
    if (angle_cos >= 0.0) return angle_cos;
    return t_ang_cos(0.5 * (segs[ra].mean[2] + segs[rb].mean[2]));
  };
  std::priority_queue<HeapItem, std::vector<HeapItem>, std::greater<HeapItem>> heap;
  auto push_candidate = [&](int ra, int rb) {
    const Seg &A = segs[ra], &Bs = segs[rb];
    double dot = A.normal[0] * Bs.normal[0] + A.normal[1] * Bs.normal[1] +
                 A.normal[2] * Bs.normal[2];
    if (dot < pair_cos_th(ra, rb)) return;
    Seg m;
    m.n = A.n + Bs.n;
    for (int k = 0; k < 3; k++) m.s1[k] = A.s1[k] + Bs.s1[k];
    for (int k = 0; k < 9; k++) m.s2[k] = A.s2[k] + Bs.s2[k];
    double nrm[3], mse;
    seg_plane(m, nrm, &mse);
    heap.push({mse, ra, rb});
  };
  for (int i = 0; i < B; i++)
    for (int j : nbr[i])
      if (j > i) push_candidate(i, j);

  while (!heap.empty()) {
    HeapItem it = heap.top();
    heap.pop();
    int ra = find(it.a), rb = find(it.b);
    if (ra == rb) continue;
    // recompute at current roots (lazy heap)
    Seg m;
    m.n = segs[ra].n + segs[rb].n;
    for (int k = 0; k < 3; k++) m.s1[k] = segs[ra].s1[k] + segs[rb].s1[k];
    for (int k = 0; k < 9; k++) m.s2[k] = segs[ra].s2[k] + segs[rb].s2[k];
    double nrm[3], mse;
    seg_plane(m, nrm, &mse);
    double zbar = m.s1[2] / m.n;
    if (mse > mse_threshold(zbar)) continue;
    double dot = segs[ra].normal[0] * segs[rb].normal[0] +
                 segs[ra].normal[1] * segs[rb].normal[1] +
                 segs[ra].normal[2] * segs[rb].normal[2];
    if (dot < pair_cos_th(ra, rb)) continue;
    // merge rb -> ra
    parent[rb] = ra;
    segs[ra].n = m.n;
    std::memcpy(segs[ra].s1, m.s1, sizeof(m.s1));
    std::memcpy(segs[ra].s2, m.s2, sizeof(m.s2));
    std::memcpy(segs[ra].normal, nrm, sizeof(nrm));
    for (int k = 0; k < 3; k++) segs[ra].mean[k] = m.s1[k] / m.n;
    // merge neighbor lists; push fresh candidates
    std::vector<int> merged;
    merged.reserve(nbr[ra].size() + nbr[rb].size());
    for (int v : nbr[ra]) if (find(v) != ra) merged.push_back(v);
    for (int v : nbr[rb]) if (find(v) != ra) merged.push_back(v);
    nbr[ra] = std::move(merged);
    for (int v : nbr[ra]) {
      int rv = find(v);
      if (rv != ra) push_candidate(ra, rv);
    }
  }

  // label segments with enough support
  std::vector<int32_t> seg_id(B, -1);
  int n_seg = 0;
  for (int i = 0; i < B; i++) out_labels[i] = -1;
  for (int i = 0; i < B; i++) {
    if (!segs[i].valid) continue;
    int r = find(i);
    if (segs[r].n < min_support) continue;
    if (seg_id[r] < 0) seg_id[r] = n_seg++;
    out_labels[i] = seg_id[r];
  }
  return n_seg;
}

}  // extern "C"
