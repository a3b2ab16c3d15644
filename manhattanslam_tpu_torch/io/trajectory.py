"""TUM-format trajectory writing + ATE evaluation.

The output format is the compatibility contract of the rebuild
(reference System.cc:188-275): one line per localized frame,
``timestamp tx ty tz qx qy qz qw`` with fixed-point formatting —
timestamp at 6 decimals, pose values at 9 decimals for the frame
trajectory and 7 decimals for the keyframe trajectory.

ATE RMSE is computed in-repo (SURVEY.md section 4 item 3) with the
standard Horn alignment used by the TUM benchmark tools.
"""

from __future__ import annotations

import numpy as np


def format_tum_line(t: float, twc: np.ndarray, q: np.ndarray, prec: int = 9) -> str:
    vals = " ".join(f"{float(v):.{prec}f}" for v in (*twc, *q))
    return f"{t:.6f} {vals}"


def save_trajectory_tum(path: str, rows) -> None:
    """rows: iterable of (timestamp, twc(3,), quat_xyzw(4,))."""
    with open(path, "w") as f:
        for t, twc, q in rows:
            f.write(format_tum_line(t, np.asarray(twc), np.asarray(q), prec=9) + "\n")


def save_keyframe_trajectory_tum(path: str, rows) -> None:
    with open(path, "w") as f:
        for t, twc, q in rows:
            f.write(format_tum_line(t, np.asarray(twc), np.asarray(q), prec=7) + "\n")


def load_trajectory_tum(path: str) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Returns (timestamps(N,), positions(N,3), quats(N,4))."""
    ts, pos, quat = [], [], []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            v = [float(x) for x in line.split()]
            if len(v) < 8:
                continue
            ts.append(v[0])
            pos.append(v[1:4])
            quat.append(v[4:8])
    return np.array(ts), np.array(pos), np.array(quat)


def associate_timestamps(
    ts_a: np.ndarray, ts_b: np.ndarray, max_dt: float = 0.02
) -> list[tuple[int, int]]:
    """Greedy nearest-timestamp association (TUM associate.py semantics)."""
    pairs = []
    j = 0
    used_b: set[int] = set()
    for i, ta in enumerate(ts_a):
        j = int(np.searchsorted(ts_b, ta))
        best, best_dt = -1, max_dt
        for k in (j - 1, j, j + 1):
            if 0 <= k < len(ts_b) and k not in used_b:
                dt = abs(ts_b[k] - ta)
                if dt < best_dt:
                    best, best_dt = k, dt
        if best >= 0:
            pairs.append((i, best))
            used_b.add(best)
    return pairs


def align_horn(model: np.ndarray, data: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Rigid (no-scale) Horn alignment: finds R, t minimizing |R*model+t - data|.

    Same as the TUM benchmark evaluate_ate.py align() without scale.
    """
    mu_m = model.mean(0)
    mu_d = data.mean(0)
    W = (data - mu_d).T @ (model - mu_m)
    U, _, Vt = np.linalg.svd(W)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1
    R = U @ S @ Vt
    t = mu_d - R @ mu_m
    return R, t


def ate_rmse(
    est_path_or_rows, gt_path_or_rows, max_dt: float = 0.02
) -> float:
    """Absolute trajectory error RMSE after timestamp association + alignment."""
    if isinstance(est_path_or_rows, str):
        ts_e, p_e, _ = load_trajectory_tum(est_path_or_rows)
    else:
        ts_e, p_e = est_path_or_rows
    if isinstance(gt_path_or_rows, str):
        ts_g, p_g, _ = load_trajectory_tum(gt_path_or_rows)
    else:
        ts_g, p_g = gt_path_or_rows
    pairs = associate_timestamps(ts_e, ts_g, max_dt)
    if len(pairs) < 2:
        return float("nan")
    ie = np.array([p[0] for p in pairs])
    ig = np.array([p[1] for p in pairs])
    R, t = align_horn(p_e[ie], p_g[ig])
    err = (p_e[ie] @ R.T + t) - p_g[ig]
    return float(np.sqrt((err**2).sum(1).mean()))
