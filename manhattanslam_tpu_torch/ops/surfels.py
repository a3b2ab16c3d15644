"""Superpixels and surfel fusion over one keyframe (counterpart of
manhattanslam_tpu/ops/surfels.py).

- SLIC-like superpixels on an 8-px seed grid: 3 iterations of
  pixel-to-seed assignment over the 3x3 seed neighbourhood (intensity,
  space and inverse-depth cost) and mean seed updates; pixels claimed by
  planes are left out.
- A robust plane per superpixel: the eig fit and a fronto-parallel plane
  at the Huber-mean depth, each refined by trimmed refits; the one with
  the larger tight consensus wins, oriented toward the camera.
- Fusion: project the active surfels, look up the superpixel under each,
  gate by depth tolerance and normal agreement, fuse weighted by
  min(1/z^2, 1); unfused valid superpixels become surfels in the lowest
  free slots.

Every per-superpixel sum runs in a fixed order.  ``assign`` looks only at
the 3x3 seed cells around a pixel's own cell, so the members of a
superpixel lie in the 24x24-pixel window around its seed cell; each sum
is a reduction over that gathered window ((S, 576) per channel), where
the reference scatter-adds over the image.  A float ``index_add_`` on the
card is atomic and its order changes from run to run, and a seed that
moves by one ulp can flip a label through the next argmin.

The surfel state is a dict of capacity tensors written in place: pos and
normal (cap, 3), color, radius and weight (cap,) float32, n_updates,
last_kf and attach_kf (cap,) int32, valid and active (cap,) bool.
"""

from __future__ import annotations

import functools

import torch

from manhattanslam_tpu_torch.ops import eig33

SP_SIZE = 8
SP_ITERS = 3
MIN_SP_PIXELS = 16
HUBER = 0.4  # m (getHuberNorm's HUBER_RANGE)
WIN = 3 * SP_SIZE  # a superpixel's members lie in this square around its seed cell
STATE_FLOAT = (("pos", 3), ("normal", 3), ("color", 0), ("radius", 0), ("weight", 0))
STATE_INT = ("n_updates", "last_kf", "attach_kf")
STATE_BOOL = ("valid", "active")
STATE_KEYS = tuple(k for k, _ in STATE_FLOAT) + STATE_INT + STATE_BOOL


def empty_state(cap: int, device) -> dict:
    """An empty surfel map of `cap` slots."""
    out = {k: torch.zeros((cap, n) if n else (cap,), device=device) for k, n in STATE_FLOAT}
    out.update({k: torch.zeros(cap, dtype=torch.int32, device=device) for k in STATE_INT})
    out.update({k: torch.zeros(cap, dtype=torch.bool, device=device) for k in STATE_BOOL})
    return out


@functools.lru_cache(maxsize=8)
def _window_index(H: int, W: int, device: torch.device) -> torch.Tensor:
    """(S, WIN*WIN) flat pixel index of each superpixel's window, rows and
    columns (seed cell - 1 .. seed cell + 1) * SP_SIZE; pixels outside the
    image point at H*W, a padding element appended to every flat image."""
    Hs, Ws = -(-H // SP_SIZE), -(-W // SP_SIZE)
    off = torch.arange(WIN, device=device) - SP_SIZE
    rows = (torch.arange(Hs, device=device) * SP_SIZE)[:, None] + off  # (Hs, WIN)
    cols = (torch.arange(Ws, device=device) * SP_SIZE)[:, None] + off  # (Ws, WIN)
    r = rows[:, None, :, None]
    c = cols[None, :, None, :]
    inside = (r >= 0) & (r < H) & (c >= 0) & (c < W)
    flat = torch.where(inside, r * W + c, torch.full_like(r * c, H * W))
    return flat.reshape(Hs * Ws, WIN * WIN)


class _Segments:
    """Fixed-order per-superpixel sums for one label image: the members of
    superpixel s are the pixels of its window whose label is s."""

    def __init__(self, labels: torch.Tensor, S: int):
        H, W = labels.shape
        self.idx = _window_index(H, W, labels.device)
        lab = torch.cat([labels.reshape(-1), labels.new_full((1,), -1)])
        s_ids = torch.arange(S, dtype=labels.dtype, device=labels.device)
        self.member = lab[self.idx] == s_ids[:, None]  # (S, WIN*WIN)

    def sum(self, v: torch.Tensor) -> torch.Tensor:
        """v (..., H, W) -> (..., S): the sum of v over each superpixel's
        members."""
        flat = v.reshape(v.shape[:-2] + (-1,))
        flat = torch.cat([flat, flat.new_zeros(flat.shape[:-1] + (1,))], -1)
        g = flat[..., self.idx]
        return torch.where(self.member, g, torch.zeros_like(g)).sum(-1)


def _moments(seg: _Segments, pts: torch.Tensor, wgt: torch.Tensor):
    """Weighted count, mean and covariance of each superpixel's points:
    (n (S,), mean (S, 3), the second moments (S, 3, 3) unnormalized)."""
    ch = [wgt] + [pts[..., i] * wgt for i in range(3)]
    ch += [(pts[..., i] * pts[..., j]) * wgt for i in range(3) for j in range(3)]
    sums = seg.sum(torch.stack(ch))  # (13, S)
    return sums[0], sums[1:4].T, sums[4:].T.reshape(-1, 3, 3)


def _cov(n, s1, s2, floor: float):
    mean = s1 / torch.clamp(n, min=floor)[:, None]
    cov = s2 / torch.clamp(n, min=floor)[:, None, None] - mean[:, None, :] * mean[:, :, None]
    return mean, cov


def superpixels(gray: torch.Tensor, depth: torch.Tensor, plane_mask: torch.Tensor,
                K: torch.Tensor) -> dict:
    """Segment the frame into ~8x8 superpixels and fit a plane to each.

    gray (H, W) float32, depth (H, W) float32 metres (0 = none),
    plane_mask (H, W) bool (pixels claimed by planes, left out), K (3, 3).
    Returns per-superpixel tensors (S,) with S = ceil(H/8) * ceil(W/8):
    mean (S, 3) camera frame, normal (S, 3), intensity, z, n_pix, radius,
    valid; and labels (H, W) int32 (-1 = none)."""
    H, W = gray.shape
    dev = gray.device
    Hs, Ws = -(-H // SP_SIZE), -(-W // SP_SIZE)
    S = Hs * Ws

    ys = torch.arange(H, dtype=torch.float32, device=dev)[:, None].expand(H, W)
    xs = torch.arange(W, dtype=torch.float32, device=dev)[None, :].expand(H, W)
    inv_d = torch.where(depth > 0, 1.0 / torch.clamp(depth, min=1e-6), torch.zeros_like(depth))
    usable = (depth > 0) & ~plane_mask

    sx = torch.clamp(torch.arange(Ws, dtype=torch.float32, device=dev) * SP_SIZE + SP_SIZE / 2,
                     0, W - 1)
    sy = torch.clamp(torch.arange(Hs, dtype=torch.float32, device=dev) * SP_SIZE + SP_SIZE / 2,
                     0, H - 1)
    seed_x = sx[None, :].expand(Hs, Ws).reshape(-1)
    seed_y = sy[:, None].expand(Hs, Ws).reshape(-1)
    xi = seed_x.to(torch.int64)
    yi = seed_y.to(torch.int64)
    seed_i = gray[yi, xi]
    seed_z = inv_d[yi, xi]

    cell_y = (ys / SP_SIZE).to(torch.int64)
    cell_x = (xs / SP_SIZE).to(torch.int64)
    neighbours = []
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            ny = torch.clamp(cell_y + dy, 0, Hs - 1)
            nx = torch.clamp(cell_x + dx, 0, Ws - 1)
            neighbours.append(ny * Ws + nx)

    def assign(seed_x, seed_y, seed_i, seed_z):
        best_cost = torch.full((H, W), 1e18, device=dev)
        best_lab = torch.full((H, W), -1, dtype=torch.int64, device=dev)
        for lab in neighbours:
            sz = seed_z[lab]
            c = (
                ((gray - seed_i[lab]) / 20.0) ** 2
                + ((xs - seed_x[lab]) ** 2 + (ys - seed_y[lab]) ** 2) / (SP_SIZE * SP_SIZE)
                + torch.where((inv_d > 0) & (sz > 0), ((inv_d - sz) * 8.0) ** 2,
                              torch.zeros_like(inv_d))
            )
            better = c < best_cost
            best_cost = torch.where(better, c, best_cost)
            best_lab = torch.where(better, lab, best_lab)
        return torch.where(usable, best_lab, torch.full_like(best_lab, -1))

    def update(labels):
        seg = _Segments(labels, S)
        w = (labels >= 0).to(torch.float32)
        sums = seg.sum(torch.stack([w, xs * w, ys * w, gray * w, inv_d * w]))
        num = sums[0]
        means = sums[1:] / torch.clamp(num, min=1.0)
        return means[0], means[1], means[2], means[3], num

    labels = assign(seed_x, seed_y, seed_i, seed_z)
    for _ in range(SP_ITERS - 1):
        seed_x, seed_y, seed_i, seed_z, _ = update(labels)
        labels = assign(seed_x, seed_y, seed_i, seed_z)
    seed_x, seed_y, seed_i, seed_z, n_pix = update(labels)

    # 3D statistics per superpixel
    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    pts = torch.stack([(xs - cx) / fx * depth, (ys - cy) / fy * depth, depth], -1)
    w = (labels >= 0).to(torch.float32)
    lab2 = torch.clamp(labels, min=0)
    seg = _Segments(labels, S)
    _, s1, s2 = _moments(seg, pts, w)
    mean = s1 / torch.clamp(n_pix, min=1.0)[:, None]
    cov = s2 / torch.clamp(n_pix, min=1.0)[:, None, None] - mean[:, None, :] * mean[:, :, None]
    ev_small, normal = eig33.eig33_smallest(cov)
    mse0 = torch.clamp(ev_small, min=0.0)

    def residual(mean_f, normal_f):
        return torch.sum(normal_f[lab2] * (pts - mean_f[lab2]), -1)

    def fit_from(mean_i, normal_i, irls: bool = True):
        """Huber IRLS (3 rounds, eig init only), then a coarse (0.15 m)
        and a tight (2% of depth) trimmed refit (getHuberNorm)."""
        mean_f, normal_f = mean_i, normal_i
        for _ in range(3 if irls else 0):
            r = residual(mean_f, normal_f)
            wh = w * torch.clamp(HUBER / torch.clamp(r.abs(), min=1e-9), max=1.0)
            nh, s1h, s2h = _moments(seg, pts, wh)
            mean_h, cov_h = _cov(nh, s1h, s2h, 1e-6)
            ok_h = nh >= 4.0
            _, normal_h = eig33.eig33_smallest(cov_h)
            mean_f = torch.where(ok_h[:, None], mean_h, mean_f)
            normal_f = torch.where(ok_h[:, None], normal_h, normal_f)
        mse_f = mse0
        n_cons_f = torch.zeros(S, device=dev)
        for tight in (False, True):
            r = residual(mean_f, normal_f)
            if tight:
                tau = torch.clamp(0.02 * mean_f[lab2][..., 2].abs(), min=0.02)
            else:
                tau = 0.15
            cw = ((r.abs() < tau) & (w > 0)).to(torch.float32)
            n_c, s1c, s2c = _moments(seg, pts, cw)
            mean_c, cov_c = _cov(n_c, s1c, s2c, 1e-6)
            ok_c = n_c >= 4.0
            ev_c, normal_c = eig33.eig33_smallest(cov_c)
            mean_f = torch.where(ok_c[:, None], mean_c, mean_f)
            normal_f = torch.where(ok_c[:, None], normal_c, normal_f)
            mse_f = torch.where(ok_c, torch.clamp(ev_c, min=0.0), mse_f)
            n_cons_f = torch.where(ok_c, n_c, torch.zeros_like(n_c))
        return mean_f, normal_f, mse_f, n_cons_f

    # candidate (a): the eig fit
    mean_a, normal_a, mse_a, cons_a = fit_from(mean, normal)
    # candidate (b): fronto-parallel at the robust (Huber-mean) depth, no
    # IRLS (the linear-tailed weight would drag it back into a plane along
    # the viewing ray before the trims run)
    z_rob = mean[:, 2]
    for _ in range(3):
        wz = w * torch.clamp(HUBER / torch.clamp((depth - z_rob[lab2]).abs(), min=1e-9), max=1.0)
        wz = torch.where(depth > 0, wz, torch.zeros_like(wz))
        sz = seg.sum(torch.stack([depth * wz, wz]))
        z_rob = sz[0] / torch.clamp(sz[1], min=1e-6)
    # (x, y) of the eig mean, z the robust depth, the normal along the
    # optical axis (built on the device: no host constant, no sync)
    mean_b0 = torch.cat([mean[:, :2], z_rob[:, None]], 1)
    normal_b0 = torch.cat([torch.zeros_like(mean[:, :2]), torch.ones_like(z_rob)[:, None]], 1)
    mean_b, normal_b, mse_b, cons_b = fit_from(mean_b0, normal_b0, irls=False)

    use_b = cons_b > cons_a
    mean = torch.where(use_b[:, None], mean_b, mean_a)
    normal = torch.where(use_b[:, None], normal_b, normal_a)
    mse = torch.where(use_b, mse_b, mse_a)
    n_cons = torch.where(use_b, cons_b, cons_a)

    flip = torch.sum(normal * mean, -1) > 0  # orient toward the camera
    normal = torch.where(flip[:, None], -normal, normal)

    z_mean = mean[:, 2]
    radius = SP_SIZE * 1.5 * z_mean / fx
    valid = (
        (n_pix >= MIN_SP_PIXELS)
        & (z_mean > 0.1)
        & (mse < (0.01 + 0.01 * z_mean) ** 2)
        # the fitted plane must explain most of the superpixel
        & (n_cons >= 0.6 * n_pix)
    )
    return {
        "labels": labels.to(torch.int32),
        "mean": mean,
        "normal": normal,
        "intensity": seed_i,
        "z": z_mean,
        "n_pix": n_pix,
        "radius": radius,
        "valid": valid,
    }


def _rt(T: torch.Tensor):
    return T[:3, :3].transpose(0, 1), T[:3, 3]


def fuse_surfels(surfels: dict, sp: dict, T_cw: torch.Tensor, T_wc: torch.Tensor,
                 K: torch.Tensor, kf_id: int, image_h: int, image_w: int) -> torch.Tensor:
    """Fuse one keyframe's superpixels into the surfel map (written in
    place).  Returns the fused mask over the superpixels (S,)."""
    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    R_cw_t, t_cw = _rt(T_cw)
    R_wc_t, t_wc = _rt(T_wc)

    # project the surfels
    pc = surfels["pos"] @ R_cw_t + t_cw
    z = pc[:, 2]
    zi = torch.where(z.abs() < 1e-9, torch.full_like(z, 1e-9), z)
    u = pc[:, 0] / zi * fx + cx
    v = pc[:, 1] / zi * fy + cy
    proj_ok = (surfels["valid"] & surfels["active"] & (z > 0.1)
               & (u >= 0) & (u < image_w) & (v >= 0) & (v < image_h))
    # out-of-range floats give any integer: clamped first, gated by proj_ok
    ui = torch.clamp(torch.round(torch.clamp(u, -1.0, float(image_w))).to(torch.int64),
                     0, image_w - 1)
    vi = torch.clamp(torch.round(torch.clamp(v, -1.0, float(image_h))).to(torch.int64),
                     0, image_h - 1)
    lab = sp["labels"][vi, ui].to(torch.int64)  # the superpixel under each surfel
    lab_ok = lab >= 0
    lab_s = torch.clamp(lab, min=0)

    sp_mean = sp["mean"][lab_s]
    sp_norm_c = sp["normal"][lab_s]
    sp_z = sp["z"][lab_s]
    # depth tolerance z^2 / (0.5 fx) * 4 (SurfelFusion.cpp:167-283)
    tol = sp_z * sp_z / (0.5 * fx) * 4.0 + 0.05
    n_cam = surfels["normal"] @ R_cw_t
    gate = (proj_ok & lab_ok & sp["valid"][lab_s] & ((z - sp_z).abs() < tol)
            & (torch.sum(n_cam * sp_norm_c, -1) > 0.1))

    # weighted fusion in the world frame (weight min(1/z^2, 1))
    w_new = torch.clamp(1.0 / torch.clamp(sp_z * sp_z, min=1e-6), max=1.0)
    sp_pos_w = sp_mean @ R_wc_t + t_wc
    sp_norm_w = sp_norm_c @ R_wc_t
    w_old = surfels["weight"]
    wsum = torch.clamp(w_old + w_new, min=1e-9)
    pos_f = (surfels["pos"] * w_old[:, None] + sp_pos_w * w_new[:, None]) / wsum[:, None]
    nrm_f = surfels["normal"] * w_old[:, None] + sp_norm_w * w_new[:, None]
    nrm_f = nrm_f / torch.clamp(torch.linalg.norm(nrm_f, dim=-1, keepdim=True), min=1e-9)
    col_f = (surfels["color"] * w_old + sp["intensity"][lab_s] * w_new) / wsum

    g = gate
    surfels["pos"].copy_(torch.where(g[:, None], pos_f, surfels["pos"]))
    surfels["normal"].copy_(torch.where(g[:, None], nrm_f, surfels["normal"]))
    surfels["color"].copy_(torch.where(g, col_f, surfels["color"]))
    surfels["radius"].copy_(torch.where(
        g, torch.minimum(surfels["radius"], sp["radius"][lab_s]), surfels["radius"]))
    surfels["weight"].copy_(torch.where(g, wsum, surfels["weight"]))
    surfels["n_updates"] += g.to(torch.int32)
    surfels["last_kf"].copy_(torch.where(g, torch.full_like(surfels["last_kf"], int(kf_id)),
                                         surfels["last_kf"]))

    # which superpixels were fused into some surfel (a bool scatter-max;
    # the ungated surfels write into a dropped padding slot)
    S = sp["mean"].shape[0]
    fused = torch.zeros(S + 1, dtype=torch.bool, device=g.device)
    fused.scatter_(0, torch.where(g, lab_s, torch.full_like(lab_s, S)), True)
    return fused[:S]


def add_new_surfels(surfels: dict, sp: dict, fused: torch.Tensor, T_wc: torch.Tensor,
                    kf_id: int) -> None:
    """Surfels for the valid, unfused superpixels, in the lowest free
    slots in superpixel order (cumsum compaction), written in place; those
    beyond the free slots are dropped."""
    new_mask = sp["valid"] & ~fused
    free = ~surfels["valid"]
    cap = free.shape[0]
    S = new_mask.shape[0]
    free_rank = torch.cumsum(free.to(torch.int64), 0) - 1
    new_rank = torch.cumsum(new_mask.to(torch.int64), 0) - 1
    n_free = free.sum()
    ar = torch.arange(cap, device=free.device)
    # slot of the k-th free rank; the occupied slots write into a padding
    # element that is dropped
    slot_of_rank = torch.full((cap + 1,), cap, dtype=torch.int64, device=free.device)
    slot_of_rank.scatter_reduce_(0, torch.where(free, free_rank, torch.full_like(ar, cap)), ar,
                                 "amin")
    take = new_mask & (new_rank < n_free)
    tgt = slot_of_rank[torch.clamp(new_rank, 0, cap - 1)]
    tgt = torch.where(take, tgt, torch.full_like(tgt, cap))
    # the superpixel written into each slot (-1 none); the dropped writes
    # land in the padding element
    sp_of_slot = torch.full((cap + 1,), -1, dtype=torch.int64, device=free.device)
    sp_of_slot.scatter_(0, tgt, torch.arange(S, device=free.device))
    sp_of_slot = sp_of_slot[:cap]
    hit = sp_of_slot >= 0
    src = torch.clamp(sp_of_slot, min=0)

    R_wc_t, t_wc = _rt(T_wc)
    new = {
        "pos": sp["mean"] @ R_wc_t + t_wc,
        "normal": sp["normal"] @ R_wc_t,
        "color": sp["intensity"],
        "radius": sp["radius"],
        "weight": torch.clamp(1.0 / torch.clamp(sp["z"] * sp["z"], min=1e-6), max=1.0),
    }
    for k, v in new.items():
        cur = surfels[k]
        m = hit[:, None] if cur.dim() == 2 else hit
        cur.copy_(torch.where(m, v[src].to(cur.dtype), cur))
    for k, val in (("n_updates", 1), ("last_kf", int(kf_id)), ("attach_kf", int(kf_id))):
        surfels[k].copy_(torch.where(hit, torch.full_like(surfels[k], val), surfels[k]))
    for k in STATE_BOOL:
        surfels[k] |= hit
