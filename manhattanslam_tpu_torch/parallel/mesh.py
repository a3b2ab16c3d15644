"""Batched multi-sequence replay on one card (counterpart of
manhattanslam_tpu/parallel/mesh.py ``build_throughput_step`` and
``init_batched_carry``, BASELINE config 5).

B independent sequence streams are tracked by one step against ONE shared
map view (localization / replay mode).  The step is the reference's full
fused frame body, points, planes with the Manhattan pose, and lines, with
a leading stream axis (``device_tracker.build_batched_body``), the
counterpart of the reference's ``jax.vmap(body, in_axes=(0, 0, None))``:
each op and each CUDA kernel launch serves all B streams, so a step
launches as many kernels at B = 8 as at B = 1.  On the card the step is
replayed from a CUDA graph (``frontend/graphed_step.py``): the first call
runs eagerly, the second captures; the view passed must be the same
tensors on every call (updated in place).  The step keeps the functional
form of the reference's: the carry passed in is not changed, and the
result and new carry returned are the caller's own copies.

The reference's multi-device entries shard over a mesh of devices:
``make_mesh`` (a ``Mesh`` of torch devices, the first n CUDA devices by
default; one H100 is a mesh of one), ``build_batched_track_step`` (B
sequences split into one shard per mesh entry, each shard through the
batched extractor and the projection solve on its device, the outputs
gathered on the first) and ``sharded_hamming_argmin`` (a descriptor bank
split over the mesh, the per-shard winners combined by an encoded min).
A mesh may name one device several times: each entry still gets its own
shard, so a split is exercised on one card or on the CPU.
"""

from __future__ import annotations

import numpy as np
import torch

from manhattanslam_tpu_torch import resolve_device
from manhattanslam_tpu_torch.config import SlamConfig
from manhattanslam_tpu_torch.frontend import device_tracker as dt
from manhattanslam_tpu_torch.frontend import tracking_ops
from manhattanslam_tpu_torch.frontend.frame import build_extractor
from manhattanslam_tpu_torch.frontend.graphed_step import GraphedStep, clone_tree
from manhattanslam_tpu_torch.ops import lm, matching

# a winner's (distance, global index) as one int64 key: dist * 2**20 + index
_KEY_SHIFT = 1 << 20


class Mesh:
    """Devices along named axes (the port's stand-in for a
    ``jax.sharding.Mesh``): ``devices`` is a numpy array of torch devices."""

    def __init__(self, devices, axis_names: tuple[str, ...]):
        self.devices = np.empty(len(devices), dtype=object)
        self.devices[:] = [torch.device(d) for d in devices]
        self.axis_names = tuple(axis_names)


def make_mesh(n_devices: int | None = None, axis: str = "seq", devices=None) -> Mesh:
    """A one-axis mesh of `devices` (default: every CUDA device; raises
    without one), cut to the first n_devices."""
    if devices is None:
        resolve_device(None)
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devs = list(devices)
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(devs, (axis,))


def _shards(n: int, mesh: Mesh, what: str) -> list[tuple[torch.device, slice]]:
    n_dev = mesh.devices.size
    if n % n_dev:
        raise ValueError(f"{what}: {n} rows do not split over a mesh of {n_dev}")
    k = n // n_dev
    return [(dev, slice(i * k, (i + 1) * k)) for i, dev in enumerate(mesh.devices)]


def build_batched_track_step(cfg: SlamConfig, mesh: Mesh):
    """Returns step(gray (B,H,W) float32 [0,255], depth (B,H,W) metres,
    T_seed (B,4,4), pts {pos (B,N,3), desc (B,N,8) int32 words, valid
    (B,N), level (B,N)}) -> {"T" (B,4,4), "n_matches" (B,), "n_inliers"
    (B,)} on the mesh's first device.

    B must be a multiple of the mesh size; each entry's shard of
    sequences goes through the batched extractor (one launch of each
    kernel for its streams) and the projection match and pose solve
    against its own landmarks, from its seed pose (the reference's
    vmapped ``one_seq``, mesh.py:62-75)."""
    K_np = np.asarray(cfg.camera.K, np.float32)
    hw = (cfg.camera.height, cfg.camera.width)
    params = lm.default_params(cfg)
    extractors = {}

    def run_shard(dev, gray, depth, T_seed, pts):
        if dev not in extractors:
            extractors[dev] = build_extractor(cfg, dev)
        b = gray.shape[0]
        feats = extractors[dev](gray, depth)
        out = tracking_ops.track_projection(
            pts, T_seed, feats, torch.from_numpy(K_np).to(dev), float(cfg.camera.bf), 7.0, hw,
            scale_factor=cfg.orb.scale_factor, n_levels=cfg.orb.n_levels, params=params,
            plane_obs=tracking_ops.empty_plane_obs(cfg.caps.max_planes_frame, (b,), dev),
            line_obs=tracking_ops.empty_line_obs(cfg.caps.max_lines, (b,), dev),
            use_planes=True, use_lines=True,
        )
        return {"T": out["T"], "n_matches": out["n_matches"], "n_inliers": out["n_pt_inliers"]}

    def step(gray, depth, T_seed, pts) -> dict:
        outs = []
        for dev, sl in _shards(gray.shape[0], mesh, "batched track step"):
            def put(x):
                return torch.as_tensor(x[sl]).to(dev)

            outs.append(run_shard(dev, put(gray), put(depth), put(T_seed),
                                  {k: put(v) for k, v in pts.items()}))
        first = mesh.devices[0]
        return {k: torch.cat([o[k].to(first) for o in outs]) for k in outs[0]}

    return step


def sharded_hamming_argmin(desc_q, desc_bank, mesh: Mesh):
    """Nearest bank descriptor of each query, the bank split over the
    mesh: (Q, 8) and (M, 8) int32 words, M a multiple of the mesh size.
    Each shard takes its local min and argmin; a winner's global index is
    encoded as dist * 2**20 + index in int64 and the min over shards is
    taken on the first device.  Returns (best_idx (Q,), best_dist (Q,))
    int32, equal to the argmin over the whole bank (ties: lowest index)."""
    keys = []
    for dev, sl in _shards(desc_bank.shape[0], mesh, "sharded hamming argmin"):
        d = matching.hamming_matrix(torch.as_tensor(desc_q).to(dev),
                                    torch.as_tensor(desc_bank[sl]).to(dev))
        best, idx = torch.min(d, dim=1)
        keys.append(best.to(torch.int64) * _KEY_SHIFT + idx.to(torch.int64) + sl.start)
    first = mesh.devices[0]
    key = torch.stack([k.to(first) for k in keys]).amin(0)
    return (key % _KEY_SHIFT).to(torch.int32), (key // _KEY_SHIFT).to(torch.int32)

# what the step returns per stream: the reference's replay summary
# (mesh.py:116-122), then each frame line's associated map line (-1 none)
RESULT_KEYS = ("T", "tracked_ok", "n_inliers", "n_matches", "manhattan_found", "use_manhattan",
               "line_assoc")


def build_throughput_step(cfg: SlamConfig, batch: int, device=None):
    """Returns step(gray8 (B,H,W) uint8, d16 (B,H,W) int32 in DEPTH_QUANT
    units, carry (batched), view (shared)) -> (result, new_carry): each
    result value has a leading axis of `batch` streams, ``manhattan_found``
    and ``use_manhattan`` as the plane branch computes them and
    ``line_assoc`` as the line branch does."""
    device = resolve_device(device)
    body = dt.build_batched_body(cfg, device, enable_planes=True, enable_lines=True)
    hw = (cfg.camera.height, cfg.camera.width)

    def inner(gray8, d16, carry, view):
        result, new_carry = body(*dt.frame_to_float(gray8, d16), carry, view)
        return {k: result[k] for k in RESULT_KEYS}, new_carry

    graphed = GraphedStep(inner, device)

    def step(gray8, d16, carry, view):
        if gray8.shape != (batch,) + hw or d16.shape != (batch,) + hw:
            raise ValueError(
                f"throughput step: frames must be {(batch,) + hw}, got "
                f"{tuple(gray8.shape)} and {tuple(d16.shape)}"
            )
        if gray8.device.type != device.type or d16.device.type != device.type:
            raise ValueError(f"throughput step: frames must be on {device}")
        result, new_carry = graphed(gray8, d16, carry, view)
        return clone_tree(result), clone_tree(new_carry)

    return step


def init_batched_carry(cfg: SlamConfig, batch: int, device=None) -> dict:
    """The single-stream initial carry repeated for `batch` streams."""
    one = dt.init_carry(cfg, resolve_device(device))
    return {k: v.expand((batch,) + v.shape).contiguous() for k, v in one.items()}
