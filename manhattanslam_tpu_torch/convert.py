"""Carry the reference package's tracker state into the port.

The system has no learned weights; what a tracker carries is state: the
map's point, line, plane and keyframe tables with the Manhattan registries
and the retired keyframe slots, the per-frame device carry, the BRIEF
pattern, and the back end's state (the mapper's points on probation, the
relocalizer's word histograms, the tracker's last relocalization and
trajectory records) and the surfel map (its capacity arrays and pose
graph).  These functions take that state as numpy arrays and
dicts (as the JAX package's ``SlamMap`` attributes, its
``FastTracker.reg2`` / ``reg3``, ``jax.device_get(init_carry(...))`` and
``ops.orb.PATTERN`` hand it over) and return the port's objects, so the
two packages can start from the same state; ``map_to_numpy`` and
``backend_state_to_numpy`` read that state from either package's
objects.  Descriptor words (uint32) become int32 tensors with the same
bits.  Nothing here imports JAX.
"""

from __future__ import annotations

import numpy as np
import torch

from manhattanslam_tpu_torch.config import SlamConfig
from manhattanslam_tpu_torch.frontend.tracking import FrameRecord
from manhattanslam_tpu_torch.slam_map import SlamMap

# SlamMap attributes carried over (the port's point, line, plane and
# keyframe tables)
MAP_TABLES = (
    "mp_pos", "mp_desc", "mp_normal", "mp_min_dist", "mp_max_dist", "mp_level",
    "mp_valid", "mp_n_obs", "mp_visible", "mp_found", "mp_first_kf",
    "ml_sp", "ml_ep", "ml_desc", "ml_valid", "ml_n_obs", "ml_visible", "ml_found",
    "ml_first_kf",
    "pl_coeffs", "pl_pts", "pl_n_pts", "pl_valid", "pl_n_obs", "pl_first_kf", "pl_color",
    "kf_pose", "kf_time", "kf_frame_id", "kf_valid", "kf_xy", "kf_uright",
    "kf_depth", "kf_level", "kf_angle", "kf_desc", "kf_kp_valid", "kf_mp_idx",
    "kf_ml_idx", "kf_pl_idx", "kf_plane_coeffs", "kf_plane_npts", "covis", "kf_parent",
)
MAP_SCALARS = ("n_kf", "last_kf_added")
# the Manhattan registries as the map keeps them (sorted id tuple -> kf)
MAP_REGISTRIES = ("manhattan_pairs", "manhattan_triples")
# retired keyframe slots awaiting reuse, and keyframes the registries pin
MAP_LIFECYCLE = ("kf_free", "kf_not_erase")


def map_to_numpy(slam_map) -> dict:
    """Copies of a SlamMap's tables, scalars, registries and retired slots
    (either package's map) in the form slam_map_from_numpy takes."""
    out = {k: np.array(getattr(slam_map, k)) for k in MAP_TABLES}
    out.update({k: int(getattr(slam_map, k)) for k in MAP_SCALARS})
    out.update({k: dict(getattr(slam_map, k)) for k in MAP_REGISTRIES})
    out["kf_free"] = [int(i) for i in slam_map.kf_free]
    out["kf_not_erase"] = sorted(int(i) for i in slam_map.kf_not_erase)
    return out


def tensor_from_numpy(a, device) -> torch.Tensor:
    """One array -> tensor on `device`; uint32 words keep their bits as int32."""
    a = np.asarray(a)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(np.array(a)).to(device)  # a copy: never aliases `a`


def slam_map_from_numpy(cfg: SlamConfig, tables: dict) -> SlamMap:
    """A port SlamMap holding copies of the given tables (attribute name ->
    array, plus the scalars n_kf / last_kf_added and, when given, the
    registries, the retired slots kf_free in their reuse order and the
    pinned keyframes kf_not_erase)."""
    m = SlamMap(cfg)
    for k in MAP_TABLES:
        src = np.asarray(tables[k])
        dst = getattr(m, k)
        if src.shape != dst.shape:
            raise ValueError(f"{k}: shape {src.shape}, the config needs {dst.shape}")
        dst[...] = src
    for k in MAP_SCALARS:
        setattr(m, k, int(tables[k]))
    m.kf_free = [int(i) for i in tables.get("kf_free", [])]
    for k in MAP_REGISTRIES:
        setattr(m, k, {tuple(int(i) for i in key): int(kf) for key, kf in tables.get(k, {}).items()})
    m.kf_not_erase = {int(kf) for kf in tables.get("kf_not_erase", ())}
    return m


def registries_from_numpy(cfg: SlamConfig, reg2, reg3) -> tuple[np.ndarray, np.ndarray]:
    """The tracker's dense Manhattan registries (reg2 (M, M), reg3
    (M, M, M) int32 keyframe ids, -1 none) as copies the port's tracker
    and view take."""
    M = cfg.caps.max_map_planes
    out = []
    for a, shape in ((reg2, (M, M)), (reg3, (M, M, M))):
        a = np.array(a, np.int32)
        if a.shape != shape:
            raise ValueError(f"registry shape {a.shape}, the config needs {shape}")
        out.append(a)
    return out[0], out[1]


def carry_from_numpy(carry: dict, device) -> dict:
    """The device carry (init_carry's keys) as tensors on `device`."""
    return {k: tensor_from_numpy(v, device) for k, v in carry.items()}


def batched_carry_from_numpy(carry: dict, device) -> dict:
    """The batched replay's carry (the reference's
    ``jax.device_get(init_batched_carry(cfg, B))``: init_carry's keys, each
    with a leading axis of B streams) as tensors on `device`."""
    out = carry_from_numpy(carry, device)
    sizes = {tuple(v.shape[:1]) for v in out.values()}
    if len(sizes) != 1 or sizes == {()}:
        raise ValueError(f"a batched carry needs one leading stream axis on every key, got {sizes}")
    return out


def pattern_from_numpy(pattern, device) -> torch.Tensor:
    """The (256, 2, 2) int32 BRIEF pattern as a tensor on `device`."""
    p = np.asarray(pattern)
    if p.shape != (256, 2, 2):
        raise ValueError(f"BRIEF pattern must be (256, 2, 2), got {p.shape}")
    return torch.from_numpy(p.astype(np.int32)).to(device)


def backend_state_to_numpy(local_mapper, reloc, tracker) -> dict:
    """The back end's state of either package: the mapper's points on
    probation, the relocalizer's word histograms, the tracker's frame of
    the last relocalization and its trajectory records as tuples."""
    return {
        "recent_points": [(int(p), int(b)) for p, b in local_mapper.recent_points],
        "kf_bow": np.array(reloc.kf_bow),
        "last_reloc_frame_id": int(tracker.last_reloc_frame_id),
        "records": [(float(r.timestamp), int(r.ref_kf), np.array(r.T_cr, np.float32), bool(r.lost))
                    for r in tracker.records],
    }


def load_backend_state(state: dict, local_mapper=None, reloc=None, tracker=None) -> None:
    """Put backend_state_to_numpy's state into the port's LocalMapper,
    Relocalizer and FastTracker (each optional)."""
    if local_mapper is not None:
        local_mapper.recent_points = [(int(p), int(b)) for p, b in state["recent_points"]]
    if reloc is not None:
        bow = np.asarray(state["kf_bow"], np.float32)
        if bow.shape != reloc.kf_bow.shape:
            raise ValueError(f"kf_bow: shape {bow.shape}, the config needs {reloc.kf_bow.shape}")
        reloc.kf_bow[...] = bow
    if tracker is not None:
        tracker.last_reloc_frame_id = int(state["last_reloc_frame_id"])
        tracker.records = [FrameRecord(float(t), int(kf), np.array(T, np.float32), bool(lost))
                           for t, kf, T, lost in state["records"]]


# the surfel map's capacity arrays (ops/surfels.py's state)
SURFEL_KEYS = ("pos", "normal", "color", "radius", "weight", "n_updates", "last_kf",
               "attach_kf", "valid", "active")


def _host_copy(a) -> np.ndarray:
    return a.cpu().numpy().copy() if isinstance(a, torch.Tensor) else np.array(a)


def surfel_state_to_numpy(mapper) -> dict:
    """Either package's SurfelMapper state: copies of the ten capacity
    arrays, the pose-graph links, the keyframe count and the last keyframe
    inserted."""
    return {
        "surfels": {k: _host_copy(mapper.surfels[k]) for k in SURFEL_KEYS},
        "pose_links": {int(k): {int(q) for q in v} for k, v in mapper.pose_links.items()},
        "n_keyframes": int(mapper.n_keyframes),
        "_last_inserted": None if mapper._last_inserted is None else int(mapper._last_inserted),
    }


def load_surfel_state(state: dict, mapper) -> None:
    """Put surfel_state_to_numpy's state into the port's SurfelMapper, its
    tensors written in place."""
    for k in SURFEL_KEYS:
        src = np.asarray(state["surfels"][k])
        dst = mapper.surfels[k]
        if tuple(src.shape) != tuple(dst.shape):
            raise ValueError(f"surfels {k}: shape {src.shape}, the config needs {tuple(dst.shape)}")
        dst.copy_(torch.from_numpy(np.array(src)))
    mapper.pose_links = {int(k): {int(q) for q in v} for k, v in state["pose_links"].items()}
    mapper.n_keyframes = int(state["n_keyframes"])
    last = state["_last_inserted"]
    mapper._last_inserted = None if last is None else int(last)
