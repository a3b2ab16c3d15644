"""Map checkpoint and resume (counterpart of manhattanslam_tpu/io/map_io.py).

The map is plain numpy arrays, so a checkpoint is one compressed npz in
the reference's layout: the ``_ARRAYS`` tables under their own names and
the scalars, the Manhattan registries and the pinned keyframes as one
JSON blob, ``_scalars``.  Either package loads the other's file.

Two keys go beyond the reference's: ``kf_free`` (the retired keyframe
slots, in their reuse order) and ``last_kf_added`` (the spanning-tree
parent of the next keyframe).  Without them a resumed map reuses no
retired slot and its next keyframe becomes a second root of the
spanning tree.  The reference's loader reads only the keys it knows; a
file without the two loads here as the reference loads it (no free
slot, no parent).
"""

from __future__ import annotations

import json

import numpy as np

from manhattanslam_tpu_torch.slam_map import SlamMap

_ARRAYS = [
    "mp_pos", "mp_desc", "mp_normal", "mp_min_dist", "mp_max_dist",
    "mp_level", "mp_valid", "mp_n_obs", "mp_visible", "mp_found",
    "mp_first_kf",
    "ml_sp", "ml_ep", "ml_desc", "ml_valid", "ml_n_obs", "ml_visible",
    "ml_found", "ml_first_kf",
    "pl_coeffs", "pl_pts", "pl_n_pts", "pl_valid", "pl_n_obs",
    "pl_first_kf", "pl_color",
    "kf_pose", "kf_time", "kf_frame_id", "kf_valid", "kf_xy", "kf_uright",
    "kf_depth", "kf_level", "kf_angle", "kf_desc", "kf_kp_valid",
    "kf_mp_idx", "kf_ml_idx", "kf_pl_idx", "kf_plane_coeffs",
    "kf_plane_npts", "covis", "kf_parent",
]


def _keys(registry: dict) -> dict:
    return {",".join(map(str, k)): int(v) for k, v in registry.items()}


def save_map(path: str, slam_map: SlamMap) -> None:
    payload = {name: getattr(slam_map, name) for name in _ARRAYS}
    meta = {
        "n_kf": int(slam_map.n_kf),
        "manhattan_pairs": _keys(slam_map.manhattan_pairs),
        "manhattan_triples": _keys(slam_map.manhattan_triples),
        "kf_not_erase": sorted(int(k) for k in slam_map.kf_not_erase),
        "kf_free": [int(k) for k in slam_map.kf_free],
        "last_kf_added": int(slam_map.last_kf_added),
    }
    payload["_scalars"] = np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8)
    np.savez_compressed(path, **payload)


def _registry(keys: dict) -> dict:
    return {tuple(int(x) for x in k.split(",")): int(v) for k, v in keys.items()}


def load_map(path: str, slam_map: SlamMap) -> SlamMap:
    """Load into a freshly constructed SlamMap, in place."""
    data = np.load(path, allow_pickle=False)
    for name in _ARRAYS:
        getattr(slam_map, name)[...] = data[name]
    meta = json.loads(bytes(data["_scalars"]).decode())
    slam_map.n_kf = int(meta["n_kf"])
    slam_map.manhattan_pairs = _registry(meta["manhattan_pairs"])
    slam_map.manhattan_triples = _registry(meta["manhattan_triples"])
    slam_map.kf_not_erase = set(meta["kf_not_erase"])
    slam_map.kf_free = [int(k) for k in meta.get("kf_free", [])]
    slam_map.last_kf_added = int(meta.get("last_kf_added", -1))
    return slam_map
