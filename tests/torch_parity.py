"""Shared helpers for the PyTorch-port parity tests (tests/test_torch_*.py).

The parity tests feed the same numpy inputs, made from a seed, to the JAX
reference package and to its PyTorch port, on the CPU.

Under pytest-xdist (one worker process per core, each collecting every
test module, so each imports this one) torch runs one intra-op thread per
worker: its default of one thread per core in every worker oversubscribes
the cores, and the JAX tests in the other workers slow down with it.
"""

import dataclasses
import os

import torch

import manhattanslam_tpu_torch.config as port_config

if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)


def port_cfg(jax_cfg):
    """The port's SlamConfig with the same values as a reference SlamConfig."""
    d = dataclasses.asdict(jax_cfg)
    subs = {
        "camera": port_config.CameraConfig,
        "orb": port_config.OrbConfig,
        "plane": port_config.PlaneConfig,
        "line": port_config.LineConfig,
        "surfel": port_config.SurfelConfig,
        "caps": port_config.CapacityConfig,
    }
    return port_config.SlamConfig(
        **{k: (subs[k](**v) if k in subs else v) for k, v in d.items()}
    )


def rot_angle(R):
    """Rotation angle (rad) of a 3x3 rotation matrix, accurate near zero."""
    import numpy as np

    R = np.asarray(R, np.float64)
    w = np.array([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]])
    return float(np.arctan2(np.linalg.norm(w) / 2, (np.trace(R) - 1) / 2))
