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
result and new carry returned are the caller's own copies.  The
reference's multi-device entries (``make_mesh``,
``build_batched_track_step``, ``sharded_hamming_argmin``) are not ported
yet.
"""

from __future__ import annotations

from manhattanslam_tpu_torch import resolve_device
from manhattanslam_tpu_torch.config import SlamConfig
from manhattanslam_tpu_torch.frontend import device_tracker as dt
from manhattanslam_tpu_torch.frontend.graphed_step import GraphedStep, clone_tree

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
