"""A fixed-shape step replayed from a CUDA graph (the port's form of the
reference's single ``jax.jit`` / ``lax.scan`` dispatch).

``GraphedStep(step)`` wraps ``step(*frames, carry, view) -> (result,
new_carry)``, a function of static shapes with no host synchronization
inside (the fused frame step of ``device_tracker.build_frame_step``, the
batched replay step of ``parallel/mesh.py``).  Its inputs are static:
the frames (copied into the graph's own input tensors, from pinned host
memory without blocking), the carry (the graph's own carry tensors: the
graph's last node copies the new carry into them) and the view (the
caller's view tensors, which must then be updated in place, never
replaced).

On CUDA the first call runs the step eagerly on the current stream: it
tracks its frame and makes every lazily built constant (the level tables,
the plane and line tables, the BRIEF pattern, the CUDA kernels' shared
libraries, the cuBLAS handles) before the capture.  The second call
captures the step once and replays it; every later call replays it.  A
capture that fails raises: there is no quiet return to eager launches.
On the CPU the same step runs eagerly on every call, with the same
static carry and the same in-place copy of the new carry, so the CPU tests
exercise the in-place discipline and only capture and replay are left to
the card.

The kernel wrappers count their launches from Python, so a capture would
count its launches once and the replays never.  The wrapper takes the
capture's counts back off and adds them again on every replay: a count
stays the number of times the card ran the kernel.

The result of a replay lives in the graph's own memory and is
overwritten by the next replay: whatever is read after the next call must
be copied out first (``FastTracker`` keeps a ring of output slots).
"""

from __future__ import annotations

import torch

from manhattanslam_tpu_torch.ops import fast as fast_ops
from manhattanslam_tpu_torch.ops import orb as orb_ops

# the wrappers of the hand kernels, whose counts a replay advances
COUNTED = (fast_ops.fast_score_levels, orb_ops.ic_angle_levels, orb_ops.brief_levels)


def copy_tree_(dst: dict, src: dict) -> None:
    """Copy every tensor of src into the tensor of dst under the same key
    (nested dicts too), in place and on the current stream; dst may hold
    more keys."""
    d, s = [], []

    def walk(a, b):
        for k, v in b.items():
            if isinstance(v, dict):
                walk(a[k], v)
            else:
                d.append(a[k])
                s.append(v)

    walk(dst, src)
    torch._foreach_copy_(d, s, non_blocking=True)


def clone_tree(tree: dict) -> dict:
    return {k: clone_tree(v) if isinstance(v, dict) else v.clone() for k, v in tree.items()}


def _ptrs(tree: dict) -> list[int]:
    return [v.data_ptr() for v in tree.values()]


class GraphedStep:
    """step(*frames, carry, view) -> (result, carry), replayed from one
    CUDA graph on the card (see the module docstring).  ``carry`` is
    copied into the static carry unless it is the static carry itself (the
    dict this call returned last); the returned carry IS the static
    carry."""

    # graph replays of every GraphedStep in the process
    replays = 0

    def __init__(self, step, device):
        self.step = step
        self.device = torch.device(device)
        self.graph = None
        self.carry = None  # the static carry
        self._frames = None  # the static frame inputs (CUDA)
        self._view_ptrs = None
        self._out = None  # the captured result (CUDA)
        self._captured = None  # launches of each counted wrapper in one step
        self.calls = 0

    def _check_view(self, view: dict) -> None:
        ptrs = _ptrs(view)
        if self._view_ptrs is None:
            self._view_ptrs = ptrs
        elif ptrs != self._view_ptrs:
            raise ValueError(
                "GraphedStep: the view's tensors were replaced; a view that a graph reads "
                "must be updated in place")

    def _take_carry(self, carry: dict) -> dict:
        if self.carry is None:
            self.carry = clone_tree(carry)
        elif carry is not self.carry:
            copy_tree_(self.carry, carry)
        return self.carry

    def __call__(self, *args):
        *frames, carry, view = args
        self.calls += 1
        self._check_view(view)
        carry = self._take_carry(carry)
        if self.device.type != "cuda":
            result, new_carry = self.step(*frames, carry, view)
            copy_tree_(carry, new_carry)
            return result, carry
        if self._frames is None:
            self._frames = [f.to(self.device, copy=True) for f in frames]
        else:
            for dst, src in zip(self._frames, frames):
                if src is not dst:
                    dst.copy_(src, non_blocking=True)
        if self.graph is None and self.calls == 1:
            # the eager first call: builds every lazy constant before capture
            result, new_carry = self.step(*self._frames, carry, view)
            copy_tree_(carry, new_carry)
            return result, carry
        if self.graph is None:
            self.capture(view)
        self.graph.replay()
        GraphedStep.replays += 1
        for fn, n in zip(COUNTED, self._captured):
            fn.launches += n
        return self._out, carry

    def capture(self, view: dict) -> None:
        """Capture the step on the static inputs (raises on failure)."""
        if self.device.type != "cuda" or self.graph is not None:
            return
        if self._frames is None or self.carry is None:
            raise RuntimeError("GraphedStep.capture: call the step once before capturing it")
        before = [fn.launches for fn in COUNTED]
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            result, new_carry = self.step(*self._frames, self.carry, view)
            # the last node: the new carry into the static carry
            copy_tree_(self.carry, new_carry)
        self._captured = [fn.launches - b for fn, b in zip(COUNTED, before)]
        for fn, b in zip(COUNTED, before):
            fn.launches = b  # a capture launches nothing
        self.graph, self._out = graph, result
