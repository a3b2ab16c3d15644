"""The pose solve's wrapper on the CPU (the kernel itself, csrc/lm_solve.cu,
runs only on the card: tests/test_torch_cuda.py holds it against the plain
version there).

- ``kernel_inputs``: a PoseProblem of each caller's families (points only
  with empty or None line fields, points and planes, every family) hands
  the kernel its fields as they are, in PoseProblem's order, with None for
  a family the solve leaves out, and the row counts; the fields rebuild
  the problem.
- ``solve_pose`` on CPU tensors takes the plain path (no launch counted)
  and is bit for bit the frozen plain copy of the solve that the
  benchmark's reference holds (portbench/reference/lm.py), for each
  caller's flags.
- The wrapper raises on a dtype, shape, layout or device it does not take.
"""

import math

import numpy as np
import pytest
import torch

from manhattanslam_tpu_torch.geometry import se3
from manhattanslam_tpu_torch.ops import lm
from portbench.reference import lm as frozen_lm

B, N, NL, NP, NPAR, NVER = 3, 40, 10, 2, 3, 1
K = torch.tensor([[300.0, 0.0, 160.0], [0.0, 300.0, 120.0], [0.0, 0.0, 1.0]])
BF = 30.0


def _problem(seed: int, lines: str = "rows") -> tuple[lm.PoseProblem, torch.Tensor]:
    """B problems of N point rows (a tenth outliers, a third stereo), NL
    line endpoints and NP / NPAR / NVER plane observations, seen from a
    pose near T0; lines "rows", "empty" (zero rows) or "none" (None
    fields).  Returns (problem, T0)."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    T_gt = se3.exp_se3(torch.from_numpy(rng.normal(0, 0.05, (B, 6)).astype(f32)))
    xw = rng.uniform([-2, -1.5, 2.0], [2, 1.5, 6.0], (B, N, 3)).astype(f32)
    pc = np.einsum("bij,bnj->bni", T_gt[:, :3, :3].numpy(), xw) + T_gt[:, None, :3, 3].numpy()
    u, v = pc[..., 0] / pc[..., 2] * 300 + 160, pc[..., 1] / pc[..., 2] * 300 + 120
    stereo = rng.random((B, N)) < 0.33
    obs = np.stack([u, v, np.where(stereo, u - BF / pc[..., 2], 0)], -1)
    obs += rng.normal(0, 0.5, obs.shape) + (rng.random((B, N, 1)) < 0.1) * 40.0
    ln_xw = rng.uniform([-2, -1.5, 2.0], [2, 1.5, 6.0], (B, NL, 3)).astype(f32)
    ang = rng.uniform(0, math.pi, (B, NL))
    eq = np.stack([np.cos(ang), np.sin(ang), rng.uniform(-400, 0, (B, NL))], -1)

    def planes(n):
        nrm = rng.normal(0, 1, (B, n, 3))
        nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
        w = np.concatenate([nrm, rng.uniform(-3, -1, (B, n, 1))], -1).astype(f32)
        moved = lm.transform_plane_g2o(T_gt, torch.from_numpy(w)).numpy()
        return (torch.from_numpy(w),
                torch.from_numpy((moved + rng.normal(0, 0.01, moved.shape)).astype(f32)),
                torch.from_numpy(rng.random((B, n)) < 0.8))

    t = lambda a, dt=torch.float32: torch.from_numpy(np.asarray(a)).to(dt)  # noqa: E731
    ln = {"rows": (t(ln_xw), t(eq), t(rng.uniform(0.5, 2, (B, NL))), t(rng.random((B, NL)) < 0.9,
                                                                          torch.bool)),
          "empty": (torch.zeros(B, 0, 3), torch.zeros(B, 0, 3), torch.zeros(B, 0),
                    torch.zeros(B, 0, dtype=torch.bool)),
          "none": (None,) * 4}[lines]
    prob = lm.PoseProblem(
        t(xw), t(obs), t(rng.uniform(0.5, 1.5, (B, N))), t(stereo, torch.bool),
        t(rng.random((B, N)) < 0.9, torch.bool), *planes(NP), *planes(NPAR), *planes(NVER), *ln)
    T0 = (se3.exp_se3(torch.from_numpy(rng.normal(0, 0.01, (B, 6)).astype(f32))) @ T_gt).contiguous()
    return prob, T0


# each caller's flags: (name, lines, solve_pose keywords)
CALLERS = [
    ("candidate", "empty", dict(n_rounds=2, n_iters=4, gauss_newton=True)),
    ("manhattan", "empty", dict(translation_only=True, n_rounds=2, n_iters=4, gauss_newton=True,
                                use_planes=True)),
    ("final", "rows", dict(n_rounds=4, n_iters=5, use_planes=True, use_lines=True)),
    ("reloc", "none", dict()),
    ("modular_translation", "rows", dict(translation_only=True, use_planes=True, use_lines=True)),
]


@pytest.mark.parametrize("name,lines,kw", CALLERS, ids=[c[0] for c in CALLERS])
def test_kernel_inputs_round_trip(name, lines, kw):
    prob, T0 = _problem(1, lines)
    use_planes, use_lines = kw.get("use_planes", False), kw.get("use_lines", False)
    tensors, dims = lm.kernel_inputs(prob, T0, K, use_planes, use_lines)
    assert len(tensors) == len(lm.PoseProblem._fields) + 2
    assert tensors[-2] is T0 and tensors[-1] is K
    used = {"pt"} | ({"ln"} if use_lines else set()) | ({"pl", "par", "ver"} if use_planes else set())
    fields = {}
    for field, t in zip(lm.PoseProblem._fields, tensors):
        if field.split("_")[0] in used:
            assert t is getattr(prob, field), field  # the field itself: no copy
            fields[field] = t
        else:
            assert t is None, field
    assert dims == [B, N, NL if use_lines else 0, NP if use_planes else 0,
                    NPAR if use_planes else 0, NVER if use_planes else 0]
    rebuilt = prob._replace(**fields)
    for field, a, b in zip(lm.PoseProblem._fields, rebuilt, prob):
        assert a is b, field


@pytest.mark.parametrize("name,lines,kw", CALLERS, ids=[c[0] for c in CALLERS])
def test_solve_pose_on_cpu_is_the_plain_solve(name, lines, kw):
    prob, T0 = _problem(2, lines)
    params = lm.default_params()
    before = lm.solve_pose_cuda.launches
    out = lm.solve_pose(prob, T0, K, BF, params, **kw)
    assert lm.solve_pose_cuda.launches == before
    ref = frozen_lm.solve_pose(frozen_lm.PoseProblem(*prob), T0, K, BF,
                               frozen_lm.SolveParams(*params), **kw)
    assert list(out) == list(ref)
    for k in out:
        assert out[k].dtype == ref[k].dtype and torch.equal(out[k], ref[k]), k
    assert torch.isfinite(out["T"]).all() and bool((out["n_inliers"] > 0).all())


def _bad(case: str):
    prob, T0 = _problem(3, "rows")
    Kb = K
    if case == "double_points":
        prob = prob._replace(pt_xw=prob.pt_xw.double())
    elif case == "mask_not_bool":
        prob = prob._replace(pl_mask=prob.pl_mask.float())
    elif case == "rows_differ":
        prob = prob._replace(pt_info=torch.ones(B, N + 1))
    elif case == "batch_differs":
        prob = prob._replace(ln_eq=prob.ln_eq[:2])
    elif case == "not_contiguous":
        prob = prob._replace(pt_obs=prob.pt_obs.transpose(0, 1).contiguous().transpose(0, 1))
    elif case == "other_device":
        prob = prob._replace(par_w=prob.par_w.to("meta"))
    elif case == "lines_none":
        prob = prob._replace(ln_xw=None, ln_eq=None, ln_info=None, ln_mask=None)
    elif case == "T0_shape":
        T0 = T0[:, :3].contiguous()
    elif case == "K_double":
        Kb = K.double()
    return prob, T0, Kb


@pytest.mark.parametrize("case", ["double_points", "mask_not_bool", "rows_differ", "batch_differs",
                                  "not_contiguous", "other_device", "lines_none", "T0_shape",
                                  "K_double"])
def test_kernel_inputs_raise_on_what_the_kernel_does_not_take(case):
    prob, T0, Kb = _bad(case)
    with pytest.raises(ValueError):
        lm.kernel_inputs(prob, T0, Kb, True, True)


def test_solve_pose_cuda_raises_off_the_card():
    prob, T0 = _problem(4, "rows")
    with pytest.raises(ValueError, match="unsupported device"):
        lm.solve_pose_cuda(prob, T0, K, BF)
    with pytest.raises(ValueError, match="unsupported device"):
        lm.solve_pose(lm.PoseProblem(*(t.to("meta") for t in prob)), T0.to("meta"), K.to("meta"), BF)
