"""Build and load the hand-written CUDA kernels and host C++ in ``csrc/``.

Each ``csrc/<name>.cu`` (a CUDA kernel) or ``csrc/<name>.cpp`` (host
C++: the exact AHC plane merge) exposes a plain C function and is
compiled on first use by ONE ``nvcc`` or ``g++`` call into
``build/torch_kernels/<name>-<hash>.so`` at the root of the checkout (a
git-ignored directory), then loaded with ``ctypes``.  The hash covers the
source and the compiler flags, so an edited source is rebuilt and an
unchanged one is reused.  Sources that need building are compiled in
parallel, one compiler process each.

Nothing here falls back: a missing compiler or a failed build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import math
import os
import shutil
import subprocess
import threading
from pathlib import Path

_CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent.parent / "build" / "torch_kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
)
CXX_FLAGS = ("-O2", "-fPIC", "-shared", "-std=c++17")

_P = ctypes.c_void_p
_I = ctypes.c_int
_PP = ctypes.POINTER(ctypes.c_void_p)  # host array of device pointers
_PI = ctypes.POINTER(ctypes.c_int)  # host array of ints
_PF = ctypes.POINTER(ctypes.c_float)  # host array of floats
# C signature of each kernel source's entry point: (symbol, argtypes).
# The ORB kernels take a level table (host arrays, one entry per pyramid
# level, at most 8 levels) and serve every level and stream in one
# launch.  The stream handle comes last.
SIGNATURES = {
    # img[], out[], h[], w[], tiles_x[], tiles_img[], tile_start[], levels, stream
    "fast": ("mslam_fast_score_levels", (_PP, _PP, _PI, _PI, _PI, _PI, _PI, _I, _P)),
    # img[], h[], w[], n[], kp_start[], vmax[], levels, xy, angle, stream
    "ic_angle": ("mslam_ic_angle_levels", (_PP, _PI, _PI, _PI, _PI, _PI, _I, _P, _P, _P)),
    # img[], h[], w[], n[], kp_start[], weight[], levels, sample radius,
    # threads per keypoint, xy, cos, sin, pattern, desc, stream
    "brief": ("mslam_brief_levels",
              (_PP, _PI, _PI, _PI, _PI, _PF, _I, _I, _I, _P, _P, _P, _P, _P, _P)),
    # the pose solve (not a level table: one problem per block): inputs[],
    # outputs[], dims[], consts[], dof, gauss_newton, use_lines,
    # use_planes, n_rounds, n_iters, stream
    "lm_solve": ("mslam_lm_solve", (_PP, _PP, _PI, _PF, _I, _I, _I, _I, _I, _I, _P)),
}
_PD = ctypes.POINTER(ctypes.c_double)
# C signature of each host C++ source's entry point: (symbol, argtypes).
HOST_SIGNATURES = {
    # bh, bw, n, s1, s2, normal, mean, valid, angle_cos, min_support, labels
    "ahc_merge": ("ahc_merge", (_I, _I, _PD, _PD, _PD, _PD, _PD,
                                ctypes.POINTER(ctypes.c_uint8), ctypes.c_double,
                                ctypes.c_double, ctypes.POINTER(ctypes.c_int32))),
}

_lock = threading.Lock()
_loaded: dict[str, ctypes._CFuncPtr] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path("/usr/local/cuda/bin/nvcc")
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _gxx() -> str:
    found = shutil.which("g++")
    if found:
        return found
    raise RuntimeError("g++ not found: the host C++ sources cannot be built")


def _source(name: str) -> tuple[Path, tuple, tuple]:
    """(source path, compiler command, flags) of csrc/<name>."""
    if name in HOST_SIGNATURES:
        return _CSRC / f"{name}.cpp", (_gxx(),), CXX_FLAGS
    return _CSRC / f"{name}.cu", (_nvcc(),), NVCC_FLAGS


def _target(name: str) -> Path:
    src, _, flags = _source(name)
    digest = hashlib.sha256(src.read_bytes() + " ".join(flags).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{name}-{digest}.so"


def build(names=tuple(SIGNATURES) + tuple(HOST_SIGNATURES)) -> dict[str, ctypes._CFuncPtr]:
    """Compile (where needed, in parallel) and load the named kernels and
    host libraries; returns {name: C function}.  Raises with the
    compiler's output on failure."""
    with _lock:
        todo = [n for n in names if n not in _loaded]
        pending = []
        for name in todo:
            so = _target(name)
            if so.exists():
                continue
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = so.with_suffix(f".{os.getpid()}.tmp")
            src, compiler, flags = _source(name)
            cmd = [*compiler, *flags, "-o", str(tmp), str(src)]
            proc = subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
            )
            pending.append((name, so, tmp, proc, src))
        errors = []
        for name, so, tmp, proc, src in pending:
            out, _ = proc.communicate()
            if proc.returncode != 0:
                errors.append(f"building csrc/{src.name} failed:\n{out}")
                tmp.unlink(missing_ok=True)
            else:
                os.replace(tmp, so)
        if errors:
            raise RuntimeError("\n".join(errors))
        for name in todo:
            symbol, argtypes = {**SIGNATURES, **HOST_SIGNATURES}[name]
            fn = getattr(ctypes.CDLL(str(_target(name))), symbol)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
            _loaded[name] = fn
        return {n: _loaded[n] for n in names}


def kernel(name: str) -> ctypes._CFuncPtr:
    """The C entry point of csrc/<name>.cu (or .cpp), built on first use."""
    fn = _loaded.get(name)
    return fn if fn is not None else build((name,))[name]


MAX_LEVELS = 8  # pyramid levels one kernel launch takes (csrc kMaxLevels)


def prefix(sizes) -> list[int]:
    """[0, s0, s0 + s1, ...]: the start offsets of consecutive blocks (the
    level tables' prefixes)."""
    out = [0]
    for n in sizes:
        out.append(out[-1] + int(n))
    return out


def level_views(flat, shapes) -> list:
    """Contiguous views of consecutive blocks of the 1-D buffer `flat`, one
    per shape (a level-major layout)."""
    starts = prefix(math.prod(s) for s in shapes)
    return [flat[a:b].view(s) for a, b, s in zip(starts, starts[1:], shapes)]


def c_array(ctype, values):
    """A ctypes array of `values`, for a host-array argument."""
    return (ctype * len(values))(*values)


def check_launch(name: str, err: int) -> None:
    """Raise if a kernel's C entry point reported a launch error."""
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: cudaError_t {err}")
