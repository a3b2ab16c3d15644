"""Build and load the hand-written CUDA kernels in ``csrc/``.

Each ``csrc/<name>.cu`` exposes a plain C function and is compiled on
first use by ONE ``nvcc`` call into ``build/torch_kernels/<name>-<hash>.so``
at the root of the checkout (a git-ignored directory), then loaded with
``ctypes``.  The hash covers the source and the compiler flags, so an
edited source is rebuilt and an unchanged one is reused.  Sources that
need building are compiled in parallel, one ``nvcc`` process each.

Nothing here falls back: a missing ``nvcc`` or a failed build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
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

_P = ctypes.c_void_p
_I = ctypes.c_int
# C signature of each kernel source's entry point: (symbol, argtypes).
# Every kernel takes a leading stream count B (its images are (B, h, w)),
# then the stream handle last.
SIGNATURES = {
    # img, out, B, h, w, stream
    "fast": ("mslam_fast_score", (_P, _P, _I, _I, _I, _P)),
    # img, xy, umax, angle, B, n, h, w, stream
    "ic_angle": ("mslam_ic_angle", (_P, _P, _P, _P, _I, _I, _I, _I, _P)),
    # img, xy, cos, sin, pattern, desc, B, n, h, w, stream
    "brief": ("mslam_brief", (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P)),
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


def _target(name: str) -> Path:
    src = (_CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{name}-{digest}.so"


def build(names=tuple(SIGNATURES)) -> dict[str, ctypes._CFuncPtr]:
    """Compile (where needed, in parallel) and load the named kernels;
    returns {name: C function}.  Raises with nvcc's output on failure."""
    with _lock:
        todo = [n for n in names if n not in _loaded]
        pending = []
        for name in todo:
            so = _target(name)
            if so.exists():
                continue
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = so.with_suffix(f".{os.getpid()}.tmp")
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(_CSRC / f"{name}.cu")]
            proc = subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
            )
            pending.append((name, so, tmp, proc))
        errors = []
        for name, so, tmp, proc in pending:
            out, _ = proc.communicate()
            if proc.returncode != 0:
                errors.append(f"nvcc failed for csrc/{name}.cu:\n{out}")
                tmp.unlink(missing_ok=True)
            else:
                os.replace(tmp, so)
        if errors:
            raise RuntimeError("\n".join(errors))
        for name in todo:
            symbol, argtypes = SIGNATURES[name]
            fn = getattr(ctypes.CDLL(str(_target(name))), symbol)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
            _loaded[name] = fn
        return {n: _loaded[n] for n in names}


def kernel(name: str) -> ctypes._CFuncPtr:
    """The C entry point of csrc/<name>.cu, built on first use."""
    fn = _loaded.get(name)
    return fn if fn is not None else build((name,))[name]


def check_launch(name: str, err: int) -> None:
    """Raise if a kernel's C entry point reported a launch error."""
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: cudaError_t {err}")
