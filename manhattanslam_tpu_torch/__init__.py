"""PyTorch + CUDA port of manhattanslam_tpu for one NVIDIA H100.

The JAX package ``manhattanslam_tpu`` stays the reference; this package
mirrors its module paths and names, imports nothing of it, and replaces
each Pallas TPU kernel with a hand-written CUDA C++ kernel (``csrc/``)
that sits beside a plain PyTorch version of the same function.

Importing the package pins float32 geometry (the reference pins
``jax_default_matmul_precision=highest`` for the same reason): TF32 in the
pyramid resize products would shift the integer-rounded blur and flip
BRIEF bits.
"""

import torch

__version__ = "0.1.0"

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.set_float32_matmul_precision("highest")


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller asks for
    another one.  Raises when CUDA is wanted and absent — the port never
    drops to the CPU on its own."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "manhattanslam_tpu_torch runs on CUDA by default and no CUDA "
            "device is available; pass device='cpu' to run the plain "
            "PyTorch versions on the CPU"
        )
    return dev
