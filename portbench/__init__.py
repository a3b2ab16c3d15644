"""The benchmark of manhattanslam_tpu_torch on NVIDIA GPUs (run.py)."""
