"""profiled_idle_pct: the traced window's length less the union of all
device activity in it, as a share of the window, under torch.profiler.
The profiler's per-kernel records slow the fused step's graph replays
(~20k kernels a frame), so the share reads the program as traced, not
the untraced window; step_device_ms gives the card's time without it."""


def read(ctx):
    tr = ctx.get("trace")
    if not tr or tr["window_s"] <= 0:
        return None
    return 100.0 * (tr["window_s"] - tr["busy_s"]) / tr["window_s"]
