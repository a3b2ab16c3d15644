"""orb_kernels_roofline: the three ORB kernels' least time (each
launch's larger of bytes at 3.35 TB/s and float ops at 67 TFLOP/s,
portbench/counts.py) over their device time in the traced window, in
percent of the full-power roofline; nothing when the trace holds none of
them."""

from portbench.counts import KERNEL_NAMES


def read(ctx):
    tr, least = ctx.get("trace"), ctx.get("least_ms")
    if not tr or not least:
        return None
    least_s = device_s = 0.0
    for key, kname in KERNEL_NAMES.items():
        for name, (n, s) in tr["kernels"].items():
            if kname in name:
                least_s += n * least[key] * 1e-3
                device_s += s
    if device_s <= 0:
        return None
    return 100.0 * least_s / device_s
