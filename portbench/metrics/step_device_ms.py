"""step_device_ms: device ms of the fused step per frame, its captured
graph (or, for the batched step, its entry) replayed back to back between
two CUDA events after the window."""


def read(ctx):
    return ctx.get("step_device_ms")
