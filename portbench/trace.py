"""The device trace of a traced window: ``torch.profiler`` (CPU and CUDA
activity) around a window of the cell's own traffic, reduced to what the
per-layer metrics and the ``breakdown`` read.

- the window: the span of the harness's own ``portbench.window``
  annotation in the trace's clock;
- ``busy_s``: the union of every device activity (kernels, copies, sets)
  inside the window;
- per kernel name: launches and device seconds;
- the longest idle gaps of the device, each named by what the host was
  doing at its middle: the harness's call under way and the innermost
  host operation.
"""

from __future__ import annotations

from collections import defaultdict

import torch
from torch.profiler import ProfilerActivity, profile, record_function

WINDOW = "portbench.window"
NAME_CHARS = 160  # device operation names are cut to this length in the breakdown
TOP = 10


def _is_device(evt) -> bool:
    return evt.device_type() == torch.autograd.DeviceType.CUDA


def _is_annotation(evt) -> bool:
    """A user annotation, which the profiler also draws on the device's
    timeline over the kernels it launched: no device activity itself."""
    return evt.is_user_annotation() or evt.name().startswith("portbench.")


def traced(run_window) -> dict:
    """Run ``run_window()`` under the profiler inside the WINDOW annotation
    and reduce the trace."""
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function(WINDOW):
            run_window()
            torch.cuda.synchronize()
    return reduce_events(prof.profiler.kineto_results.events())


def reduce_events(events) -> dict:
    win = [e for e in events if e.name() == WINDOW and not _is_device(e)]
    events = [e for e in events if not (_is_device(e) and _is_annotation(e))]
    if not win:
        raise RuntimeError("the trace holds no window annotation")
    w0, w1 = win[0].start_ns(), win[0].end_ns()
    dev, host = [], []
    for e in events:
        a, b = e.start_ns(), e.end_ns()
        if b <= w0 or a >= w1:
            continue
        (dev if _is_device(e) else host).append((max(a, w0), min(b, w1), e.name()))
    kernels = defaultdict(lambda: [0, 0.0])
    for a, b, name in dev:
        k = kernels[name]
        k[0] += 1
        k[1] += (b - a) * 1e-9
    # union of the device intervals, and the gaps between them
    busy_ns, gaps, end = 0, [], w0
    for a, b, _ in sorted(dev):
        if a > end:
            gaps.append((end, a))
        if b > end:
            busy_ns += b - max(a, end)
            end = b
    if end < w1:
        gaps.append((end, w1))
    gaps.sort(key=lambda g: g[0] - g[1])
    calls = [h for h in host if h[2].startswith("portbench.") and h[2] != WINDOW]
    ops = [h for h in host if not h[2].startswith("portbench.")]
    named_gaps = []
    for a, b in gaps[:TOP]:
        mid = (a + b) // 2
        call = [h for h in calls if h[0] <= mid < h[1]]
        inner = min((h for h in ops if h[0] <= mid < h[1]), key=lambda h: h[1] - h[0],
                    default=None)
        label = " / ".join(x for x in (call[0][2] if call else "host",
                                       inner[2] if inner else "no host operation"))
        named_gaps.append([label[:NAME_CHARS], (b - a) * 1e-9])
    top_ops = sorted(kernels.items(), key=lambda kv: -kv[1][1])[:TOP]
    return {
        "window_s": (w1 - w0) * 1e-9,
        "busy_s": busy_ns * 1e-9,
        "kernels": {name: (n, s) for name, (n, s) in kernels.items()},
        "breakdown": {"device_ops": [[name[:NAME_CHARS], s] for name, (_, s) in top_ops],
                      "idle_gaps": named_gaps},
    }
