"""Host spans and counters, and the marks that split the fused step into
its branches for a timing capture.

``Recorder`` keeps everything in memory.  ``span(name)`` is a context
manager: each span path (its parents' names and its own, joined by "/",
e.g. ``chunk_dispatch/step.launch``) keeps host seconds, a count and the
seconds of its child spans, so its self time is its seconds less its
children's.  ``count(name, n)`` adds to a counter.  ``snapshot()`` copies
both; ``diff(a, b)`` is what happened between two snapshots, and
``table(snap)`` prints one.  While a ``torch.profiler`` is active, each
span is also a ``record_function`` range named ``mslam.<path>``, so the
program's spans lie in the device trace, on its clock; with no profiler
active no range is entered.  The port starts no thread, so one stack of
open spans per recorder is enough.

``mark(name)`` closes the branch ``name`` of the fused step
(``device_tracker.build_batched_body``).  It does nothing unless a
``BranchTiming`` is under way, as ``GraphedStep.branch_times`` makes one
for a second capture of the step: then each mark records a timing CUDA
event, which the capture turns into an event node of that graph, and the
number of nodes the graph holds before it; on the CPU it reads the host
clock.  The production graph is captured with no timing under way, so it
holds no mark.
"""

from __future__ import annotations

import ctypes
import time
from collections import Counter, defaultdict

import torch

PREFIX = "mslam."  # the profiler's name of a span is PREFIX + its path


class _Span:
    __slots__ = ("rec", "name", "range")

    def __init__(self, rec: Recorder, name: str):
        self.rec = rec
        self.name = name
        self.range = None

    def __enter__(self):
        stack = self.rec._stack
        path = f"{stack[-1][0]}/{self.name}" if stack else self.name
        if torch._C._autograd._profiler_enabled():
            self.range = torch.autograd.profiler.record_function(PREFIX + path)
            self.range.__enter__()
        stack.append([path, time.perf_counter(), 0.0])
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter()
        stack = self.rec._stack
        path, t0, child = stack.pop()
        d = t1 - t0
        s = self.rec.spans.get(path)
        if s is None:
            s = self.rec.spans[path] = [0.0, 0, 0.0]
        s[0] += d
        s[1] += 1
        s[2] += child
        if stack:
            stack[-1][2] += d
        if self.range is not None:
            self.range.__exit__(None, None, None)
        return False


class Recorder:
    """Host spans by path ([seconds, count, child seconds]) and counters,
    in memory."""

    def __init__(self):
        self.spans: dict[str, list] = {}
        self.counters = Counter()
        self._stack: list[list] = []  # the open spans: [path, start, child seconds]

    def span(self, name: str) -> _Span:
        return _Span(self, name)

    def count(self, name: str, n: int = 1) -> None:
        self.counters[name] += n

    def snapshot(self) -> dict:
        """{"spans": {path: (seconds, count, self seconds)}, "counters":
        {name: n}}."""
        return {"spans": {p: (s, n, s - c) for p, (s, n, c) in self.spans.items()},
                "counters": dict(self.counters)}


def diff(a: dict, b: dict) -> dict:
    """What the recorder did between snapshots a and b (b the later): the
    spans entered and the counters moved in between."""
    spans = {}
    for p, (s, n, own) in b["spans"].items():
        s0, n0, own0 = a["spans"].get(p, (0.0, 0, 0.0))
        if n > n0:
            spans[p] = (s - s0, n - n0, own - own0)
    counters = {k: v - a["counters"].get(k, 0) for k, v in b["counters"].items()
                if v != a["counters"].get(k, 0)}
    return {"spans": spans, "counters": counters}


def by_leaf(snap: dict, names=None) -> dict[str, tuple[float, int]]:
    """Seconds and count of each span name (the last part of its path),
    summed over every path it ends; only `names` when given."""
    out = defaultdict(lambda: [0.0, 0])
    for p, (s, n, _) in snap["spans"].items():
        leaf = p.rsplit("/", 1)[-1]
        if names is None or leaf in names:
            out[leaf][0] += s
            out[leaf][1] += n
    return {k: (s, n) for k, (s, n) in out.items()}


def table(snap: dict, per: int = 1) -> str:
    """One line per span path (ms, count and self ms, each over `per`,
    e.g. the frames of a window) and the counters."""
    rows = [f"{p:58s} {s * 1e3 / per:10.4f} ms {n / per:9.3f} x  self {own * 1e3 / per:10.4f} ms"
            for p, (s, n, own) in sorted(snap["spans"].items())]
    rows += [f"{k:58s} {v / per:10.4f}" for k, v in sorted(snap["counters"].items())]
    return "\n".join(rows)


# ------------------------------------------------------ the branch marks
_timing = None  # the BranchTiming under way


def mark(name: str) -> None:
    """Close the step's branch `name`: a no-op unless a BranchTiming is
    under way."""
    if _timing is not None:
        _timing.mark(name)


class BranchTiming:
    """The marks of one capture (CUDA) or run (CPU) of the step, between
    ``start()`` and ``end()``; what follows the last mark up to ``end()``
    counts to the last mark's branch.  ``times_ms()`` after a replay (or
    the run) gives each branch's ms; ``ops`` each branch's nodes of the
    captured graph, not counting the marks' own event nodes (None on the
    CPU or where the driver cannot tell)."""

    def __init__(self, cuda: bool):
        self.cuda = cuda
        self.names: list[str] = []  # the marks in order; "" the start and the end
        self.stamps: list = []  # CUDA events or host seconds, one per mark
        self.nodes: list = []  # the captured graph's nodes before each mark

    def __enter__(self):
        global _timing
        if _timing is not None:
            raise RuntimeError("a branch timing is already under way")
        _timing = self
        return self

    def __exit__(self, *exc):
        global _timing
        _timing = None
        return False

    def mark(self, name: str) -> None:
        self.names.append(name)
        if self.cuda:
            self.nodes.append(capture_nodes())
            ev = torch.cuda.Event(enable_timing=True, external=True)
            ev.record()
            self.stamps.append(ev)
        else:
            self.stamps.append(time.perf_counter())

    def start(self) -> None:
        self.mark("")

    def end(self) -> None:
        self.mark("")

    def _intervals(self, values: list) -> dict[str, float]:
        """Each branch's share of consecutive differences of `values`; the
        tail after the last named mark goes to that mark's branch."""
        out, last = {}, None
        for i in range(1, len(values)):
            name = self.names[i] or last
            out[name] = out.get(name, 0) + values[i] - values[i - 1]
            last = name
        return out

    def times_ms(self) -> dict[str, float]:
        if self.cuda:
            first = self.stamps[0]
            return self._intervals([first.elapsed_time(e) for e in self.stamps])
        return self._intervals([t * 1e3 for t in self.stamps])

    @property
    def ops(self) -> dict[str, int | None]:
        if not self.cuda or any(n is None for n in self.nodes):
            return {name: None for name in self._intervals([0] * len(self.names))}
        # each mark after the first adds its own event node before the next count
        return self._intervals([n - i for i, n in enumerate(self.nodes)])


# --------------------------------------- nodes of a graph under capture
_driver = None


def _cuda_driver():
    """The CUDA driver API (libcuda), loaded once; None where it lacks
    what capture_nodes needs."""
    global _driver
    if _driver is None:
        try:
            lib = ctypes.CDLL("libcuda.so.1")
            vp, sz = ctypes.c_void_p, ctypes.c_size_t
            info = getattr(lib, "cuStreamGetCaptureInfo_v2")
            info.argtypes = [vp, ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_ulonglong),
                             ctypes.POINTER(vp), ctypes.POINTER(vp), ctypes.POINTER(sz)]
            info.restype = ctypes.c_int
            nodes = lib.cuGraphGetNodes
            nodes.argtypes = [vp, vp, ctypes.POINTER(sz)]
            nodes.restype = ctypes.c_int
            _driver = (info, nodes)
        except (OSError, AttributeError):
            _driver = False
    return _driver or None


def capture_nodes() -> int | None:
    """The number of nodes (kernels, copies, sets, events) of the CUDA
    graph that the current stream is capturing into; None when the stream
    is not capturing or the driver cannot tell."""
    fns = _cuda_driver()
    if fns is None:
        return None
    info, get_nodes = fns
    status, gid = ctypes.c_int(0), ctypes.c_ulonglong(0)
    graph, deps, n_deps = ctypes.c_void_p(), ctypes.c_void_p(), ctypes.c_size_t(0)
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    if info(stream, ctypes.byref(status), ctypes.byref(gid), ctypes.byref(graph),
            ctypes.byref(deps), ctypes.byref(n_deps)) != 0 or status.value != 1:
        return None
    n = ctypes.c_size_t(0)
    if get_nodes(graph, None, ctypes.byref(n)) != 0:
        return None
    return int(n.value)
