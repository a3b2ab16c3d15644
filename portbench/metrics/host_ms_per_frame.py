"""host_ms_per_frame: the host state machine's own sections
(FastTracker.perf: dispatch, back-end join, keyframe work, relocalization)
summed over the window, per frame handed in.  The summary pull, the
wait for a chunk's results, is left out; the dispatch keeps the time its
graph launches wait while the card's launch queue is full, so on a
card-bound cell this reads mostly the card."""


def read(ctx):
    if ctx.get("host_perf_s") is None or not ctx["frames"]:
        return None
    return ctx["host_perf_s"] * 1e3 / ctx["frames"]
