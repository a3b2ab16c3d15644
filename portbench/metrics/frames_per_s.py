"""frames_per_s: every frame handed in during the window over the
window's length; the host's clock."""

from portbench.common import rate


def read(ctx):
    return rate(ctx["frames"], ctx["window_s"])
