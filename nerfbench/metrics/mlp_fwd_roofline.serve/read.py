"""The forward MLP kernels' share of their bound while serving: the
forward operations of every real ray's points of the frames rendered in
the window (padding rays not counted) at the card's peak, over the device
time of the kernels named in ``kernels/``."""

from nerfbench import flops
from nerfbench.trace import names_in


def read(trace, ctx):
    frames = sum(n for _, _, n in ctx["frame_spans"])
    t = trace.seconds(trace.matching(names_in(ctx["dir"])))
    if t <= 0 or frames <= 0:
        return None
    return 100.0 * frames * flops.frame_ops(ctx["cfg"]) / ctx["peak"] / t
