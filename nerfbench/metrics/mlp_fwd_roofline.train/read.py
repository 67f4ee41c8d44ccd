"""The forward MLP kernels' share of their bound in the training window:
the forward operations of every point of the window's steps (the coarse
and fine passes, 1,186,816 a point at the published widths) at the card's
peak, over the device time of the kernels named in ``kernels/``."""

from nerfbench import flops
from nerfbench.trace import names_in


def read(trace, ctx):
    t = trace.seconds(trace.matching(names_in(ctx["dir"])))
    if t <= 0 or ctx["steps"] <= 0:
        return None
    cfg = ctx["cfg"]
    ops = ctx["steps"] * cfg["N_rand"] * flops.points_per_ray(cfg) \
        * flops.forward_ops(cfg)
    return 100.0 * ops / ctx["peak"] / t
