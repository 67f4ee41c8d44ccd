"""The backward MLP kernels' share of their bound in the training window:
the least backward operations of every point of the window's steps
(2,302,208 a point at the published widths) at the card's peak, over the
device time of the kernels named in ``kernels/``."""

from nerfbench import flops
from nerfbench.trace import names_in


def read(trace, ctx):
    t = trace.seconds(trace.matching(names_in(ctx["dir"])))
    if t <= 0 or ctx["steps"] <= 0:
        return None
    cfg = ctx["cfg"]
    ops = ctx["steps"] * cfg["N_rand"] * flops.points_per_ray(cfg) \
        * flops.backward_ops(cfg)
    return 100.0 * ops / ctx["peak"] / t
