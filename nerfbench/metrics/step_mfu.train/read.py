"""The whole step's share of the card's peak: the model operations of the
traced window's steps (forward and backward of every point, 9.146e11 a
step at 1024 rays) over the window's wall time, at the peak of the
configuration's dtype."""

from nerfbench import flops


def read(trace, ctx):
    if ctx["steps"] <= 0 or trace.window_s <= 0:
        return None
    ops = ctx["steps"] * flops.step_ops(ctx["cfg"])
    return 100.0 * ops / ctx["peak"] / trace.window_s
