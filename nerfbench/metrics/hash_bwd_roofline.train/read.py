"""The hash encoding's backward kernel's share of its bound in the training
window: the bytes it moves in a step (``families/ngp.py::hash_bwd_bytes``:
a sample's feature gradients, 32 float32, and position, 12 B, once each,
and every gradient entry a launch can touch written once, min(8 x samples,
the level's entries) x 8 B a level, for the coarse and the fine launch)
times the window's steps, at the card's bandwidth, over the device time of
the kernels named in ``kernels/``. Nothing to read where no such kernel
ran."""

from nerfbench import flops
from nerfbench.families import ngp
from nerfbench.trace import names_in


def read(trace, ctx):
    t = trace.seconds(trace.matching(names_in(ctx["dir"])))
    if t <= 0 or ctx["steps"] <= 0:
        return None
    moved = ctx["steps"] * ngp.hash_bwd_bytes(ctx["cfg"])
    return 100.0 * moved / flops.PEAKS["hbm_bytes_per_s"] / t
