"""The Instant-NGP field's fused MLP kernels' share of their bound in the
training window: the step's MLP operations (``families/ngp.py::step_ops``,
forward and the backward's least work at every sample, 1.426e10 at 1024
rays) times the window's steps, at the peak of the configuration's dtype,
over the device time of the kernels named in ``kernels/``. Bytes bind a
little before operations (~76 MB of features, outputs and gradients a step,
~23 us at 3.35 TB/s, against 14.4 us of operations), so ~60% is its
practical ceiling. Nothing to read where no such kernel ran (the MLPs
through ``torch.matmul``, or a NeRF cell)."""

from nerfbench.families import ngp
from nerfbench.trace import names_in


def read(trace, ctx):
    t = trace.seconds(trace.matching(names_in(ctx["dir"])))
    if t <= 0 or ctx["steps"] <= 0:
        return None
    ops = ctx["steps"] * ngp.step_ops(ctx["cfg"])
    return 100.0 * ops / ctx["peak"] / t
