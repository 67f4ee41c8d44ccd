"""Device milliseconds a step of the optimizer's kernels named in
``kernels/`` (the one-launch Adam over every leaf): their device time in
the window over the window's steps. Nothing to read where no such kernel
ran."""

from nerfbench.trace import names_in


def read(trace, ctx):
    t = trace.seconds(trace.matching(names_in(ctx["dir"])))
    if t <= 0 or ctx["steps"] <= 0:
        return None
    return 1e3 * t / ctx["steps"]
