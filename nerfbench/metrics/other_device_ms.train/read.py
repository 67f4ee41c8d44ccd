"""Device milliseconds a step outside the MLP kernels (rays, sampling,
compositing, the draws, Adam): all device activity in the window less the
kernels named in ``kernels/``, over the window's steps."""

from nerfbench.trace import names_in


def read(trace, ctx):
    mlp = trace.matching(names_in(ctx["dir"]))
    if not mlp or ctx["steps"] <= 0:
        return None
    lo, hi = trace.window
    inside = [e for e in trace.device if e[1] >= lo and e[2] <= hi]
    mlp_ids = {id(e) for e in mlp}
    other = trace.seconds([e for e in inside if id(e) not in mlp_ids])
    return 1e3 * other / ctx["steps"]
