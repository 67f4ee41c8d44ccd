"""Device milliseconds a step of an Instant-NGP train step outside its
hash-encode kernels and Adam (the 64-wide MLPs' GEMMs and their casts,
rays, sampling, compositing, the draws, the gradient buffer's zeroing,
the block's copies): all device activity in the window less the kernels
named in ``kernels/``, over the window's steps. Nothing to read where no
``hash_encode_fwd`` ran (a NeRF cell)."""

from nerfbench.trace import names_in


def read(trace, ctx):
    if ctx["steps"] <= 0 or not trace.matching(["hash_encode_fwd"]):
        return None
    lo, hi = trace.window
    inside = [e for e in trace.device if e[1] >= lo and e[2] <= hi]
    own = {id(e) for e in trace.matching(names_in(ctx["dir"]))}
    other = trace.seconds([e for e in inside if id(e) not in own])
    return 1e3 * other / ctx["steps"]
