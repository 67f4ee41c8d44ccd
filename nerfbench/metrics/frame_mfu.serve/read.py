"""A frame's share of the card's peak: the model operations of one frame
(every real ray's points through both nets) over the frame's span (a
render call's host span divided by the frames it rendered), the median
over the window's frames."""

import statistics

from nerfbench import flops


def read(trace, ctx):
    per_frame = [(b - a) / 1e9 / n for a, b, n in ctx["frame_spans"]
                 for _ in range(n)]
    if not per_frame:
        return None
    ops = flops.frame_ops(ctx["cfg"])
    return 100.0 * ops / ctx["peak"] / statistics.median(per_frame)
