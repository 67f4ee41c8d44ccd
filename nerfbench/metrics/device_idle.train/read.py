"""The share of the training window in which nothing ran on the device."""


def read(trace, ctx):
    if not trace.device or trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - trace.busy_s() / trace.window_s)
