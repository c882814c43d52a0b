"""device.idle_share.train: the share of the traced window, its own start to its
own end, in which no kernel, copy or memset ran on the card."""


def read(ctx):
    trace = ctx.trace
    if trace is None or trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - trace.busy_s / trace.window_s)
