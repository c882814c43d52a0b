"""train.mfu: the step's operations a cloud, counted from the configuration's
shapes (EMA pass, student forward and backward, teacher; nothing recomputed
counted), times the clouds trained in the traced window over its length, as
a share of the chip's dense TF32 peak."""

from benchmark.harness.peaks import share_of_peak


def read(ctx):
    trace, steps = ctx.trace, ctx.layer.get("trace_steps")
    if trace is None or not steps:
        return None
    clouds = steps * ctx.layer["batch"]
    return share_of_peak(ctx.cfgmod.train_flops_per_cloud(ctx.cfg) * clouds, trace.window_s)
