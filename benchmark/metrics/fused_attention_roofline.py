"""fused_attention_roofline: the least time of every attention sublayer of the
traced steps, from its shapes (``configs/<config>.py::attention_calls``:
operations and bytes as ``harness/work.py`` counts them), over the device
time of the kernels that implement it (the configuration's
``ATTENTION_KERNELS``). Absent where none of them ran."""

from benchmark.harness import work as W
from benchmark.harness.peaks import least_seconds


def read(ctx):
    trace, steps = ctx.trace, ctx.layer.get("trace_steps")
    names = getattr(ctx.cfgmod, "ATTENTION_KERNELS", ())
    if trace is None or not steps or not names:
        return None
    seconds, launches = trace.kernel_seconds(names)
    if not launches:
        return None
    batch, dim = ctx.layer["batch"], ctx.cfg["student"]["trans_dim"]
    least = 0.0
    for length, forwards, backwards in ctx.cfgmod.attention_calls(ctx.cfg):
        for count, bwd in ((forwards, False), (backwards, True)):
            least += count * least_seconds(batch * W.attention_sublayer(length, dim, bwd),
                                           W.attention_bytes(batch, length, dim, bwd))
    return 100.0 * steps * least / seconds
