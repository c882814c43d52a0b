"""patch_embed_roofline: the least time of the fused patch embeds of the
traced steps, from their shapes (``configs/<config>.py::patch_embed_calls``,
``harness/work.py``), over the device time of the kernels that implement them
(the configuration's ``PATCH_EMBED_KERNELS``). Absent where none ran."""

from benchmark.harness import work as W
from benchmark.harness.peaks import least_seconds


def read(ctx):
    trace, steps = ctx.trace, ctx.layer.get("trace_steps")
    names = getattr(ctx.cfgmod, "PATCH_EMBED_KERNELS", ())
    if trace is None or not steps or not names:
        return None
    seconds, launches = trace.kernel_seconds(names)
    if not launches:
        return None
    batch = ctx.layer["batch"]
    least = sum(least_seconds(W.patch_embed(batch * g, s, c), W.patch_embed_bytes(batch * g, s, c))
                for g, s, c in ctx.cfgmod.patch_embed_calls(ctx.cfg))
    return 100.0 * steps * least / seconds
