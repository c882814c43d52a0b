"""batcher.clouds_per_call.steady: clouds served over device calls made by the
port's ``DynamicBatcher`` during the window (its own counters
``clouds_served`` and ``device_calls``)."""


def read(ctx):
    calls = ctx.layer.get("device_calls")
    return ctx.layer["clouds_served"] / calls if calls else None
