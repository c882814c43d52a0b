"""batcher.handoff_ms.steady: the mean time from the end of the device call
that served a request (span ``batcher.call``, which lists the waits it served)
to the end of the request's ``serve.wait`` over the traced stretch: the
port's ``DynamicBatcher`` handing the answer over and the handler's thread
waking."""

from benchmark.harness import spans


def read(ctx):
    return spans.handoff_ms(spans.recorded())
