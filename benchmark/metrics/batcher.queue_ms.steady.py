"""batcher.queue_ms.steady: the mean wait of a cloud in the port's
``DynamicBatcher`` queue over the traced stretch, from its enqueue to the start
of its device call: the ``queue_wait_s`` of each span ``batcher.call`` over
its ``clouds``."""

from benchmark.harness import spans


def read(ctx):
    return spans.queue_ms(spans.recorded())
