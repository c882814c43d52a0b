"""data.loader_wait_ms.train: the host's ms in the pull from the port's ``DataLoader``
(span ``data.loader``) per batch that ``device_prefetch`` hands to the step
(span ``data.next``), over the traced steps."""

from benchmark.harness import spans


def read(ctx):
    return spans.loader_wait_ms(spans.recorded())
