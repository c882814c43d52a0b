"""data.wait_ms.train: the host's mean wait, by its clock, for the next batch
from the port's ``device_prefetch`` over its ``DataLoader``, over the
window's steps."""


def read(ctx):
    waits = ctx.layer.get("data_wait_s")
    return 1e3 * sum(waits) / len(waits) if waits else None
