"""runner.read_back_ms.steady: the host's ms a device call in the port's
``ServingModel`` read back over the traced stretch (span ``runner.read_back``:
the wait for the device and the copy out), over the launches."""

from benchmark.harness import spans


def read(ctx):
    return spans.read_back_ms(spans.recorded())
