"""runner.host_ms.steady: the host's ms a device call in the port's
``ServingModel`` over the traced stretch: spans ``runner.pad``,
``runner.copy_in`` and ``runner.launch``, over the launches."""

from benchmark.harness import spans


def read(ctx):
    return spans.runner_host_ms(spans.recorded())
