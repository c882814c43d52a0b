"""step.optimizer_ms.train: the stream's ms of the train step's stage
``optimizer_ema`` (the gradient norm, the optimizer and the EMA update), mean
over the traced steps: from the end of the stage before to its own, by the
CUDA events of the port's stage spans (``utils/profiling.py::stage_ms``)."""

from benchmark.harness import spans


def read(ctx):
    return spans.stage_mean_ms(spans.stage_steps(), "optimizer_ema")
