"""step.ema_pass_ms.train: the stream's ms of the train step's stage
``ema_forward_mask`` (the EMA's unmasked forward and the geometric mask), mean
over the traced steps: from the end of the stage before to its own, by the
CUDA events of the port's stage spans (``utils/profiling.py::stage_ms``)."""

from benchmark.harness import spans


def read(ctx):
    return spans.stage_mean_ms(spans.stage_steps(), "ema_forward_mask")
