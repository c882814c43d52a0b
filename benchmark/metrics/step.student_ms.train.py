"""step.student_ms.train: the stream's ms of the train step's stage
``student_forward`` (the student's masked forward), mean over the traced
steps: from the end of the stage before to its own, by the CUDA events of the
port's stage spans (``utils/profiling.py::stage_ms``)."""

from benchmark.harness import spans


def read(ctx):
    return spans.stage_mean_ms(spans.stage_steps(), "student_forward")
