"""serve.p50_ms: the median latency of every request of the window, from its
due time to the end of its answer, by the load generator's clock (a failed
request counts as infinitely late)."""

from benchmark.harness.stats import percentile


def read(ctx):
    latency = ctx.layer.get("latency_ms")
    return percentile(latency, 50) if latency else None
