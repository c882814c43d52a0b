"""serve.handler_ms.steady: the mean self time of a request in the port's HTTP
handler over the traced stretch: its spans ``serve.parse`` (read and decode
the body) and ``serve.encode`` (encode and send the answer), over the
requests (``serve.request``)."""

from benchmark.harness import spans


def read(ctx):
    return spans.handler_ms(spans.recorded())
