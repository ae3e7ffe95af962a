"""``forward_ms.cloud``: host milliseconds a scene in the program's
``run_forward`` calls, results on the host (``readers.span_ms``)."""

from benchmark import readers


def read(res):
    return readers.span_ms(res, "forward")
