"""``idle_caller_ms.cloud``: device idle ms a profiled scene with no program
span open, in the caller's own code (``spans.idle_ms``)."""

from benchmark import spans


def read(res):
    return spans.idle_ms(res, lambda name: name == spans.CALLER)
