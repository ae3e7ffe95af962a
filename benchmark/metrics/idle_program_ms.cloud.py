"""``idle_program_ms.cloud``: device idle ms a profiled scene whose innermost
program span is any other (``spans.idle_ms``)."""

from benchmark import spans


def read(res):
    return spans.idle_ms(res, lambda name: name not in spans.COPIES and name != spans.CALLER)
