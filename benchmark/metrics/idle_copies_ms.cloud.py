"""``idle_copies_ms.cloud``: device idle ms a profiled scene whose innermost
program span copies to or from the card, ``spans.COPIES``
(``spans.idle_ms``)."""

from benchmark import spans


def read(res):
    return spans.idle_ms(res, lambda name: name in spans.COPIES)
