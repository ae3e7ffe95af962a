"""``idle_feed_ms.train``: device idle ms a profiled step inside the
program's ``feed`` span (``spans.idle_ms``)."""

from benchmark import spans


def read(res):
    return spans.idle_ms(res, lambda name: name == "feed")
