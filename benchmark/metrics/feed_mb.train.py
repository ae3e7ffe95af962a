"""``feed_mb.train``: MB (1e6 bytes) that a ``batch_to_torch`` call moves to
the card: the program's ``feed.bytes`` over its ``feed`` spans
(``spans.per_call``)."""

from benchmark import spans


def read(res):
    per_call = spans.per_call("feed.bytes", "feed")
    return None if per_call is None else per_call / 1e6
