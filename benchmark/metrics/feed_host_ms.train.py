"""``feed_host_ms.train``: the median host ms of the program's ``feed`` span,
``batch_to_torch``'s pinned copies and enqueue of one batch
(``spans.median_ms``)."""

from benchmark import spans


def read(res):
    return spans.median_ms("feed")
