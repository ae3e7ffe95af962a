"""``forward_wait_ms.cloud``: the median host ms of the program's
``forward.wait`` span, ``run_forward`` waiting for the card
(``spans.median_ms``)."""

from benchmark import spans


def read(res):
    return spans.median_ms("forward.wait")
