"""``forward_copy_in_ms.cloud``: the median host ms of the program's
``forward.copy_in`` span, the pad and the copies to the card in
``run_forward`` (``spans.median_ms``)."""

from benchmark import spans


def read(res):
    return spans.median_ms("forward.copy_in")
