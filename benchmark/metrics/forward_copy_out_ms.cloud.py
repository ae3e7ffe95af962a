"""``forward_copy_out_ms.cloud``: the median host ms of the program's
``forward.copy_out`` span, ``run_forward``'s results to the host
(``spans.median_ms``)."""

from benchmark import spans


def read(res):
    return spans.median_ms("forward.copy_out")
