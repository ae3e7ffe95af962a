"""``fusion_filter_ms.cloud``: the median host ms of the program's
``fusion.filter`` span, ``filter_ref_view``'s uploads, captured filter and
downloads (``spans.median_ms``)."""

from benchmark import spans


def read(res):
    return spans.median_ms("fusion.filter")
