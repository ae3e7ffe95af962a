"""``fusion_gather_ms.cloud``: the median host ms of the program's
``fusion.gather`` span, ``fused_world_points`` (``spans.median_ms``)."""

from benchmark import spans


def read(res):
    return spans.median_ms("fusion.gather")
