"""``fusion_ms.cloud``: host milliseconds a scene in the program's
``fuse_view`` calls and the join of the scene's points (``readers.span_ms``)."""

from benchmark import readers


def read(res):
    return readers.span_ms(res, "fusion")
