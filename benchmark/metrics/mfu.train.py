"""``mfu.train``: logical FLOPs over the profiled stretch and the dense peak
(``readers.mfu``)."""

from benchmark import readers


def read(res):
    return readers.mfu(res)
