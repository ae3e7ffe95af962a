"""``replay_host_ms.eval``: the median host ms of the program's
``graph.replay`` span, the static-input copies, the replay's enqueue and
the output clones (``spans.median_ms``)."""

from benchmark import spans


def read(res):
    return spans.median_ms("graph.replay")
