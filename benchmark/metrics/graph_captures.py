"""``graph_captures``: the program's ``graph.captures`` counter, the input
signatures it captured (``spans.counter``)."""

from benchmark import spans


def read(res):
    return spans.counter("graph.captures")
