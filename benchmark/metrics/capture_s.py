"""``capture_s``: seconds in the program's ``graph.capture`` spans, the
warm-up and record of each new input signature, less the kernel loads
nested in them (``spans.summed_s``)."""

from benchmark import spans


def read(res):
    return spans.summed_s("graph.capture", "self_s")
