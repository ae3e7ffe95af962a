"""``kernel_load_s``: seconds in the program's ``kernels.load`` spans, each
library's build, if any, and load (``spans.summed_s``)."""

from benchmark import spans


def read(res):
    return spans.summed_s("kernels.load")
