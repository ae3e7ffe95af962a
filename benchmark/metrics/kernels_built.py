"""``kernels_built``: the program's ``kernels.built`` counter, the kernel
libraries it compiled in this run; 0 where every library was built
already, which tells a warm ``kernel_load_s`` from one that compiled
(``spans.counter``)."""

from benchmark import spans


def read(res):
    return spans.counter("kernels.built")
