"""``kernel_roofline.eval``: the port's kernels' bound over their device time
(``readers.kernel_roofline``)."""

from benchmark import readers


def read(res):
    return readers.kernel_roofline(res)
