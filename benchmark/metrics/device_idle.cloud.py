"""``device_idle.cloud``: the idle share of the profiled stretch (``readers.device_idle``)."""

from benchmark import readers


def read(res):
    return readers.device_idle(res)
