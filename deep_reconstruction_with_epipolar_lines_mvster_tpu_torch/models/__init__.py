"""Port models: the network, its blocks and its losses."""

from .mvs4net import MVS4Net

__all__ = ["MVS4Net"]
