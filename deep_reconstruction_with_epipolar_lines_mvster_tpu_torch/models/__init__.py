"""Port models: the eval network and its blocks."""

from .mvs4net import MVS4Net

__all__ = ["MVS4Net"]
