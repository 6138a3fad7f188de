from . import dists

__all__ = ["dists"]
