from . import dists, kde

__all__ = ["dists", "kde"]
