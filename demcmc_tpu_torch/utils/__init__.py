from . import checkpoint, dists, kde, monitor, pytree

__all__ = ["checkpoint", "dists", "kde", "monitor", "pytree"]
