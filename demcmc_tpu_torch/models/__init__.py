from . import gaussian

__all__ = ["gaussian"]
