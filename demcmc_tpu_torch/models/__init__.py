from . import gaussian, mvnormal

__all__ = ["gaussian", "mvnormal"]
