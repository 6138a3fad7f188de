from . import binomial, discrete_binomial, gaussian, lba, mvnormal

__all__ = ["binomial", "discrete_binomial", "gaussian", "lba", "mvnormal"]
