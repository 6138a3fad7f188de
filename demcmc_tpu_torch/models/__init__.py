from . import (abc_kde, binomial, discrete_binomial, gaussian, hierarchical,
               lba, lnr, mvnormal, rastrigin)

__all__ = ["abc_kde", "binomial", "discrete_binomial", "gaussian",
           "hierarchical", "lba", "lnr", "mvnormal", "rastrigin"]
