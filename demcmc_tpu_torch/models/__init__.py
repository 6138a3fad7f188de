from . import (abc_kde, binomial, discrete_binomial, gaussian, hierarchical,
               lba, lnr, lotka_volterra, mvnormal, rastrigin)

__all__ = ["abc_kde", "binomial", "discrete_binomial", "gaussian",
           "hierarchical", "lba", "lnr", "lotka_volterra", "mvnormal",
           "rastrigin"]
