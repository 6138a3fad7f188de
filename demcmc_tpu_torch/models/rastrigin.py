"""Rastrigin benchmark for DE optimization (port of
``demcmc_tpu.models.rastrigin``; reference ``test/optimization_tests.jl:
1-44``): ``A·n + Σᵢ (xᵢ² − A·cos(2π xᵢ))`` with A = 10 over U(−5, 5) per
dimension, minimized with ``update_particle='minimize'`` and
``evaluate_fitness='fun'``; its minimum is 0 at x = 0.  The model has no
prior (optimization only).  The sum runs in index order, as the CUDA
objective ``csrc/densities/rastrigin.cuh`` (n = 2) does, so a float32
configuration of the 2-d function runs on K1 with the greedy accept.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..config import DE
from ..model import CudaDensity, DEModel
from ..utils import dists

NAMES = ("x",)
BOUNDS = ((-5.0, 5.0),)
A = 10.0
CUDA_DIM = 2          # the width csrc/densities/rastrigin.cuh is built for


def rastrigin_batched(data, x):
    """Chains-last ``A·n + Σᵢ (xᵢ² − A cos(2π xᵢ))`` over ``x [n, *cs]``
    (``2π`` rounded to the state's dtype, as JAX folds it), summed in
    index order."""
    t = x * x - A * torch.cos(dists.const(2.0 * math.pi, x.dtype) * x)
    s = t[0]
    for i in range(1, t.shape[0]):
        s = s + t[i]
    return A * x.shape[0] + s


def rastrigin(data, x):
    """The per-cell form, of one ``x [n]``: the same expression."""
    return rastrigin_batched(data, x)


def density(n_dim: int = CUDA_DIM) -> CudaDensity:
    """The kernel objective ``csrc/densities/rastrigin.cuh`` with its
    float32 constants (A·n, A, 2π)."""
    if n_dim != CUDA_DIM:
        raise ValueError(f"the CUDA Rastrigin objective is built for n = "
                         f"{CUDA_DIM}, not {n_dim}")
    return CudaDensity("rastrigin", (dists.f32(A * n_dim), dists.f32(A),
                                     dists.f32(2.0 * math.pi)))


def make(n_dim=2, Np=6, n_groups=1, dtype=np.float64, **de_kwargs):
    """``(model, de)`` of the JAX ``make``: the ``n_dim``-dimensional
    Rastrigin, minimized with the objective alone, float64 by default;
    the model names its CUDA objective at ``n_dim = 2``."""
    def sample_prior(uniform, n):
        return [(-5.0 + 10.0 * uniform(n_dim)).T]

    model = DEModel(loglike=rastrigin, loglike_batched=rastrigin_batched,
                    sample_prior=sample_prior, names=NAMES, data=None,
                    cuda_density=density() if n_dim == CUDA_DIM else None)
    kw = dict(bounds=BOUNDS, Np=Np, n_groups=n_groups,
              update_particle="minimize", evaluate_fitness="fun",
              dtype=dtype)
    kw.update(de_kwargs)
    return model, DE(**kw)
