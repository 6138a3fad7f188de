"""Batched DE proposal pieces in plain torch (port of the parts of
``demcmc_tpu.ops.proposals`` the synchronous step needs).

Tensors are group-shaped: ``[G, Np]`` per chain, ``[G, Np, d]`` for
parameters.  Each function reproduces the TPU kernel's draw-to-value
rules (``demcmc_tpu/ops/fused_step.py``), so the plain step can be fed the
same random words as the JAX kernel and as the CUDA kernel.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .. import rng

GAMMA_FIXED = 2.38


def partner_indices(wa, wb, Np: int):
    """Two distinct non-self partner slots from two word rows
    (``fused_step.py:2113-2125``): ``a ~ U{0..Np-2}``, ``b ~ U{0..Np-3}``
    shifted past ``a``, then both shifted past the chain's own slot."""
    p = torch.arange(Np, device=wa.device)
    a = rng.randint(wa, Np - 1)
    b = rng.randint(wb, Np - 2)
    b = b + (b >= a).to(b.dtype)
    a = a + (a >= p).to(a.dtype)
    b = b + (b >= p).to(b.dtype)
    return a, b


def gather_members(theta, idx):
    """``theta [G, Np, d]``, ``idx [G, Np]`` -> ``theta[g, idx[g, p]]``."""
    d = theta.shape[-1]
    return torch.gather(theta, 1, idx[..., None].expand(-1, -1, d))


def seg_scan(x, op):
    """Inclusive Hillis–Steele scan along the group axis of ``x [G, Np]``:
    ``x[p] = op(x[p], x[p-k])`` for ``p >= k``, ``k = 1, 2, 4, ...`` — the
    TPU kernel's ``_seg_scan`` order, which fixes the float rounding."""
    Np = x.shape[1]
    p = torch.arange(Np, device=x.device)
    k = 1
    while k < Np:
        shifted = torch.cat([x[:, :k], x[:, :-k]], dim=1)
        x = torch.where(p >= k, op(x, shifted), x)
        k *= 2
    return x


def select_base(weight, u_b):
    """Base slot per chain ∝ softmax(weight) over its group by inverse CDF
    (reference ``crossover.jl:282-289``; ``fused_step.py:2287-2311``):
    the number of group members whose scanned CDF lies below
    ``max(u_b, tiny) · total``, clamped to ``Np - 1``."""
    Np = weight.shape[1]
    mx = seg_scan(weight, torch.maximum)[:, -1:]
    mx = torch.where(torch.isfinite(mx), mx, torch.zeros_like(mx))
    q = seg_scan(torch.exp(weight - mx), torch.add)
    u_bs = torch.clamp_min(u_b, rng.TINY) * q[:, -1:]
    cnt = (q[:, None, :] < u_bs[:, :, None]).sum(-1)
    return torch.clamp_max(cnt, Np - 1)


def random_gamma(theta, pm, pn, g1, bterm):
    """DE proposal with γ₁ ~ U(0.5, 1) and the burn-in base term
    (reference ``crossover.jl:158-168``)."""
    return theta + g1[..., None] * (pm - pn) + bterm


def fixed_gamma(theta, pm, pn):
    """DE proposal with γ = 2.38."""
    return theta + gamma_scale("fixed_gamma", theta.shape[-1]) * (pm - pn)


def variable_gamma(theta, pm, pn):
    """DE proposal with γ = 2.38 / sqrt(2 d)."""
    return theta + gamma_scale("variable_gamma", theta.shape[-1]) * (pm - pn)


def gamma_scale(name: str, d: int) -> float:
    """The float32 γ of the fixed-scale proposals."""
    if name == "fixed_gamma":
        return float(np.float32(GAMMA_FIXED))
    return float(np.float32(GAMMA_FIXED / math.sqrt(2.0 * d)))
