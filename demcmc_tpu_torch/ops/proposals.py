"""Batched DE proposal pieces in plain torch (port of the parts of
``demcmc_tpu.ops.proposals`` the fused step needs: DE partners, the γ₂
base select, the snooker proposal and its correction, and the DE-MCz
history indices).

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


# --------------------------------------------------------------- snooker


def snooker_indices(wa, wb, wc, Np: int):
    """Three distinct group slots INCLUDING the chain's own, from three word
    rows (``fused_step.py:2332-2339``): ``a ~ U{0..Np-1}``, ``b ~
    U{0..Np-2}`` shifted past ``a``, ``c ~ U{0..Np-3}`` shifted past the
    smaller and then the larger of the two."""
    a = rng.randint(wa, Np)
    b = rng.randint(wb, Np - 1)
    c = rng.randint(wc, Np - 2)
    b = b + (b >= a).to(b.dtype)
    lo, hi = torch.minimum(a, b), torch.maximum(a, b)
    c = c + (c >= lo).to(c.dtype)
    c = c + (c >= hi).to(c.dtype)
    return a, b, c


def dot(x, y):
    """``Σᵢ xᵢ yᵢ`` over the last axis, summed in index order — the order
    the CUDA kernels use, so both round alike."""
    xs, ys = x.unbind(-1), y.unbind(-1)
    s = xs[0] * ys[0]
    for a, b in zip(xs[1:], ys[1:]):
        s = s + a * b
    return s


def project(p1, p2, den):
    """Projection of ``p1`` onto ``p2`` (reference ``project``,
    ``utilities.jl:239-246``) in the kernel's form: ``((p1·p2) / den) p2``
    with ``den = p2·p2`` passed in."""
    return (dot(p1, p2) / den)[..., None] * p2


def snooker(theta, pz, pm, pn, gamma):
    """Snooker proposal along θ − z (``fused_step.py:2342-2351``; reference
    ``snooker_update!``, ``crossover.jl:239-257``): project ``pm`` and
    ``pn`` onto ``θ − z`` and step ``γ (r₁ − r₂)``.  A degenerate draw
    (‖θ − z‖² ≤ tiny: z is the chain itself) projects onto a vector of
    ones instead, so nothing divides by zero.  Returns ``(proposal,
    ‖θ − z‖², degenerate)``."""
    pd = theta - pz
    den0 = dot(pd, pd)
    degen = den0 <= rng.TINY
    safe = torch.where(degen[..., None], torch.ones_like(pd), pd)
    dens = dot(safe, safe)
    r1 = project(pm, safe, dens)
    r2 = project(pn, safe, dens)
    return theta + gamma[..., None] * (r1 - r2), den0, degen


def snooker_log_adj(prop, pz, den0, degen, d: int):
    """Snooker MH correction on the final proposal (reference
    ``adjust_loglike``, ``crossover.jl:268-273``) in the kernel's form
    ``0.5 (d − 1) (log‖θ′ − z‖² − log‖θ − z‖²)`` (``fused_step.py:
    2379-2383``); a degenerate draw gets ``-inf``, an explicit reject."""
    diff = prop - pz
    a1sq = dot(diff, diff)
    adj = float(np.float32(0.5 * (d - 1))) * (torch.log(a1sq)
                                               - torch.log(den0))
    return torch.where(degen, torch.full_like(adj, -math.inf), adj)


# --------------------------------------------------------------- DE-MCz

_U32 = 0xFFFFFFFF


def distinct_flat_draws(draw_fn, n: int):
    """``n`` distinct uniform draws over a flat index space by the shift
    trick (``demcmc_tpu/ops/proposals.py:218-245``): ``draw_fn(k)`` is a
    uniform draw over ``span - k`` (int64 tensors holding uint32 values);
    draw k is bumped past each earlier pick in ascending order, which
    gives exactly uniform ordered tuples without replacement.  Returns a
    list of ``n`` tensors."""
    picks, ordered = [], []
    for k in range(n):
        a = draw_fn(k)
        for s in ordered:
            a = a + (a >= s).to(a.dtype)
        picks.append(a)
        if k + 1 < n:
            out, cur = [], a
            for s in ordered:
                out.append(torch.minimum(cur, s))
                cur = torch.maximum(cur, s)
            ordered = out + [cur]
    return picks


def resample_flat_indices(words, count: int, C: int):
    """DE-MCz partner indices (``demcmc_tpu/ops/proposals.py:248-268``):
    from ``words [n, ...]`` (one word row per pick), ``n`` distinct flat
    indices ``row·C + chain`` over the ``count·C`` (past row, chain) pairs,
    draw k being ``words[k] mod (span − k)``.  The span is uint32 in the
    JAX package; here int64 masked to 32 bits.  Returns ``[n, ...]``
    int64."""
    span = (int(count) * int(C)) & _U32
    w = words.to(torch.int64)
    return torch.stack(distinct_flat_draws(
        lambda k: w[k] % ((span - k) & _U32), w.shape[0]))
