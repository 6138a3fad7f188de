"""Batched DE proposal pieces in plain torch (port of
``demcmc_tpu.ops.proposals``).

Tensors are group-shaped: ``[G, Np]`` per chain, ``[G, Np, d]`` for
parameters.  Two families live here:

* the kernels' forms (``partner_indices`` .. ``kernel_snooker_log_adj``,
  ``resample_flat_indices``): values from word rows by the TPU kernel's
  draw-to-value rules (``demcmc_tpu/ops/fused_step.py``), the plain
  versions of K1 and K3 and so their oracle;
* the unfused step's strategies (``ProposalContext`` .. ``snooker_log_adj``,
  the JAX names and signatures): draws from an
  :class:`~demcmc_tpu_torch.rng.Pool` in the JAX XLA step's call order, so
  the port's unfused step can be fed the JAX pool's words.  A custom
  strategy slot receives the context and a
  :class:`~demcmc_tpu_torch.rng.Key` and may delegate to the public
  built-ins (``random_gamma``, ``fixed_gamma``, ``variable_gamma``,
  ``snooker``, ``sample_current``, ``resample``), which take the key for
  the JAX signature and draw from ``ctx.draws`` exactly as when the step
  calls them.
"""

from __future__ import annotations

import inspect
import math
from dataclasses import dataclass, field
from typing import Any, Optional

import numpy as np
import torch

from .. import rng
from ..utils.dists import const, f32

GAMMA_FIXED = 2.38
# the min-mode base select clamps +inf weights to this before the softmax
# (fused_step.py:2289-2293)
MIN_MODE_CLAMP = f32(3.0e38)


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


def select_base(weight, u_b, clamp: bool = False):
    """Base slot per chain ∝ softmax(weight) over its group by inverse CDF
    (reference ``crossover.jl:282-289``; ``fused_step.py:2287-2311``):
    the number of group members whose scanned CDF lies below
    ``max(u_b, tiny) · total``, clamped to ``Np - 1``.  ``clamp`` (min
    mode, whose out-of-bounds weights are ``+inf``) first lowers the
    weights to ``MIN_MODE_CLAMP`` (``:2289-2293``), so the softmax stays
    finite."""
    Np = weight.shape[1]
    if clamp:
        weight = torch.clamp_max(weight, MIN_MODE_CLAMP)
    mx = seg_scan(weight, torch.maximum)[:, -1:]
    mx = torch.where(torch.isfinite(mx), mx, torch.zeros_like(mx))
    q = seg_scan(torch.exp(weight - mx), torch.add)
    u_bs = torch.clamp_min(u_b, rng.TINY) * q[:, -1:]
    cnt = (q[:, None, :] < u_bs[:, :, None]).sum(-1)
    return torch.clamp_max(cnt, Np - 1)


def kernel_random_gamma(theta, pm, pn, g1, bterm):
    """DE proposal with γ₁ ~ U(0.5, 1) and the burn-in base term
    (reference ``crossover.jl:158-168``)."""
    return theta + g1[..., None] * (pm - pn) + bterm


def kernel_fixed_gamma(theta, pm, pn):
    """DE proposal with γ = 2.38."""
    return theta + gamma_scale("fixed_gamma", theta.shape[-1]) * (pm - pn)


def kernel_variable_gamma(theta, pm, pn):
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


def kernel_snooker(theta, pz, pm, pn, gamma):
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


def kernel_snooker_log_adj(prop, pz, den0, degen, d: int):
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
            a = a + (a >= s)
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


# ------------------------------------------ the unfused step's strategies


@dataclass
class ProposalContext:
    """What a proposal strategy of the unfused step reads (``demcmc_tpu/
    ops/proposals.py:39``, its fields in its order): the configuration and
    the parameter spec, the group-shaped population ``theta [G, Np, d]``
    and ``weight [G, Np]``, the 1-based iteration (a host int), for DE-MCz
    the ``history [H, C, d]`` of past states, the iteration's
    :class:`~demcmc_tpu_torch.rng.Pool` and, where a custom slot runs, the
    :class:`~demcmc_tpu_torch.rng.Key` of the sweep (``key``)."""

    de: Any
    spec: Any
    theta: torch.Tensor
    weight: torch.Tensor
    iteration: int
    history: Optional[torch.Tensor] = None
    draws: Any = None
    key: Any = None
    # next_key()'s counter in a shared one-element list: dataclasses.replace
    # copies the reference, so the count survives copies of the context
    # (demcmc_tpu/ops/proposals.py:49-52)
    _key_count: list = field(default_factory=lambda: [0])

    @property
    def dim(self) -> int:
        return self.theta.shape[-1]

    def next_key(self):
        """A fresh key for custom strategy code, distinct at each call
        within the step, copies of the context included: ``key`` folded
        with ``NEXT_KEY`` and the call's count (``demcmc_tpu/ops/
        proposals.py:60-71``)."""
        if self.key is None:
            raise ValueError(
                "ProposalContext.key is not set: custom strategy slots "
                "need a key; construct the context with key=...")
        self._key_count[0] += 1
        return self.key.fold_in(rng.NEXT_KEY).fold_in(self._key_count[0])

    def partners(self, n: int, exclude_self: bool, replace: bool = False):
        """``n`` partner populations ``[n, G, Np, d]`` from the ``sample``
        slot: the current group (:func:`sample_current`), the history
        (:func:`resample`, DE-MCz) or a custom slot, called with a fresh
        key as ``slot(ctx, key, n, exclude_self[, replace])``, ``replace``
        passed where it takes five positionals (``demcmc_tpu/ops/
        proposals.py:72-121``)."""
        slot = self.de.sample
        if callable(slot):
            if _slot_takes_replace(slot):
                return slot(self, self.next_key(), n, exclude_self, replace)
            return slot(self, self.next_key(), n, exclude_self)
        if self.de.uses_resample:
            return resample(self, None, n, exclude_self, replace)
        return sample_current(self, None, n, exclude_self, replace)


def _slot_takes_replace(slot) -> bool:
    """True where a custom ``sample`` slot takes a fifth positional
    (``replace``; ``demcmc_tpu/ops/proposals.py:126``)."""
    try:
        params = inspect.signature(slot).parameters.values()
    except (TypeError, ValueError):
        return False
    n_pos = sum(p.kind in (p.POSITIONAL_ONLY, p.POSITIONAL_OR_KEYWORD)
                for p in params)
    return n_pos >= 5 or any(p.kind == p.VAR_POSITIONAL for p in params)


def _distinct_indices(draws, G: int, Np: int, n: int, exclude_self: bool,
                      replace: bool = False):
    """``[n, G, Np]`` member indices from the group, distinct by the shift
    trick unless ``replace``, skipping the target itself when
    ``exclude_self`` (``demcmc_tpu/ops/proposals.py:121``)."""
    m = Np - 1 if exclude_self else Np
    shape = (G, Np)
    if replace:
        idx = torch.stack([draws.randint(shape, 0, m) for _ in range(n)])
    else:
        if m < n:
            raise ValueError(f"need {n} distinct partners from {m} "
                             f"candidates (Np={Np}, "
                             f"exclude_self={exclude_self})")
        idx = torch.stack(distinct_flat_draws(
            lambda k: draws.randint(shape, 0, m - k), n))
    if exclude_self:
        self_idx = torch.arange(Np, device=idx.device)
        idx = idx + (idx >= self_idx).to(idx.dtype)
    return idx


def _gather_partners(theta, idx):
    """``theta [G, Np, d]``, ``idx [n, G, Np]`` -> ``[n, G, Np, d]``."""
    n = idx.shape[0]
    d = theta.shape[-1]
    src = theta[None].expand((n,) + tuple(theta.shape))
    return torch.gather(src, 2, idx[..., None].expand(-1, -1, -1, d))


def sample_current(ctx: ProposalContext, key, n: int, exclude_self: bool,
                   replace: bool = False):
    """Partners from the current group (``demcmc_tpu/ops/proposals.py:
    200``; reference ``sample``, ``crossover.jl:138-140``), drawn from
    ``ctx.draws``."""
    G, Np = ctx.theta.shape[:2]
    return _gather_partners(ctx.theta, _distinct_indices(
        ctx.draws, G, Np, n, exclude_self, replace))


def resample(ctx: ProposalContext, key, n: int, exclude_self: bool,
             replace: bool = False):
    """DE-MCz partners (``demcmc_tpu/ops/proposals.py:271-295``; reference
    ``resample``, ``crossover.jl:113-124``): ``n`` uniform draws over the
    flat ``count·C`` space of (past row, chain) pairs, ``count = max(it −
    1, 1)``, without replacement unless ``replace`` (the shift trick,
    :func:`distinct_flat_draws`, over the pool's uint32-span draws); the
    target is not excluded.  Returns ``[n, G, Np, d]``."""
    if ctx.history is None:
        raise ValueError("sample='resample' needs the history of past "
                         "states (n_initial > 0)")
    C, d = ctx.history.shape[1:]
    G, Np = ctx.theta.shape[:2]
    rows = (ctx.draws.rows_seen(ctx.iteration)
            if isinstance(ctx.draws, rng.Pool)
            else max(int(ctx.iteration) - 1, 1))
    span = rows * C
    if replace:
        flats = [ctx.draws.randuint((G, Np), span) for _ in range(n)]
    else:
        flats = distinct_flat_draws(
            lambda k: ctx.draws.randuint((G, Np), (span - k) & _U32), n)
    return ctx.history.reshape(-1, d)[torch.stack(flats)]


def select_base_idx(draws, weight, Np: int):
    """Base member per chain ∝ softmax(weight) over its group by inverse
    CDF (``demcmc_tpu/ops/proposals.py:300``): the count of CDF entries
    below ``max(u, tiny) · total``, clamped to ``Np − 1``, ``u`` in the
    weights' dtype; ``-inf`` weights get no mass.  A ``+inf`` weight (an
    out-of-bounds score when minimizing) is not clamped, as in the JAX
    XLA step: its group's maximum is taken as 0, so its CDF is ``inf``
    from there on (the kernels' form, :func:`select_base`, clamps)."""
    G = weight.shape[0]
    m = torch.amax(weight, dim=1, keepdim=True)
    e = torch.exp(weight - torch.where(torch.isfinite(m), m, 0.0))
    q = torch.cumsum(e, dim=1)
    u = torch.clamp_min(draws.uniform((G, Np), dtype=weight.dtype),
                        rng.tiny(weight.dtype)) * q[:, -1:]
    idx = (q[:, None, :] < u[:, :, None]).sum(-1)
    return torch.clamp_max(idx, Np - 1)


def recombination(draws, theta, prop, kappa: float):
    """With probability 1 − κ per scalar, keep the current value
    (``demcmc_tpu/ops/proposals.py:331``); no draw at κ = 1."""
    if kappa >= 1.0:
        return prop
    keep = draws.uniform(tuple(prop.shape)) > f32(1.0 - kappa)
    return torch.where(keep, prop, theta)


def _noise(draws, shape, eps: float, dtype):
    """``U(−ε, ε)`` of ``dtype`` per scalar, or 0.0 (no draw) at ε = 0."""
    if eps == 0.0:
        return 0.0
    return draws.uniform(tuple(shape), -eps, eps, dtype)


def random_gamma(ctx: ProposalContext, key=None):
    """θ′ = θ + γ₁(θm − θn) + γ₂(θb − θ) + b, γ₁, γ₂ ~ U(0.5, 1), γ₂ = 0
    after burn-in (``demcmc_tpu/ops/proposals.py:353``; reference
    ``crossover.jl:154-172``).  Past burn-in the base draw's columns are
    skipped, not computed: the term is γ₂ = 0 times a finite difference.
    The base draw is in the weights' dtype, γ₁, γ₂ and the noise in the
    state's."""
    de, theta, draws = ctx.de, ctx.theta, ctx.draws
    G, Np, d = theta.shape
    dt = theta.dtype
    burn = ctx.iteration <= de.burnin
    if burn:
        bidx = select_base_idx(draws, ctx.weight, Np)
    else:
        draws.skip((G, Np), ctx.weight.dtype)
    pm, pn = ctx.partners(2, exclude_self=True)
    g1 = draws.uniform((G, Np, 1), 0.5, 1.0, dt)
    prop = theta + g1 * (pm - pn)
    if burn:
        g2 = draws.uniform((G, Np, 1), 0.5, 1.0, dt)
        base = _gather_partners(theta, bidx[None])[0]
        prop = prop + g2 * (base - theta)
    else:
        draws.skip((G, Np, 1), dt)
    prop = prop + _noise(draws, theta.shape, de.epsilon, dt)
    return recombination(draws, theta, prop, de.kappa)


def _plain_de(ctx: ProposalContext, gamma: float):
    dt = ctx.theta.dtype
    pm, pn = ctx.partners(2, exclude_self=True)
    prop = ctx.theta + const(gamma, dt) * (pm - pn) + _noise(
        ctx.draws, ctx.theta.shape, ctx.de.epsilon, dt)
    return recombination(ctx.draws, ctx.theta, prop, ctx.de.kappa)


def fixed_gamma(ctx: ProposalContext, key=None):
    """θ′ = θ + 2.38(θm − θn) + b (reference ``crossover.jl:186-199``)."""
    return _plain_de(ctx, GAMMA_FIXED)


def variable_gamma(ctx: ProposalContext, key=None):
    """θ′ = θ + 2.38/√(2d)(θm − θn) + b (reference
    ``crossover.jl:213-226``)."""
    return _plain_de(ctx, GAMMA_FIXED / math.sqrt(2.0 * ctx.dim))


def _project(p1, p2, p2p2=None):
    """((p1·p2) / (p2·p2)) p2 along the last axis (reference
    ``project``, ``utilities.jl:239-246``; ``demcmc_tpu/ops/proposals.py:
    421``); ``p2p2`` is p2·p2 where the caller has it.  The unfused
    step's sums are one reduction each, as the JAX XLA step's
    ``jnp.sum``, which holds it by tolerance; the kernels' forms sum in
    index order (:func:`dot`)."""
    if p2p2 is None:
        p2p2 = torch.sum(p2 * p2, -1)
    return (torch.sum(p1 * p2, -1) / p2p2)[..., None] * p2


def snooker(ctx: ProposalContext, key=None):
    """Snooker proposal along θ − z (``demcmc_tpu/ops/proposals.py:429``;
    reference ``snooker_update!``, ``crossover.jl:239-257``): (z, m, n)
    distinct members including the target, m and n projected onto θ − z,
    θ′ = θ + γ(r₁ − r₂) + b with γ ~ U(1.2, 2.2).  A draw with z = θ
    (‖θ − z‖² ≤ tiny) is degenerate: its proposal is θ and the caller
    rejects it.  Returns ``(proposal, z, degenerate)``."""
    de, theta, draws = ctx.de, ctx.theta, ctx.draws
    G, Np, d = theta.shape
    pz, pm, pn = ctx.partners(3, exclude_self=False)
    pd = theta - pz
    degenerate = torch.sum(pd * pd, -1) <= rng.tiny(theta.dtype)
    safe = torch.where(degenerate[..., None], 1.0, pd)
    gamma = draws.uniform((G, Np, 1), 1.2, 2.2, theta.dtype)
    ss = torch.sum(safe * safe, -1)
    prop = (theta + gamma * (_project(pm, safe, ss) - _project(pn, safe, ss))
            + _noise(draws, theta.shape, de.epsilon, theta.dtype))
    prop = recombination(draws, theta, prop, de.kappa)
    prop = torch.where(degenerate[..., None], theta, prop)
    return prop, pz, degenerate


def snooker_log_adj(theta, prop, z, dim: int, degenerate):
    """Snooker MH correction (``demcmc_tpu/ops/proposals.py:463``;
    reference ``adjust_loglike``, ``crossover.jl:268-273``): (d − 1)
    (log‖θ′ − z‖ − log‖θ − z‖), ``-inf`` for a degenerate draw."""
    dp, dt = prop - z, theta - z
    a1 = torch.sqrt(torch.sum(dp * dp, -1))
    a2 = torch.sqrt(torch.sum(dt * dt, -1))
    adj = float(dim - 1) * (torch.log(a1) - torch.log(a2))
    return torch.where(degenerate, -math.inf, adj)
