"""One DE iteration: the wrapper of CUDA kernel K1 (``csrc/de_step.cu``)
and its plain PyTorch version.

K1 is the port of the TPU kernel ``demcmc_tpu/ops/fused_step.py::
build_fused_step`` (standard layout, synchronous sweep, MH, random/fixed/
variable γ, no snooker) for one iteration in the flat ``[C, d]`` layout;
the name of this module is kept so the counterpart is easy to find.
Migration is the separate kernel K2 (:mod:`.migration`), launched first.

Random words come in the TPU kernel's static row order
(``fused_step.py:1802-1828``; :func:`draw_rows`): the 3 migration rows
(when α > 0), then 2 partner rows, u_b/γ₁/γ₂ (random γ), d rows of ε,
d rows of κ (κ < 1), the mutation gate, 2d Box–Muller rows, the accept
row and the next-iteration gate row — 17 words per chain for the d = 2
Gaussian.  Every draw is taken whether or not its branch applies, so the
layout is static.  In normal runs word (row, chain) is Philox(seed,
iteration, row, chain); in bits-in mode (tests) it is read from a
``[n_words, C]`` uint32 tensor — the same tensor the JAX interpret-mode
kernel can be fed.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass, field
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from .. import rng
from . import _build
from . import accept as accept_ops
from . import migration as migration_ops
from . import mutation as mutation_ops
from . import proposals as proposal_ops


class Rows(NamedTuple):
    """First row of each draw in an iteration's words (-1: not drawn)."""
    mig: int
    partners: int
    gamma: int
    eps: int
    kappa: int
    gate: int
    normal: int
    accept: int
    fire: int
    n_words: int


def draw_rows(de, d: int) -> Rows:
    """The per-iteration row layout of ``fused_step.py:1802-1828`` for the
    synchronous, snooker-free, resample-free sweep."""
    at = [0]

    def take(n, present=True):
        if not present:
            return -1
        r = at[0]
        at[0] += n
        return r

    alpha = float(de.alpha) if de.n_groups > 1 else 0.0
    mig = take(migration_ops.N_ROWS, alpha > 0.0)
    partners = take(2)
    gamma = take(3, de.generate_proposal == "random_gamma")
    eps = take(d, float(de.epsilon) > 0.0)
    kappa = take(d, float(de.kappa) < 1.0)
    gate = take(1, float(de.beta) > 0.0)
    normal = take(2 * d, float(de.beta) > 0.0)
    acc = take(1)
    fire = take(1)
    return Rows(mig, partners, gamma, eps, kappa, gate, normal, acc, fire,
                at[0])


def _f32(x: float) -> float:
    return float(np.float32(x))


@dataclass(frozen=True)
class StepConfig:
    """Everything K1 and its plain version need besides the state."""
    G: int
    Np: int
    d: int
    burnin: int
    proposal: str               # random_gamma | fixed_gamma | variable_gamma
    eps: float
    kappa: float
    beta: float
    sigma: float
    alpha: float
    lo: Tuple[float, ...]
    hi: Tuple[float, ...]
    rows: Rows
    density: Optional[object]   # model.CudaDensity or None
    _iargs: dict = field(default_factory=dict, compare=False, repr=False)

    @staticmethod
    def make(model, de, spec) -> "StepConfig":
        d = spec.dim
        return StepConfig(
            G=de.n_groups, Np=de.Np, d=d, burnin=int(de.burnin),
            proposal=de.generate_proposal,
            eps=float(de.epsilon), kappa=float(de.kappa),
            beta=float(de.beta), sigma=float(de.sigma),
            alpha=float(de.alpha) if de.n_groups > 1 else 0.0,
            lo=tuple(float(v) for v in spec.lo),
            hi=tuple(float(v) for v in spec.hi),
            rows=draw_rows(de, d), density=model.cuda_density)

    @property
    def random_gamma(self) -> bool:
        return self.proposal == "random_gamma"

    def iargs(self, it: int, seed: int):
        """K1's integer arguments (``csrc/de_step.cu``) as a ctypes array,
        built once per seed; a launch rewrites only the iteration."""
        a = self._iargs.get(seed)
        if a is None:
            k0, k1 = rng.seed_key(seed)
            r = self.rows
            a = self._iargs[seed] = _build.u32_array(
                [self.G, self.Np, it, self.burnin, int(self.random_gamma),
                 k0, k1, r.partners, r.gamma, r.eps, r.kappa, r.gate,
                 r.normal, r.accept, r.fire])
        a[2] = it & 0xFFFFFFFF
        return a

    @functools.cached_property
    def fargs(self):
        """K1's float arguments, the same for every launch."""
        return _build.f32_array(
            [0.0 if self.random_gamma
             else proposal_ops.gamma_scale(self.proposal, self.d),
             _f32(self.eps), _f32(2 * self.eps),
             _f32(1.0 - self.kappa), _f32(self.beta), _f32(self.sigma),
             _f32(self.alpha), *self.lo, *self.hi, *self.density.params])


def de_step_plain(cfg: StepConfig, model, spec, theta, w, fire, it: int,
                  words, out=None):
    """Plain version of K1, in place: ``theta [C, d]``, ``w [C]``,
    ``fire [1]`` int32 (overwritten with the next gate), ``words
    [n_words, C]`` uint32, ``out`` an optional ``(theta_row, w_row,
    acc_row)`` trajectory slot.  Same operations, same order as K1.

    Returns each chain's accept margin ``log max(u, tiny) − Δ`` ``[C]``
    (accepted where ≤ 0), which comparisons use to spot near-ties."""
    G, Np, d, r = cfg.G, cfg.Np, cfg.d, cfg.rows
    th = theta.view(G, Np, d)
    wg = w.view(G, Np)

    uniforms = rng.to_uni(words)

    def row(i):
        return words[i].view(G, Np)

    def uni(i):
        return uniforms[i].view(G, Np)

    a, b = proposal_ops.partner_indices(row(r.partners),
                                        row(r.partners + 1), Np)
    pm = proposal_ops.gather_members(th, a)
    pn = proposal_ops.gather_members(th, b)
    if cfg.random_gamma:
        u_b = uni(r.gamma)
        g1 = uni(r.gamma + 1) * 0.5 + 0.5
        g2 = uni(r.gamma + 2) * 0.5 + 0.5
        if it <= cfg.burnin:
            base = proposal_ops.gather_members(
                th, proposal_ops.select_base(wg, u_b))
            bterm = g2[..., None] * (base - th)
        else:
            bterm = torch.zeros_like(th)
        prop = proposal_ops.random_gamma(th, pm, pn, g1, bterm)
    else:
        prop = getattr(proposal_ops, cfg.proposal)(th, pm, pn)
    if r.eps >= 0:
        u = torch.stack([uni(r.eps + i) for i in range(d)], -1)
        prop = prop + (u * _f32(2 * cfg.eps) - _f32(cfg.eps))
    if r.kappa >= 0:
        u = torch.stack([uni(r.kappa + i) for i in range(d)], -1)
        prop = torch.where(u > _f32(1.0 - cfg.kappa), prop, th)
    if r.gate >= 0:
        gate = uni(r.gate)[:, 0]                       # group leader's word
        u1 = torch.stack([uni(r.normal + i) for i in range(d)], -1)
        u2 = torch.stack([uni(r.normal + d + i) for i in range(d)], -1)
        nrm = mutation_ops.box_muller(u1, u2)
        prop = mutation_ops.mutate(th, prop, gate, nrm, cfg.beta, cfg.sigma)
    w_prop = accept_ops.compute_posterior(model, spec, prop)
    u_acc = uni(r.accept)
    acc = accept_ops.mh_accept(w_prop, wg, u_acc)
    margin = torch.log(torch.clamp_min(u_acc, rng.TINY)) - (w_prop - wg)
    new_t = torch.where(acc[..., None], prop, th).view(-1, d)
    new_w = torch.where(acc, w_prop, wg).view(-1)
    uf = uniforms[r.fire, :1]
    nfire = ((uf <= _f32(cfg.alpha)) & (cfg.alpha > 0.0)).to(torch.int32)
    theta.copy_(new_t)
    w.copy_(new_w)
    fire.copy_(nfire)
    if out is not None:
        out[0].copy_(new_t)
        out[1].copy_(new_w)
        out[2].copy_(acc.view(-1))
    return margin.view(-1)


def de_step(cfg: StepConfig, model, spec, theta, w, fire, it: int,
            seed: int = 0, out=None, bits=None, check: bool = True):
    """One DE iteration in place on ``theta [C, d]`` / ``w [C]``; writes
    the next migration gate into ``fire [1]`` and, with ``out =
    (theta_row [C, d], w_row [C], acc_row [C] bool)``, the trajectory row.

    Words are Philox(seed, it) or, in bits-in mode, ``bits [n_words, C]``
    uint32.  CPU tensors take the plain version; CUDA tensors launch K1
    (``de_step.launches`` counts the launches).  ``check=False`` skips the
    tensor checks, for a caller that made them once for a run
    (:func:`check_cuda`)."""
    C = cfg.G * cfg.Np
    if theta.device.type == "cpu":
        words = (bits if bits is not None
                 else rng.words(seed, it, cfg.rows.n_words, C))
        de_step_plain(cfg, model, spec, theta, w, fire, it, words, out)
        return
    if check:
        check_cuda(cfg, theta, w, fire, bits, out)
    lib = _build.library("de_step")
    fn = getattr(lib, f"de_step_{cfg.density.name}")
    o_t, o_w, o_a = (None, None, None) if out is None else (
        out[0].data_ptr(), out[1].data_ptr(), out[2].data_ptr())
    rc = fn(theta.data_ptr(), w.data_ptr(), o_t, o_w, o_a, fire.data_ptr(),
            None if bits is None else bits.data_ptr(),
            cfg.iargs(it, seed), cfg.fargs,
            torch.cuda.current_stream(theta.device).cuda_stream)
    de_step.launches += 1
    _build.check(lib, rc, f"de_step_{cfg.density.name}")


de_step.launches = 0


def check_cuda(cfg, theta, w, fire, bits=None, out=None):
    """Raise unless the tensors are what K1 takes on a CUDA device."""
    dev = theta.device
    if dev.type != "cuda":
        raise ValueError(f"de_step runs on cpu or cuda, not {dev}")
    if cfg.density is None:
        raise ValueError("the model names no CUDA density "
                         "(DEModel.cuda_density); run it with device='cpu'")
    C, d = cfg.G * cfg.Np, cfg.d
    want = [("theta", theta, torch.float32, (C, d)),
            ("w", w, torch.float32, (C,)),
            ("fire", fire, torch.int32, (1,))]
    if bits is not None:
        want.append(("bits", bits, torch.uint32, (cfg.rows.n_words, C)))
    if out is not None:
        want += [("out[0]", out[0], torch.float32, (C, d)),
                 ("out[1]", out[1], torch.float32, (C,)),
                 ("out[2]", out[2], torch.bool, (C,))]
    for name, t, dt, shape in want:
        if (t.device != dev or t.dtype != dt or tuple(t.shape) != shape
                or not t.is_contiguous()):
            raise ValueError(f"{name}: need a contiguous {dt} {shape} tensor "
                             f"on {dev}, got {t.dtype} {tuple(t.shape)} on "
                             f"{t.device}")


def philox_words_cuda(out, seed: int, it: int, ns: int = rng.STEP_NS):
    """Fill ``out [n_rows, n]`` (uint32, CUDA) with the device Philox words
    ``(seed, it, row, chain)`` of namespace ``ns`` — the generator K1 and
    K2 run, exposed so it can be held against :func:`rng.words`."""
    if out.device.type != "cuda" or out.dtype != torch.uint32 \
            or out.dim() != 2 or not out.is_contiguous():
        raise ValueError("out: need a contiguous 2-D uint32 CUDA tensor")
    lib = _build.library("de_step")
    k0, k1 = rng.seed_key(seed)
    rc = lib.philox_fill(out.data_ptr(), out.shape[0], out.shape[1], k0, k1,
                         int(it), int(ns),
                         torch.cuda.current_stream(out.device).cuda_stream)
    _build.check(lib, rc, "philox_fill")
