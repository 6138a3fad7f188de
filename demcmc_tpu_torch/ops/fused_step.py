"""One DE iteration: the wrapper of CUDA kernel K1 (``csrc/de_step.cu``)
and the plain PyTorch sweep it shares with K3 (:mod:`.resample_step`).

K1 is the port of the TPU kernel ``demcmc_tpu/ops/fused_step.py::
build_fused_step`` (standard layout, MH, random/fixed/variable γ, the
snooker branch, synchronous or sequential sweep) for one iteration in the
flat ``[C, d]`` layout; the name of this module is kept so the counterpart
is easy to find.  Migration is the separate kernel K2 (:mod:`.migration`),
launched first.

Random words come in the order of the TPU kernel's draw calls
(``fused_step.py:1802-1828``, ``_sweep_tail`` :2248-2451; :func:`draw_rows`):
the 3 migration rows (when α > 0); in the sequential sweep one β-gate row;
then one block of rows per sub-sweep (one block in the synchronous sweep,
Np in the sequential one) holding 2 partner rows, u_b/γ₁/γ₂ (random γ),
the snooker rows (3 member indices, γ and the snooker gate), d rows of ε,
d rows of κ (κ < 1), the β gate (synchronous sweep), 2d Box–Muller rows,
a stochastic model's noise panel (n_sim rows, ``fused_step.py:1824``,
:2422-2427) and the accept row; last the next-iteration gate row — 17
words per chain for the d = 2 Gaussian with default settings.  The
resample variant (K3) has no partner or member-index rows: its partners
come from the history.
Every draw is taken whether or not its branch applies, so the layout is
static.  In normal runs word (row, chain) is Philox(seed, iteration, row,
chain); in bits-in mode (tests) it is read from a ``[n_words, C]`` uint32
tensor — the same tensor the JAX interpret-mode kernel can be fed.
"""

from __future__ import annotations

import ctypes
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
    """First row of each draw in an iteration's words (-1: not drawn).

    Rows of a sub-sweep block are those of member 0; member m adds
    ``m * stride``.  ``gate`` is absolute: inside the block in the
    synchronous sweep, before the blocks in the sequential one."""
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
    triple: int = -1      # snooker member indices az, bz, cz
    snooker: int = -1     # snooker γ, then the snooker gate
    n_members: int = 1    # sub-sweeps per iteration (Np when sequential)
    stride: int = 0       # rows per sub-sweep block
    noise: int = -1       # a stochastic model's noise panel (n_noise rows)
    n_noise: int = 0


def draw_rows(de, d: int, n_noise: int = 0) -> Rows:
    """The per-iteration row layout of ``fused_step.py:1802-1828`` in the
    order ``_sweep_tail`` draws (module docstring); ``n_noise`` uniforms
    per evaluation for a stochastic model."""
    at = [0]

    def take(n, present=True):
        if not present:
            return -1
        r = at[0]
        at[0] += n
        return r

    resample = bool(de.uses_resample)
    seq = bool(de.sequential_sweep)
    snooker = float(de.theta_snooker) > 0.0
    beta = float(de.beta) > 0.0
    alpha = float(de.alpha) if de.n_groups > 1 else 0.0
    mig = take(migration_ops.N_ROWS, alpha > 0.0)
    seq_gate = take(1, beta and seq)
    block = at[0]
    partners = take(2, not resample)
    gamma = take(3, de.generate_proposal == "random_gamma")
    triple = take(3, snooker and not resample)
    sn = take(2, snooker)
    eps = take(d, float(de.epsilon) > 0.0)
    kappa = take(d, float(de.kappa) < 1.0)
    gate = take(1, beta and not seq)
    normal = take(2 * d, beta)
    noise = take(n_noise, n_noise > 0)
    acc = take(1)
    stride = at[0] - block
    n_members = de.Np if seq else 1
    at[0] = block + n_members * stride
    fire = take(1)
    return Rows(mig, partners, gamma, eps, kappa,
                seq_gate if seq else gate, normal, acc, fire, at[0],
                triple, sn, n_members, stride, noise, n_noise)


def _f32(x: float) -> float:
    return float(np.float32(x))


@dataclass(frozen=True)
class StepConfig:
    """Everything K1, K3 and their plain version need besides the state."""
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
    theta_snooker: float = 0.0
    resample: bool = False      # DE-MCz: partners from the history (K3)
    int_dims: Tuple[int, ...] = ()   # integer dimensions, snapped
    _iargs: dict = field(default_factory=dict, compare=False, repr=False)

    @staticmethod
    def make(model, de, spec) -> "StepConfig":
        d = spec.dim
        int_dims = tuple(int(i) for i in np.flatnonzero(spec.int_mask))
        return StepConfig(
            G=de.n_groups, Np=de.Np, d=d, burnin=int(de.burnin),
            proposal=de.generate_proposal,
            eps=float(de.epsilon), kappa=float(de.kappa),
            beta=float(de.beta), sigma=float(de.sigma),
            alpha=float(de.alpha) if de.n_groups > 1 else 0.0,
            lo=tuple(float(v) for v in spec.lo),
            hi=tuple(float(v) for v in spec.hi),
            rows=draw_rows(de, d, model.noise_words),
            density=model.cuda_density,
            theta_snooker=float(de.theta_snooker),
            resample=bool(de.uses_resample), int_dims=int_dims)

    @property
    def random_gamma(self) -> bool:
        return self.proposal == "random_gamma"

    @property
    def n_slots(self) -> int:
        """History partner slots per sub-sweep (resample): the DE pair,
        then the snooker triple."""
        return 5 if self.theta_snooker > 0.0 else 2

    def iargs(self, it: int, seed: int):
        """K1's and K3's integer arguments (``csrc/step_body.cuh``) as a
        ctypes array, built once per seed; a launch rewrites only the
        iteration."""
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
        """K1's and K3's float arguments, the same for every launch."""
        return _build.f32_array(
            [0.0 if self.random_gamma
             else proposal_ops.gamma_scale(self.proposal, self.d),
             _f32(self.eps), _f32(2 * self.eps),
             _f32(1.0 - self.kappa), _f32(self.beta), _f32(self.sigma),
             _f32(self.alpha), *self.lo, *self.hi, *self.density.params])

    @functools.cached_property
    def sweep_args(self):
        """The sweep layout (``csrc/step_body.cuh``): sub-sweeps, rows per
        sub-sweep block, the snooker member-index and snooker rows, the
        integer dimensions as a bit mask and the noise panel's row."""
        r = self.rows
        if self.int_dims and self.int_dims[-1] >= 32:
            raise ValueError("the kernels snap integer dimensions 0..31 "
                             "only (a 32-bit mask)")
        return _build.u32_array([r.n_members, r.stride, r.triple,
                                 r.snooker, sum(1 << i for i in self.int_dims),
                                 r.noise])

    def density_data(self, device):
        """The density's data buffer on ``device`` (or None), passed to the
        kernels as a pointer."""
        return self.density.data_on(device) if self.density else None

    @functools.cached_property
    def theta_snooker_arg(self):
        return ctypes.c_float(_f32(self.theta_snooker))


def group_partners(cfg: StepConfig, words):
    """K1's partner source: the DE pair, and the snooker triple, drawn
    from the words of sub-sweep block ``off`` and read from the current
    group ``th [G, Np, d]``."""
    G, Np, r = cfg.G, cfg.Np, cfg.rows

    def row(i):
        return words[i].view(G, Np)

    def partners(th, member, off):
        a, b = proposal_ops.partner_indices(row(r.partners + off),
                                            row(r.partners + off + 1), Np)
        pm = proposal_ops.gather_members(th, a)
        pn = proposal_ops.gather_members(th, b)
        triple = None
        if r.triple >= 0:
            triple = tuple(proposal_ops.gather_members(th, i) for i in
                           proposal_ops.snooker_indices(
                               row(r.triple + off), row(r.triple + off + 1),
                               row(r.triple + off + 2), Np))
        return pm, pn, triple

    return partners


def sweep_plain(cfg: StepConfig, model, spec, theta, w, fire, it: int,
                words, partners, out=None):
    """The plain sweep of K1 and K3, in place: ``theta [C, d]``, ``w [C]``,
    ``fire [1]`` int32 (overwritten with the next gate), ``words
    [n_words, C]`` uint32, ``partners(th, member, row_offset) -> (pm, pn,
    triple or None)`` the partner source, ``out`` an optional
    ``(theta_row, w_row, acc_row)`` trajectory slot.  Same operations,
    same order as the kernels.

    The sequential sweep runs Np sub-sweeps that each compute every
    chain's proposal from the partly updated group and commit only group
    slot ``member`` (``fused_step.py:2453-2475``); the β gate is drawn
    once per sweep.  Returns each chain's accept margin (``accept.
    mh_accept``, accepted where ≤ 0) from its own sub-sweep ``[C]``."""
    G, Np, d, r = cfg.G, cfg.Np, cfg.d, cfg.rows
    th = theta.view(G, Np, d)
    wg = w.view(G, Np)
    uniforms = rng.to_uni(words)

    def uni(i):
        return uniforms[i].view(G, Np)

    snooker = cfg.theta_snooker > 0.0
    int_mask = None
    if cfg.int_dims:
        int_mask = torch.zeros(d, dtype=torch.bool, device=theta.device)
        int_mask[list(cfg.int_dims)] = True
    gate = uni(r.gate)[:, 0] if r.gate >= 0 else None    # group leader's
    slot = torch.arange(Np, device=theta.device)
    acc_all = margin = None
    for member in range(r.n_members):
        o = member * r.stride
        pm, pn, triple = partners(th, member, o)
        if cfg.random_gamma:
            u_b = uni(r.gamma + o)
            g1 = uni(r.gamma + o + 1) * 0.5 + 0.5
            g2 = uni(r.gamma + o + 2) * 0.5 + 0.5
            if it <= cfg.burnin:
                base = proposal_ops.gather_members(
                    th, proposal_ops.select_base(wg, u_b))
                bterm = g2[..., None] * (base - th)
            else:
                bterm = torch.zeros_like(th)
            prop = proposal_ops.kernel_random_gamma(th, pm, pn, g1, bterm)
        else:
            prop = getattr(proposal_ops, "kernel_" + cfg.proposal)(th, pm,
                                                                   pn)
        if snooker:
            pz, pm2, pn2 = triple
            g_sn = uni(r.snooker + o) + _f32(1.2)
            sn_gate = uni(r.snooker + o + 1) <= _f32(cfg.theta_snooker)
            p_sn, den0, degen = proposal_ops.kernel_snooker(
                th, pz, pm2, pn2, g_sn)
            prop = torch.where(sn_gate[..., None], p_sn, prop)
        if r.eps >= 0:
            u = torch.stack([uni(r.eps + o + i) for i in range(d)], -1)
            prop = prop + (u * _f32(2 * cfg.eps) - _f32(cfg.eps))
        if r.kappa >= 0:
            u = torch.stack([uni(r.kappa + o + i) for i in range(d)], -1)
            prop = torch.where(u > _f32(1.0 - cfg.kappa), prop, th)
        log_adj = None
        if snooker:
            prop = torch.where((sn_gate & degen)[..., None], th, prop)
            adj = proposal_ops.kernel_snooker_log_adj(prop, pz, den0,
                                                      degen, d)
            log_adj = torch.where(sn_gate, adj, torch.zeros_like(adj))
        if gate is not None:
            u1 = torch.stack([uni(r.normal + o + i) for i in range(d)], -1)
            u2 = torch.stack([uni(r.normal + o + d + i) for i in range(d)],
                             -1)
            nrm = mutation_ops.box_muller(u1, u2)
            prop = mutation_ops.kernel_mutate(th, prop, gate, nrm,
                                              cfg.beta, cfg.sigma)
            if log_adj is not None:
                mut = (gate <= _f32(cfg.beta))[:, None]
                log_adj = torch.where(mut, torch.zeros_like(log_adj),
                                      log_adj)
        if int_mask is not None:
            # integer snap (fused_step.py:2402-2410), round half to even
            prop = torch.where(int_mask, torch.round(prop), prop)
        noise = None
        if r.noise >= 0:
            noise = uniforms[r.noise + o:r.noise + o + r.n_noise].view(
                r.n_noise, G, Np)
        w_prop = accept_ops.compute_posterior(model, spec, prop, noise)
        u_acc = uni(r.accept + o)
        acc, mg = accept_ops.mh_accept(w_prop, wg, u_acc, log_adj)
        if r.n_members > 1:
            mine = slot == member
            acc = acc & mine
            margin = mg if margin is None else torch.where(mine, mg, margin)
        else:
            margin = mg
        th = torch.where(acc[..., None], prop, th)
        wg = torch.where(acc, w_prop, wg)
        acc_all = acc if acc_all is None else acc_all | acc
    new_t, new_w = th.reshape(-1, d), wg.reshape(-1)
    uf = uniforms[r.fire, :1]
    nfire = ((uf <= _f32(cfg.alpha)) & (cfg.alpha > 0.0)).to(torch.int32)
    theta.copy_(new_t)
    w.copy_(new_w)
    fire.copy_(nfire)
    if out is not None:
        out[0].copy_(new_t)
        out[1].copy_(new_w)
        out[2].copy_(acc_all.view(-1))
    return margin.view(-1)


def de_step_plain(cfg: StepConfig, model, spec, theta, w, fire, it: int,
                  words, out=None):
    """Plain version of K1, in place (:func:`sweep_plain` with partners
    from the current group).  Returns each chain's accept margin."""
    return sweep_plain(cfg, model, spec, theta, w, fire, it, words,
                       group_partners(cfg, words), out)


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
    if cfg.resample:
        raise ValueError("a resample configuration steps with "
                         "resample_step (K3), not de_step")
    if theta.device.type == "cpu":
        words = (bits if bits is not None
                 else rng.words(seed, it, cfg.rows.n_words, C))
        de_step_plain(cfg, model, spec, theta, w, fire, it, words, out)
        return
    if check:
        check_cuda(cfg, theta, w, fire, bits, out)
    lib = _build.library("de_step")
    name = _build.entry("de_step", cfg.density)
    o_t, o_w, o_a = (None, None, None) if out is None else (
        out[0].data_ptr(), out[1].data_ptr(), out[2].data_ptr())
    rc = getattr(lib, name)(
        theta.data_ptr(), w.data_ptr(), o_t, o_w, o_a, fire.data_ptr(),
        None if bits is None else bits.data_ptr(),
        cfg.iargs(it, seed), cfg.fargs, cfg.sweep_args,
        cfg.theta_snooker_arg, _ptr(cfg.density_data(theta.device)),
        torch.cuda.current_stream(theta.device).cuda_stream)
    de_step.launches += 1
    _build.check(lib, rc, name)


de_step.launches = 0


def _ptr(t):
    return None if t is None else t.data_ptr()


def check_cuda(cfg, theta, w, fire, bits=None, out=None, what="de_step"):
    """Raise unless the tensors are what K1 (or K3) takes on a CUDA
    device."""
    dev = theta.device
    if dev.type != "cuda":
        raise ValueError(f"{what} runs on cpu or cuda, not {dev}")
    _build.entry(what, cfg.density)
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
