"""A window of DE iterations: the wrapper of CUDA kernel K1
(``csrc/de_step.cu``) and the plain PyTorch sweep it shares with K3
(:mod:`.resample_step`).

K1 is the port of the TPU kernel ``demcmc_tpu/ops/fused_step.py::
build_fused_step`` (standard layout, random/fixed/variable γ, the
snooker branch, synchronous or sequential sweep, the MH accept or, for
optimization, the greedy max/min accept on the objective alone,
``:2429-2445``) in the flat ``[C, d]`` layout; the name of this module
is kept so the counterpart is easy to find.  Like the TPU kernel's grid
over K (``fused_step.py:2618``), one launch runs a window of ``K``
iterations, storing the trajectory rows of its emission rule
``(emit_first, emit_stride)``: local iteration k is stored iff ``k >= emit_first`` and ``(k - emit_first) % emit_stride ==
0`` (``emit='all'`` is ``(0, 1)``, ``'last'`` ``(K - 1, 1)``, ``('stride',
s)`` ``(s - 1, s)``), and with ``phase='post'`` (``:2250-2276``) past
burn-in without the γ₂ base select.  Migration is the separate kernel K2
(:mod:`.migration`), launched between windows: a window never holds an
open migration gate before its last iteration (``sampler.plan_windows``
cuts it there), so it is bitwise equal to K one-iteration launches.

Random words come in the order of the TPU kernel's draw calls
(``fused_step.py:1802-1828``, ``_sweep_tail`` :2248-2451; :func:`draw_rows`):
the 3 migration rows (when α > 0); in the sequential sweep one β-gate row;
then one block of rows per sub-sweep (one block in the synchronous sweep,
Np in the sequential one) holding 2 partner rows, u_b/γ₁/γ₂ (random γ),
the snooker rows (3 member indices, γ and the snooker gate), d rows of ε,
d rows of κ (κ < 1), the β gate (synchronous sweep), 2d Box–Muller rows,
a stochastic model's noise panel (n_sim rows, ``fused_step.py:1824``,
:2422-2427) and the accept row (read in every accept mode, so the layout
does not depend on it, ``:2436``); last the next-iteration gate row — 17
words per chain for the d = 2 Gaussian with default settings.  With
constant blocks (``:2479-2488``) everything between the migration rows
and the gate row repeats once per block sweep (``:1827``), and each
block's mask keeps the crossover or snooker proposal to its dimensions.
The resample variant (K3) has no partner or member-index rows: its
partners come from the history.
Every draw is taken whether or not its branch applies, so the layout is
static.  In normal runs word (row, chain) is Philox(seed, iteration, row,
chain); in bits-in mode (tests) a window reads iteration k's words from
rows ``k·n_words ..`` of a ``[K·n_words, C]`` uint32 tensor — the same
tensor the JAX interpret-mode kernel is fed (``fused_step.py:2717-2735``).

Under a chain mesh (``sampler.ShardedStep``) each shard holds a contiguous
run of whole groups (:func:`shard_groups`) and K1 runs on it alone
(:func:`local_config`, ``de_step(..., chain0=)``): groups do not interact
within a window, and chain ``c`` of a shard draws the words of chain
``chain0 + c`` of the population, the migration gate those of chain 0, so
the shards together are the unsharded launch bit for bit.  The JAX
package's ``sharded_supported`` (``demcmc_tpu/ops/fused_step.py:399-
418``) asks for ``Gr % D == 0``, a rule of the TPU's lane-packed layout,
which the port does not use; here a configuration runs sharded where it
runs unsharded (``sampler.fused_supported`` depends on the group, not on
how many groups a launch holds).

A replicated launch (``sampler.sample_replicated`` and its packed and
optimization twins; :func:`de_step_rep`, ``csrc/de_step_rep.cu``) runs R
replications' populations side by side, group-contiguous, in one launch:
``StepConfig.reps`` (:class:`Replicas`) gives each replication its seed,
its row of the density table and its gate ``fire[r]``, and the plain
version steps each replication with its own model's torch density.
"""

from __future__ import annotations

import ctypes
import functools
import math
from dataclasses import dataclass, field, replace
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from .. import rng
from ..config import _blocking_const
from . import _build
from . import accept as accept_ops
from . import migration as migration_ops
from . import mutation as mutation_ops
from . import proposals as proposal_ops


@dataclass(frozen=True)
class Replicas:
    """The replication table of a replicated K1 launch (``sampler.
    sample_replicated``, ``sample_replicated_packed``): the population is
    ``n_reps`` replications of ``c_rep`` chains each, group-contiguous
    (replication r owns chains ``r·c_rep .. (r+1)·c_rep − 1``, whole
    groups), replication r's words keyed by ``seeds[r]`` with chain words
    local to it (``local``: chain ``c − r·c_rep``, so each replication is
    its solo run) or the population's (a packed run: every seed the same),
    its density built from row r of ``table``
    (:class:`~demcmc_tpu_torch.model.DensityTable`) and, in the plain
    version, scored by ``models[r]``'s torch density; K1 writes its gate
    into ``fire[r]``."""
    seeds: Tuple[int, ...]
    local: bool
    c_rep: int
    table: object                 # model.DensityTable
    models: tuple = field(compare=False, repr=False)
    _keys: dict = field(default_factory=dict, compare=False, repr=False)

    @property
    def n_reps(self) -> int:
        return len(self.seeds)

    def keys_on(self, device) -> torch.Tensor:
        """The ``[R, 2]`` uint32 Philox key table on ``device``, made once
        per device: row r the two words of ``seeds[r]``."""
        key = str(torch.device(device))
        t = self._keys.get(key)
        if t is None:
            k = np.array([rng.seed_key(x) for x in self.seeds], np.int64)
            t = self._keys[key] = torch.tensor(
                k.astype(np.uint32).view(np.int32), device=device).view(
                    torch.uint32)
        return t

    def chain0(self, r: int) -> int:
        """Replication r's first chain word (0 where words are local)."""
        return 0 if self.local else r * self.c_rep


# Iterations per K1 window at most (the JAX package's SUPER_K,
# demcmc_tpu/ops/fused_step.py:121), chosen on an H100 by chip_smoke.py's
# K sweep (PERF.md: on the 4,096-chain Gaussian at α = 0.1, K = 4, 16, 64
# and 256 within a few µs per iteration of each other, 64 the lowest);
# any K gives the same draws.
SUPER_K = 64


MAX_BLOCK_CHAINS = 1024     # threads of one CTA: launch_sweep's Np limit
_block_chains: dict = {}


def block_chains(resample: bool, density, seq: bool, snooker: bool,
                 n_blocks: int, device, mode: str = "mh",
                 rep: bool = False) -> int:
    """Chains one block of K1 (K3 where ``resample``) holds for a
    configuration: on a CUDA device the fewer that its two phases'
    instantiations hold in one block (the threads their registers allow,
    and the stage, d + 1 floats a chain and on the d = 2 densities their
    words' table, within the shared memory a block may opt in to; for a
    density with lanes, the one-thread kernel's, which
    runs the largest groups at one lane a chain), read from the built
    library once per configuration (``csrc/step_body.cuh``
    ``block_chains_of``); on the CPU the launch's static limit,
    :data:`MAX_BLOCK_CHAINS`.  A group must fit one block (a K3 window's
    population: :func:`.resample_step.window_chains`).  ``mode`` is the
    accept mode (``'mh'``, or K1's greedy ``'max'``/``'min'``); ``rep``
    asks of the replicated K1 (:func:`de_step_rep`)."""
    device = torch.device(device)
    if device.type != "cuda":
        return MAX_BLOCK_CHAINS
    kernel = "resample_step" if resample else "de_step"
    name = _build.entry(kernel, density, mode)      # raises if not built
    fn = ("resample_block_chains_" + density.name if resample
          else name.replace("de_step_", "de_step_rep_block_chains_" if rep
                            else "de_step_block_chains_", 1))
    key = (fn, bool(seq), bool(snooker), int(n_blocks), device.index)
    if key not in _block_chains:
        lib = _build.library("de_step_resample" if resample else
                             "de_step_rep" if rep else "de_step")
        n = ctypes.c_int()
        with torch.cuda.device(device):
            rc = getattr(lib, fn)(int(seq), int(snooker), int(n_blocks),
                                  ctypes.byref(n))
        _build.check(lib, rc, fn)
        _block_chains[key] = min(n.value, MAX_BLOCK_CHAINS)
    return _block_chains[key]


def super_k() -> int:
    """Iterations per K1 launch at most (windows are also cut where a
    migration gate opens and at the burn-in boundary)."""
    return SUPER_K


def n_emitted(K: int, emit) -> int:
    """Trajectory rows a window of ``K`` iterations stores under the
    emission rule ``emit = (emit_first, emit_stride)``."""
    first, stride = emit
    if first < 0 or stride < 1:
        raise ValueError(f"emission rule {emit}: need first >= 0 and "
                         f"stride >= 1")
    return 0 if first >= K else (K - 1 - first) // stride + 1


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
    n_blocks: int = 1     # block sweeps per iteration (constant blocks)
    blk_stride: int = 0   # rows per block sweep (its gate and sub-sweeps)


def draw_rows(de, d: int, n_noise: int = 0, n_blocks: int = 1) -> Rows:
    """The per-iteration row layout of ``fused_step.py:1802-1828`` in the
    order ``_sweep_tail`` draws (module docstring); ``n_noise`` uniforms
    per evaluation for a stochastic model; ``n_blocks`` block sweeps, each
    with its own rows (``n_words`` times the block count, :1827), the
    migration rows before them and the gate row after."""
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
    blk0 = at[0]
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
    blk_stride = at[0] - blk0
    at[0] = blk0 + max(n_blocks, 1) * blk_stride
    fire = take(1)
    return Rows(mig, partners, gamma, eps, kappa,
                seq_gate if seq else gate, normal, acc, fire, at[0],
                triple, sn, n_members, stride, noise, n_noise,
                max(n_blocks, 1), blk_stride)


def const_blocks(de) -> tuple:
    """The blocks every iteration sweeps (constant-True ``blocking_on``),
    else ``()``: constant False never applies them, and a callable
    ``blocking_on`` decides per iteration, which the kernels do not take
    (the JAX kernel's gate, ``fused_step.py:218-221``)."""
    if de.blocks is not None and _blocking_const(de) is True:
        return tuple(de.blocks)
    return ()


def _f32(x: float) -> float:
    return float(np.float32(x))


def accept_mode(de) -> str:
    """The kernels' accept mode of a configuration (the TPU kernel's
    ``mode``, ``fused_step.py:1450-1458``): ``'mh'``, or for optimization
    ``'max'`` or ``'min'``."""
    if de.is_mh:
        return "mh"
    return "min" if de.is_minimize else "max"


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
    # the constant blocks' flat [d] masks, one per block sweep (none: ())
    blocks: Tuple[Tuple[bool, ...], ...] = ()
    mode: str = "mh"            # accept: mh | max | min (accept_mode)
    reps: Optional[Replicas] = None  # a replicated launch's table, or None
    _iargs: dict = field(default_factory=dict, compare=False, repr=False)

    @staticmethod
    def make(model, de, spec) -> "StepConfig":
        from ..sampler import flatten_block
        d = spec.dim
        int_dims = tuple(int(i) for i in np.flatnonzero(spec.int_mask))
        blocks = tuple(tuple(bool(v) for v in flatten_block(spec, b))
                       for b in const_blocks(de))
        return StepConfig(
            G=de.n_groups, Np=de.Np, d=d, burnin=int(de.burnin),
            proposal=de.generate_proposal,
            eps=float(de.epsilon), kappa=float(de.kappa),
            beta=float(de.beta), sigma=float(de.sigma),
            alpha=float(de.alpha) if de.n_groups > 1 else 0.0,
            lo=tuple(float(v) for v in spec.lo),
            hi=tuple(float(v) for v in spec.hi),
            rows=draw_rows(de, d, model.noise_words, len(blocks)),
            density=model.cuda_density,
            theta_snooker=float(de.theta_snooker),
            resample=bool(de.uses_resample), int_dims=int_dims,
            blocks=blocks, mode=accept_mode(de))

    @property
    def random_gamma(self) -> bool:
        return self.proposal == "random_gamma"

    @property
    def n_slots(self) -> int:
        """History partner slots per sub-sweep (resample): the DE pair,
        then the snooker triple."""
        return 5 if self.theta_snooker > 0.0 else 2

    @property
    def n_sets(self) -> int:
        """Partner slot sets per iteration: one per block sweep and
        sub-sweep, block-major (``fused_step.py:2235-2237``)."""
        return self.rows.n_blocks * self.rows.n_members

    def iargs(self, it: int, seed: int, K: int = 1, emit=(0, 1),
              post: bool = False, n_all: int = None):
        """K1's and K3's integer arguments (``csrc/step_body.cuh``) as a
        ctypes array, built once per seed; a launch rewrites only the
        window: its first iteration, K, the emission rule and the phase,
        and the chains of the whole population, ``n_all`` (the width of a
        bits-in buffer; default this launch's ``G·Np``)."""
        a = self._iargs.get(seed)
        if a is None:
            k0, k1 = rng.seed_key(seed)
            r = self.rows
            a = self._iargs[seed] = _build.u32_array(
                [self.G, self.Np, it, self.burnin, int(self.random_gamma),
                 k0, k1, r.partners, r.gamma, r.eps, r.kappa, r.gate,
                 r.normal, r.accept, r.fire, K, *emit, r.n_words,
                 int(post), 0])
        a[2] = it & 0xFFFFFFFF
        a[15], a[16], a[17], a[19] = K, emit[0], emit[1], int(post)
        a[20] = self.G * self.Np if n_all is None else n_all
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
        integer dimensions as a bit mask, the noise panel's row, the block
        sweeps, rows per block sweep and each block's dimensions as a bit
        mask."""
        r = self.rows
        if self.int_dims and self.int_dims[-1] >= 32:
            raise ValueError("the kernels snap integer dimensions 0..31 "
                             "only (a 32-bit mask)")
        if self.blocks and self.d > 32:
            raise ValueError("the kernels take block masks over 32 "
                             "dimensions at most (a 32-bit mask)")
        return _build.u32_array(
            [r.n_members, r.stride, r.triple, r.snooker,
             sum(1 << i for i in self.int_dims), r.noise, r.n_blocks,
             r.blk_stride,
             *(sum(1 << i for i, v in enumerate(m) if v)
               for m in self.blocks)])

    def density_data(self, device):
        """The density's data buffer on ``device`` (or None), passed to the
        kernels as a pointer."""
        return self.density.data_on(device) if self.density else None

    @functools.cached_property
    def theta_snooker_arg(self):
        return ctypes.c_float(_f32(self.theta_snooker))


def shard_groups(G: int, n_shards: int):
    """The groups of each shard of a ``G``-group population split over
    ``n_shards`` devices of a chain mesh: ``[(g0, n), ...]``, contiguous
    runs of whole groups in mesh order, as even as ``torch.tensor_split``
    makes them (the first ``G % n_shards`` one group larger).  Raises
    where a shard would hold no group."""
    if n_shards < 1 or G < n_shards:
        raise ValueError(f"{G} groups cannot be split over {n_shards} "
                         f"devices: every shard needs a group")
    out, g0 = [], 0
    for i in range(n_shards):
        n = G // n_shards + (i < G % n_shards)
        out.append((g0, n))
        g0 += n
    return out


def rep_config(cfg: StepConfig, reps: Replicas) -> StepConfig:
    """The configuration of a replicated K1 launch over ``reps``: ``cfg``
    (one replication's: its groups, row layout and α) on the whole
    population of ``reps.n_reps`` replications, with the table."""
    if reps.c_rep != cfg.G * cfg.Np:
        raise ValueError(f"a replication holds {reps.c_rep} chains; the "
                         f"configuration's groups {cfg.G * cfg.Np}")
    return replace(cfg, G=cfg.G * reps.n_reps, reps=reps, _iargs={})


def solo_config(cfg: StepConfig) -> StepConfig:
    """One replication's configuration of a replicated ``cfg``."""
    return replace(cfg, G=cfg.reps.c_rep // cfg.Np, reps=None, _iargs={})


def local_config(cfg: StepConfig, n_groups: int) -> StepConfig:
    """The configuration K1 runs on one shard of ``n_groups`` groups (the
    JAX ``local_de``, ``demcmc_tpu/ops/fused_step.py:392``): the shard's
    groups, every other field the population's — its row layout (the
    migration rows stay where the population migrates, even on a shard of
    one group) and α, with which each shard writes the population's
    gate."""
    return replace(cfg, G=int(n_groups), _iargs={})


def group_partners(cfg: StepConfig, words):
    """K1's partner source: the DE pair, and the snooker triple, drawn
    from the words of sub-sweep block ``off`` and read from the current
    group ``th [G, Np, d]`` (the slot set is K3's)."""
    G, Np, r = cfg.G, cfg.Np, cfg.rows

    def row(i):
        return words[i].view(G, Np)

    def partners(th, slot_set, off):
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
                words, partners, out=None, gate_word=None):
    """The plain sweep of K1 and K3, in place: ``theta [C, d]``, ``w [C]``,
    ``fire [1]`` int32 (overwritten with the next gate), ``words
    [n_words, C]`` uint32, ``partners(th, slot_set, row_offset) -> (pm,
    pn, triple or None)`` the partner source, ``out`` an optional
    ``(theta_row, w_row, acc_row)`` trajectory slot, ``gate_word [1]``
    the fire row's word of the population's chain 0 (default: of
    ``words``' first column; a shard past the first passes it).  Same
    operations, same order as the kernels.

    The sequential sweep runs Np sub-sweeps that each compute every
    chain's proposal from the partly updated group and commit only group
    slot ``member`` (``fused_step.py:2453-2475``); the β gate is drawn
    once per sweep.  With constant blocks the sweep runs once per block
    (``:2479-2488``), each from the state the earlier blocks left, on its
    own rows and slot sets; the block's mask keeps the crossover or
    snooker proposal to its dimensions before the snooker correction
    (``:2360-2372``), the mutation ignores it, and the last block's
    accepts are recorded.  Returns each chain's accept margin (``accept.
    mh_accept``, accepted where ≤ 0) from its own sub-sweep of the last
    block, ``[C]``.  In the greedy modes (``cfg.mode`` ``'max'``, ``'min'``)
    a proposal is scored by the objective alone (out of bounds or NaN:
    ``∓inf``), accepted by ``>`` or ``<`` with no snooker correction
    (:func:`.accept.greedy_accept`, whose margins are negative where
    accepted), and the min mode clamps the weights of the γ₂ base select
    (:func:`.proposals.select_base`)."""
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
    masks = [torch.tensor(m, device=theta.device) for m in cfg.blocks]
    slot = torch.arange(Np, device=theta.device)
    for blk in range(r.n_blocks):
        bo = blk * r.blk_stride
        gate = uni(r.gate + bo)[:, 0] if r.gate >= 0 else None  # leader's
        acc_all = margin = None
        for member in range(r.n_members):
            o = bo + member * r.stride
            pm, pn, triple = partners(th, blk * r.n_members + member, o)
            if cfg.random_gamma:
                u_b = uni(r.gamma + o)
                g1 = uni(r.gamma + o + 1) * 0.5 + 0.5
                g2 = uni(r.gamma + o + 2) * 0.5 + 0.5
                if it <= cfg.burnin:
                    base = proposal_ops.gather_members(
                        th, proposal_ops.select_base(wg, u_b,
                                                     cfg.mode == "min"))
                    bterm = g2[..., None] * (base - th)
                else:
                    bterm = torch.zeros_like(th)
                prop = proposal_ops.kernel_random_gamma(th, pm, pn, g1,
                                                        bterm)
            else:
                prop = getattr(proposal_ops, "kernel_" + cfg.proposal)(
                    th, pm, pn)
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
                u = torch.stack([uni(r.kappa + o + i) for i in range(d)],
                                -1)
                prop = torch.where(u > _f32(1.0 - cfg.kappa), prop, th)
            if masks:
                prop = torch.where(masks[blk], prop, th)
            log_adj = None
            if snooker:
                prop = torch.where((sn_gate & degen)[..., None], th, prop)
                adj = proposal_ops.kernel_snooker_log_adj(prop, pz, den0,
                                                          degen, d)
                log_adj = torch.where(sn_gate, adj, torch.zeros_like(adj))
            if gate is not None:
                u1 = torch.stack([uni(r.normal + o + i) for i in range(d)],
                                 -1)
                u2 = torch.stack([uni(r.normal + o + d + i)
                                  for i in range(d)], -1)
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
            if cfg.mode == "mh":
                w_prop = accept_ops.compute_posterior(model, spec, None, prop,
                                                      noise)
                acc, mg = accept_ops.mh_accept(w_prop, wg,
                                               uni(r.accept + o), log_adj)
            else:     # greedy: the accept row stays in the layout, unused
                w_prop = accept_ops.objective(
                    model, spec, prop,
                    math.inf if cfg.mode == "min" else -math.inf, noise)
                acc, mg = accept_ops.greedy_accept(w_prop, wg,
                                                   cfg.mode == "min")
            if r.n_members > 1:
                mine = slot == member
                acc = acc & mine
                margin = mg if margin is None else torch.where(mine, mg,
                                                               margin)
            else:
                margin = mg
            th = torch.where(acc[..., None], prop, th)
            wg = torch.where(acc, w_prop, wg)
            acc_all = acc if acc_all is None else acc_all | acc
    new_t, new_w = th.reshape(-1, d), wg.reshape(-1)
    uf = (uniforms[r.fire, :1] if gate_word is None
          else rng.to_uni(gate_word))
    nfire = ((uf <= _f32(cfg.alpha)) & (cfg.alpha > 0.0)).to(torch.int32)
    theta.copy_(new_t)
    w.copy_(new_w)
    fire.copy_(nfire)
    if out is not None:
        out[0].copy_(new_t)
        out[1].copy_(new_w)
        out[2].copy_(acc_all.view(-1))
    return margin.view(-1)


def check_window(cfg: StepConfig, it: int, K: int, emit, phase: str):
    """Raise unless ``(it, K, emit, phase)`` is a window the kernels take:
    K >= 1, a valid emission rule, and ``phase='post'`` only past
    burn-in (the γ₂ base select is left out)."""
    if K < 1:
        raise ValueError(f"a window runs K >= 1 iterations, not {K}")
    n_emitted(K, emit)
    if phase not in ("all", "post"):
        raise ValueError(f"phase must be 'all' or 'post', not {phase!r}")
    if phase == "post" and it <= cfg.burnin:
        raise ValueError(f"phase='post' runs past burn-in only: iteration "
                         f"{it} <= burnin {cfg.burnin}")


def trajectory(cfg: StepConfig, out, K: int, emit):
    """``out`` as ``([T, C, d], [T, C], [T, C])`` views (a ``[C, d]`` row
    is T = 1), T the rows the window stores; None stays None."""
    if out is None:
        return None
    C, d = cfg.G * cfg.Np, cfg.d
    T = n_emitted(K, emit)
    views = (out[0].view(-1, C, d), out[1].view(-1, C), out[2].view(-1, C))
    if any(v.shape[0] != T for v in views):
        raise ValueError(f"the window stores {T} trajectory rows; out holds "
                         f"{views[0].shape[0]}")
    return views


def window_plain(cfg: StepConfig, fire, it: int, K: int, emit, out, one):
    """The plain window of K1 and K3: ``one(k, it_k, slot)`` runs
    iteration ``it_k = it + k`` in place and returns its accept margins,
    writing the trajectory ``slot`` (a ``(θ [C, d], w [C], acc [C])``
    row, or None) where the emission rule stores iteration k.  Raises if
    an iteration before the last writes an open migration gate: the
    sampler cuts windows there (a host read of ``fire`` per iteration).
    Returns the margins, ``[C]`` for K = 1 and ``[K, C]`` above."""
    first, stride = emit
    margins, t = [], 0
    for k in range(K):
        slot = None
        if out is not None and k >= first and (k - first) % stride == 0:
            slot = (out[0][t], out[1][t], out[2][t])
            t += 1
        margins.append(one(k, it + k, slot))
        if k + 1 < K and cfg.alpha > 0.0 and bool(fire[0]):
            raise RuntimeError(
                f"iteration {it + k} opened the migration gate inside a "
                f"window of {K} from {it}: migration must come before "
                f"iteration {it + k + 1} (cut the window there)")
    return margins[0] if K == 1 else torch.stack(margins)


def de_step_plain(cfg: StepConfig, model, spec, theta, w, fire, it: int,
                  words, out=None, K: int = 1, emit=(0, 1),
                  phase: str = "all", seed: int = 0, chain0: int = 0):
    """Plain version of K1 for a window of ``K`` iterations from ``it``,
    in place: :func:`sweep_plain` with partners from the current group,
    iteration by iteration, on chains ``chain0 ..`` of the population
    (``theta [C, d]`` holds them).  ``words [K·n_words, n]`` with the
    population's ``n >= chain0 + C`` columns (None: Philox(seed, it + k));
    ``out`` the window's trajectory slice (:func:`trajectory`).  Returns
    the accept margins (:func:`window_plain`)."""
    check_window(cfg, it, K, emit, phase)
    out = trajectory(cfg, out, K, emit)
    n, C, r = cfg.rows.n_words, cfg.G * cfg.Np, cfg.rows
    if words is not None and words.shape[1] < chain0 + C:
        raise ValueError(f"words: {words.shape[1]} columns, need the "
                         f"population's {chain0 + C} or more")

    def one(k, it_k, slot):
        gate = None
        if words is None:
            wk = rng.words(seed, it_k, n, C, device=theta.device,
                           chain0=chain0)
            if chain0:
                gate = rng.words(seed, it_k, 1, 1, device=theta.device,
                                 row0=r.fire)[0]
        else:
            wk = words[k * n:(k + 1) * n, chain0:chain0 + C]
            gate = words[k * n + r.fire, :1]
        return sweep_plain(cfg, model, spec, theta, w, fire, it_k, wk,
                           group_partners(cfg, wk), slot, gate)

    return window_plain(cfg, fire, it, K, emit, out, one)


def de_step(cfg: StepConfig, model, spec, theta, w, fire, it: int,
            seed: int = 0, out=None, bits=None, check: bool = True,
            K: int = 1, emit=(0, 1), phase: str = "all", chain0: int = 0):
    """A window of ``K`` DE iterations from ``it`` in place on ``theta [C,
    d]`` / ``w [C]``; writes the gate the last iteration draws into ``fire
    [1]`` and, with ``out = (θ [T, C, d], w [T, C], acc [T, C] bool)``
    (for one row also ``[C, d]``, ``[C]``, ``[C]``), the T trajectory rows
    the emission rule ``emit = (emit_first, emit_stride)`` stores;
    ``phase='post'`` (past burn-in only) drops the γ₂ base select.  The
    window must hold no open migration gate before its last iteration.

    ``theta`` may be one shard of the population (``cfg`` its
    :func:`local_config`): chains ``chain0 ..`` of it, whose words it
    draws, the gate from chain 0's.  Words are Philox(seed, it + k) or, in
    bits-in mode, ``bits [K·n_words, n]`` uint32 of the population's ``n``
    chains.  CPU tensors take the plain version; CUDA tensors launch K1
    once (``de_step.launches`` counts the launches).  ``check=False`` skips
    the tensor checks, for a caller that made them once for a run
    (:func:`check_cuda`)."""
    if cfg.resample:
        raise ValueError("a resample configuration steps with "
                         "resample_step (K3), not de_step")
    if cfg.reps is not None:
        raise ValueError("a replicated configuration steps with "
                         "de_step_rep, not de_step")
    if theta.device.type == "cpu":
        de_step_plain(cfg, model, spec, theta, w, fire, it, bits, out, K,
                      emit, phase, seed, chain0)
        return
    check_window(cfg, it, K, emit, phase)
    if check:
        check_cuda(cfg, theta, w, fire, bits, out, K=K, emit=emit,
                   chain0=chain0)
    lib = _build.library("de_step")
    name = _build.entry("de_step", cfg.density, cfg.mode)
    o_t, o_w, o_a = (None, None, None) if out is None else (
        out[0].data_ptr(), out[1].data_ptr(), out[2].data_ptr())
    _build.launch(
        lib, name, theta.device,
        theta.data_ptr(), w.data_ptr(), o_t, o_w, o_a, fire.data_ptr(),
        None if bits is None else bits.data_ptr(),
        cfg.iargs(it, seed, K, emit, phase == "post",
                  None if bits is None else bits.shape[1]),
        cfg.fargs, cfg.sweep_args, cfg.theta_snooker_arg,
        _ptr(cfg.density_data(theta.device)), int(chain0))
    de_step.launches += 1


de_step.launches = 0


def _ptr(t):
    return None if t is None else t.data_ptr()


def de_step_rep_plain(cfg: StepConfig, spec, theta, w, fire, it: int,
                      words=None, out=None, K: int = 1, emit=(0, 1),
                      phase: str = "all"):
    """Plain version of the replicated K1 (``cfg.reps``), in place: each
    replication's :func:`sweep_plain` window on its own chains (``theta
    [R·c_rep, d]`` group-contiguous), scored by its own model's torch
    density, with its own words — Philox(``seeds[r]``, it + k) at its
    chain words (:meth:`Replicas.chain0`), or columns ``r·c_rep ..`` of a
    bits-in buffer ``words [K·n_words, R·c_rep]`` — and its gate, the fire
    row's word of its first chain, written into ``fire[r]``.  ``out`` is
    the window's trajectory slice over the whole population.  Returns the
    accept margins, ``[C]`` (K = 1) or ``[K, C]``."""
    check_window(cfg, it, K, emit, phase)
    out = trajectory(cfg, out, K, emit)
    reps, one_cfg = cfg.reps, solo_config(cfg)
    n, Cr = cfg.rows.n_words, reps.c_rep
    if words is not None and words.shape[1] != cfg.G * cfg.Np:
        raise ValueError(f"words: {words.shape[1]} columns for "
                         f"{cfg.G * cfg.Np} chains")
    margins = []
    for r in range(reps.n_reps):
        sl = slice(r * Cr, (r + 1) * Cr)
        model = reps.models[r]
        wr = (words[:, sl] if words is not None else rng.words_block(
            reps.seeds[r], it, K, n, Cr, device=theta.device,
            chain0=reps.chain0(r)).view(K * n, Cr))

        def one(k, it_k, slot, r=r, wr=wr, model=model, sl=sl):
            wk = wr[k * n:(k + 1) * n]
            return sweep_plain(one_cfg, model, spec, theta[sl], w[sl],
                               fire[r:r + 1], it_k, wk,
                               group_partners(one_cfg, wk), slot)

        margins.append(window_plain(
            one_cfg, fire[r:r + 1], it, K, emit,
            None if out is None else tuple(o[:, sl] for o in out), one))
    return torch.cat(margins, -1)


def de_step_rep(cfg: StepConfig, spec, theta, w, fire, it: int, out=None,
                bits=None, check: bool = True, K: int = 1, emit=(0, 1),
                phase: str = "all"):
    """A window of ``K`` iterations of every replication of ``cfg.reps``
    in one launch, in place on ``theta [R·c_rep, d]`` / ``w [R·c_rep]``;
    writes each replication's next gate into ``fire [R]`` and, with
    ``out``, the trajectory rows of the emission rule over the whole
    population (as :func:`de_step`).  Each replication's chains build
    their density from its row of the table and draw their words under
    its seed (:class:`Replicas`).  CPU tensors take the plain version
    (:func:`de_step_rep_plain`); CUDA tensors launch the replicated K1
    once (``de_step_rep.launches`` counts the launches).  ``bits`` is a
    bits-in buffer ``[K·n_words, R·c_rep]`` (tests)."""
    reps = cfg.reps
    if reps is None:
        raise ValueError("de_step_rep needs a replicated configuration "
                         "(rep_config)")
    if cfg.resample:
        raise ValueError("K1 runs no DE-MCz: replications of a resample "
                         "configuration run in turn")
    if theta.device.type == "cpu":
        de_step_rep_plain(cfg, spec, theta, w, fire, it, bits, out, K, emit,
                          phase)
        return
    check_window(cfg, it, K, emit, phase)
    if check:
        check_cuda(cfg, theta, w, fire, bits, out, K=K, emit=emit)
    lib = _build.library("de_step_rep")
    name = rep_entry(cfg.density, cfg.mode)
    params, data = reps.table.on(theta.device)
    o_t, o_w, o_a = (None, None, None) if out is None else (
        out[0].data_ptr(), out[1].data_ptr(), out[2].data_ptr())
    _build.launch(
        lib, name, theta.device,
        theta.data_ptr(), w.data_ptr(), o_t, o_w, o_a, fire.data_ptr(),
        None if bits is None else bits.data_ptr(),
        cfg.iargs(it, 0, K, emit, phase == "post",
                  None if bits is None else bits.shape[1]),
        cfg.fargs, cfg.sweep_args, cfg.theta_snooker_arg,
        reps.keys_on(theta.device).data_ptr(), params.data_ptr(),
        _ptr(data), int(params.shape[1]),
        0 if data is None else int(data.shape[1]), int(reps.c_rep),
        int(reps.local))
    de_step_rep.launches += 1


de_step_rep.launches = 0


def rep_entry(density, mode: str = "mh") -> str:
    """The replicated K1's C entry point for a density and accept mode
    (``de_step_rep_NAME``, ``de_step_rep_MODE_NAME``); raises where the
    solo K1 has none."""
    return _build.entry("de_step", density, mode).replace(
        "de_step_", "de_step_rep_", 1)


def check_cuda(cfg, theta, w, fire, bits=None, out=None, what="de_step",
               K: int = 1, emit=(0, 1), chain0: int = 0):
    """Raise unless the tensors are what K1 (or K3) takes on a CUDA
    device for a window of ``K`` iterations storing by ``emit``, on
    chains ``chain0 ..`` of the population (a bits-in buffer holds its
    columns)."""
    dev = theta.device
    if dev.type != "cuda":
        raise ValueError(f"{what} runs on cpu or cuda, not {dev}")
    _build.entry(what, cfg.density, cfg.mode)
    C, d = cfg.G * cfg.Np, cfg.d
    T = n_emitted(K, emit)
    n_fire = 1
    if cfg.reps is not None:
        reps = cfg.reps
        n_fire = reps.n_reps
        if (reps.c_rep % cfg.Np or reps.c_rep * reps.n_reps != C
                or reps.table.n_reps != reps.n_reps
                or reps.table.name != cfg.density.name
                or len(reps.models) != reps.n_reps or chain0):
            raise ValueError(f"the replication table ({reps.n_reps} of "
                             f"{reps.c_rep} chains, {reps.table.name}) does "
                             f"not fit the launch ({C} chains of groups of "
                             f"{cfg.Np}, {cfg.density.name})")
    want = [("theta", theta, torch.float32, [(C, d)]),
            ("w", w, torch.float32, [(C,)]),
            ("fire", fire, torch.int32, [(n_fire,)])]
    if chain0 < 0:
        raise ValueError(f"chain0 must be >= 0, not {chain0}")
    if bits is not None:
        want.append(("bits", bits, torch.uint32, [(
            K * cfg.rows.n_words, max(bits.shape[-1], chain0 + C))]))
    if out is not None:
        one = T == 1
        want += [("out[0]", out[0], torch.float32,
                  [(T, C, d)] + [(C, d)] * one),
                 ("out[1]", out[1], torch.float32, [(T, C)] + [(C,)] * one),
                 ("out[2]", out[2], torch.bool, [(T, C)] + [(C,)] * one)]
    for name, t, dt, shapes in want:
        if (t.device != dev or t.dtype != dt or tuple(t.shape) not in shapes
                or not t.is_contiguous()):
            raise ValueError(f"{name}: need a contiguous {dt} {shapes[0]} "
                             f"tensor on {dev}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")


def philox_fill(out, seed: int, it: int, ns: int = rng.STEP_NS,
                row0: int = 0, chain0: int = 0):
    """Fill ``out [n_rows, n]`` with the Philox words ``(seed, it, row0 +
    r, chain0 + c)`` of namespace ``ns`` (``out`` uint32) or with their
    uniforms ``rng.to_uni`` (``out`` float32): a stochastic model's noise
    panel in the unfused step, a custom slot's key words, and the
    generator K1 and K2 run, held against :func:`rng.words`.  A CPU
    ``out`` takes the plain version (:func:`rng.words`); a CUDA one
    launches ``philox_fill`` (``csrc/de_step.cu``; ``philox_fill.
    launches`` counts the launches)."""
    uni = out.dtype == torch.float32
    if (out.dtype not in (torch.uint32, torch.float32) or out.dim() != 2
            or not out.is_contiguous()):
        raise ValueError(f"out: need a contiguous 2-D uint32 or float32 "
                         f"tensor, got {out.dtype} {tuple(out.shape)}")
    n_rows, n = out.shape
    if row0 < 0 or chain0 < 0 or row0 + n_rows > 1 << 32 \
            or chain0 + n > 1 << 32:
        raise ValueError(f"rows {row0} + {n_rows} and chains {chain0} + "
                         f"{n} must lie in [0, 2**32)")
    if out.device.type == "cpu":
        w = rng.words(seed, it, n_rows, n, ns, row0=row0, chain0=chain0)
        out.copy_(rng.to_uni(w) if uni else w)
        return out
    if out.device.type != "cuda":
        raise ValueError(f"philox_fill runs on cpu or cuda, not "
                         f"{out.device}")
    lib = _build.library("de_step")
    k0, k1 = rng.seed_key(seed)
    _build.launch(lib, "philox_fill", out.device, out.data_ptr(), n_rows, n,
                  k0, k1, int(it) & 0xFFFFFFFF, int(ns), int(row0),
                  int(chain0), int(uni))
    philox_fill.launches += 1
    return out


philox_fill.launches = 0


def philox_uniforms(seed: int, it: int, n_rows: int, n: int, ns: int,
                    device, row0: int = 0, chain0: int = 0):
    """``[n_rows, n]`` float32 uniforms ``rng.to_uni`` of the words
    ``(seed, it, row0 + r, chain0 + c)`` of namespace ``ns`` on
    ``device``: one :func:`philox_fill` launch on the card, the same bits
    as :func:`rng.words` on the CPU."""
    out = torch.empty((n_rows, n), dtype=torch.float32, device=device)
    return philox_fill(out, seed, it, ns, row0, chain0)
