"""The sampling loop (port of ``demcmc_tpu.sampler``).

Reference: ``src/main.jl:19-42`` (``sample``).  :func:`build_step` picks
one of two steps, statically from the model and the configuration, as the
JAX package's ``build_step`` does (``demcmc_tpu/sampler.py:100-171``):

* :class:`Step`, the kernels' step, for a model that names a CUDA density
  built into K1 or, for DE-MCz, K3 (:func:`fused_supported`).
  :func:`run_scan` runs it as the JAX main path does (``demcmc_tpu/sampler.py:464-595``, ``run_scan``
  :1226): K-iteration launches of the DE-step kernel K1 (or, for DE-MCz,
  the resample kernel K3, which also writes each state into the history),
  device-side thinning, and the post-burn-in variant past burn-in.  The
  migration gates are a pure function of the Philox counter, so the host
  computes them all before the first launch (:func:`rng.gates`) and cuts
  the run into windows (:func:`plan_windows`) that end where a gate opens;
  the migration kernel K2 runs between two windows (of K1 or K3), and
  each window is bitwise equal to the same iterations run one launch at a
  time (``Step.__call__``: K2 gated on the device-side flag, then K1 or
  K3);
* :class:`UnfusedStep` for every other configuration, or with
  ``allow_fused=False``: the twin of the JAX XLA step
  (``demcmc_tpu/sampler.py:954-1130``), plain torch operations around the
  model's torch density, which may itself launch a kernel (the KDE kernel
  K4 of ``models/abc_kde.py``).

Under a chain mesh of more than one device (``mesh=``, :mod:`.parallel`)
:class:`ShardedStep` splits the groups over the devices, one of the
above per shard, and runs migration on the whole population; DE-MCz
keeps a history replica a device, its new rows shared every iteration; a
``chains × data`` mesh sums each shard's likelihood over its data
pieces; over several processes (``parallel.distributed``) each rank
steps its own shards and the exchanges are collectives.  A sharded run
is the unsharded run bit for bit.

:func:`sample_replicated` (and :func:`sample_replicated_packed`,
``optimize.optimize_replicated``) runs R datasets' runs as one batch:
:class:`RepStep`, a :class:`Step` over the R populations side by side
through the replicated K1 and K2's segmented form (over a mesh,
:class:`RepShardedStep`), or, where a replication takes no K1, each
replication's solo run in turn.

The host loop reads the device once, the first gate before the loop, so
it runs ahead of the card.  :func:`run_scan` runs the JAX package's chunk
loop (progress, checkpoints, the streaming monitor, an early stop at a
chunk's end); only the rows a run keeps are stored, and they stream to
pinned host memory as the run goes.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``,
which runs the plain PyTorch versions of the kernels (the tests do); with
no GPU and no ``device=`` they raise.
"""

from __future__ import annotations

import functools
import itertools
import math
import time
from typing import NamedTuple, Optional

import numpy as np
import torch

from . import rng
from .chains import Chains
from .config import DE, MCMCThreads, _blocking_const
from .model import DensityTable, DEModel, ParamSpec
from .ops import _build
from .ops import accept as accept_ops
from .ops import fused_step as fused_ops
from .ops import migration as migration_ops
from .ops import mutation as mutation_ops
from .ops import proposals as proposal_ops
from .ops import resample_step as resample_ops
from .parallel import distributed
from .parallel.mesh import (ShardedData, has_data_axis, mesh_devices,
                            shard_replications)
from .utils import checkpoint, dists, pytree
from .utils.monitor import ConvergenceMonitor


class SamplerState(NamedTuple):
    """The entire resumable state of a run: ``theta [C, d]`` and
    ``weight [C]`` of the configuration's dtype, float32 or float64
    (chain c in group c // Np), the integer
    ``key`` (Philox seed), the next ``iteration`` (1-based), ``fire``
    ``[1]`` int32, the migration gate of that iteration, and for DE-MCz
    the ``history [H, C, d]`` of past states (row t holds iteration t+1's
    state; the first ``n_initial`` rows are prior draws)."""

    theta: torch.Tensor
    weight: torch.Tensor
    key: int
    iteration: int
    fire: torch.Tensor
    history: Optional[torch.Tensor] = None


class StepOutput(NamedTuple):
    theta: np.ndarray     # [T, C, d]
    accept: np.ndarray    # [T, C] bool
    lp: np.ndarray        # [T, C]


class _DEView:
    """What a callable ``blocking_on`` sees (``demcmc_tpu/sampler.py:
    63-73``; reference ``de.blocking_on(de)``, ``src/main.jl:162``): the
    configuration's fields and ``iter``, the iteration as a host int, so
    the flag costs no device sync."""

    def __init__(self, de: DE, iteration: int):
        self._de = de
        self.iter = iteration

    def __getattr__(self, name):
        return getattr(self._de, name)


def flatten_block(spec: ParamSpec, block) -> np.ndarray:
    """One block mask (a bool or a nested mask per parameter, reference
    ``blocks``, ``src/structs.jl:48``) as a flat ``[d]`` bool mask
    (``demcmc_tpu/sampler.py:76-100``): a scalar element covers its whole
    parameter, an array element must have the parameter's size."""
    if isinstance(block, np.ndarray) and block.dtype != object:
        block = list(block)
    parts = []
    for elem, shape, size in zip(block, spec.shapes, spec.sizes):
        a = np.asarray(elem, dtype=bool)
        if a.shape == ():
            parts.append(np.full(size, bool(a)))
        else:
            if int(np.prod(a.shape)) != size:
                raise ValueError(f"block element shape {a.shape} does not "
                                 f"match parameter shape {shape}")
            parts.append(a.reshape(-1))
    return np.concatenate(parts)


def resolve_device(device=None) -> torch.device:
    """``cuda`` by default; raises when CUDA is asked for (by default or
    by name) and there is no GPU."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: demcmc_tpu_torch runs on the GPU unless "
            "called with device='cpu' (the plain PyTorch path)")
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"demcmc_tpu_torch runs on cpu or cuda, not "
                         f"{device}")
    return device


def make_spec(model: DEModel, de: DE) -> ParamSpec:
    """Build the ParamSpec from one host-side prior draw."""
    draws = model.sample_prior(
        lambda k: rng.to_uni(rng.words(0, 0, k, 1, ns=rng.INIT_NS)), 1)
    example = [np.asarray(p)[0] for p in draws]
    return ParamSpec.from_example(model.names, example, de.bounds)


def _first_gate(de: DE, key: int, iteration: int, device) -> torch.Tensor:
    """Migration gate of a run's first iteration, K1's and K3's runs alike
    (the JAX look-ahead gate's seeding, ``demcmc_tpu/sampler.py:806-813``),
    from its own Philox namespace; later gates are drawn by the step
    kernel."""
    alpha = float(de.alpha) if de.n_groups > 1 else 0.0
    u = rng.to_uni(rng.words(key, iteration, 1, 1, ns=rng.GATE_NS))
    fire = (u <= float(np.float32(alpha))) & (alpha > 0.0)
    return fire.view(1).to(device=device, dtype=torch.int32)


def init_state(model: DEModel, de: DE, spec: ParamSpec, key: int = 0,
               device=None, start_iteration: int = None) -> SamplerState:
    """Prior draws for every chain (reference ``sample_init``) in the
    configuration's dtype, their fitness by its ``evaluate_fitness`` slot
    (the log posterior, or the objective when optimizing; ``demcmc_tpu/
    sampler.py:1159-1165``), and the first migration gate.  With
    ``sample='resample'`` the history is seeded with ``n_initial`` rows of
    prior draws per chain and the chains start from row 0
    (``demcmc_tpu/sampler.py:1133-1169``).  The run starts at iteration
    ``n_initial + 1`` unless ``start_iteration`` says otherwise."""
    device = resolve_device(device)
    C, dtype = de.n_chains, de.torch_dtype
    history = None
    if de.uses_resample:
        if de.n_initial < 1:
            raise ValueError(
                "sample='resample' requires n_initial >= 1 prior-seeded "
                "history rows (the reference recommends 10x the parameter "
                "count, src/structs.jl:37)")
        history = model.init_population(spec, key, de.n_initial * C,
                                        device=device, dtype=dtype).view(
            de.n_initial, C, spec.dim).contiguous()
        theta = history[0].clone()
    else:
        theta = model.init_population(spec, key, C, device=device,
                                      dtype=dtype)
    noise = None
    if model.stochastic:          # the initial weights' own noise panel
        noise = fused_ops.philox_uniforms(key, 0, model.noise_words, C,
                                          rng.INIT_NOISE_NS, device)
    weight = accept_ops.make_fitness(model, spec, de)(theta, noise)
    it0 = (de.n_initial + 1 if start_iteration is None
           else int(start_iteration))
    return SamplerState(theta=theta.contiguous(), weight=weight.contiguous(),
                        key=int(key), iteration=it0,
                        fire=_first_gate(de, key, it0, device),
                        history=history)


def _grow_history(state: SamplerState, n_iter: int) -> SamplerState:
    """Extend the history by ``n_iter`` zero rows, for this run's states
    (``demcmc_tpu/sampler.py:1172``); no-op without a history."""
    if state.history is None:
        return state
    H, C, d = state.history.shape
    pad = state.history.new_zeros((n_iter, C, d))
    return state._replace(history=torch.cat([state.history, pad]))


def _unpack_history(h, n_chains: int) -> np.ndarray:
    """The JAX fused resample layout's lane-packed history ``[S, d, Cf]``
    to ``[S·B, C, d]`` (the inverse of ``pack_history``,
    ``demcmc_tpu/sampler.py:779-795``): row t of chain c sits in slab
    t // B at lane (t % B)·C + c, with B = 128 // C for C <= 128 and 1
    above.  The slab count's zero padding comes along as zero rows."""
    h = np.asarray(h, dtype=np.float32)
    S, d, _ = h.shape
    B = 128 // n_chains if n_chains <= 128 else 1
    x = h[:, :, :B * n_chains].reshape(S, d, B, n_chains)
    return x.transpose(0, 2, 3, 1).reshape(S * B, n_chains, d)


def state_from_numpy(theta, weight, iteration, fire, layout: str,
                     key: int = 0, device=None, history=None,
                     n_chains: int = None) -> SamplerState:
    """The port's state from a JAX ``SamplerState``'s arrays (as numpy).

    ``layout="fused"``: theta ``[d, 8, C/8]`` and weight ``[8, C/8]``,
    chain c at (c // (C/8), c % (C/8)) (``demcmc_tpu/sampler.py:539-543``);
    ``layout="flat"``: theta ``[G, Np, d]`` and weight ``[G, Np]``;
    ``layout="resample"`` (the JAX fused resample state): theta ``[d, 8,
    Cf]`` and weight ``[8, Cf]`` with the ``n_chains`` real chains as the
    row-0 prefix.  ``history`` (DE-MCz) is flat ``[H, C, d]`` or, in the
    resample layout's packing, ``[S, d, Cf]`` (:func:`_unpack_history`).
    ``fire`` is the JAX state's gate; None (a flat-layout state) means no
    migration before the first iteration.  ``key`` seeds the port's
    Philox words (a JAX key does not carry over).  Integer parameters
    arrive as floats that are integers (the JAX state is float) and stay
    so.  A float64 θ (a JAX float64 state) gives a float64 state, any
    other a float32 one; w and the history take θ's dtype."""
    dtype = (np.float64 if np.asarray(theta).dtype == np.float64
             else np.float32)
    theta = np.asarray(theta, dtype=dtype)
    if layout == "fused":
        d = theta.shape[0]
        flat = theta.reshape(d, -1).T
    elif layout == "flat":
        flat = theta.reshape(-1, theta.shape[-1])
    elif layout == "resample":
        if n_chains is None or history is None:
            raise ValueError("layout='resample' needs n_chains and history")
        flat = theta[:, 0, :n_chains].T
        weight = np.asarray(weight)[0, :n_chains]
    else:
        raise ValueError(f"layout must be 'fused', 'flat' or 'resample'; "
                         f"got {layout!r}")
    w = np.asarray(weight, dtype=dtype).reshape(-1)
    C, d = flat.shape
    if w.shape[0] != C:
        raise ValueError(f"{w.shape[0]} weights for {C} chains")
    f = 0 if fire is None else int(np.asarray(fire).reshape(-1)[0])
    device = resolve_device(device)
    hist = None
    if history is not None:
        h = np.asarray(history, dtype=dtype)
        if h.shape[1:] != (C, d):
            h = _unpack_history(h, C)
        hist = torch.tensor(np.ascontiguousarray(h), device=device)
    return SamplerState(
        theta=torch.tensor(np.ascontiguousarray(flat), device=device),
        weight=torch.tensor(w, device=device), key=int(key),
        iteration=int(np.asarray(iteration)),
        fire=torch.tensor([f], dtype=torch.int32, device=device),
        history=hist)


class Window(NamedTuple):
    """One launch of a planned run (:func:`plan_windows`): iterations
    ``it0 .. it0+K-1``, with K2 first where ``migrate`` (the gate of
    ``it0`` is open), storing ``n_emit`` trajectory rows from row ``t0``
    by the emission rule ``emit = (emit_first, emit_stride)``, through the
    post-burn-in step where ``post``."""
    it0: int
    K: int
    migrate: bool
    emit: tuple
    t0: int
    n_emit: int
    post: bool


def plan_windows(it0: int, n_iter: int, fire0: bool, gates, k_max: int,
                 thin: int = 1, switch: int = None, store: bool = True,
                 cuts=(), skip: int = 0):
    """Cut the iterations ``it0 .. it0+n_iter-1`` of a run into windows of
    at most ``k_max``: a window ends before an iteration whose migration
    gate is open (``fire0`` for the first iteration, ``gates[i]`` — the
    gate iteration ``it0 + i`` writes — for the next, None: no migration;
    a replicated run's ``fire0 [R]`` and ``gates [n, R]``, where any
    replication's gate opens),
    at run index ``switch`` (the first iteration of phase 2, or None), at
    each run index of ``cuts`` (a chunk's edge, :func:`run_scan`) and at
    the end.  Run index i is stored where ``(i + 1) % thin == 0``, as
    trajectory row ``(i + 1) // thin - 1 - skip``: the first ``skip`` rows
    are not stored (a window that reaches them starts its emission rule
    at the first kept one), and a window that ends mid-thin carries its
    offset into the next; with ``store=False`` no window stores a row
    (emission rule ``(K, 1)``: a run without a trajectory).  Returns a
    list of :class:`Window`."""
    opens = np.zeros(n_iter, dtype=bool)
    if gates is not None and n_iter:
        g = np.asarray(gates, dtype=bool)
        opens[0] = bool(np.any(fire0))
        opens[1:] = g.reshape(g.shape[0], -1)[:n_iter - 1].any(axis=1)
    cuts = {0, n_iter, *np.flatnonzero(opens).tolist(),
            *(int(c) for c in cuts if 0 < c < n_iter)}
    if switch is not None and 0 < switch < n_iter:
        cuts.add(switch)
    cuts = sorted(cuts)
    kept = (skip + 1) * thin - 1          # run index of the first kept row
    out = []
    for a, b in zip(cuts, cuts[1:]):
        for s in range(a, b, k_max):
            K = min(k_max, b - s)
            first = max((thin - 1 - s) % thin, kept - s) if store else K
            out.append(Window(
                it0 + s, K, bool(opens[s]), (first, thin if store else 1),
                (s + first + 1) // thin - 1 - skip if store else 0,
                fused_ops.n_emitted(K, (first, thin)) if store else 0,
                switch is not None and s >= switch))
    return out


class Step:
    """The kernels' step for a (model, de, spec) configuration: one
    iteration (``__call__``: K2 where the configuration migrates, then K1,
    or K3 for DE-MCz), or a planned
    run of K-iteration windows (:meth:`plan` and :meth:`window`, which
    :func:`run_scan` takes; :meth:`advance`), with the JAX step's superstep
    names (``superstep_k``,
    :meth:`get_superstep`, :meth:`get_thin_step`, :meth:`get_post_burnin`,
    ``demcmc_tpu/sampler.py:464-595``).

    On the CPU the plain versions read their words from blocks drawn for
    many iterations at once (the same words, with fewer torch calls).

    With ``groups = (g0, n)`` the step runs groups ``g0 .. g0+n-1`` of the
    population, one shard of a chain mesh (:class:`ShardedStep`): K1 on
    the shard's state with the words of its chains (``chain0``) and
    without migration, which the sharded step runs on the whole
    population.  A DE-MCz shard runs K3 on the population's history (the
    state's, a replica on the shard's device) one iteration a launch,
    writing its chains' columns of each row: iteration ``it + 1`` may read
    row ``it − 1`` of any chain, which another shard writes."""

    WORDS_PER_BLOCK = 1 << 20     # CPU: words drawn per block, at most

    def __init__(self, model: DEModel, de: DE, spec: ParamSpec, device,
                 groups=None):
        self.model, self.spec = model, spec
        if de.blocks is not None and _blocking_const(de) is None:
            raise ValueError("the kernels' step sweeps constant blocks "
                             "only (blocking_on a bool); a callable "
                             "blocking_on takes the unfused step")
        self.cfg = fused_ops.StepConfig.make(model, de, spec)
        n_blk = len(self.cfg.blocks)
        if n_blk and n_blk not in _build.BLOCK_COUNTS:
            raise ValueError(f"K1 and K3 are built for {_build.BLOCK_COUNTS} "
                             f"block sweeps, not {n_blk}; such a "
                             f"configuration takes the unfused step")
        if self.cfg.resample and self.cfg.mode != "mh":
            raise ValueError("K3 runs the MH accept only: DE-MCz "
                             "optimization takes the unfused step, as in "
                             "the JAX package")
        self.n_all = self.cfg.G * self.cfg.Np     # the population's chains
        self.chain0, self.migrates = 0, self.cfg.rows.mig >= 0
        self.shard = groups is not None
        if groups is not None:
            self.chain0 = groups[0] * self.cfg.Np
            self.cfg = fused_ops.local_config(self.cfg, groups[1])
            self.migrates = False
        self.device = torch.device(device)
        if self.device.type == "cuda":
            _build.entry("resample_step" if self.cfg.resample else "de_step",
                         model.cuda_density, self.cfg.mode)
        self._blocks = {}             # CPU: namespace -> (key, it0, words)

    @functools.cached_property
    def superstep_k(self) -> int:
        """Iterations per launch at most (windows are cut shorter where a
        gate opens): K3 takes one CTA per window, so K = 1 above the chains
        one CTA of its kernel holds (read from the library at first use),
        and on a shard of a chain mesh."""
        if self.cfg.resample:
            if self.shard:
                return 1
            return resample_ops.resample_super_k(self.cfg, self.device)
        return fused_ops.super_k()

    def _words(self, key: int, it: int, ns: int, n_rows: int):
        blk_key, it0, block = self._blocks.get(ns, (None, 0, None))
        if blk_key != key or not it0 <= it < it0 + len(block):
            C = self.n_all
            block = rng.words_block(
                key, it, max(1, min(64, self.WORDS_PER_BLOCK // (C * n_rows))),
                n_rows, C, ns=ns, device=self.device)
            self._blocks[ns], it0 = (key, it, block), it
        return block[it - it0]

    def check(self, state: SamplerState, out=None):
        """Raise unless the state (and a trajectory slot) suit the kernels;
        :func:`run_scan` checks once and then launches unchecked."""
        cfg = self.cfg
        if cfg.resample and state.history is None:
            raise ValueError("a resample run needs state.history")
        if self.device.type != "cuda":
            return
        if self.migrates:
            migration_ops.check_cuda(state.theta, state.weight, state.fire,
                                     cfg.G, cfg.Np)
        if cfg.resample:
            resample_ops.check_cuda(cfg, state.theta, state.weight,
                                    state.fire, state.history, out=out,
                                    chain0=self.chain0)
        else:
            fused_ops.check_cuda(cfg, state.theta, state.weight, state.fire,
                                 out=out)

    def __call__(self, state: SamplerState, out=None, check: bool = True,
                 phase: str = "all") -> SamplerState:
        """Advance ``state`` one iteration in place (its tensors are
        updated); ``out`` is an optional trajectory slot, ``phase='post'``
        the post-burn-in variant (:meth:`get_post_burnin`)."""
        cfg, it = self.cfg, state.iteration
        cpu = self.device.type == "cpu"
        bits = (self._words(state.key, it, rng.STEP_NS, cfg.rows.n_words)
                if cpu else None)
        if self.migrates:
            migration_ops.migrate(state.theta, state.weight, state.fire,
                                  cfg.G, cfg.Np, seed=state.key, it=it,
                                  bits=bits, check=check)
        if cfg.resample:
            idx = None
            c0, c = self.chain0, cfg.G * cfg.Np
            if cpu:
                idx = resample_ops.indices_from_words(cfg, self._words(
                    state.key, it, rng.RESAMPLE_NS,
                    resample_ops.index_rows(cfg))[:, c0:c0 + c], it,
                    self.n_all)
            resample_ops.resample_step(
                cfg, self.model, self.spec, state.theta, state.weight,
                state.fire, state.history, it, seed=state.key, out=out,
                bits=bits, idx=idx, check=check, phase=phase, chain0=c0)
        else:
            fused_ops.de_step(cfg, self.model, self.spec, state.theta,
                              state.weight, state.fire, it, seed=state.key,
                              out=out, bits=bits, check=check, phase=phase,
                              chain0=self.chain0)
        return state._replace(iteration=it + 1)

    def window(self, state: SamplerState, w: Window, traj=None):
        """Launch window ``w`` on the state's tensors in place: K2 first
        where ``w.migrate``, then one K1 (or K3) launch of ``w.K``
        iterations writing its rows of ``traj = (θ [T, C, d], w [T, C],
        acc [T, C])`` (or of a run's :class:`_Rows`), unchecked (:meth:`check` checks a run once), through
        the post-burn-in variant where ``w.post``.  The state's
        ``iteration`` is not advanced; a shard's step does not migrate."""
        cfg, key = self.cfg, state.key
        phase = "post" if w.post else "all"
        C = self.n_all
        out = None
        if traj is not None and w.n_emit:
            out = _slot(traj, w.t0, w.n_emit)
        bits = idx = None
        if self.device.type == "cpu":     # one Philox call per window
            bits = rng.words_block(key, w.it0, w.K, cfg.rows.n_words, C,
                                   device=self.device).view(-1, C)
            if cfg.resample:
                words = rng.words_block(key, w.it0, w.K,
                                        resample_ops.index_rows(cfg),
                                        cfg.G * cfg.Np, ns=rng.RESAMPLE_NS,
                                        device=self.device,
                                        chain0=self.chain0)
                idx = torch.cat([resample_ops.indices_from_words(
                    cfg, words[k], w.it0 + k, C) for k in range(w.K)])
        if w.migrate and self.migrates:
            migration_ops.migrate(state.theta, state.weight, state.fire,
                                  cfg.G, cfg.Np, seed=key, it=w.it0,
                                  bits=bits, check=False)
        if cfg.resample:
            resample_ops.resample_step(
                cfg, self.model, self.spec, state.theta, state.weight,
                state.fire, state.history, w.it0, seed=key, out=out,
                bits=bits, idx=idx, check=False, K=w.K, emit=w.emit,
                phase=phase, chain0=self.chain0)
        else:
            fused_ops.de_step(cfg, self.model, self.spec, state.theta,
                              state.weight, state.fire, w.it0, seed=key,
                              out=out, bits=bits, check=False, K=w.K,
                              emit=w.emit, phase=phase, chain0=self.chain0)

    def plan(self, state: SamplerState, n_iter: int, thin: int = 1,
             fire=None, switch: int = None, store: bool = True, cuts=(),
             skip: int = 0):
        """The windows of ``n_iter`` iterations from ``state``
        (:func:`plan_windows`; ``store=False``: windows that store no
        row; ``cuts``: more run indices where a window ends; ``skip``:
        trajectory rows not stored): the gates from :func:`rng.gates`, the
        first one ``fire`` or, when None, read from ``state.fire`` (the
        run's one host sync)."""
        cfg = self.cfg
        gates, fire0 = None, False
        if cfg.rows.mig >= 0:
            fire0 = bool(int(state.fire[0]) if fire is None else fire)
            gates = rng.gates(state.key, state.iteration, n_iter,
                              cfg.rows.fire, cfg.alpha)
        return plan_windows(state.iteration, n_iter, fire0, gates,
                            self.superstep_k, thin, switch, store, cuts,
                            skip)

    def advance(self, state: SamplerState, n_iter: int, thin: int = 1,
                traj=None, fire=None, switch: int = None) -> SamplerState:
        """Run ``n_iter`` iterations in place as planned windows
        (:meth:`plan`), storing every ``thin``-th into ``traj`` (with no
        ``traj``, windows that store nothing); the windows from run index
        ``switch`` on take the post-burn-in variant.  No host sync after
        the plan."""
        for w in self.plan(state, n_iter, thin, fire, switch,
                           store=traj is not None):
            self.window(state, w, traj)
        return state._replace(iteration=state.iteration + n_iter)

    def get_superstep(self):
        """``superstep(state, out=None) -> state``: ``superstep_k``
        iterations as planned windows, each stored into ``out`` (``[K, C,
        d]``, ``[K, C]``, ``[K, C]``)."""
        return lambda state, out=None: self.advance(
            state, self.superstep_k, 1, out)

    def get_thin_step(self, thin: int):
        """``thin_step(state, out=None) -> state``: ``thin`` iterations as
        planned windows, the last one stored into ``out`` (device-side
        thinning, ``emit='last'``)."""
        return lambda state, out=None: self.advance(state, thin, thin, out)

    def get_post_burnin(self):
        """The one-iteration step past burn-in (``phase='post'``), bitwise
        equal to this one for iterations > burnin; None where there is no
        γ₂ base select to leave out (not random γ, no burn-in).  A planned
        run takes it per window (:meth:`advance`'s ``switch``)."""
        if self.cfg.burnin <= 0 or not self.cfg.random_gamma:
            return None
        return functools.partial(self, phase="post")


GRAPHS = True        # the unfused step's sweeps as CUDA graphs on the card


class UnfusedStep:
    """One iteration of the unfused step, the twin of the JAX XLA step
    (``demcmc_tpu/sampler.py:954-1130``: ``do_update`` :966,
    ``sweep_update`` :1033, ``step_core`` :1055, the integer snap
    :1013-1014, the history write :1116-1123) on the group-major state
    ``[C, d]`` (the JAX state ``[G, Np, d]`` reshaped): migration with
    probability α, then the synchronous or sequential sweep, once per
    block where the blocks apply, each chain's proposal scored by the
    model's torch density through the configuration's fitness slot
    (:func:`.ops.accept.make_fitness`: the posterior, the objective alone
    when optimizing, or a custom slot) and accepted by its update slot
    (MH, the greedy ``maximize``/``minimize``, which draw nothing, or a
    custom slot); partners come from the current group, from the history
    for DE-MCz, or from a custom ``sample`` slot, whose row ``it − 1``
    takes the new state.  The state is float32 or float64, the
    configuration's dtype; a float64 one draws by the JAX step's x64 word
    rules (:mod:`.rng`).

    On the card the sweeps after migration replay as a CUDA graph, one per
    (burn-in, ``blocking_on`` flag) (:meth:`_graphed`): the same kernels
    on the same inputs as the eager iteration, bit for bit, in one call
    instead of hundreds to thousands of launches.  Migration, whose
    exchange takes a host-drawn group count, stays eager; a custom slot, a
    stochastic model, a shard of a chain mesh, a density that launches a
    kernel of the port or that a capture cannot hold run eagerly
    (``GRAPHS = False`` runs every step so).

    Its random numbers come as the JAX step's do, from one
    :class:`~demcmc_tpu_torch.rng.Pool` per iteration: ``[G,
    pool_words]`` words of Philox namespace ``POOL_NS`` (the pool's width
    counted by a dry run with :class:`~demcmc_tpu_torch.rng.CountingDraws`
    before the first iteration, custom slots included, as the JAX step
    traces them), and two scalars on the host (namespace ``SCALAR_NS``),
    so the migration gate needs no sync.  Words are drawn for many
    iterations at once.  A callable ``blocking_on`` is the JAX step's
    ``lax.cond``, which traces both branches, the blocked one first: the
    pool holds the blocked sweeps' columns and then the plain sweep's,
    and an iteration uses one set and passes over the other (a callable
    that ignores the iteration is taken as one that reads it).

    Where a slot is custom, each sweep has a :class:`~demcmc_tpu_torch.rng.
    Key` folded as the JAX step folds its key (per block, per member of
    the sequential sweep): the context's key is its ``CUSTOM`` fold, a
    custom update gets its ``ACCEPT`` fold.  A stochastic model's
    proposals are scored on a fresh ``[n_noise, C]`` uniform panel at each
    evaluation, Philox namespace ``EVAL_NS`` keyed by (seed, iteration,
    :func:`rng.eval_row`, chain): one ``philox_fill`` launch on the card.

    With ``groups = (g0, n)`` the step runs groups ``g0 .. g0+n-1``, one
    shard of a chain mesh (:class:`ShardedStep`): its pool holds those
    groups' rows of the population's pool, its keys and panels draw those
    groups' (chains') words, and it passes over the migration's columns,
    which the sharded step draws for the whole population.  A DE-MCz
    shard reads the population's history ``[H, C_pop, d]`` and writes its
    chains' columns of row ``it − 1``."""

    WORDS_PER_BLOCK = 1 << 21     # pool words drawn per block, at most

    def __init__(self, model: DEModel, de: DE, spec: ParamSpec, device,
                 groups=None):
        self.de = de
        self.device = torch.device(device)
        self.dtype, self.x64 = de.torch_dtype, de.dtype is np.float64
        self.G, self.Np, self.d = de.n_groups, de.Np, spec.dim
        self.n_pop = de.n_chains      # the population's chains
        self.g0 = None                # None: the whole population
        if groups is not None:
            self.g0, self.G = groups
        self.fitness = accept_ops.make_fitness(model, spec, de)
        self.n_noise = model.noise_words
        self.spec = spec
        self.custom = bool(de.custom_slots)
        self.update = accept_ops.make_update(de)
        self.int_mask = (torch.as_tensor(spec.int_mask, device=self.device)
                         if spec.has_int else None)
        self.proposal = (de.generate_proposal
                         if callable(de.generate_proposal)
                         else getattr(proposal_ops, de.generate_proposal))
        self.block_masks = None
        if de.blocks is not None:
            self.block_masks = [torch.as_tensor(flatten_block(spec, b),
                                                device=self.device)
                                for b in de.blocks]
        self.blocking = _blocking_const(de)
        # the sequential sweep's member masks [Np], made once
        self._members = torch.eye(self.Np, dtype=torch.bool,
                                  device=self.device).unbind(0)
        zeros = (torch.zeros((self.G, self.Np, self.d), dtype=self.dtype,
                             device=self.device),
                 torch.zeros((self.G, self.Np), dtype=self.dtype,
                             device=self.device))
        hist = (torch.zeros((1, self.G * self.Np, self.d), dtype=self.dtype,
                            device=self.device)
                if de.uses_resample else None)

        def fit0(x, noise=None):
            return torch.zeros(x.shape[:-1], dtype=x.dtype, device=x.device)
        self.branch_cols = {}
        if self.block_masks is not None and self.blocking is None:
            for blocked in (True, False):
                counter = rng.CountingDraws(self.G, self.device, self.x64)
                self.sweeps(counter, *zeros, 1, fit0, hist, blocked,
                            self._key(0, 1))
                self.branch_cols[blocked] = counter.words
        counter = rng.CountingDraws(self.G, self.device, self.x64)
        self.step_core(counter, *zeros, 1, fit0, hist, seed=0)
        self.pool_words = max(counter.words, 1)
        self._blocks = {}             # namespace -> (key, it0, words)
        # the sweeps' CUDA graphs (:meth:`_graphed`) by key, or None: eager
        # on the CPU, with a custom slot (user code reads host values), for
        # a stochastic model (its panel's fill takes the iteration on the
        # host) and in a shard of a chain mesh
        self._graphs = ({} if GRAPHS and self.device.type == "cuda"
                        and not self.custom and not self.n_noise
                        and groups is None else None)
        self.eager_reason = None      # why a graphed step turned eager

    # ---- the step body, draw for draw as the JAX XLA step

    def _key(self, seed: int, it: int):
        """The iteration's root key for the custom slots, or None."""
        if not self.custom:
            return None
        _need_seed(seed, "a custom slot's key")
        return rng.Key(seed, it, self.G, self.g0 or 0, self.device,
                       self.x64)

    def _panel(self, draws, seed: int, it: int, block, member):
        """A stochastic model's noise panel ``[n_noise, G·Np]`` of one
        evaluation (None for a deterministic model, and in the pool's
        sizing run)."""
        if not self.n_noise or isinstance(draws, rng.CountingDraws):
            return None
        _need_seed(seed, "a stochastic model's noise panel")
        return fused_ops.philox_uniforms(
            seed, it, self.n_noise, self.G * self.Np, rng.EVAL_NS,
            self.device, row0=rng.eval_row(block, member, self.Np,
                                           self.n_noise),
            chain0=(self.g0 or 0) * self.Np)

    def do_update(self, draws, theta, weight, it: int, fitness,
                  history=None, block_mask=None, member: int = None,
                  mut_mask=None, key=None, seed: int = None, block=None):
        """One mutate-or-crossover sweep over all groups (``sampler.py:
        966``; reference ``mutate_or_crossover!``, ``main.jl:199-207``);
        with ``member`` (sequential sweep) only group slot ``member``
        accepts, and ``mut_mask`` is the per-group mutation gate drawn
        once per sweep.  ``block_mask [d]`` keeps the crossover or snooker
        proposal to the block's dimensions before the snooker correction
        (``reset!``, ``crossover.jl:84-87,336-352``); the mutation ignores
        it (``main.jl:199-207``).  ``key`` is the sweep's
        :class:`~demcmc_tpu_torch.rng.Key` (custom slots), ``seed`` and
        ``block`` key a stochastic model's panel."""
        de, d = self.de, self.d
        G, Np = self.G, self.Np
        if key is not None and member is not None:
            key = key.fold_in(rng.MEMBER * 1000 + member)
        ctx = proposal_ops.ProposalContext(
            de=de, spec=self.spec, theta=theta, weight=weight, iteration=it,
            history=history, draws=draws,
            key=None if key is None else key.fold_in(rng.CUSTOM))
        cross = (self.proposal(ctx) if key is None
                 else self.proposal(ctx, ctx.next_key()))
        if de.theta_snooker > 0.0:
            sn_gate = draws.uniform((G, Np)) <= dists.f32(de.theta_snooker)
            sn_prop, z, degen = proposal_ops.snooker(ctx)
            cross = torch.where(sn_gate[..., None], sn_prop, cross)
        if block_mask is not None:
            cross = torch.where(block_mask, cross, theta)
        if de.theta_snooker > 0.0:
            adj = proposal_ops.snooker_log_adj(theta, cross, z, d, degen)
            log_adj = torch.where(sn_gate, adj, 0.0)
        else:
            log_adj = torch.zeros((G, Np), dtype=theta.dtype,
                                  device=theta.device)
        prop = cross
        if de.beta > 0.0:
            if mut_mask is None:
                mut_mask = draws.uniform((G,)) <= dists.f32(de.beta)
            mut_prop = mutation_ops.mutate(draws, theta, de.sigma)
            prop = torch.where(mut_mask[:, None, None], mut_prop, cross)
            log_adj = torch.where(mut_mask[:, None], 0.0, log_adj)
        if self.int_mask is not None:
            prop = torch.where(self.int_mask, torch.round(prop), prop)
        w_prop = fitness(prop, self._panel(draws, seed, it, block, member))
        acc_src = (key.fold_in(rng.ACCEPT)
                   if callable(de.update_particle) else draws)
        acc = self.update(acc_src, weight, w_prop, log_adj)
        if member is not None:
            acc = acc & self._members[member]
        theta, weight = accept_ops.apply_accept(theta, weight, prop, w_prop,
                                                acc)
        return theta, weight, acc

    def sweep_update(self, draws, theta, weight, it: int, fitness,
                     history=None, block_mask=None, key=None,
                     seed: int = None, block=None):
        """One sweep (``sampler.py:1033``): synchronous, or the sequential
        one's Np member-masked sub-sweeps from the partly updated
        population, the mutation gate drawn once for all of them."""
        de = self.de
        if not de.sequential_sweep:
            return self.do_update(draws, theta, weight, it, fitness,
                                  history, block_mask, key=key, seed=seed,
                                  block=block)
        mut_mask = None
        if de.beta > 0.0:
            mut_mask = draws.uniform((self.G,)) <= dists.f32(de.beta)
        acc_tot = None
        for p0 in range(self.Np):
            theta, weight, acc = self.do_update(
                draws, theta, weight, it, fitness, history, block_mask,
                member=p0, mut_mask=mut_mask, key=key, seed=seed,
                block=block)
            acc_tot = acc if acc_tot is None else acc_tot | acc
        return theta, weight, acc_tot

    def sweeps(self, draws, theta, weight, it: int, fitness, history,
               blocked: bool, key=None, seed: int = None):
        """The iteration's sweeps after migration: one (``blocked`` False)
        or one per block, later blocks from earlier blocks' accepts, the
        last block's accept and lp kept (``block_update!``, ``main.jl:
        174-179``; the JAX step's ``blocked``, ``sampler.py:1066-1075``),
        each block's key folded from the iteration's (``:1067``)."""
        if not blocked:
            return self.sweep_update(draws, theta, weight, it, fitness,
                                     history, key=key, seed=seed)
        for bi, mask in enumerate(self.block_masks):
            kb = (None if key is None
                  else key.fold_in(rng.BLOCK * 1000 + bi))
            theta, weight, acc = self.sweep_update(
                draws, theta, weight, it, fitness, history, mask, kb, seed,
                bi)
        return theta, weight, acc

    def step_core(self, draws, theta, weight, it: int, fitness,
                  history=None, seed: int = None):
        """Migration, then the sweeps (``sampler.py:1055``); returns
        ``(theta [G, Np, d], weight [G, Np], accept [G, Np])``.  A shard
        passes over the migration's draws.  ``seed`` (the run's key) keys
        the custom slots' keys and a stochastic model's panels."""
        theta, weight = self.migrate(draws, theta, weight)
        return self.after_migration(draws, theta, weight, it, fitness,
                                    history, seed, self._flag(it))

    def migrate(self, draws, theta, weight):
        """The iteration's migration (a shard passes over its draws)."""
        if self.g0 is None:
            return migration_ops.maybe_migrate(draws, theta, weight,
                                               self.de.alpha, self.G)
        migration_ops.skip_migration(draws, self.de.alpha, self.de.n_groups,
                                     self.G, self.Np)
        return theta, weight

    def _flag(self, it: int):
        """A callable ``blocking_on``'s value at ``it`` (None where the
        blocks are constant or absent)."""
        if self.block_masks is None or self.blocking is not None:
            return None
        return bool(self.de.blocking_on(_DEView(self.de, it)))

    def after_migration(self, draws, theta, weight, it: int, fitness,
                        history, seed, flag):
        """The sweeps after migration, ``flag`` a callable
        ``blocking_on``'s value (:meth:`_flag`): its other branch's columns
        passed over."""
        key = self._key(seed, it)
        if flag is None:
            return self.sweeps(draws, theta, weight, it, fitness, history,
                               self.block_masks is not None
                               and self.blocking, key, seed)
        if not flag:
            draws.skip((self.G, self.branch_cols[True]))
        out = self.sweeps(draws, theta, weight, it, fitness, history, flag,
                          key, seed)
        if flag:
            draws.skip((self.G, self.branch_cols[False]))
        return out

    # ---- the sweeps as a CUDA graph

    def _graphed(self, draws, theta, weight, it: int, history, seed):
        """The sweeps after migration (:meth:`after_migration`) replayed
        from a CUDA graph, one graph per (burn-in, ``blocking_on`` flag,
        pool offset, history buffer): the step is host-bound, a few hundred
        to thousands of small launches an iteration, and a replay issues
        them in one call.  The first iteration of a key runs eagerly: if it
        launched a kernel of the port (whose wrapper counts its launches)
        or drew from the scalar side channel (a host value the graph would
        keep), the step stays eager.  The next captures the graph on
        static copies of its inputs (the pool's words, θ, w, the iteration
        as a device scalar for DE-MCz's span) and replays it.  The graph
        runs the eager iteration's kernels on the same inputs, so its
        output is the eager output bit for bit.  A density that a capture
        cannot hold (it syncs, or copies from pageable host memory) keeps
        the step eager from that iteration on."""
        flag = self._flag(it)
        gkey = (it <= self.de.burnin, flag, draws.offset,
                None if history is None
                else (history.data_ptr(), tuple(history.shape)))
        g = self._graphs.get(gkey)
        if g is None:
            n0, s0 = _build.launch.calls, draws.scalars.i
            out = self.after_migration(draws, theta, weight, it,
                                       self.fitness, history, seed, flag)
            if _build.launch.calls != n0 or draws.scalars.i != s0:
                self._graphs = None
                self.eager_reason = ("the density launched a kernel of the "
                                     "port" if _build.launch.calls != n0
                                     else "the sweeps drew a host scalar")
            else:
                self._graphs[gkey] = _SweepGraph.SEEN
            return out
        if g is _SweepGraph.SEEN:
            try:
                g = _SweepGraph(self, draws, theta, weight, it, history,
                                seed, flag)
            except RuntimeError as e:   # an operation no capture holds
                self._graphs = None      # (a sync, a pageable host copy)
                self.eager_reason = f"the capture failed: {e}"
                return self.after_migration(draws, theta, weight, it,
                                            self.fitness, history, seed,
                                            flag)
            self._graphs[gkey] = g
        return g.run(draws, theta, weight, it)

    # ---- random numbers

    def _block(self, ns: int, key: int, it: int, n_rows: int, n: int,
               device, chain0: int = 0):
        blk_key, it0, block = self._blocks.get(ns, (None, 0, None))
        if blk_key != key or not it0 <= it < it0 + len(block):
            n_it = max(1, min(64, self.WORDS_PER_BLOCK // (n * n_rows)))
            block = rng.words_block(key, it, n_it, n_rows, n, ns=ns,
                                    device=device, chain0=chain0)
            if ns == rng.SCALAR_NS:
                block = block.to(torch.int64).tolist()
            self._blocks[ns], it0 = (key, it, block), it
        return block[it - it0]

    def draws(self, key: int, it: int) -> rng.Pool:
        """Iteration ``it``'s pool: its ``[G, pool_words]`` words (a
        shard's: its groups' rows) and its scalar side channel."""
        bits = self._block(rng.POOL_NS, key, it, self.pool_words, self.G,
                           self.device, self.g0 or 0).T
        return rng.Pool(bits, rng.Scalars(self.scalar_words(key, it)),
                        self.x64)

    def scalar_words(self, key: int, it: int) -> list:
        """Iteration ``it``'s scalar side channel (host ints), the same
        for every shard."""
        scal = self._block(rng.SCALAR_NS, key, it, rng.Scalars.N_DRAWS, 1,
                           torch.device("cpu"))
        return [w[0] for w in scal]

    # ---- run_scan's interface, as Step's

    def check(self, state: SamplerState, out=None):
        """Raise unless the state (and a trajectory slot) suit the step."""
        C, d = self.G * self.Np, self.d
        if self.de.uses_resample and (
                state.history is None
                or tuple(state.history.shape[1:]) != (self.n_pop, d)
                or state.history.shape[0] < state.iteration):
            raise ValueError("a resample run needs state.history [H, C, d] "
                             "of the population's C chains with a row for "
                             "each iteration")
        dt = self.dtype
        want = [("theta", state.theta, dt, (C, d)),
                ("weight", state.weight, dt, (C,))]
        if out is not None:
            want += [("out[0]", out[0], dt, (C, d)),
                     ("out[1]", out[1], dt, (C,)),
                     ("out[2]", out[2], torch.bool, (C,))]
        for name, t, dt, shape in want:
            if (t.device != state.theta.device or t.dtype != dt
                    or tuple(t.shape) != shape or not t.is_contiguous()
                    or t.device.type != self.device.type):
                raise ValueError(f"{name}: need a contiguous {dt} {shape} "
                                 f"tensor on {self.device}, got {t.dtype} "
                                 f"{tuple(t.shape)} on {t.device}")

    def __call__(self, state: SamplerState, out=None,
                 check: bool = True) -> SamplerState:
        """Advance ``state`` one iteration in place (its tensors are
        updated); ``out`` is an optional trajectory slot."""
        if check:
            self.check(state, out)
        G, Np, d, it = self.G, self.Np, self.d, state.iteration
        draws = self.draws(state.key, it)
        if self._graphs is None:
            theta, weight, acc = self.step_core(
                draws, state.theta.view(G, Np, d), state.weight.view(G, Np),
                it, self.fitness, state.history, seed=state.key)
        else:
            theta, weight = self.migrate(draws, state.theta.view(G, Np, d),
                                         state.weight.view(G, Np))
            theta, weight, acc = self._graphed(draws, theta, weight, it,
                                               state.history, state.key)
        if draws.offset != self.pool_words:
            raise RuntimeError(f"the step took {draws.offset} pool columns "
                               f"of {self.pool_words}")
        state.theta.copy_(theta.reshape(G * Np, d))
        state.weight.copy_(weight.reshape(G * Np))
        if state.history is not None:     # store_samples!, row it - 1
            c0 = (self.g0 or 0) * Np
            state.history[it - 1, c0:c0 + G * Np].copy_(state.theta)
        if out is not None:
            out[0].copy_(state.theta)
            out[1].copy_(state.weight)
            out[2].copy_(acc.reshape(G * Np))
        return state._replace(iteration=it + 1)


class _SweepGraph:
    """One CUDA graph of :meth:`UnfusedStep.after_migration` and its
    static inputs and outputs: the sweeps recorded on copies of an
    iteration's inputs (its words in the eager pool's layout, θ, w, and
    the iteration as an int64 device scalar that DE-MCz's span reads,
    :meth:`rng.Pool.rows_seen`); :meth:`run` copies an iteration's inputs
    in, replays, and moves the eager pool past the columns the sweeps
    took.  On CPU tensors (tests) it reruns the recorded call on the
    static inputs instead of a replay: the same bookkeeping, no graph."""

    SEEN = object()                # a key whose first iteration ran eagerly

    def __init__(self, step, draws, theta, weight, it, history, seed, flag):
        # the graph's inputs outlive an inference_mode() around the run
        with torch.inference_mode(False):
            self.bits = torch.empty_like(draws.bits.T).T
            self.theta = torch.empty_like(theta)
            self.weight = torch.empty_like(weight)
            self.it = torch.zeros((), dtype=torch.int64,
                                  device=theta.device)
        self.offset = draws.offset
        bits, th, w, it_t, offset = (self.bits, self.theta, self.weight,
                                     self.it, self.offset)

        def body():
            """The sweeps on the static inputs; (out, columns taken)."""
            pool = rng.Pool(bits, rng.Scalars(()), step.x64)
            pool.offset, pool.it_tensor = offset, it_t
            out = step.after_migration(pool, th, w, it, step.fitness,
                                       history, seed, flag)
            return out, pool.offset - offset
        self.body, self.graph = body, None
        if theta.device.type == "cuda":
            # captured on a side stream (the default stream cannot be),
            # without torch.cuda.graph's synchronize and empty_cache
            self._load(draws, theta, weight, it)
            cur = _build.stream(theta.device)
            side = torch.cuda.Stream(theta.device)
            side.wait_stream(cur)
            self.graph = torch.cuda.CUDAGraph()
            with torch.cuda.stream(side):
                self.graph.capture_begin(capture_error_mode="thread_local")
                try:
                    self.out, self.cols = body()
                finally:
                    self.graph.capture_end()
            cur.wait_stream(side)
            self.body = None     # the graph holds the work; no cycle back
                                 # to the step keeps its memory alive

    def _load(self, draws, theta, weight, it):
        self.bits.copy_(draws.bits)
        self.theta.copy_(theta)
        self.weight.copy_(weight)
        self.it.fill_(it)

    def run(self, draws, theta, weight, it):
        self._load(draws, theta, weight, it)
        if self.graph is None:
            out, self.cols = self.body()
        else:
            self.graph.replay()
            out = self.out
        draws.offset += self.cols
        return out


def _need_seed(seed, what: str):
    if seed is None:
        raise ValueError(f"{what} is keyed by the run's seed: pass "
                         f"step_core(..., seed=)")


def fused_supported(model: DEModel, de: DE, device="cpu") -> bool:
    """Static predicate: does this configuration step through the kernels
    (:class:`Step`)?  It does where the configuration is float32 and its
    kernel is built for the model's CUDA density with its accept: MH with
    the posterior (K3 for DE-MCz, K1 else, ``_build.KERNEL_DENSITIES``),
    or the greedy max/min with the objective (``evaluate_fitness='fun'``;
    K1 only, not DE-MCz, ``_build.GREEDY_DENSITIES``), as the JAX
    predicate fuses (``demcmc_tpu/ops/fused_step.py:170-198, 287-288``);
    where the blocks, if any, are constant and as many as the kernels are
    built for; and where a group fits one block of the kernel
    (``fused_step.block_chains``, read from the built kernel on a CUDA
    device; the launch's static limit of 1,024 chains on the CPU), as the
    JAX predicate falls back outside its kernel's shapes
    (``demcmc_tpu/ops/fused_step.py:200-204``).  Every other
    configuration (float64, any custom strategy slot and data sharded over
    a mesh's ``data`` axis among them) takes the unfused step."""
    dens = model.cuda_density
    if (dens is None or de.dtype is not np.float32 or de.custom_slots
            or isinstance(model.data, ShardedData)):
        return False
    if de.is_mh:
        if de.fun_fitness:
            return False
        kernel = "resample_step" if de.uses_resample else "de_step"
        built = _build.KERNEL_DENSITIES[kernel]
    else:
        if not de.fun_fitness or de.uses_resample:
            return False
        built = _build.GREEDY_DENSITIES
    if dens.name not in built:
        return False
    if de.blocks is not None and _blocking_const(de) is None:
        return False
    n_blk = len(fused_ops.const_blocks(de))
    if n_blk and n_blk not in _build.BLOCK_COUNTS:
        return False
    greedy = {} if de.is_mh else {"mode": fused_ops.accept_mode(de)}
    return de.Np <= fused_ops.block_chains(
        de.uses_resample, dens, de.sequential_sweep, de.theta_snooker > 0.0,
        max(n_blk, 1), device, **greedy)


class ShardedState(NamedTuple):
    """A run's state split over a chain mesh: one :class:`SamplerState`
    per shard in mesh order, each on its shard's device with its groups'
    chains; the key, the iteration and the gate are the same in all
    (:meth:`ShardedStep.split`, :meth:`ShardedStep.gather`)."""

    shards: tuple

    @property
    def key(self) -> int:
        return self.shards[0].key

    @property
    def iteration(self) -> int:
        return self.shards[0].iteration

    def at(self, iteration: int) -> "ShardedState":
        return ShardedState(tuple(s._replace(iteration=iteration)
                                  for s in self.shards))


class ShardedStep:
    """The step of a run whose groups are split over a chain mesh (the
    JAX package's ``shard_map`` and GSPMD steps, ``demcmc_tpu/sampler.py:
    100-171, 255-297``): one :class:`Step` or :class:`UnfusedStep` per
    shard on its device, each holding a contiguous run of whole groups
    (``fused_step.shard_groups``); groups do not interact within an
    iteration, so each shard steps alone.  Migration, the only operation
    across groups (``demcmc_tpu/parallel/mesh.py:1-12``), runs on the
    whole population: every shard's θ and w are gathered in chain order on
    the mesh's first device, the exchange runs once there (K2 with the
    first shard's gate; for the unfused step, from the migration columns
    of a pool of every group), and each shard's rows are copied back.

    DE-MCz reads the history of every chain: each distinct device of the
    mesh holds a replica of the population's ``[H, C, d]`` history, seeded
    from the state's; a shard runs K3 (or the unfused step) one iteration
    at a time on its device's replica, writing its chains' columns of row
    ``it − 1``, and after each iteration each shard's new rows are copied
    (stream-ordered, no host sync) to the replicas on the other devices.
    Shards on one device share its replica: an iteration reads only rows
    below ``it − 1``, so no shard reads what another writes.

    Under a ``chains × data`` mesh (``parallel.data_mesh``) each shard
    takes the unfused step with its chain row of the model's sharded data
    (``parallel.ShardedData.row``): the likelihood piece by piece on the
    row's data devices.  The kernels' step is not taken under a data axis.

    Over several processes (``owners``, the rank that owns each shard:
    ``parallel.distributed.global_chain_mesh``) a rank steps only its own
    shards, which are a contiguous run of the mesh; the gather before
    migration is a collective all-gather, every rank runs the exchange on
    the same gathered population and keeps its rows, DE-MCz's new history
    rows are all-gathered every iteration, and :meth:`collect` all-gathers
    a run's kept rows.

    Every word is keyed by the population's chain (or group), so a sharded
    run is the unsharded run bit for bit.  The JAX package coalesces a
    window's migration events to its start (``mig_replay``, TPU kernel
    row 1r; ``mig_multi``, ``demcmc_tpu/sampler.py:366-408``) because its
    gate is data-dependent between launches; here the host knows every
    gate before the first launch (:func:`rng.gates`), windows end where a
    gate opens, and each event runs at its own iteration.

    :meth:`split` and :meth:`gather` convert a :class:`SamplerState` to a
    :class:`ShardedState` (this rank's shards) and back; the other methods
    are :class:`Step`'s on a :class:`ShardedState`, with a trajectory slot
    per shard."""

    def __init__(self, model: DEModel, de: DE, spec: ParamSpec, devices,
                 allow_fused: bool = True, owners=None):
        from dataclasses import replace
        devices = [torch.device(d) for d in devices]
        groups = fused_ops.shard_groups(de.n_groups, len(devices))
        self.spans_all = [(g0 * de.Np, (g0 + n) * de.Np)   # each shard's
                          for g0, n in groups]            # chains
        self.owners = None if owners is None else [int(r) for r in owners]
        self.local = list(range(len(devices)))   # this rank's shards
        if self.owners is not None:
            if len(self.owners) != len(devices) \
                    or self.owners != sorted(self.owners):
                raise ValueError(f"owners {self.owners}: one rank a shard, "
                                 f"each rank's shards a contiguous run")
            me = distributed.rank()
            self.local = [i for i, r in enumerate(self.owners) if r == me]
            if not self.local:
                raise ValueError(f"rank {me} owns no shard of the mesh")
            self.counts = [sum(b - a for (a, b), r in zip(
                self.spans_all, self.owners) if r == k)
                for k in range(distributed.world_size())]
        self.devices = [devices[i] for i in self.local]
        self.device = self.devices[0]
        self.groups = [groups[i] for i in self.local]
        self.spans = [self.spans_all[i] for i in self.local]
        models = [model] * len(self.local)
        if isinstance(model.data, ShardedData):
            if model.data.n_rows != len(devices):
                raise ValueError(f"the model's data is sharded over "
                                 f"{model.data.n_rows} chain rows; the "
                                 f"mesh has {len(devices)}")
            models = [replace(model, data=model.data.row(i))
                      for i in self.local]
        self.fused = allow_fused and all(
            fused_supported(m, de, d) for m, d in zip(models, self.devices))
        make = Step if self.fused else UnfusedStep
        self.steps = [make(m, de, spec, dev, groups=g)
                      for m, dev, g in zip(models, self.devices,
                                           self.groups)]
        self.G, self.Np, self.d = de.n_groups, de.Np, spec.dim
        self.alpha = float(de.alpha) if de.n_groups > 1 else 0.0
        self.resample = de.uses_resample

    # ---- the state across the mesh

    def split(self, state: SamplerState) -> ShardedState:
        """This rank's shards of the state, each shard's chains copied to
        its device; for DE-MCz one replica of the history a device."""
        replicas = {}

        def history(dev):
            if state.history is None:
                return None
            if dev not in replicas:
                replicas[dev] = state.history.to(dev, copy=True)
            return replicas[dev]
        return ShardedState(tuple(state._replace(
            theta=state.theta[a:b].to(dev, copy=True).contiguous(),
            weight=state.weight[a:b].to(dev, copy=True).contiguous(),
            fire=state.fire.to(dev, copy=True), history=history(dev))
            for (a, b), dev in zip(self.spans, self.devices)))

    def gather(self, state: ShardedState) -> SamplerState:
        """The whole population on this rank's first device (the mesh's
        first device in one process), with the history of its replica."""
        theta, weight = self._gathered(state)
        s0 = state.shards[0]
        return s0._replace(theta=theta, weight=weight,
                           fire=s0.fire.to(self.device, copy=True))

    def _gathered(self, state: ShardedState):
        theta = torch.cat([s.theta.to(self.device) for s in state.shards])
        weight = torch.cat([s.weight.to(self.device) for s in state.shards])
        if self.owners is not None:
            theta = distributed.all_gather_chains(theta, self.counts)
            weight = distributed.all_gather_chains(weight, self.counts)
        return theta, weight

    def _scatter(self, state: ShardedState, theta, weight):
        for (a, b), s in zip(self.spans, state.shards):
            s.theta.copy_(theta[a:b])
            s.weight.copy_(weight[a:b])

    def _share_rows(self, state: ShardedState, r0: int, r1: int):
        """DE-MCz: history rows ``r0 .. r1-1``, each shard's columns
        written on its device's replica, copied to every other replica
        (and, over processes, all-gathered from every rank)."""
        if not self.resample:
            return
        replicas = list({id(s.history): s.history
                         for s in state.shards}.values())
        if len(replicas) > 1:
            for (a, b), s in zip(self.spans, state.shards):
                for h in replicas:
                    if h is not s.history:
                        h[r0:r1, a:b].copy_(s.history[r0:r1, a:b],
                                            non_blocking=True)
        if self.owners is not None:
            lo, hi = self.spans[0][0], self.spans[-1][1]
            rows = distributed.all_gather_chains(
                state.shards[0].history[r0:r1, lo:hi], self.counts, dim=1)
            for h in replicas:
                h[r0:r1].copy_(rows, non_blocking=True)

    def collect(self, ys: "StepOutput") -> "StepOutput":
        """A run's kept rows of this rank's chains as every rank's, the
        population's in chain order (over processes an all-gather; in one
        process they already are)."""
        if self.owners is None or ys is None:
            return ys
        dev = distributed.layout().device
        out = []
        for x in (ys.theta, ys.accept, ys.lp):
            t = torch.from_numpy(np.ascontiguousarray(x)).to(dev)
            out.append(distributed.all_gather_chains(
                t, self.counts, dim=1).cpu().numpy())
        return StepOutput(theta=out[0], accept=out[1], lp=out[2])

    def migrate(self, state: ShardedState, it: int):
        """Migration before iteration ``it`` on the whole population: K2
        (or its plain version) gated on the first shard's device-side
        flag; for the unfused step, where the host's gate opens, the
        exchange from the migration columns of iteration ``it``'s pool of
        every group (the shards' pools pass over them)."""
        if self.alpha <= 0.0:
            return
        if self.fused:
            theta, weight = self._gathered(state)
            migration_ops.migrate(theta, weight, state.shards[0].fire,
                                  self.G, self.Np, seed=state.key, it=it,
                                  check=False)
        else:
            scal = self.steps[0].scalar_words(state.key, it)
            if rng.Scalars(scal).uniform() > float(np.float32(self.alpha)):
                return
            theta, weight = self._gathered(state)
            bits = rng.words(state.key, it, 1 + self.Np, self.G,
                             ns=rng.POOL_NS, device=self.device).T
            th, w = migration_ops.maybe_migrate(
                rng.Pool(bits, rng.Scalars(scal), self.steps[0].x64),
                theta.view(self.G, self.Np, self.d),
                weight.view(self.G, self.Np), self.alpha, self.G)
            theta, weight = th.reshape(-1, self.d), w.reshape(-1)
        self._scatter(state, theta, weight)

    # ---- Step's interface

    def check(self, state: ShardedState, out=None):
        """Raise unless every shard's state (and trajectory slot) suits
        its step."""
        outs = out if out is not None else [None] * len(self.steps)
        for step, s, o in zip(self.steps, state.shards, outs):
            step.check(s, o)

    def __call__(self, state: ShardedState, out=None, check: bool = True,
                 phase: str = "all") -> ShardedState:
        """One iteration: migration (:meth:`migrate`), then each shard's
        step (and DE-MCz's history row shared); ``out`` a trajectory slot
        per shard, or None."""
        it = state.iteration
        self.migrate(state, it)
        outs = out if out is not None else [None] * len(self.steps)
        kw = {"phase": phase} if self.fused else {}
        state = ShardedState(tuple(
            step(s, o, check=check, **kw)
            for step, s, o in zip(self.steps, state.shards, outs)))
        self._share_rows(state, it - 1, it)
        return state

    def window(self, state: ShardedState, w: Window, traj=None):
        """Window ``w`` (:meth:`Step.window`): migration on the whole
        population where ``w.migrate``, then one K1 (K3) launch per shard
        (and DE-MCz's history rows shared); ``traj`` a trajectory per
        shard, or None."""
        if w.migrate:
            self.migrate(state, w.it0)
        trajs = traj if traj is not None else [None] * len(self.steps)
        for step, s, t in zip(self.steps, state.shards, trajs):
            step.window(s, w, t)
        self._share_rows(state, w.it0 - 1, w.it0 - 1 + w.K)

    @property
    def superstep_k(self) -> int:
        return self.steps[0].superstep_k

    def plan(self, state: ShardedState, n_iter: int, thin: int = 1,
             fire=None, switch: int = None, store: bool = True, cuts=(),
             skip: int = 0):
        """The run's windows (:meth:`Step.plan`): the gates are the
        population's, the same for every shard."""
        return self.steps[0].plan(state.shards[0], n_iter, thin, fire,
                                  switch, store, cuts, skip)

    def advance(self, state: ShardedState, n_iter: int, thin: int = 1,
                traj=None, fire=None, switch: int = None) -> ShardedState:
        """:meth:`Step.advance` over the mesh."""
        for w in self.plan(state, n_iter, thin, fire, switch,
                           store=traj is not None):
            self.window(state, w, traj)
        return state.at(state.iteration + n_iter)

    def get_superstep(self):
        return lambda state, out=None: self.advance(
            state, self.superstep_k, 1, out)

    def get_thin_step(self, thin: int):
        return lambda state, out=None: self.advance(state, thin, thin, out)

    def get_post_burnin(self):
        if not self.fused or self.steps[0].get_post_burnin() is None:
            return None
        return functools.partial(self, phase="post")


def _kernels(step) -> bool:
    """True for the kernels' step, on one device or over a mesh."""
    return isinstance(step, (Step, RepShardedStep)) or (
        isinstance(step, ShardedStep) and step.fused)


def _on_mesh(mesh, device):
    """``(devices, device)`` of a call with ``mesh=`` and ``device=``:
    the mesh's chain shards' devices, or None without a mesh or with a
    mesh of one chain shard (the plain path on it), and the device the
    state starts on (over processes, this rank's first shard's).  Raises
    for a non-mesh and for a ``device=`` that differs from the mesh's
    devices."""
    if mesh is None:
        return None, resolve_device(device)
    devices = mesh_devices(mesh)
    first = 0
    if mesh.owners is not None:
        first = mesh.owners.index(distributed.rank())
    if device is not None:
        want = torch.device(device)
        if want.type == "cuda" and want.index is None:
            want = torch.device("cuda", torch.cuda.current_device()
                                if torch.cuda.is_available() else 0)
        mine = (devices if mesh.owners is None else
                [d for d, r in zip(devices, mesh.owners)
                 if r == distributed.rank()])
        if any(d != want for d in mine):
            raise ValueError(f"device={device} with a mesh of "
                             f"{[str(d) for d in devices]}: pass one or "
                             f"the other")
    devices = [resolve_device(d) for d in devices]
    return (devices if len(devices) > 1 else None), devices[first]


def build_step(model: DEModel, de: DE, spec: ParamSpec, device=None,
               allow_fused: bool = True, mesh=None):
    """The one-iteration step for this configuration on ``device``: the
    kernels' :class:`Step` where :func:`fused_supported`, else (or with
    ``allow_fused=False``, or under a mesh's ``data`` axis) the
    :class:`UnfusedStep`; over a mesh of more than one chain shard, a
    :class:`ShardedStep` of them (a mesh of one chain shard is the plain
    path on its device).  The choice depends on the model and the
    configuration only; a kernel that fails to build or launch raises."""
    devices, device = _on_mesh(mesh, device)
    if has_data_axis(mesh):
        allow_fused = False
    if devices is not None:
        return ShardedStep(model, de, spec, devices, allow_fused,
                           owners=mesh.owners)
    if allow_fused and fused_supported(model, de, device):
        return Step(model, de, spec, device)
    return UnfusedStep(model, de, spec, device)


def _trajectory_run(step, state, n_iter: int, thin: int, body,
                    collect: bool = True):
    """Allocate the whole trajectory (in the state's dtype; for a
    :class:`ShardedState` a list of one per shard, on its device), check
    once, run ``body(state, traj)`` and bring the stored rows to the host
    (the shards' chains side by side); with ``collect=False`` no trajectory
    at all (``traj`` None, no buffer, no copy; returns ``(state,
    None)``).  :func:`run_loop`'s storage: the reference's, kept simple."""
    if thin < 1 or n_iter % thin:
        raise ValueError(f"n_iter ({n_iter}) must be a positive multiple "
                         f"of thin ({thin})")
    if not collect:
        step.check(state)
        return body(state, None), None
    sharded = isinstance(state, ShardedState)
    T = n_iter // thin
    trajs = []
    for s in (state.shards if sharded else (state,)):
        (C, d), dev, dt = s.theta.shape, s.theta.device, s.theta.dtype
        trajs.append((torch.empty((T, C, d), dtype=dt, device=dev),
                      torch.empty((T, C), dtype=dt, device=dev),
                      torch.empty((T, C), dtype=torch.bool, device=dev)))
    traj = trajs if sharded else trajs[0]
    step.check(state, _row(traj, 0))
    state = body(state, traj)
    theta, lp, acc = (
        np.concatenate(x, 1) if sharded else x[0]
        for x in ([t[i].cpu().numpy() for t in trajs] for i in range(3)))
    ys = StepOutput(theta=theta, accept=acc, lp=lp)
    return state, (step.collect(ys) if isinstance(step, ShardedStep)
                   else ys)


def _row(traj, t: int):
    """Trajectory row ``t`` as a slot: ``(θ, w, acc)``, or a list of one
    per shard."""
    if isinstance(traj, list):
        return [_row(x, t) for x in traj]
    return tuple(x[t] for x in traj)


def _slot(traj, t0: int, n: int):
    """Rows ``t0 .. t0+n-1`` of a trajectory, a tuple of tensors or a
    :class:`_Rows`, as a window's slot."""
    if isinstance(traj, _Rows):
        return traj.slot(t0, n)
    return tuple(x[t0:t0 + n] for x in traj)


class _Rows:
    """The kept trajectory rows of one device's chains as a run stores
    them, in order: ``T`` rows of θ ``[C, d]``, w ``[C]`` (the state's
    dtype) and the accept flags ``[C]``, on the host at the end.

    On the CPU a slot is a slice of the host tensors.  On a CUDA device
    the rows go to one of ``N_BUF`` device buffers in turn, each of
    ``cap`` rows (about ``BUF_BYTES``, and at least the most one window
    stores, ``min_rows``); a buffer is closed where the next slot would
    not fit, so a window never straddles two.  A closed buffer's rows are
    copied, ``non_blocking``, on a stream of their own into pinned host
    memory, after an event recorded on the compute stream; the compute
    stream waits for that copy's event before it writes the buffer again.
    Neither waits on the host: only :meth:`wait` does (the end of a run,
    the monitor's rows).  A failed pinned allocation, stream or copy
    raises."""

    N_BUF = 3
    BUF_BYTES = 4 << 20

    def __init__(self, T: int, C: int, d: int, dtype, device,
                 min_rows: int = 1):
        self.T, self.device = T, torch.device(device)
        self.cuda = self.device.type == "cuda"
        shapes = ((T, C, d), (T, C), (T, C))
        dts = (dtype, dtype, torch.bool)
        self.host = tuple(torch.empty(sh, dtype=dt, pin_memory=self.cuda)
                          for sh, dt in zip(shapes, dts))
        if self.cuda and T and not all(h.is_pinned() for h in self.host):
            raise RuntimeError("the trajectory's host rows are not pinned")
        self.next = 0                 # rows handed out so far
        self.cap = 0
        if not self.cuda or T == 0:
            return
        row = C * (d + 1) * torch.empty((), dtype=dtype).element_size() + C
        self.cap = min(T, max(min_rows, -(-self.BUF_BYTES // row)))
        self.bufs = [tuple(torch.empty((self.cap,) + sh[1:], dtype=dt,
                                       device=self.device)
                           for sh, dt in zip(shapes, dts))
                     for _ in range(self.N_BUF)]
        self.freed = [None] * self.N_BUF   # each buffer's last copy done
        self.stream = torch.cuda.Stream(self.device)
        self.k, self.cur, self.base, self.done = -1, None, 0, None

    def slot(self, t0: int, n: int):
        """The slot of rows ``t0 .. t0+n-1`` (``[n, C, d]``, ``[n, C]``,
        ``[n, C]``), the next rows of the run."""
        if t0 != self.next or t0 + n > self.T:
            raise RuntimeError(f"rows {t0}..{t0 + n - 1} out of order "
                               f"(next {self.next} of {self.T})")
        if not self.cuda:
            self.next = t0 + n
            return tuple(x[t0:t0 + n] for x in self.host)
        if self.cur is None or t0 + n - self.base > self.cap:
            self.flush()              # rows base .. t0-1
            self.k = (self.k + 1) % self.N_BUF
            if self.freed[self.k] is not None:
                _build.stream(self.device).wait_event(
                    self.freed[self.k])
            self.cur, self.base = self.bufs[self.k], t0
        self.next = t0 + n
        off = t0 - self.base
        return tuple(x[off:off + n] for x in self.cur)

    def probe(self):
        """A one-row slot that :meth:`Step.check` can check (no row is
        handed out), or None without rows."""
        if self.T == 0:
            return None
        return tuple(x[0] for x in (self.bufs[0] if self.cuda
                                    else self.host))

    def flush(self):
        """Copy the open buffer's rows to the host (without waiting)."""
        if not self.cuda or self.cur is None:
            return
        n = self.next - self.base
        if n:
            ready = torch.cuda.Event()
            ready.record(_build.stream(self.device))
            with torch.cuda.stream(self.stream):
                self.stream.wait_event(ready)
                for h, b in zip(self.host, self.cur):
                    h[self.base:self.next].copy_(b[:n], non_blocking=True)
                ev = torch.cuda.Event()
                ev.record(self.stream)
            self.freed[self.k] = self.done = ev
        self.cur = None

    def wait(self):
        """Every row handed out on the host: flush, then block until the
        last copy is done."""
        self.flush()
        if self.cuda and self.done is not None:
            self.done.synchronize()

    def rows(self, i: int, lo: int, hi: int) -> np.ndarray:
        """Rows ``lo .. hi-1`` of field ``i`` (0 θ, 1 w, 2 accept) on the
        host; :meth:`wait` first."""
        return self.host[i][lo:hi].numpy()


class _Store:
    """A run's kept rows over its shards (one :class:`_Rows` each, the
    whole population for an unsharded run); ``traj`` is what the steps
    take: the one :class:`_Rows`, or the list of them."""

    def __init__(self, state, T: int, min_rows: int = 1):
        self.sharded = isinstance(state, ShardedState)
        self.parts = [_Rows(T, *s.theta.shape, s.theta.dtype,
                            s.theta.device, min_rows)
                      for s in (state.shards if self.sharded else (state,))]
        self.traj = self.parts if self.sharded else self.parts[0]

    @property
    def next(self) -> int:
        return self.parts[0].next

    def row(self, t: int):
        """Trajectory row ``t`` as a one-iteration slot (or a list)."""
        out = [tuple(x[0] for x in p.slot(t, 1)) for p in self.parts]
        return out if self.sharded else out[0]

    def probe(self):
        out = [p.probe() for p in self.parts]
        return out if self.sharded else out[0]

    def wait(self):
        for p in self.parts:
            p.flush()
        for p in self.parts:
            p.wait()

    def rows(self, i: int, lo: int, hi: int) -> np.ndarray:
        """Rows ``lo .. hi-1`` of field ``i``, the shards' chains side by
        side; :meth:`wait` first."""
        x = [p.rows(i, lo, hi) for p in self.parts]
        return np.concatenate(x, 1) if self.sharded else x[0]

    def result(self) -> StepOutput:
        """The rows handed out, on the host."""
        self.wait()
        theta, lp, acc = (self.rows(i, 0, self.next) for i in range(3))
        return StepOutput(theta=theta, accept=acc, lp=lp)


PROGRESS_CHUNKS = 20      # chunks of a run with progress or stop_rhat


def chunk_schedule(n_iter: int, thin: int = 1, checkpoint_every: int = 0,
                   progress: bool = False, stop: bool = False,
                   switch: int = None) -> list:
    """The chunks of a run, in outer steps (``n_iter / thin``), as the JAX
    ``run_scan`` cuts them (``demcmc_tpu/sampler.py:1254-1261,
    1372-1391``): ``checkpoint_every`` rounded up to outer steps, at most
    ``ceil(n_outer / PROGRESS_CHUNKS)`` with ``progress`` or ``stop``
    (``stop_rhat``), and a cut at the phase-2 ``switch`` (a run index)
    where it falls on an outer step inside the run."""
    if thin < 1 or n_iter % thin:
        raise ValueError(f"n_iter ({n_iter}) must be a positive multiple "
                         f"of thin ({thin})")
    n = n_iter // thin
    if checkpoint_every and checkpoint_every > 0 and thin > 1:
        checkpoint_every = max(1, math.ceil(checkpoint_every / thin))
    chunk = n
    if checkpoint_every and checkpoint_every > 0:
        chunk = min(chunk, checkpoint_every)
    if progress or stop:
        chunk = min(chunk, max(1, math.ceil(n / PROGRESS_CHUNKS)))
    cut = None
    if switch is not None and 0 < switch < n_iter and switch % thin == 0:
        cut = switch // thin
    out, done = [], 0
    while done < n:
        m = min(chunk, n - done)
        if cut is not None and done < cut:
            m = min(m, cut - done)
        out.append(m)
        done += m
    return out


def _at(state, iteration: int):
    if isinstance(state, ShardedState):
        return state.at(iteration)
    return state._replace(iteration=iteration)


def run_scan(step, state, n_iter: int, thin: int = 1, phase2: int = None,
             collect: bool = True, *, skip: int = 0, progress: bool = False,
             checkpoint_every: int = 0, checkpoint_path=None, monitor=None,
             monitor_skip: int = 0, stop_check=None):
    """Run ``n_iter`` iterations, storing every ``thin``-th (iterations
    thin, 2·thin, ... of the run) but the first ``skip`` of those
    (``sample()`` skips the burn-in's with ``discard_burnin``); returns
    ``(state, StepOutput)`` with the stored rows on the host, or ``(state,
    None)`` with ``collect=False`` (optimization: no trajectory).

    The run is the JAX ``run_scan``'s chunk loop (``demcmc_tpu/
    sampler.py:1226-1448``): chunks of outer steps (:func:`chunk_schedule`),
    and at each chunk's end the progress line, a periodic asynchronous
    checkpoint to ``checkpoint_path`` (``checkpoint_every`` iterations,
    :func:`~demcmc_tpu_torch.utils.checkpoint.save_state`, joined before
    the next and at the end), the streaming ``monitor`` (fed the stored
    rows from run row ``monitor_skip`` on) and ``stop_check()``, which ends
    the run there (only the rows taken are returned).  The kernels'
    :class:`Step` runs one plan of K-iteration windows for the whole run
    (one read of ``state.fire``, the gates computed once), cut at every
    chunk's edge as well; ``phase2`` is the run index from which they take
    the post-burn-in variant (:func:`sample` wires it).  The unfused step
    runs one iteration at a time.  A :class:`ShardedStep` runs a
    :class:`ShardedState` the same way.

    The stored rows stream to the host as the run goes (:class:`_Rows`:
    device buffers copied on a side stream into pinned memory); the host
    waits for them only for the monitor and at the end."""
    kernels = _kernels(step)
    if phase2 is not None and not kernels:
        raise ValueError("phase2 needs the kernels' Step")
    chunks = chunk_schedule(n_iter, thin, checkpoint_every, progress,
                            stop_check is not None, phase2)
    n_out = n_iter // thin
    skip = min(max(int(skip), 0), n_out) if collect else 0
    edges = [0, *itertools.accumulate(c * thin for c in chunks)]
    it0 = state.iteration
    plan = None
    if kernels:
        plan = step.plan(state, n_iter, thin, switch=phase2, store=collect,
                         cuts=edges[1:-1], skip=skip)
    store = traj = None
    if collect:
        store = _Store(state, n_out - skip,
                       max([w.n_emit for w in plan or ()] + [1]))
        traj = store.traj
    step.check(state, store.probe() if store is not None else None)
    ckpt_every = checkpoint_every if checkpoint_every and \
        checkpoint_every > 0 else 0
    if ckpt_every and thin > 1:
        ckpt_every = max(1, math.ceil(ckpt_every / thin))
    ckpt_future, last_ckpt, fed, wi, done = None, 0, 0, 0, 0
    t0 = done0 = None
    for n, a, b in zip(chunks, edges[:-1], edges[1:]):
        if kernels:
            while wi < len(plan) and plan[wi].it0 - it0 < b:
                step.window(state, plan[wi], traj)
                wi += 1
            state = _at(state, it0 + b)
        else:
            for i in range(a, b):
                t = (i + 1) // thin - 1 - skip
                out = (store.row(t) if store is not None
                       and (i + 1) % thin == 0 and t >= 0 else None)
                state = step(state, out, check=False)
        done += n
        if monitor is not None and store is not None:
            lo, hi = max(fed, monitor_skip - skip), store.next
            if lo < hi:
                store.wait()
                monitor.update(store.rows(0, lo, hi))
            fed = max(fed, hi)
        if progress:
            # rate and ETA as the reference's ProgressMeter, clocked from
            # the end of the first chunk
            if t0 is None:
                t0, done0, tail = time.perf_counter(), done, ""
            else:
                rate = ((done - done0) * thin
                        / max(time.perf_counter() - t0, 1e-9))
                eta = (n_out - done) * thin / max(rate, 1e-9)
                tail = f"  ({rate:,.0f} it/s, ETA {eta:,.1f}s)"
            if monitor is not None:
                r = monitor.max_rhat()
                if r is not None:
                    tail += f"  R̂max {r:.3f}"
            print(f"\r[demcmc_tpu_torch] {done * thin}/{n_iter} iterations"
                  f"{tail}", end="", flush=True)
        if (ckpt_every and checkpoint_path
                and done - last_ckpt >= ckpt_every):
            last_ckpt = done
            if ckpt_future is not None:
                ckpt_future.result()     # one write at a time; errors here
            snap = (step.gather(state) if isinstance(state, ShardedState)
                    else state)
            ckpt_future = checkpoint.save_state(checkpoint_path, snap,
                                                async_=True)
        if stop_check is not None and done < n_out and stop_check():
            if progress:
                print(f"\n[demcmc_tpu_torch] convergence target reached at "
                      f"{done * thin}/{n_iter} iterations", flush=True)
            break
    if progress:
        print()
    if ckpt_future is not None:
        ckpt_future.result()             # join the last write
    if store is None:
        return state, None
    ys = store.result()
    return state, (step.collect(ys) if isinstance(step, ShardedStep)
                   else ys)


def run_loop(step, state: SamplerState, n_iter: int, thin: int = 1,
             collect: bool = True):
    """:func:`run_scan` one iteration at a time through ``step(state,
    out)`` (for :class:`Step`: K2, gated on the device flag, and K1 at
    every iteration, or K3), storing every stored row, burn-in included,
    in one trajectory on the device copied at the end: the reference the
    chunked runs are held against."""
    def body(s, traj):
        for i in range(n_iter):
            out = None
            if traj is not None and (i + 1) % thin == 0:
                out = _row(traj, (i + 1) // thin - 1)
            s = step(s, out, check=False)
        return s
    return _trajectory_run(step, state, n_iter, thin, body, collect)


def sample(model: DEModel, de: DE, *args, key: int = 0,
           progress: bool = False, thin: int = 1,
           return_state: bool = False, state: SamplerState = None,
           device=None, mesh=None, checkpoint_every: int = 0,
           checkpoint_path: str = None, monitor: bool = False,
           stop_rhat: float = None, allow_fused: bool = True):
    """Sample from the posterior (reference ``sample``,
    ``src/main.jl:19-42``): ``sample(model, de, n_iter)`` or
    ``sample(model, de, MCMCThreads(), n_iter)``.

    ``key`` is the integer Philox seed, ``thin`` keeps every thin-th draw
    (``n_iter`` and, with ``discard_burnin``, ``burnin`` divisible by it),
    ``state`` resumes from a returned or loaded state (it is not
    modified), ``return_state`` also returns the final state,
    ``allow_fused=False`` takes the unfused step (:func:`build_step`).
    ``mesh`` (a :func:`~demcmc_tpu_torch.parallel.chain_mesh`, a
    ``data_mesh`` with the model's data from ``shard_data``, or
    ``distributed.global_chain_mesh()`` over several processes) splits
    the groups over its devices (:class:`ShardedStep`; the state starts
    on, and a returned state is gathered to, its first device, over
    processes this rank's; bitwise the unsharded run, DE-MCz included;
    over processes every rank returns the same ``Chains``); ``device=``
    with a mesh must name the mesh's devices.  Over several processes
    ``checkpoint_every``, ``monitor`` and ``stop_rhat`` raise
    ``NotImplementedError`` (ROADMAP.md A10 rest 6).

    As in the JAX package (``demcmc_tpu/sampler.py:1451-1575``):
    ``progress`` prints a progress line (rate, ETA and, when monitoring,
    R̂max); ``checkpoint_every``/``checkpoint_path`` save the state every
    that many iterations, asynchronously and atomically
    (:func:`~demcmc_tpu_torch.load_state` and ``state=`` resume it, bit
    for bit); ``monitor`` streams a split-R̂ and ESS over the post-burn-in
    draws as they reach the host, attached to the chains as ``.monitor``
    (:class:`~demcmc_tpu_torch.utils.monitor.ConvergenceMonitor`);
    ``stop_rhat`` (implies ``monitor``) ends the run at the first chunk
    boundary where the streaming R̂max is at or below it, never before 50
    stored post-burn-in draws, and returns only the draws taken.  None of
    them changes the draws.  Returns a :class:`Chains`."""
    args = [a for a in args if not isinstance(a, MCMCThreads)]
    if len(args) != 1:
        raise TypeError("expected sample(model, de, n_iter) or "
                        "sample(model, de, MCMCThreads(), n_iter)")
    n_iter = int(args[0])
    if thin > 1 and de.discard_burnin and de.burnin % thin:
        raise ValueError(f"burnin ({de.burnin}) must be divisible by "
                         f"thin ({thin})")
    devices, device = _on_mesh(mesh, device)
    _refuse_across_processes(mesh, checkpoint_every=checkpoint_every,
                             monitor=monitor or stop_rhat is not None)
    spec = make_spec(model, de)
    if state is None:
        state = init_state(model, de, spec, key, device=device)
    else:
        state = state._replace(**{
            k: getattr(state, k).to(device, copy=True).contiguous()
            for k in ("theta", "weight", "fire", "history")
            if getattr(state, k) is not None})
    state = _grow_history(state, n_iter)
    step = build_step(model, de, spec,
                      device=device if mesh is None else None,
                      allow_fused=allow_fused, mesh=mesh)
    if devices is not None:
        state = step.split(state)
    mon = None
    if monitor or stop_rhat is not None:
        mon = ConvergenceMonitor()
    stop_check = None
    if stop_rhat is not None:
        def stop_check():
            if mon.n < 50:           # too few draws for a stable R̂
                return False
            r = mon.max_rhat()
            return r is not None and np.isfinite(r) and r <= stop_rhat
    skip = de.burnin // thin if de.discard_burnin else 0
    state, ys = run_scan(step, state, n_iter, thin=thin,
                         phase2=_phase2(step, de, state, n_iter), skip=skip,
                         progress=progress,
                         checkpoint_every=checkpoint_every,
                         checkpoint_path=checkpoint_path, monitor=mon,
                         monitor_skip=de.burnin // thin,
                         stop_check=stop_check)
    # an early stop returns the draws taken
    n_iter = (ys.theta.shape[0] + min(skip, n_iter // thin)) * thin
    if devices is not None:
        state = step.gather(state)
    chains = bundle_samples(model, de, spec, ys, n_iter, thin=thin)
    if mon is not None:
        chains.monitor = mon
    if return_state:
        return chains, state
    return chains


def _refuse_across_processes(mesh, checkpoint_every=0, monitor=False,
                             what=None):
    """Raise ``NotImplementedError`` (ROADMAP.md A10 rest 6) for what a run
    over several processes (a mesh with ``owners``) does not carry yet:
    checkpoints, the monitor and ``stop_rhat``, or ``what``."""
    if getattr(mesh, "owners", None) is None:
        return
    if checkpoint_every and checkpoint_every > 0:
        what = "checkpoints (checkpoint_every)"
    elif monitor:
        what = "the streaming monitor (monitor, stop_rhat)"
    if what is not None:
        raise NotImplementedError(
            f"{what} under a process group (a mesh over several ranks) "
            f"is not ported to demcmc_tpu_torch yet (ROADMAP.md A10 rest "
            f"6); run it in one process")


def _phase2(step, de: DE, state, n_iter: int):
    """The run index from which the kernels' step takes its post-burn-in
    variant (``demcmc_tpu/sampler.py:1537-1556``), bitwise equal; windows
    store by thin on either side of the switch, so it needs no alignment
    to thin.  None where there is no switch in the run."""
    if not _kernels(step) or step.get_post_burnin() is None:
        return None
    remaining = max(de.burnin - (state.iteration - 1), 0)
    return remaining if remaining < n_iter else None


def bundle_samples(model: DEModel, de: DE, spec: ParamSpec, ys: StepOutput,
                   n_iter: int, thin: int = 1) -> Chains:
    """Trajectory to :class:`Chains` (reference ``bundle_samples``,
    ``src/main.jl:222-250``): the burn-in draws left out when
    ``discard_burnin`` (dropped here from a trajectory that stored them,
    as :func:`run_loop`'s; a chunked run's never stored them); per-chain
    acceptance and lp internals.  With ``n_initial > 0`` the output is
    the run's iterations burnin+1 .. n_iter, not history rows
    (``demcmc_tpu/sampler.py:1591-1594``)."""
    offset = de.burnin if de.discard_burnin else 0
    if offset >= n_iter and de.discard_burnin:
        raise ValueError(f"burnin ({de.burnin}) >= n_iter ({n_iter}); "
                         "nothing left to return")
    offset //= thin
    rows, full = np.asarray(ys.theta).shape[0], n_iter // thin
    drop = offset if rows == full else 0
    if rows - drop != full - offset:
        raise ValueError(f"{rows} trajectory rows for {n_iter} iterations "
                         f"(thin {thin}, {offset} burn-in rows)")
    return Chains.from_samples(np.asarray(ys.theta)[drop:],
                               np.asarray(ys.accept)[drop:],
                               np.asarray(ys.lp)[drop:], spec)


# ------------------------------------------------------ replicated runs
#
# R whole runs, one dataset each, as one batch (the JAX package's
# ``sample_replicated``/``sample_replicated_packed``, ``demcmc_tpu/
# sampler.py:1688-1877``).  The JAX package memoizes its ``jit`` wrappers
# in a bounded LRU (``_replicated_jit``, ``:1607-1638``) so that a repeated
# call does not re-trace; the port traces nothing and builds each kernel
# once per process (``ops/_build.py``), so it keeps no such cache.


class RepStep(Step):
    """The replicated kernels' step: one :class:`Step` over the R
    replications' populations laid out group-contiguous (replication r
    owns chains ``r·c_rep .. (r+1)·c_rep − 1``, ``c_rep = G·Np``), each
    window one replicated K1 launch (:func:`.ops.fused_step.de_step_rep`)
    and migration the segmented K2 (:func:`.ops.migration.
    migrate_segments`), one CTA a replication.

    ``packed_key`` None: ``sample_replicated``'s step.  Replication r's
    words are those of its solo run (seed ``seeds[r]``, local chain
    words), its gates its solo gates (:func:`rng.rep_gates`); a window
    ends where any replication's gate opens, and K2 exchanges in the
    replications whose device-side gate ``fire[r]`` is open, so each
    replication is its solo run bit for bit.  Otherwise a packed run's
    step: K1 on one stream (every seed ``packed_key``, the population's
    chain words) with migration off in the kernel, and before each window
    K2 once where the window holds an (iteration, replication) event
    (:func:`rng.packed_events`), each replication's events replayed in its
    own groups."""

    def __init__(self, models, de: DE, spec: ParamSpec, device, seeds,
                 packed_key: int = None):
        from dataclasses import replace
        self.packed_alpha = 0.0
        if packed_key is not None:
            self.packed_alpha = float(de.alpha) if de.n_groups > 1 else 0.0
            de = replace(de, alpha=0.0)
            seeds = [int(packed_key)] * len(models)
        super().__init__(models[0], de, spec, device)
        self.reps = fused_ops.Replicas(
            tuple(int(x) for x in seeds), packed_key is None,
            self.cfg.G * self.cfg.Np,
            DensityTable.stack(m.cuda_density for m in models),
            tuple(models))
        self.cfg = fused_ops.rep_config(self.cfg, self.reps)
        self.n_all = self.cfg.G * self.cfg.Np
        self.G1 = de.n_groups                 # groups a replication
        self._replays = {}        # a packed plan's events by window start
        if self.device.type == "cuda":
            fused_ops.rep_entry(self.cfg.density, self.cfg.mode)

    def check(self, state: SamplerState, out=None):
        if self.device.type == "cuda":
            fused_ops.check_cuda(self.cfg, state.theta, state.weight,
                                 state.fire, out=out)

    def _migrate(self, state: SamplerState, it: int, K: int):
        """The migration before window ``it .. it+K-1``: each replication
        whose gate is open (the device-side ``fire[r]``), or a packed
        window's events."""
        if self.packed_alpha > 0.0:
            ev = self._replays.get((it, K))
            if ev is None:
                ev = self._events(it, K)
            if ev is not False:
                migration_ops.migrate_segments(
                    state.theta, state.weight, self.G1, self.cfg.Np,
                    self.reps, it, events=ev, check=False)
        elif self.migrates:
            migration_ops.migrate_segments(
                state.theta, state.weight, self.G1, self.cfg.Np, self.reps,
                it, fire=state.fire, check=False)

    def __call__(self, state: SamplerState, out=None, check: bool = True,
                 phase: str = "all") -> SamplerState:
        """One iteration in place: K2 (each open gate, or the packed
        iteration's events), then the replicated K1."""
        if check:
            self.check(state, out)
        it = state.iteration
        self._migrate(state, it, 1)
        fused_ops.de_step_rep(self.cfg, self.spec, state.theta,
                              state.weight, state.fire, it, out=out,
                              check=False, phase=phase)
        return state._replace(iteration=it + 1)

    def window(self, state: SamplerState, w: Window, traj=None):
        """Window ``w``: K2 first (where ``w.migrate``; for a packed run
        where the window holds an event), then one replicated K1 launch
        of ``w.K`` iterations."""
        out = None
        if traj is not None and w.n_emit:
            out = _slot(traj, w.t0, w.n_emit)
        if w.migrate or self.packed_alpha > 0.0:
            self._migrate(state, w.it0, w.K)
        fused_ops.de_step_rep(self.cfg, self.spec, state.theta,
                              state.weight, state.fire, w.it0, out=out,
                              check=False, K=w.K, emit=w.emit,
                              phase="post" if w.post else "all")

    def _events(self, it: int, K: int):
        """A packed window's events (:func:`migration_ops.segment_events`),
        or False where it holds none."""
        ev = rng.packed_events(self.reps.seeds[0], it, K, self.reps.n_reps,
                               self.packed_alpha)
        return (migration_ops.segment_events(ev, self.reps.n_reps)
                if ev.any() else False)

    def plan(self, state: SamplerState, n_iter: int, thin: int = 1,
             fire=None, switch: int = None, store: bool = True, cuts=(),
             skip: int = 0):
        """The run's windows (:func:`plan_windows`), cut where any
        replication's gate opens: the first gates ``fire [R]`` (read from
        ``state.fire`` when None, the run's one host sync), the later ones
        :func:`rng.rep_gates`; for a packed run also each window's events,
        uploaded to the card in one copy."""
        gates = None
        if self.migrates:
            if fire is None:
                fire = state.fire.cpu().numpy()
            gates = rng.rep_gates(self.reps.seeds, state.iteration, n_iter,
                                  self.cfg.rows.fire, self.cfg.alpha)
        plan = plan_windows(state.iteration, n_iter, fire, gates,
                            self.superstep_k, thin, switch, store, cuts, skip)
        if self.packed_alpha > 0.0:
            found = [(w, self._events(w.it0, w.K)) for w in plan]
            found = [(w, ev) for w, ev in found if ev is not False]
            evs = migration_ops.upload_events([ev for _, ev in found],
                                              self.device)
            self._replays = {(w.it0, w.K): ev
                             for (w, _), ev in zip(found, evs)}
            self._replays.update({(w.it0, w.K): False for w in plan
                                  if (w.it0, w.K) not in self._replays})
        return plan


class _ShardWindow(NamedTuple):
    """A window of one shard's plan in a :class:`RepShardedStep` run."""
    shard: int
    w: Window

    @property
    def it0(self) -> int:
        return self.w.it0

    @property
    def n_emit(self) -> int:
        return self.w.n_emit


class RepShardedStep:
    """``sample_replicated(mesh=)``'s step: the replications split over
    the mesh's devices (:func:`~demcmc_tpu_torch.parallel.mesh.
    shard_replications`), each device a :class:`RepStep` of its R/n_dev
    whole replications with its own plan (its windows cut at its own
    replications' gates); nothing crosses devices during the run.  Every
    replication draws its own words, so the run is the unsharded one bit
    for bit.  The plan is the shards' windows in the order of their first
    iteration, so that every device is kept busy."""

    def __init__(self, models, de: DE, spec: ParamSpec, devices, seeds):
        self.devices = [torch.device(d) for d in devices]
        self.device = self.devices[0]
        self.split_reps = shard_replications(len(models), self.devices)
        self.steps = [RepStep(models[r0:r0 + n], de, spec, dev,
                              seeds[r0:r0 + n])
                      for dev, r0, n in self.split_reps]
        c_rep = de.n_groups * de.Np
        self.spans = [(r0 * c_rep, (r0 + n) * c_rep)
                      for _, r0, n in self.split_reps]

    def split(self, state: SamplerState) -> ShardedState:
        """Each shard's replications (chains and gates) on its device."""
        return ShardedState(tuple(state._replace(
            theta=state.theta[a:b].to(dev, copy=True).contiguous(),
            weight=state.weight[a:b].to(dev, copy=True).contiguous(),
            fire=state.fire[r0:r0 + n].to(dev, copy=True).contiguous())
            for (a, b), (dev, r0, n) in zip(self.spans, self.split_reps)))

    def gather(self, state: ShardedState) -> SamplerState:
        """Every replication on the mesh's first device."""
        def cat(field):
            return torch.cat([getattr(s, field).to(self.device)
                              for s in state.shards])
        return state.shards[0]._replace(theta=cat("theta"),
                                        weight=cat("weight"),
                                        fire=cat("fire"))

    def check(self, state: ShardedState, out=None):
        outs = out if out is not None else [None] * len(self.steps)
        for step, s, o in zip(self.steps, state.shards, outs):
            step.check(s, o)

    def window(self, state: ShardedState, sw: _ShardWindow, traj=None):
        """Shard ``sw.shard``'s window on its state and trajectory."""
        self.steps[sw.shard].window(
            state.shards[sw.shard], sw.w,
            None if traj is None else traj[sw.shard])

    def plan(self, state: ShardedState, n_iter: int, thin: int = 1,
             switch: int = None, store: bool = True, cuts=(),
             skip: int = 0):
        """Every shard's plan (:meth:`RepStep.plan`), merged by first
        iteration."""
        return sorted(
            (_ShardWindow(i, w) for i, (step, s) in enumerate(
                zip(self.steps, state.shards))
             for w in step.plan(s, n_iter, thin, None, switch, store, cuts,
                                skip)),
            key=lambda sw: (sw.it0, sw.shard))

    def get_post_burnin(self):
        return self.steps[0].get_post_burnin()


def _replicated_setup(make_model, de: DE, datasets, key, keys):
    """The shared set-up of the replicated runs (``demcmc_tpu/sampler.py:
    1641-1665``): every data leaf's leading replication axis checked, each
    replication's model, the spec from replication 0's and the seeds
    (``keys``, R of them, or :func:`rng.replication_seeds` of ``key``).
    Returns ``(models, seeds, spec)``."""
    leaves = pytree.leaves(datasets)
    if not leaves:
        raise ValueError("datasets is empty")
    R = int(np.shape(leaves[0])[0]) if np.ndim(leaves[0]) else 0
    for x in leaves:
        if np.ndim(x) == 0 or int(np.shape(x)[0]) != R:
            raise ValueError("all dataset leaves need the same leading "
                             "replication axis")
    models = [make_model(pytree.take(datasets, r)) for r in range(R)]
    if keys is None:
        seeds = rng.replication_seeds(key, R)
    else:
        seeds = [int(k) for k in np.asarray(keys).reshape(-1)]
        if len(seeds) != R:
            raise ValueError(f"{len(seeds)} keys for {R} replications")
    return models, seeds, make_spec(models[0], de)


def _check_thin(de: DE, n_iter: int, thin: int):
    if thin < 1 or n_iter % thin:
        raise ValueError(f"n_iter ({n_iter}) must be divisible by thin "
                         f"({thin})")
    if thin > 1 and de.discard_burnin and de.burnin % thin:
        raise ValueError(f"burnin ({de.burnin}) must be divisible by "
                         f"thin ({thin})")


def rep_supported(models, de: DE, device) -> bool:
    """Static predicate: do these replications run as one replicated K1
    batch (:class:`RepStep`)?  Where every replication's configuration
    takes the kernels' step with K1 (:func:`fused_supported`, not DE-MCz),
    a group fits one block of the replicated kernel and, where the
    replications migrate (α > 0, G > 1), one replication fits the
    segmented K2's one CTA (``ops/migration.py::ONE_CTA_MAX_CHAINS``;
    wider ones run in turn, until ROADMAP.md A8 rest 3 lifts the limit).
    Their densities must then stack into one table
    (``DensityTable.stack`` raises otherwise).  It depends on the
    configuration alone, so the CPU evaluates it."""
    migrates_wide = (de.alpha > 0.0 and de.n_groups > 1 and de.n_groups
                     * de.Np > migration_ops.ONE_CTA_MAX_CHAINS)
    if (de.uses_resample or migrates_wide
            or not all(fused_supported(m, de, device) for m in models)):
        return False
    dens = models[0].cuda_density
    greedy = {} if de.is_mh else {"mode": fused_ops.accept_mode(de)}
    n_blk = len(fused_ops.const_blocks(de))
    return de.Np <= fused_ops.block_chains(
        False, dens, de.sequential_sweep, de.theta_snooker > 0.0,
        max(n_blk, 1), device, rep=True, **greedy)


def _rep_state(models, de: DE, spec: ParamSpec, seeds, device,
               start_iteration: int = None) -> SamplerState:
    """The replications' initial states, each its solo run's
    (:func:`init_state` with its own model and seed), side by side:
    ``theta [R·c_rep, d]``, ``weight``, ``fire [R]``."""
    states = [init_state(m, de, spec, s, device=device,
                         start_iteration=start_iteration)
              for m, s in zip(models, seeds)]
    return states[0]._replace(
        theta=torch.cat([s.theta for s in states]).contiguous(),
        weight=torch.cat([s.weight for s in states]).contiguous(),
        fire=torch.cat([s.fire for s in states]).contiguous())


def _rep_devices(mesh, device, R: int):
    """Each replication's device: ``(devices, by_rep)`` — the mesh's
    devices (None without a mesh, or with a mesh of one device) and the
    device of each of the R replications."""
    _refuse_across_processes(mesh, what="a replicated run")
    devices, device = _on_mesh(mesh, device)
    if devices is None:
        return None, [device] * R
    by_rep = []
    for dev, _, n in shard_replications(R, devices):
        by_rep += [dev] * n
    return devices, by_rep


def _run_replicated(models, de: DE, spec: ParamSpec, seeds, n_iter: int,
                    thin: int, devices, device, collect: bool = True,
                    start_iteration: int = None, packed_key: int = None):
    """The replicated kernels' run: the replications' state, the step
    (:class:`RepStep`, or :class:`RepShardedStep` over a mesh) and
    :func:`run_scan`.  Returns ``(state, StepOutput or None)``."""
    state = _rep_state(models, de, spec, seeds, device, start_iteration)
    if devices is None:
        step = RepStep(models, de, spec, device, seeds, packed_key)
    else:
        step = RepShardedStep(models, de, spec, devices, seeds)
        state = step.split(state)
    skip = de.burnin // thin if collect and de.discard_burnin else 0
    state, ys = run_scan(step, state, n_iter, thin=thin,
                         phase2=_phase2(step, de, state, n_iter),
                         collect=collect, skip=skip)
    if devices is not None:
        state = step.gather(state)
    return state, ys


def _bundle_reps(models, de: DE, spec: ParamSpec, ys: StepOutput,
                 n_iter: int, thin: int) -> list:
    """Each replication's :class:`Chains` from the run's kept rows (its
    slice of the chains)."""
    c_rep = de.n_groups * de.Np
    out = []
    for r, m in enumerate(models):
        sl = slice(r * c_rep, (r + 1) * c_rep)
        out.append(bundle_samples(m, de, spec, StepOutput(
            theta=ys.theta[:, sl], accept=ys.accept[:, sl],
            lp=ys.lp[:, sl]), n_iter, thin=thin))
    return out


def sample_replicated(make_model, de: DE, n_iter: int, datasets, key=0,
                      thin: int = 1, keys=None, mesh=None, device=None,
                      allow_fused: bool = True) -> list:
    """R independent runs, one dataset each (per-subject fits,
    simulation-based calibration, prior-predictive sweeps), as one batch
    (the JAX ``sample_replicated``, ``demcmc_tpu/sampler.py:1688-1761``).

    ``make_model(data) -> DEModel`` is called once per replication with
    entry r of every leaf of ``datasets`` (an array, or nested lists,
    tuples and dicts of arrays, each with the same leading replication
    axis R).  Replication r is bit for bit ``sample(make_model(
    datasets[r]), de, n_iter, key=seeds[r], thin=thin)`` on the step that
    solo run takes; ``seeds`` are ``keys`` (R integer seeds) or
    :func:`rng.replication_seeds` of ``key``.  ``n_iter`` and, with
    ``discard_burnin``, ``burnin`` must be divisible by ``thin``.

    Where every replication takes the kernels' step with K1 (a float32
    model with a CUDA density, the MH or greedy accept,
    :func:`rep_supported`), the replications run as one batch on the card
    (:class:`RepStep`: one replicated K1 launch a window, the segmented K2
    where a replication's gate opens); their densities must name one
    header with data of one shape, else ``ValueError``.  Every other
    configuration (DE-MCz, float64, custom slots, stochastic models,
    models without a CUDA density, a migrating replication of more than
    ``ops/migration.py::ONE_CTA_MAX_CHAINS`` chains, or
    ``allow_fused=False``) runs its
    replications in turn, each its solo run, in this one call.  A kernel
    that fails to build or launch raises.

    ``mesh`` (a :func:`~demcmc_tpu_torch.parallel.chain_mesh`) splits the
    replications over its devices, R/n_dev whole ones each (R must divide
    over them, else ``ValueError``), bit for bit the unsharded run.
    Returns a list of R :class:`Chains`."""
    _check_thin(de, n_iter, thin)
    models, seeds, spec = _replicated_setup(make_model, de, datasets, key,
                                            keys)
    devices, by_rep = _rep_devices(mesh, device, len(models))
    if not (allow_fused and all(rep_supported(models, de, d)
                                for d in set(by_rep))):
        return [sample(m, de, n_iter, key=s, thin=thin, device=d,
                       allow_fused=allow_fused)
                for m, s, d in zip(models, seeds, by_rep)]
    _, ys = _run_replicated(models, de, spec, seeds, n_iter, thin, devices,
                            by_rep[0])
    return _bundle_reps(models, de, spec, ys, n_iter, thin)


def sample_replicated_packed(make_model, de: DE, n_iter: int, datasets,
                             key=0, thin: int = 1, device=None) -> list:
    """R independent runs packed into one population (the JAX
    ``sample_replicated_packed``, ``demcmc_tpu/sampler.py:1825-1877``):
    replication r's groups are groups ``r·G .. (r+1)·G − 1`` of one run,
    stepped by one replicated K1 stream keyed by ``key`` (the
    population's chain words, migration off in the kernel).

    * Every replication starts from its solo run's initial state (its own
      seed, :func:`rng.replication_seeds`).
    * With α > 0 migration is replication-local: each (iteration,
      replication) pair is a Bernoulli(α) event drawn from ``key``
      (:func:`rng.packed_events`), and a window's events are replayed at
      its start by the segmented K2, each on the words of its own
      iteration, so the event schedule is the same for any window sizes.
    * The draws are not the solo runs' (one stream): the posteriors are
      statistically equivalent, not bitwise.

    A configuration that does not take the replicated K1 (DE-MCz,
    float64, a model without a CUDA density, a migrating replication wider
    than K2's one CTA, :func:`rep_supported`) raises ``ValueError`` before
    any kernel is built: use :func:`sample_replicated`.  Returns a list of R :class:`Chains`."""
    _check_thin(de, n_iter, thin)
    models, seeds, spec = _replicated_setup(make_model, de, datasets, key,
                                            None)
    device = resolve_device(device)
    if not rep_supported(models, de, device):
        raise ValueError(
            f"configuration is not fused-supported when packed "
            f"(n_groups={de.n_groups * len(models)}): the replicated K1 runs "
            f"float32 K1 densities, not DE-MCz, and a migrating "
            f"replication of at most {migration_ops.ONE_CTA_MAX_CHAINS} "
            f"chains; use sample_replicated")
    _, ys = _run_replicated(models, de, spec, seeds, n_iter, thin, None,
                            device, packed_key=int(key))
    return _bundle_reps(models, de, spec, ys, n_iter, thin)
