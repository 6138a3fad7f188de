"""The sampling loop (port of ``demcmc_tpu.sampler`` for the main path).

Reference: ``src/main.jl:19-42`` (``sample``).  One iteration is two
launches on the current stream: the migration kernel K2, gated on the
device-side flag the previous iteration drew, then the DE-step kernel K1,
which updates the population in place, writes the trajectory row and
draws the next gate.  A DE-MCz (``sample='resample'``) configuration has
no migration and runs the resample kernel K3 instead, which also writes
the new state into the history.  The host loop never reads the device, so
it runs ahead of the card; the trajectory comes back once, at the end.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``,
which runs the plain PyTorch versions of both kernels (the tests do); with
no GPU and no ``device=`` they raise.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from . import rng
from .chains import Chains
from .config import DE, MCMCThreads
from .model import DEModel, ParamSpec
from .ops import _build
from .ops import accept as accept_ops
from .ops import fused_step as fused_ops
from .ops import migration as migration_ops
from .ops import resample_step as resample_ops


class SamplerState(NamedTuple):
    """The entire resumable state of a run: ``theta [C, d]`` and
    ``weight [C]`` float32 (chain c in group c // Np), the integer
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
    """Migration gate of a run's first iteration, from its own Philox
    namespace (later gates are drawn by the step kernel)."""
    alpha = float(de.alpha) if de.n_groups > 1 else 0.0
    u = rng.to_uni(rng.words(key, iteration, 1, 1, ns=rng.GATE_NS))
    fire = (u <= float(np.float32(alpha))) & (alpha > 0.0)
    return fire.view(1).to(device=device, dtype=torch.int32)


def init_state(model: DEModel, de: DE, spec: ParamSpec, key: int = 0,
               device=None, start_iteration: int = None) -> SamplerState:
    """Prior draws for every chain (reference ``sample_init``), their log
    posterior, and the first migration gate.  With ``sample='resample'``
    the history is seeded with ``n_initial`` rows of prior draws per chain
    and the chains start from row 0 (``demcmc_tpu/sampler.py:1133-1169``).
    The run starts at iteration ``n_initial + 1`` unless
    ``start_iteration`` says otherwise."""
    device = resolve_device(device)
    C = de.n_chains
    history = None
    if de.uses_resample:
        if de.n_initial < 1:
            raise ValueError(
                "sample='resample' requires n_initial >= 1 prior-seeded "
                "history rows (the reference recommends 10x the parameter "
                "count, src/structs.jl:37)")
        history = model.init_population(spec, key, de.n_initial * C,
                                        device=device).view(
            de.n_initial, C, spec.dim).contiguous()
        theta = history[0].clone()
    else:
        theta = model.init_population(spec, key, C, device=device)
    noise = None
    if model.stochastic:          # the initial weights' own noise panel
        noise = rng.to_uni(rng.words(key, 0, model.noise_words, C,
                                     ns=rng.INIT_NOISE_NS, device=device))
    weight = accept_ops.compute_posterior(model, spec, theta, noise)
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
    so."""
    theta = np.asarray(theta, dtype=np.float32)
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
    w = np.asarray(weight, dtype=np.float32).reshape(-1)
    C, d = flat.shape
    if w.shape[0] != C:
        raise ValueError(f"{w.shape[0]} weights for {C} chains")
    f = 0 if fire is None else int(np.asarray(fire).reshape(-1)[0])
    device = resolve_device(device)
    hist = None
    if history is not None:
        h = np.asarray(history, dtype=np.float32)
        if h.shape[1:] != (C, d):
            h = _unpack_history(h, C)
        hist = torch.tensor(np.ascontiguousarray(h), device=device)
    return SamplerState(
        theta=torch.tensor(np.ascontiguousarray(flat), device=device),
        weight=torch.tensor(w, device=device), key=int(key),
        iteration=int(np.asarray(iteration)),
        fire=torch.tensor([f], dtype=torch.int32, device=device),
        history=hist)


class Step:
    """One iteration for a (model, de, spec) configuration: K2 then K1, or
    K3 for DE-MCz.

    On the CPU the plain versions read their words from blocks drawn for
    many iterations at once (the same words, with fewer torch calls)."""

    WORDS_PER_BLOCK = 1 << 20     # CPU: words drawn per block, at most

    def __init__(self, model: DEModel, de: DE, spec: ParamSpec, device):
        self.model, self.spec = model, spec
        self.cfg = fused_ops.StepConfig.make(model, de, spec)
        self.device = torch.device(device)
        if self.device.type == "cuda":
            _build.entry("resample_step" if self.cfg.resample else "de_step",
                         model.cuda_density)
        self._blocks = {}             # CPU: namespace -> (key, it0, words)

    def _words(self, key: int, it: int, ns: int, n_rows: int):
        blk_key, it0, block = self._blocks.get(ns, (None, 0, None))
        if blk_key != key or not it0 <= it < it0 + len(block):
            C = self.cfg.G * self.cfg.Np
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
        if cfg.resample:
            resample_ops.check_cuda(cfg, state.theta, state.weight,
                                    state.fire, state.history, out=out)
            return
        if cfg.rows.mig >= 0:
            migration_ops.check_cuda(state.theta, state.weight, state.fire,
                                     cfg.G, cfg.Np)
        fused_ops.check_cuda(cfg, state.theta, state.weight, state.fire,
                             out=out)

    def __call__(self, state: SamplerState, out=None,
                 check: bool = True) -> SamplerState:
        """Advance ``state`` one iteration in place (its tensors are
        updated); ``out`` is an optional trajectory slot."""
        cfg, it = self.cfg, state.iteration
        cpu = self.device.type == "cpu"
        bits = (self._words(state.key, it, rng.STEP_NS, cfg.rows.n_words)
                if cpu else None)
        if cfg.resample:
            idx = None
            if cpu:
                idx = resample_ops.indices_from_words(cfg, self._words(
                    state.key, it, rng.RESAMPLE_NS,
                    resample_ops.index_rows(cfg)), it)
            resample_ops.resample_step(
                cfg, self.model, self.spec, state.theta, state.weight,
                state.fire, state.history, it, seed=state.key, out=out,
                bits=bits, idx=idx, check=check)
            return state._replace(iteration=it + 1)
        if cfg.rows.mig >= 0:
            migration_ops.migrate(state.theta, state.weight, state.fire,
                                  cfg.G, cfg.Np, seed=state.key, it=it,
                                  bits=bits, check=check)
        fused_ops.de_step(cfg, self.model, self.spec, state.theta,
                          state.weight, state.fire, it, seed=state.key,
                          out=out, bits=bits, check=check)
        return state._replace(iteration=it + 1)


def build_step(model: DEModel, de: DE, spec: ParamSpec, device=None) -> Step:
    """The one-iteration step for this configuration on ``device``."""
    return Step(model, de, spec, resolve_device(device))


def run_scan(step: Step, state: SamplerState, n_iter: int, thin: int = 1):
    """Run ``n_iter`` iterations, storing every ``thin``-th (iterations
    thin, 2·thin, ...); returns ``(state, StepOutput)`` with the trajectory
    on the host.  The loop issues launches only: no ``.item()``, no
    synchronisation until the final copy."""
    if thin < 1 or n_iter % thin:
        raise ValueError(f"n_iter ({n_iter}) must be a positive multiple "
                         f"of thin ({thin})")
    C, d = state.theta.shape
    T = n_iter // thin
    dev = state.theta.device
    traj_t = torch.empty((T, C, d), dtype=torch.float32, device=dev)
    traj_w = torch.empty((T, C), dtype=torch.float32, device=dev)
    traj_a = torch.empty((T, C), dtype=torch.bool, device=dev)
    step.check(state, (traj_t[0], traj_w[0], traj_a[0]))
    for i in range(n_iter):
        out = None
        if (i + 1) % thin == 0:
            t = (i + 1) // thin - 1
            out = (traj_t[t], traj_w[t], traj_a[t])
        state = step(state, out, check=False)
    ys = StepOutput(theta=traj_t.cpu().numpy(), accept=traj_a.cpu().numpy(),
                    lp=traj_w.cpu().numpy())
    return state, ys


def _not_ported(name: str, where: str):
    raise NotImplementedError(
        f"sample(..., {name}) is not ported to demcmc_tpu_torch yet "
        f"({where}, ROADMAP.md); use demcmc_tpu for it")


def sample(model: DEModel, de: DE, *args, key: int = 0, thin: int = 1,
           return_state: bool = False, state: SamplerState = None,
           device=None, mesh=None, checkpoint_every: int = 0,
           checkpoint_path: str = None, monitor: bool = False,
           stop_rhat: float = None):
    """Sample from the posterior (reference ``sample``,
    ``src/main.jl:19-42``): ``sample(model, de, n_iter)`` or
    ``sample(model, de, MCMCThreads(), n_iter)``.

    ``key`` is the integer Philox seed, ``thin`` keeps every thin-th draw
    (``n_iter`` and, with ``discard_burnin``, ``burnin`` divisible by it),
    ``state`` resumes from a returned state (it is not modified),
    ``return_state`` also returns the final state.  ``mesh``,
    ``checkpoint_every``, ``monitor`` and ``stop_rhat`` belong to later
    slices of the port and raise ``NotImplementedError``.
    Returns a :class:`Chains`."""
    args = [a for a in args if not isinstance(a, MCMCThreads)]
    if len(args) != 1:
        raise TypeError("expected sample(model, de, n_iter) or "
                        "sample(model, de, MCMCThreads(), n_iter)")
    n_iter = int(args[0])
    if mesh is not None:
        _not_ported("mesh=", "multi-GPU, A10")
    if checkpoint_every or checkpoint_path:
        _not_ported("checkpoint_every=", "checkpointing, A9")
    if monitor:
        _not_ported("monitor=True", "streaming monitor, A9")
    if stop_rhat is not None:
        _not_ported("stop_rhat=", "streaming monitor, A9")
    if thin > 1 and de.discard_burnin and de.burnin % thin:
        raise ValueError(f"burnin ({de.burnin}) must be divisible by "
                         f"thin ({thin})")
    device = resolve_device(device)
    spec = make_spec(model, de)
    if state is None:
        state = init_state(model, de, spec, key, device=device)
    else:
        state = state._replace(**{
            k: getattr(state, k).to(device, copy=True).contiguous()
            for k in ("theta", "weight", "fire", "history")
            if getattr(state, k) is not None})
    state = _grow_history(state, n_iter)
    step = build_step(model, de, spec, device=device)
    state, ys = run_scan(step, state, n_iter, thin=thin)
    chains = bundle_samples(model, de, spec, ys, n_iter, thin=thin)
    if return_state:
        return chains, state
    return chains


def bundle_samples(model: DEModel, de: DE, spec: ParamSpec, ys: StepOutput,
                   n_iter: int, thin: int = 1) -> Chains:
    """Trajectory to :class:`Chains` (reference ``bundle_samples``,
    ``src/main.jl:222-250``): drop the burn-in draws when
    ``discard_burnin``; per-chain acceptance and lp internals.  With
    ``n_initial > 0`` the output is the run's iterations burnin+1 ..
    n_iter, not history rows (``demcmc_tpu/sampler.py:1591-1594``)."""
    offset = de.burnin if de.discard_burnin else 0
    if offset >= n_iter and de.discard_burnin:
        raise ValueError(f"burnin ({de.burnin}) >= n_iter ({n_iter}); "
                         "nothing left to return")
    offset //= thin
    return Chains.from_samples(np.asarray(ys.theta)[offset:],
                               np.asarray(ys.accept)[offset:],
                               np.asarray(ys.lp)[offset:], spec)
