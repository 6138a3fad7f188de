"""The sampling loop (port of ``demcmc_tpu.sampler`` for the main path).

Reference: ``src/main.jl:19-42`` (``sample``).  One iteration is two
launches on the current stream: the migration kernel K2, gated on the
device-side flag the previous iteration drew, then the DE-step kernel K1,
which updates the population in place, writes the trajectory row and
draws the next gate.  The host loop never reads the device, so it runs
ahead of the card; the trajectory comes back once, at the end.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``,
which runs the plain PyTorch versions of both kernels (the tests do); with
no GPU and no ``device=`` they raise.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from . import rng
from .chains import Chains
from .config import DE, MCMCThreads
from .model import DEModel, ParamSpec
from .ops import accept as accept_ops
from .ops import fused_step as fused_ops
from .ops import migration as migration_ops


class SamplerState(NamedTuple):
    """The entire resumable state of a run: ``theta [C, d]`` and
    ``weight [C]`` float32 (chain c in group c // Np), the integer
    ``key`` (Philox seed), the next ``iteration`` (1-based) and ``fire``
    ``[1]`` int32, the migration gate of that iteration."""

    theta: torch.Tensor
    weight: torch.Tensor
    key: int
    iteration: int
    fire: torch.Tensor


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
               device=None, start_iteration: int = 1) -> SamplerState:
    """Prior draws for every chain (reference ``sample_init``), their log
    posterior, and the first migration gate."""
    device = resolve_device(device)
    theta = model.init_population(spec, key, de.n_chains, device=device)
    weight = accept_ops.compute_posterior(model, spec, theta)
    return SamplerState(theta=theta.contiguous(), weight=weight.contiguous(),
                        key=int(key), iteration=int(start_iteration),
                        fire=_first_gate(de, key, start_iteration, device))


def state_from_numpy(theta, weight, iteration, fire, layout: str,
                     key: int = 0, device=None) -> SamplerState:
    """The port's state from a JAX ``SamplerState``'s arrays (as numpy).

    ``layout="fused"``: theta ``[d, 8, C/8]`` and weight ``[8, C/8]``,
    chain c at (c // (C/8), c % (C/8)) (``demcmc_tpu/sampler.py:539-543``);
    ``layout="flat"``: theta ``[G, Np, d]`` and weight ``[G, Np]``.
    ``fire`` is the JAX state's gate; None (a flat-layout state) means no
    migration before the first iteration.  ``key`` seeds the port's
    Philox words (a JAX key does not carry over)."""
    theta = np.asarray(theta, dtype=np.float32)
    if layout == "fused":
        d = theta.shape[0]
        flat = theta.reshape(d, -1).T
    elif layout == "flat":
        flat = theta.reshape(-1, theta.shape[-1])
    else:
        raise ValueError(f"layout must be 'fused' or 'flat'; got {layout!r}")
    w = np.asarray(weight, dtype=np.float32).reshape(-1)
    if w.shape[0] != flat.shape[0]:
        raise ValueError(f"{w.shape[0]} weights for {flat.shape[0]} chains")
    f = 0 if fire is None else int(np.asarray(fire).reshape(-1)[0])
    device = resolve_device(device)
    return SamplerState(
        theta=torch.tensor(np.ascontiguousarray(flat), device=device),
        weight=torch.tensor(w, device=device), key=int(key),
        iteration=int(np.asarray(iteration)),
        fire=torch.tensor([f], dtype=torch.int32, device=device))


class Step:
    """One iteration (K2 then K1) for a (model, de, spec) configuration.

    On the CPU the plain versions read their words from blocks drawn for
    many iterations at once (the same words, with fewer torch calls)."""

    WORDS_PER_BLOCK = 1 << 20     # CPU: words drawn per block, at most

    def __init__(self, model: DEModel, de: DE, spec: ParamSpec, device):
        self.model, self.spec = model, spec
        self.cfg = fused_ops.StepConfig.make(model, de, spec)
        self.device = torch.device(device)
        if self.device.type == "cuda" and model.cuda_density is None:
            raise ValueError("this model has no CUDA density "
                             "(DEModel.cuda_density); use device='cpu'")
        self._block = (None, 0, None)     # CPU: key, first iteration, words

    def _words(self, key: int, it: int) -> torch.Tensor:
        blk_key, it0, block = self._block
        if blk_key != key or not it0 <= it < it0 + len(block):
            cfg = self.cfg
            n = cfg.G * cfg.Np * cfg.rows.n_words
            block = rng.words_block(key, it, max(1, min(
                64, self.WORDS_PER_BLOCK // n)), cfg.rows.n_words,
                cfg.G * cfg.Np, device=self.device)
            self._block, it0 = (key, it, block), it
        return block[it - it0]

    def check(self, state: SamplerState, out=None):
        """Raise unless the state (and a trajectory slot) suit the kernels;
        :func:`run_scan` checks once and then launches unchecked."""
        if self.device.type != "cuda":
            return
        cfg = self.cfg
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
        bits = (self._words(state.key, it) if self.device.type == "cpu"
                else None)
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
        state = state._replace(
            theta=state.theta.to(device, copy=True).contiguous(),
            weight=state.weight.to(device, copy=True).contiguous(),
            fire=state.fire.to(device, copy=True).contiguous())
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
    ``discard_burnin``; per-chain acceptance and lp internals."""
    offset = de.burnin if de.discard_burnin else 0
    if offset >= n_iter and de.discard_burnin:
        raise ValueError(f"burnin ({de.burnin}) >= n_iter ({n_iter}); "
                         "nothing left to return")
    offset //= thin
    return Chains.from_samples(np.asarray(ys.theta)[offset:],
                               np.asarray(ys.accept)[offset:],
                               np.asarray(ys.lp)[offset:], spec)
