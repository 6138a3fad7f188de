"""Migration between groups: the wrapper of CUDA kernel K2
(``csrc/migration.cu``), its plain PyTorch version, and the unfused step's
exchange (:func:`maybe_migrate`), which shares the exchange's arithmetic.
K2 has two forms, bit for bit the same exchange: one CTA (a bitonic sort
of the keys) up to ``ONE_CTA_MAX_CHAINS`` chains, and above it the spread
form (victims on every SM, ranks by counting, then a scatter) on a scratch
buffer this module keeps per (G, d, device).

Reference exchange ``src/migration.jl:11-91`` as the TPU kernel computes
it (``demcmc_tpu/ops/fused_step.py::_mig_apply_sorted``): groups rank by
their leader chain's row-0 uniform (ties by group index); the first
``N = 2 + (word mod (G-1))`` ranks form a cycle in which rank r's victim
slot receives rank (r-1) mod N's victim; a group's victim is
argmax(gumbel − w), first index on ties.  Values move as exact copies
(after ``+ 0.0``, which only turns −0.0 into +0.0, like the TPU kernel's
additive victim broadcast).  The exchange runs only when the device-side
``fire`` flag is set; the decision never reaches the host.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import rng
from . import _build

N_ROWS = 3        # rows 0-2 of an iteration's words: ranks, N, gumbels
# the most chains (G·Np) K2 runs in one CTA, above it the spread form: on
# an H100 the one-CTA form was the faster below 1,024 chains (G = 128 × 4
# included), the two even at 1,024 (64 × 16, 256 × 4) and the spread form
# the faster from 2,048 on (tools/k2_phases.py, PERF.md)
ONE_CTA_MAX_CHAINS = 1024
_scratch: dict = {}


def _rank_and_perm(u):
    """The groups ranked by their keys ``u [G]``, ties by group index:
    ``(rank, perm)`` with ``perm[rank[g]] == g`` (``demcmc_tpu/ops/
    migration.py:45``)."""
    perm = torch.sort(u, stable=True).indices
    rank = torch.empty_like(perm)
    rank[perm] = torch.arange(perm.shape[0], device=u.device)
    return rank, perm


def _select_victims(theta, w, gum):
    """Each group's victim ``argmax(gum − w)``, first index on ties
    (``demcmc_tpu/ops/migration.py:73``), with its θ ``[G, d]`` and w
    ``[G]`` as exact copies (after ``+ 0.0``); returns ``(θ, w, slot)``."""
    gi = torch.arange(theta.shape[0], device=theta.device)
    vid = torch.argmax(gum - w, dim=1)
    return theta[gi, vid] + 0.0, w[gi, vid] + 0.0, vid


def _exchange_values(theta, w, u_key, n_active, gum):
    """The exchange reduced to its outputs (``demcmc_tpu/ops/migration.py:
    _migrate_values``): the θ ``[G, d]`` and w ``[G]`` each group's victim
    slot receives — rank r < N takes the victim of rank (r − 1) mod N,
    every other group its own — and the victim slots ``[G]``."""
    rank, perm = _rank_and_perm(u_key)
    vt, vw, vid = _select_victims(theta, w, gum)
    n = n_active      # kept a host int where it is one: no copy, no sync
    src = perm[torch.where(rank < n, torch.remainder(rank - 1, n), rank)]
    return vt[src], vw[src], vid


def _apply(theta, w, routed_t, routed_w, vid):
    gi = torch.arange(theta.shape[0], device=theta.device)
    new_theta, new_w = theta.clone(), w.clone()
    new_theta[gi, vid] = routed_t
    new_w[gi, vid] = routed_w
    return new_theta, new_w


def exchange(theta, w, u_key, n_active, gum):
    """One exchange on group-shaped values: ``theta [G, Np, d]``,
    ``w [G, Np]``, ``u_key [G]`` rank keys, ``n_active`` (0-d int tensor
    or int) and ``gum [G, Np]``; returns new ``(theta, w)``."""
    return _apply(theta, w, *_exchange_values(theta, w, u_key, n_active,
                                              gum))


def draws(words, G: int, Np: int):
    """The exchange's random values from rows 0-2 of ``words [>=3, C]``:
    ``(u_key [G], n_active, gum [G, Np])`` — the leader chains' row-0
    uniforms, ``2 + word(1, 0) mod (G - 1)`` and the row-2 Gumbels
    ``-log(-log(max(u, tiny)))``."""
    u_key = rng.to_uni(words[0]).view(G, Np)[:, 0]
    n_active = rng.randint(words[1, 0], G - 1) + 2
    u_g = torch.clamp_min(rng.to_uni(words[2]), rng.TINY)
    return u_key, n_active, (-torch.log(-torch.log(u_g))).view(G, Np)


def migrate_plain(theta, w, fire, words, G: int, Np: int):
    """Plain version of K2, in place: ``theta [C, d]``, ``w [C]``,
    ``fire [1]`` int32, ``words [>=3, C]`` uint32 (rows 0-2 used)."""
    C, d = theta.shape
    nt, nw = exchange(theta.view(G, Np, d), w.view(G, Np),
                      *draws(words, G, Np))
    fired = fire.view(()) != 0
    theta.copy_(torch.where(fired, nt.view(C, d), theta))
    w.copy_(torch.where(fired, nw.view(C), w))


def migrate(theta, w, fire, G: int, Np: int, seed: int = 0, it: int = 0,
            bits=None, check: bool = True):
    """Migrate ``theta [C, d]`` / ``w [C]`` in place when ``fire[0] != 0``.

    Words are Philox(seed, it) rows 0-2, or rows 0-2 of ``bits [n_words,
    C]`` (uint32, bits-in test mode).  CPU tensors take the plain version;
    CUDA tensors launch K2 (``migrate.launches`` counts the calls), in its
    spread form where ``G·Np > ONE_CTA_MAX_CHAINS``.
    ``check=False`` skips the tensor checks, for a caller that made them
    once for a run (:func:`check_cuda`)."""
    C, d = theta.shape
    if theta.device.type == "cpu":
        words = bits if bits is not None else rng.words(seed, it, N_ROWS, C)
        migrate_plain(theta, w, fire, words, G, Np)
        return
    if check:
        check_cuda(theta, w, fire, G, Np, bits)
    lib = _build.library("migration")
    k0, k1 = rng.seed_key(seed)
    bits_ptr = None if bits is None else bits.data_ptr()
    spread = C > ONE_CTA_MAX_CHAINS
    scratch = _scratch_of(lib, G, d, theta.device) if spread else None
    _build.launch(lib, "migrate_f32", theta.device, theta.data_ptr(),
                  w.data_ptr(), fire.data_ptr(), bits_ptr, k0, k1, int(it),
                  G, Np, d, scratch, int(spread))
    migrate.launches += 1


migrate.launches = 0


def _scratch_of(lib, G: int, d: int, device) -> int:
    """The address of the spread form's scratch for (G, d) on ``device``,
    allocated at its first use (the staged victim rows, keys, ranks)."""
    buf = _scratch.get((G, d, device))
    if buf is None:
        n = lib.migrate_scratch_bytes(G, d)
        buf = _scratch[(G, d, device)] = torch.empty(
            (n + 7) // 8, dtype=torch.int64, device=device)
    return buf.data_ptr()


def check_cuda(theta, w, fire, G: int, Np: int, bits=None):
    """Raise unless the tensors are what K2 takes on a CUDA device."""
    C, d = G * Np, theta.shape[-1]
    if theta.device.type != "cuda":
        raise ValueError(f"migrate runs on cpu or cuda, not {theta.device}")
    for name, t, dt, shape in (("theta", theta, torch.float32, (C, d)),
                               ("w", w, torch.float32, (C,)),
                               ("fire", fire, torch.int32, (1,))):
        if (t.device != theta.device or t.dtype != dt
                or tuple(t.shape) != shape or not t.is_contiguous()):
            raise ValueError(f"{name}: need a contiguous {dt} {shape} tensor "
                             f"on {theta.device}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
    if bits is not None and (bits.device != theta.device
                             or bits.dtype != torch.uint32
                             or bits.shape[0] < N_ROWS
                             or bits.shape[1] != C
                             or not bits.is_contiguous()):
        raise ValueError("bits: need a contiguous uint32 [n_words, C] "
                         "tensor on the same device")


# ------------------------------------------ the unfused step's migration


def _migrate_values(draws, theta, weight, n_groups: int):
    """The exchange's draws from the unfused step's pool in the JAX XLA
    step's order (``demcmc_tpu/ops/migration.py:120``): N ~ U{2..G} from
    the scalar side channel, the groups' rank keys ``[G]``, the Gumbels
    ``[G, Np]``; returns what :func:`_exchange_values` returns."""
    G, Np = theta.shape[:2]
    n_active = draws.randint((), 2, n_groups + 1)
    u = draws.uniform((G,))
    return _exchange_values(theta, weight, u, n_active,
                            draws.gumbel((G, Np)))


def maybe_migrate(draws, theta, weight, alpha: float, n_groups: int):
    """Migration with probability α per iteration (``demcmc_tpu/ops/
    migration.py:177``, with its ``migrate`` :156; reference ``rand() <=
    de.α``, ``main.jl:85``) on ``theta [G, Np, d]``, ``weight [G, Np]``;
    returns new ``(theta, weight)``.  The gate is a scalar draw, known on
    the host, so a closed gate skips the exchange, with its draws'
    columns, and syncs nothing."""
    if alpha <= 0.0 or n_groups < 2:
        return theta, weight
    G, Np = theta.shape[:2]
    if draws.uniform(()) <= float(np.float32(alpha)):
        return _apply(theta, weight, *_migrate_values(draws, theta, weight,
                                                      n_groups))
    _skip_exchange(draws, G, Np)
    return theta, weight


def _skip_exchange(draws, G: int, Np: int):
    """Pass over the exchange's draws (N, the rank keys, the Gumbels)."""
    for shape in ((), (G,), (G, Np)):
        draws.skip(shape)


def skip_migration(draws, alpha: float, n_groups: int, G: int, Np: int):
    """Pass over what :func:`maybe_migrate` draws, gate included, in a
    pool of ``G`` of the population's ``n_groups`` groups: the pool of one
    shard of a run split over a chain mesh, whose migration the sharded
    step runs on the whole population (``sampler.ShardedStep``)."""
    if alpha <= 0.0 or n_groups < 2:
        return
    draws.skip(())
    _skip_exchange(draws, G, Np)
