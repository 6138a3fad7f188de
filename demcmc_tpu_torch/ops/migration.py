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

from typing import NamedTuple, Optional

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


class SegmentEvents(NamedTuple):
    """A packed window's events as K2's segmented form takes them
    (:func:`segment_events`): ``counts [R]`` and ``its [R, E]`` int32,
    row r replication r's event iterations as offsets from the window's
    first, in rising order (E at least 1, unused entries 0), and ``dev``,
    the flat table ``[counts, its]`` on the card (:func:`upload_events`),
    or None."""
    counts: np.ndarray
    its: np.ndarray
    dev: Optional[torch.Tensor] = None

    def flat(self) -> np.ndarray:
        return np.concatenate([self.counts, self.its.reshape(-1)])


def segment_events(events, n_reps: int) -> SegmentEvents:
    """A packed window's events, ``[n, R]`` bool over its iterations
    ``it0 .. it0+n-1`` (:func:`~demcmc_tpu_torch.rng.packed_events`), as
    :class:`SegmentEvents`."""
    events = np.asarray(events, dtype=bool).reshape(-1, n_reps)
    counts = events.sum(0).astype(np.int32)
    its = np.zeros((n_reps, max(int(counts.max(initial=0)), 1)), np.int32)
    for r in range(n_reps):
        k = np.flatnonzero(events[:, r])
        its[r, :k.size] = k
    return SegmentEvents(counts, its)


def upload_events(windows, device) -> list:
    """The :class:`SegmentEvents` of a run's windows with their tables on
    ``device``, in one copy (a run's plan makes it once, so no window
    waits on a copy from the host)."""
    if not windows or torch.device(device).type != "cuda":
        return list(windows)
    flats = [ev.flat() for ev in windows]
    table = torch.tensor(np.concatenate(flats), dtype=torch.int32).to(
        device)
    out, at = [], 0
    for ev, f in zip(windows, flats):
        out.append(ev._replace(dev=table[at:at + f.size]))
        at += f.size
    return out


def migrate_segments_plain(theta, w, G: int, Np: int, reps, it: int,
                           fire=None, events=None):
    """Plain version of K2's segmented form, in place: ``theta [R·G·Np,
    d]`` / ``w`` as the R replications of ``reps`` (a
    :class:`~demcmc_tpu_torch.ops.fused_step.Replicas`) of G groups each,
    exchanging among their own groups only, as the solo exchange
    (:func:`migrate_plain`) on their chains.  With ``fire [R]`` int32
    replication r exchanges once where ``fire[r]``, on the words
    Philox(``reps.seeds[r]``, ``it``) rows 0-2 of ``STEP_NS`` at its chain
    words (``reps.chain0(r)``: local, ``c − r·G·Np``, or the
    population's).  With ``events`` (:class:`SegmentEvents`: ``counts
    [R]``, ``its [R, E]``) replication r runs ``counts[r]`` exchanges in
    order, event j on the words Philox(``reps.seeds[r]``, ``it + its[r,
    j]``) rows 0-2 of ``PACKED_MIG_NS``."""
    Cr = G * Np
    one = torch.ones(1, dtype=torch.int32, device=theta.device)
    for r, seed in enumerate(reps.seeds):
        sl = slice(r * Cr, (r + 1) * Cr)
        if events is None:
            words = rng.words(seed, it, N_ROWS, Cr, device=theta.device,
                              chain0=reps.chain0(r))
            migrate_plain(theta[sl], w[sl], fire[r:r + 1], words, G, Np)
            continue
        counts, its = events.counts, events.its
        for j in range(int(counts[r])):
            words = rng.words(seed, it + int(its[r, j]), N_ROWS, Cr,
                              ns=rng.PACKED_MIG_NS, device=theta.device,
                              chain0=reps.chain0(r))
            migrate_plain(theta[sl], w[sl], one, words, G, Np)


def migrate_segments(theta, w, G: int, Np: int, reps, it: int, fire=None,
                     events=None, check: bool = True):
    """Replication-local migration (K2's segmented form): the exchange of
    :func:`migrate_segments_plain` on every replication of ``theta
    [R·G·Np, d]`` in one launch, one CTA a replication, in place.  Either
    ``fire [R]`` int32 on the device (``sample_replicated``: each
    replication's own gate) or ``events``, a packed run's window
    (:class:`SegmentEvents`, its table on the card where the run's plan
    uploaded it, :func:`upload_events`).  The seeds and chain words are
    ``reps``'s (``fused_step.Replicas``), its key table copied to the card
    once (``Replicas.keys_on``).  CPU tensors take the plain version; CUDA
    tensors launch the segmented K2 once (``migrate_segments.launches``
    counts the launches).  A replication of more than ``ONE_CTA_MAX_CHAINS`` chains
    raises (ROADMAP.md A8 rest)."""
    if (fire is None) == (events is None):
        raise ValueError("pass fire (each replication's gate) or events "
                         "(a packed window's), not both or neither")
    if theta.device.type == "cpu":
        migrate_segments_plain(theta, w, G, Np, reps, it, fire, events)
        return
    R = reps.n_reps
    if G * Np > ONE_CTA_MAX_CHAINS:
        raise ValueError(
            f"a replication of {G * Np} chains exceeds the "
            f"{ONE_CTA_MAX_CHAINS} K2's segmented form takes in one CTA "
            f"(ROADMAP.md A8 rest: replications larger than one K2 CTA)")
    if theta.device.type != "cuda":
        raise ValueError(f"migrate_segments runs on cpu or cuda, not "
                         f"{theta.device}")
    ev = None
    if events is not None:
        ev = events.dev
        if ev is None or ev.device != theta.device:
            ev = upload_events([events], theta.device)[0].dev
    keys = reps.keys_on(theta.device)
    if check:
        C, d = R * G * Np, theta.shape[-1]
        want = [("theta", theta, torch.float32, (C, d)),
                ("w", w, torch.float32, (C,)),
                ("keys", keys, torch.uint32, (R, 2))]
        if fire is not None:
            want.append(("fire", fire, torch.int32, (R,)))
        for name, t, dt, shape in want:
            if (t.device != theta.device or t.dtype != dt
                    or tuple(t.shape) != shape or not t.is_contiguous()):
                raise ValueError(f"{name}: need a contiguous {dt} {shape} "
                                 f"tensor on {theta.device}")
    lib = _build.library("migration")
    E = 0 if events is None else int(events.its.shape[1])
    _build.launch(lib, "migrate_segments_f32", theta.device,
                  theta.data_ptr(), w.data_ptr(),
                  None if fire is None else fire.data_ptr(),
                  None if ev is None else ev.data_ptr(), E,
                  keys.data_ptr(), int(it),
                  rng.STEP_NS if events is None else rng.PACKED_MIG_NS,
                  int(reps.local), R, G, Np, theta.shape[-1])
    migrate_segments.launches += 1


migrate_segments.launches = 0


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
