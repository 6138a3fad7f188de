"""Counter-based Philox4x32-10 random words.

Every random word the sampler consumes is a pure function of
``(seed, iteration, row, chain)`` — the port's replacement for the JAX
package's threefry keys and the TPU kernel's hardware PRNG.  The same
function is written twice: here in plain torch (int64 arithmetic, so it
runs on any device) and in ``csrc/philox.cuh`` for the CUDA kernels; the
two agree bit for bit.

Word ``row`` of a chain comes from lane ``row & 3`` of the Philox block
with counter ``(chain, row >> 2, iteration, namespace)`` and key
``(seed & 0xffffffff, seed >> 32)``.  Namespaces keep the purposes apart
as counter offsets: ``STEP_NS`` holds the per-iteration draw rows,
``INIT_NS`` the initial population, ``GATE_NS`` the first iteration's
migration gate, ``RESAMPLE_NS`` the DE-MCz history index words (row =
partner slot of the iteration), ``INIT_NOISE_NS`` the noise panel that
scores a stochastic model's initial population, ``POOL_NS`` and
``SCALAR_NS`` the unfused step's :class:`Pool` (row = pool column, chain
= group) and its scalar side channel (chain 0), ``EVAL_NS`` the noise
panel of one evaluation of a stochastic model in the unfused step (row =
:func:`eval_row`: the block, the sequential sweep's member and the
panel's index) and ``CUSTOM_NS`` the words of a :class:`Key`, the key a
custom strategy slot receives: the counterpart of the JAX PRNG key, not
its threefry bits (a slot is written against each package's own API, so
none could be bit for bit its JAX twin).  A replicated run's seeds come
from ``REPLICATE_NS`` (:func:`replication_seeds`, chain = replication);
a packed run's migration events from ``PACKED_GATE_NS`` (:func:`packed_events`,
chain = replication) and each event's exchange words from
``PACKED_MIG_NS`` (rows 0-2, keyed by the event's own iteration).

The chain word is the chain's index in the whole population, so a shard
of a run split over a chain mesh (``chain0``: its first chain, or for the
pool its first group) draws the columns of the unsharded draw, and a
sharded run is the unsharded run bit for bit.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

STEP_NS = 0     # per-iteration draw rows (migration + sweep + fire)
INIT_NS = 1     # initial population draws (iteration slot = 0)
GATE_NS = 2     # first migration gate of a run
RESAMPLE_NS = 3  # DE-MCz history indices (row = partner slot)
INIT_NOISE_NS = 4  # initial weights' noise panel (stochastic models)
POOL_NS = 5     # the unfused step's pool: row = column, "chain" = group
SCALAR_NS = 6   # the unfused step's scalar side channel (chain 0)
EVAL_NS = 7     # the unfused step's noise panel of one evaluation
CUSTOM_NS = 8   # the words of a Key (custom strategy slots)
FOLD_NS = 9     # Key.fold_in's derivation of a key's two words
REPLICATE_NS = 10   # a replicated run's seeds (chain = replication)
PACKED_GATE_NS = 11  # a packed run's migration events (chain = replication)
PACKED_MIG_NS = 12  # a packed event's exchange words (rows 0-2, K2's)

# The JAX step's purpose tags within an iteration's key (demcmc_tpu/rng.py:
# 27-40), which the unfused step folds into a Key as the JAX step folds
# them into its PRNG key.
ACCEPT = 16     # a custom update_particle slot's key
BLOCK = 18      # per-block keys: BLOCK * 1000 + block
CUSTOM = 19     # the custom slots' root (ProposalContext.key)
NEXT_KEY = 20   # ProposalContext.next_key's stream
MEMBER = 24     # per-member keys of the sequential sweep: MEMBER * 1000 + p

_M0, _M1 = 0xD2511F53, 0xCD9E8D57          # Philox multipliers
_W0, _W1 = 0x9E3779B9, 0xBB67AE85          # Weyl key bumps
_MASK = 0xFFFFFFFF
TINY = 1.1754943508222875e-38              # float32 smallest normal
TWO_PI = float(np.float32(2.0 * math.pi))


def tiny(dtype) -> float:
    """The smallest normal number of a torch float dtype."""
    return torch.finfo(dtype).tiny


def seed_key(seed: int) -> tuple:
    """The two 32-bit Philox key words of an integer seed."""
    seed = int(seed)
    if seed < 0 or seed >= 1 << 64:
        raise ValueError(f"seed must be in [0, 2**64); got {seed}")
    return seed & _MASK, seed >> 32


def _mulhilo(a: torch.Tensor, m: int):
    """(hi, lo) 32-bit halves of ``a * m`` for uint32 values held in
    int64, without any intermediate above 2**49."""
    m_lo, m_hi = m & 0xFFFF, m >> 16
    p_lo = a * m_lo                          # < 2**48
    p_hi = a * m_hi                          # < 2**48
    mid = p_lo + ((p_hi & 0xFFFF) << 16)     # < 2**49
    lo = mid & _MASK
    hi = ((p_hi >> 16) + (mid >> 32)) & _MASK
    return hi, lo


def _mulhilo_u64(a: np.ndarray, m: int):
    """:func:`_mulhilo` for numpy uint64 arrays: the product is exact."""
    p = a * np.uint64(m)
    return p >> np.uint64(32), p & np.uint64(_MASK)


def _mulhilo_int(a: int, m: int):
    """:func:`_mulhilo` for Python ints."""
    p = a * m
    return p >> 32, p & _MASK


def _rounds(ctr, key, mulhilo, word=int):
    """Philox4x32-10 on four counter words of uint32 values (int64
    tensors, uint64 arrays or ints) and a ``(k0, k1)`` key, each product
    by ``mulhilo`` and each key word made by ``word``."""
    c0, c1, c2, c3 = ctr
    k0, k1 = int(key[0]) & _MASK, int(key[1]) & _MASK
    for r in range(10):
        if r:
            k0, k1 = (k0 + _W0) & _MASK, (k1 + _W1) & _MASK
        hi0, lo0 = mulhilo(c0, _M0)
        hi1, lo1 = mulhilo(c2, _M1)
        c0, c1, c2, c3 = hi1 ^ c1 ^ word(k0), lo1, hi0 ^ c3 ^ word(k1), lo0
    return c0, c1, c2, c3


def philox4x32(ctr, key):
    """Philox4x32-10 on four int64 tensors of uint32 counter words and a
    ``(k0, k1)`` key; returns the four output words (int64 tensors).  CPU
    tensors run the rounds in numpy, whose uint64 product takes a third
    of the operations (the port's CPU tests run in half the time); other
    devices in torch."""
    if ctr[0].device.type != "cpu":
        return _rounds(ctr, key, _mulhilo)
    out = _rounds([c.numpy().astype(np.uint64) for c in ctr], key,
                  _mulhilo_u64, np.uint64)
    return tuple(torch.from_numpy(o.astype(np.int64)) for o in out)


def words(seed: int, iteration: int, n_rows: int, n: int, ns: int = STEP_NS,
          device=None, row0: int = 0, chain0: int = 0) -> torch.Tensor:
    """Word ``(seed, iteration, row, chain)`` for rows ``row0 ..
    row0+n_rows-1`` and chains ``chain0 .. chain0+n-1``, as a ``[n_rows,
    n]`` torch.uint32 tensor."""
    return words_block(seed, iteration, 1, n_rows, n, ns, device, row0,
                       chain0)[0]


def words_block(seed: int, iteration: int, n_iter: int, n_rows: int, n: int,
                ns: int = STEP_NS, device=None, row0: int = 0,
                chain0: int = 0) -> torch.Tensor:
    """:func:`words` for the ``n_iter`` iterations from ``iteration`` on,
    as one ``[n_iter, n_rows, n]`` torch.uint32 tensor."""
    shape = (n_iter, n_rows, n)
    rows = torch.arange(row0, row0 + n_rows, dtype=torch.int64,
                        device=device)
    its = torch.arange(iteration, iteration + n_iter, dtype=torch.int64,
                       device=device) & _MASK
    c0 = torch.arange(chain0, chain0 + n, dtype=torch.int64,
                      device=device).expand(shape)
    c1 = (rows >> 2)[None, :, None].expand(shape)
    c2 = its[:, None, None].expand(shape)
    c3 = torch.full(shape, int(ns) & _MASK, dtype=torch.int64, device=device)
    out = torch.stack(philox4x32((c0, c1, c2, c3), seed_key(seed)))
    lane = (rows & 3)[None, None, :, None].expand((1,) + shape)
    return torch.gather(out, 0, lane)[0].to(torch.uint32)


def gates(seed: int, it0: int, n: int, row: int, alpha: float) -> np.ndarray:
    """The migration gates iterations ``it0 .. it0+n-1`` write: ``[n]``
    bool, True where ``to_uni(word(seed, it, row, chain 0)) <= α`` (α
    rounded to float32) and α > 0 — the host twin of the step kernels'
    gate draw (``csrc/step_body.cuh``, from the ``fire`` row).  One
    vectorised Philox call on the CPU; the card is not touched."""
    if alpha <= 0.0 or n <= 0:
        return np.zeros(max(n, 0), dtype=bool)
    w = words_block(seed, it0, n, 1, 1, row0=row)[:, 0, 0]
    return (to_uni(w) <= float(np.float32(alpha))).numpy()


def replication_seeds(key: int, n_reps: int) -> list:
    """The Philox seeds of a replicated run's ``n_reps`` replications,
    a pure function of ``key`` (the JAX package splits its key,
    ``demcmc_tpu/sampler.py:1658-1659``): replication r's seed is the
    64-bit word pair ``(row 0, row 1)`` of chain r in ``REPLICATE_NS``."""
    w = words(key, 0, 2, n_reps, ns=REPLICATE_NS).to(torch.int64).tolist()
    return [lo | (hi << 32) for lo, hi in zip(w[0], w[1])]


def rep_gates(seeds, it0: int, n: int, row: int, alpha: float) -> np.ndarray:
    """:func:`gates` of each seed of a replicated run: ``[n, R]`` bool,
    column r replication r's solo gates."""
    if not len(seeds):
        return np.zeros((max(n, 0), 0), dtype=bool)
    return np.stack([gates(s, it0, n, row, alpha) for s in seeds], axis=1)


def packed_events(key: int, it0: int, n: int, n_reps: int,
                  alpha: float) -> np.ndarray:
    """A packed run's migration events at iterations ``it0 .. it0+n-1``:
    ``[n, R]`` bool, True where ``to_uni(word(key, it, 0, r)) <= α`` in
    ``PACKED_GATE_NS`` (α rounded to float32) and α > 0 — one Bernoulli(α)
    event per iteration and replication, the JAX law (``demcmc_tpu/
    sampler.py:858-863``), a pure function of the iteration, so the same
    for any split of the run into windows."""
    if alpha <= 0.0 or n <= 0:
        return np.zeros((max(n, 0), n_reps), dtype=bool)
    w = words_block(key, it0, n, 1, n_reps, ns=PACKED_GATE_NS)[:, 0]
    return (to_uni(w) <= float(np.float32(alpha))).numpy()


def to_uni(bits: torch.Tensor) -> torch.Tensor:
    """uint32 words -> float32 uniforms in [0, 1) with 23 random bits:
    ``float_from_bits((b >> 9) | 0x3F800000) - 1`` — the TPU kernel's map
    (``demcmc_tpu/ops/fused_step.py`` ``to_uni``), not curand's."""
    b = bits.to(torch.int64)
    one = ((b >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
    return one - 1.0


def randint(bits: torch.Tensor, span: int) -> torch.Tensor:
    """``bits % span`` as int64 (the TPU kernel's index draw)."""
    return bits.to(torch.int64) % int(span)


# ------------------------------------------------- the unfused step's pool
#
# Word rules of the unfused step, as the JAX pool's (demcmc_tpu/rng.py:
# 133-180).  A float32 draw takes one word per element: a uniform is
# (w >> 8) · 2⁻²⁴.  A float64 draw takes two, the high word's top 26 bits
# and the low word's top 27: (w_hi >> 6) · 2⁻²⁶ + (w_lo >> 5) · 2⁻⁵³, the
# two column sets one after the other; a normal, two uniforms, takes four.
# The port models the JAX step with x64 off for a float32 configuration
# and with x64 on for a float64 one, where every group randint also takes
# two words (a 64-bit draw, (w_hi · 2³² + w_lo) mod span); a draw that
# names no dtype is float32 in either, and a uint32-span draw (randuint)
# takes one word in both.


def _uniform24(w: torch.Tensor) -> torch.Tensor:
    """uint32 words -> float32 uniforms ``(w >> 8) · 2⁻²⁴`` (the JAX
    ``Pool``'s map, not the kernels' :func:`to_uni`)."""
    return (w.to(torch.int64) >> 8).to(torch.float32) * 2.0 ** -24


def _uniform53(w_hi: torch.Tensor, w_lo: torch.Tensor) -> torch.Tensor:
    """Two uint32 words (int64 values) -> a float64 uniform with 53 random
    bits, ``(w_hi >> 6) · 2⁻²⁶ + (w_lo >> 5) · 2⁻⁵³`` (exact: the two
    parts' bits do not overlap)."""
    return ((w_hi >> 6).to(torch.float64) * 2.0 ** -26
            + (w_lo >> 5).to(torch.float64) * 2.0 ** -53)


def _wide(dtype) -> bool:
    """True for a float64 draw (two words per element)."""
    return dtype == torch.float64


def _shift(u, lo, hi, dtype):
    """``lo + (hi − lo) u``, in float32 with both constants rounded to
    float32 once (JAX's weak-typed constants), in float64 as given."""
    if (lo, hi) == (0.0, 1.0):
        return u
    if _wide(dtype):
        return lo + (hi - lo) * u
    return float(np.float32(lo)) + float(np.float32(hi - lo)) * u


def _mod64(w_hi, w_lo, span: int):
    """``(w_hi · 2³² + w_lo) mod span`` for uint32 words held in int64 and
    ``0 < span < 2³¹``, without an intermediate at or above 2⁶³."""
    return ((w_hi % span) * ((1 << 32) % span) + w_lo % span) % span


class Scalars:
    """The :class:`Pool`'s scalar side channel (the JAX ``Pool.scalars``,
    a ``KeyDraws``): scalar draws in call order, on the host.  From
    ``words`` (uint32 ints: a float32 uniform ``(w >> 8) · 2⁻²⁴``, a
    float64 one from two words as the pool's, randint ``lo + w mod (hi −
    lo)``) or, in tests, from fed ``values`` taken as they are.  The
    unfused step draws two per iteration, both one word: the migration
    gate (float32, as the JAX step draws it whatever the state's dtype)
    and, when it fires, the number of groups that take part."""

    N_DRAWS = 2

    def __init__(self, words=(), values=None):
        self.words, self.values, self.i = list(words), values, 0

    def _next(self):
        i = self.i
        self.i += 1
        return i

    def uniform(self, shape=(), lo=0.0, hi=1.0, dtype=torch.float32):
        if tuple(shape) != ():
            raise ValueError(f"the scalar side channel draws scalars, not "
                             f"{shape}")
        i = self._next()
        if self.values is not None:
            u = float(self.values[i])
        elif _wide(dtype):
            self.i += 1
            u = ((int(self.words[i]) >> 6) * 2.0 ** -26
                 + (int(self.words[i + 1]) >> 5) * 2.0 ** -53)
        else:
            u = (int(self.words[i]) >> 8) * 2.0 ** -24
        return u if (lo, hi) == (0.0, 1.0) else lo + (hi - lo) * u

    def randint(self, shape, lo: int, hi: int):
        if tuple(shape) != ():
            raise ValueError(f"the scalar side channel draws scalars, not "
                             f"{shape}")
        i = self._next()
        if self.values is not None:
            return int(self.values[i])
        return lo + int(self.words[i]) % (hi - lo)


class Pool:
    """Twin of ``demcmc_tpu.rng.Pool`` (``demcmc_tpu/rng.py:68-193``): one
    ``[G, n_words]`` uint32 block of words per iteration, from which every
    group-shaped draw takes the next columns in call order; scalar draws
    go to the :class:`Scalars` side channel.

    A draw of shape ``(G, ...)`` takes ``prod(shape[1:])`` columns, one of
    shape ``(n, G, ...)`` takes ``n · prod(rest)`` (group-major, then moved
    to the front), twice as many for a float64 draw and, with ``x64`` (a
    float64 configuration), for a randint (the word rules above).  Maps:
    uniform (``lo + (hi − lo) u``), normal Box–Muller from two uniforms
    with the first clamped to ``tiny``, gumbel ``−log(−log(max(u,
    tiny)))``, randint ``lo + w mod (hi − lo)``.  ``bits`` comes from
    Philox namespace ``POOL_NS`` or, in tests, from the JAX ``Pool``'s own
    ``jax.random.bits``.  The block is converted to int64 and mapped to
    float32 uniforms once, at its first draw, and each draw slices them:
    on the card the step is host-bound, one torch launch a draw fewer is
    what counts."""

    def __init__(self, bits: torch.Tensor, scalars: Scalars,
                 x64: bool = False):
        self.bits, self.scalars, self.x64 = bits, scalars, bool(x64)
        self.n_rows = int(bits.shape[0])
        self.offset = 0
        # the iteration as an int64 device scalar, in a pool the unfused
        # step's CUDA graph captures (its value changes between replays)
        self.it_tensor = None

    def rows_seen(self, iteration: int):
        """DE-MCz's count of past rows, ``max(it − 1, 1)``: a host int,
        or in a captured pool an int64 device scalar."""
        if self.it_tensor is None:
            return max(int(iteration) - 1, 1)
        return torch.clamp_min(self.it_tensor - 1, 1)

    def _cols(self, shape):
        """Columns a group-shaped draw takes, or None for a scalar one."""
        shape = tuple(shape)
        rest = 1
        if shape and shape[0] == self.n_rows:
            for s in shape[1:]:
                rest *= int(s)
            return rest
        if len(shape) >= 2 and shape[1] == self.n_rows:
            for s in shape[2:]:
                rest *= int(s)
            return int(shape[0]) * rest
        return None

    @functools.cached_property
    def _words(self):
        """The block as int64, converted once (draws are slices of it)."""
        return self.bits.to(torch.int64)

    @functools.cached_property
    def _uniforms(self):
        """The block's float32 uniforms, mapped once for the iteration's
        draws."""
        return _uniform24(self._words)

    def _take(self, shape, src=None):
        """The next columns of ``src`` (the int64 words by default) for a
        group-shaped draw of ``shape``."""
        shape = tuple(shape)
        k = self._cols(shape)
        if k is None:
            raise ValueError(f"pool draw shape {shape} has no group axis of "
                             f"size {self.n_rows}")
        if self.offset + k > self.bits.shape[1]:
            raise ValueError("random pool exhausted; size it to the step")
        src = self._words if src is None else src
        w = src[:, self.offset:self.offset + k]
        self.offset += k
        if shape[0] == self.n_rows:
            return w.reshape(shape)
        return w.reshape((self.n_rows, shape[0]) + shape[2:]).movedim(1, 0)

    def skip(self, shape, dtype=torch.float32):
        """Pass over what a uniform draw of ``shape`` (and ``dtype``) would
        take: the JAX pool slices its columns, and numbers its scalar
        draws, when the step is traced, so a draw inside a branch that does
        not run still uses them up."""
        cols = self._cols(shape)
        if cols is None:
            self.scalars.i += 1
        else:
            self.offset += cols * (2 if _wide(dtype) else 1)

    def uniform(self, shape=(), lo=0.0, hi=1.0, dtype=torch.float32):
        if self._cols(shape) is None:
            return self.scalars.uniform(shape, lo, hi, dtype)
        if _wide(dtype):
            w_hi = self._take(shape)
            u = _uniform53(w_hi, self._take(shape))
        else:
            u = self._take(shape, self._uniforms)
        return _shift(u, lo, hi, dtype)

    def gumbel(self, shape=(), dtype=torch.float32):
        u = self.uniform(shape, dtype=dtype)
        return -torch.log(-torch.log(torch.clamp_min(u, tiny(dtype))))

    def normal(self, shape=(), dtype=torch.float32):
        u1 = torch.clamp_min(self.uniform(shape, dtype=dtype), tiny(dtype))
        u2 = self.uniform(shape, dtype=dtype)
        two_pi = 2.0 * math.pi if _wide(dtype) else TWO_PI
        return torch.sqrt(-2.0 * torch.log(u1)) * torch.cos(two_pi * u2)

    def randint(self, shape, lo: int, hi: int):
        if self._cols(shape) is None:
            return self.scalars.randint(shape, lo, hi)
        if self.x64:
            w_hi = self._take(shape)
            idx = _mod64(w_hi, self._take(shape), hi - lo)
        else:
            idx = self._take(shape) % (hi - lo)
        return idx + lo if lo else idx

    def randuint(self, shape, span):
        """Words modulo ``span``, a uint32 span held in a Python int or
        an int64 device scalar (the JAX ``Pool.randuint``, over resample's
        flat (row, chain) space; one word in either word rule); int64
        values."""
        if isinstance(span, torch.Tensor):
            return self._take(shape) % (span & 0xFFFFFFFF)
        return self._take(shape) % (int(span) & 0xFFFFFFFF)


class CountingDraws:
    """Shape-faithful stand-in that sizes a :class:`Pool` (the JAX
    ``CountingDraws``, ``demcmc_tpu/rng.py:195``): draws return zeros and
    ``words`` counts the columns the real pool would take, by the same
    word rules (a normal takes two uniforms; scalar draws take none)."""

    def __init__(self, n_rows: int, device=None, x64: bool = False):
        self.n_rows, self.device, self.words = int(n_rows), device, 0
        self.x64 = bool(x64)
        # the migration gate open (0.0), so its exchange's draws count too
        self.scalars = Scalars(values=[0.0, 2])

    _cols = Pool._cols

    def _zeros(self, shape, k=1, dtype=torch.float32):
        cols = self._cols(shape)
        if cols is not None:
            self.words += k * cols
        return torch.zeros(tuple(shape), dtype=dtype, device=self.device)

    def skip(self, shape, dtype=torch.float32):
        if self._cols(shape) is None:
            self.scalars.i += 1
        else:
            self._zeros(shape, 2 if _wide(dtype) else 1)

    def uniform(self, shape=(), lo=0.0, hi=1.0, dtype=torch.float32):
        if self._cols(shape) is None:
            return self.scalars.uniform(shape, lo, hi, dtype)
        return _shift(self._zeros(shape, 2 if _wide(dtype) else 1, dtype),
                      lo, hi, dtype)

    def gumbel(self, shape=(), dtype=torch.float32):
        return self._zeros(shape, 2 if _wide(dtype) else 1, dtype)

    def normal(self, shape=(), dtype=torch.float32):
        return self._zeros(shape, 4 if _wide(dtype) else 2, dtype)

    def randint(self, shape, lo: int, hi: int):
        if self._cols(shape) is None:
            return self.scalars.randint(shape, lo, hi)
        return self._zeros(shape, 2 if self.x64 else 1,
                           dtype=torch.int64) + lo

    def randuint(self, shape, span: int):
        return self._zeros(shape, dtype=torch.int64)


# ------------------------------------------ stochastic models, custom slots


def eval_row(block, member, Np: int, n_noise: int) -> int:
    """The first ``EVAL_NS`` row of one evaluation's noise panel of
    ``n_noise`` uniforms per chain: the row packs the sweep (0, or 1 +
    the block's index), the sequential sweep's member (0, or 1 + its
    slot) and the panel's index, so that each (iteration, block, member)
    draws its own panel, as the JAX step folds its evaluation key per
    iteration, block and member (``demcmc_tpu/sampler.py:978, 1018,
    1067``)."""
    sub = ((0 if block is None else int(block) + 1) * (int(Np) + 1)
           + (0 if member is None else int(member) + 1))
    row = sub * int(n_noise)
    if row + int(n_noise) > 1 << 32:
        raise ValueError(f"the noise panel's rows reach past 2**32 "
                         f"(block {block}, member {member}, {n_noise} "
                         f"uniforms)")
    return row


GLOBAL_CHAIN = _MASK    # a Key's chain word for draws with no group axis


class Key:
    """The port's counterpart of the JAX PRNG key a custom strategy slot
    receives (``ProposalContext.key``, ``next_key()``, a custom update's
    key): a counter-based stream of Philox words of namespace
    ``CUSTOM_NS`` under the key's own two words, drawn as the
    :class:`Pool` draws.  A group-shaped draw (``(G, ...)`` or ``(n, G,
    ...)``) takes the next columns of each group, the chain word being the
    population's group index (a shard of a chain mesh, ``chain0``, draws
    the unsharded values); any other shape takes the next columns of one
    global stream, the same on every shard.  Maps: uniform (float32 from
    one word, float64 from two), normal by Box–Muller, ``randint`` ``lo +
    w mod (hi − lo)`` (two words with ``x64``), ``bits`` the words
    themselves (int64 values in [0, 2³²)).

    :meth:`fold_in` derives a new key as ``jax.random.fold_in`` does:
    its two words are a Philox block of the data, the iteration and
    ``FOLD_NS`` under the parent's words.  The unfused step folds them
    as the JAX step folds its keys (``demcmc_tpu/sampler.py:978-979,
    1024-1025, 1067``; ``next_key``, ``demcmc_tpu/ops/proposals.py:
    60-71``), so no two calls share words, and a key's words never alias
    the pool's (another namespace) or another key's.  A custom slot is
    written against each package's own API, so the words are not JAX's
    threefry bits: a slot that draws from its key gives the same law, not
    the same numbers, as its JAX twin."""

    def __init__(self, seed: int, iteration: int, n_rows: int,
                 chain0: int = 0, device=None, x64: bool = False,
                 words=None):
        self.seed, self.iteration = int(seed), int(iteration)
        self.n_rows, self.chain0 = int(n_rows), int(chain0)
        self.device = torch.device("cpu" if device is None else device)
        self.x64 = bool(x64)
        self.words = seed_key(seed) if words is None else tuple(words)
        self.offset = self.global_offset = 0

    def fold_in(self, data: int) -> "Key":
        """A new key at the start of its stream, derived from this one's
        words and ``data`` (a non-negative int below 2⁶⁴)."""
        data = int(data)
        ctr = (data & _MASK, data >> 32, self.iteration & _MASK, FOLD_NS)
        w = _rounds(ctr, self.words, _mulhilo_int)
        return Key(self.seed, self.iteration, self.n_rows, self.chain0,
                   self.device, self.x64, words=w[:2])

    _cols = Pool._cols

    def _fill(self, row0: int, n_rows: int, chain0: int, n: int):
        """Words ``[n_rows, n]`` (int64) of rows ``row0 ..`` and chains
        ``chain0 ..`` of this key's stream: one ``philox_fill`` launch on
        the card, :func:`words` on the CPU."""
        from .ops import fused_step
        out = torch.empty((n_rows, n), dtype=torch.uint32,
                          device=self.device)
        fused_step.philox_fill(out, self.words[0] | (self.words[1] << 32),
                               self.iteration, CUSTOM_NS, row0=row0,
                               chain0=chain0)
        return out.to(torch.int64)

    def _take(self, shape):
        """The next words for a draw of ``shape``: the group's next columns
        for a group-shaped draw, the global stream's next values else."""
        shape = tuple(shape)
        k = self._cols(shape)
        if k is None:
            n = 1
            for s in shape:
                n *= int(s)
            w = self._fill(self.global_offset, max(n, 1), GLOBAL_CHAIN, 1)
            self.global_offset += max(n, 1)
            return w.reshape(shape) if shape else w.reshape(())
        w = self._fill(self.offset, k, self.chain0, self.n_rows).T
        self.offset += k
        if shape[0] == self.n_rows:
            return w.reshape(shape)
        return w.reshape((self.n_rows, shape[0]) + shape[2:]).movedim(1, 0)

    def bits(self, shape=()):
        return self._take(shape)

    def uniform(self, shape=(), lo=0.0, hi=1.0, dtype=torch.float32):
        if _wide(dtype):
            w_hi = self._take(shape)
            u = _uniform53(w_hi, self._take(shape))
        else:
            u = _uniform24(self._take(shape))
        return _shift(u, lo, hi, dtype)

    def normal(self, shape=(), dtype=torch.float32):
        u1 = torch.clamp_min(self.uniform(shape, dtype=dtype), tiny(dtype))
        u2 = self.uniform(shape, dtype=dtype)
        two_pi = 2.0 * math.pi if _wide(dtype) else TWO_PI
        return torch.sqrt(-2.0 * torch.log(u1)) * torch.cos(two_pi * u2)

    def randint(self, shape, lo: int, hi: int):
        if self.x64:
            w_hi = self._take(shape)
            idx = _mod64(w_hi, self._take(shape), hi - lo)
        else:
            idx = self._take(shape) % (hi - lo)
        return idx + lo if lo else idx
