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
= group) and its scalar side channel (chain 0).

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


def philox4x32(ctr, key):
    """Philox4x32-10 on four int64 tensors of uint32 counter words and a
    ``(k0, k1)`` key; returns the four output words (int64 tensors)."""
    c0, c1, c2, c3 = ctr
    k0, k1 = int(key[0]) & _MASK, int(key[1]) & _MASK
    for r in range(10):
        if r:
            k0, k1 = (k0 + _W0) & _MASK, (k1 + _W1) & _MASK
        hi0, lo0 = _mulhilo(c0, _M0)
        hi1, lo1 = _mulhilo(c2, _M1)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


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

    def randuint(self, shape, span: int):
        """Words modulo ``span``, a uint32 span held in a Python int (the
        JAX ``Pool.randuint``, over resample's flat (row, chain) space; one
        word in either word rule); int64 values."""
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
