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
partner slot of the iteration).
"""

from __future__ import annotations

import torch

STEP_NS = 0     # per-iteration draw rows (migration + sweep + fire)
INIT_NS = 1     # initial population draws (iteration slot = 0)
GATE_NS = 2     # first migration gate of a run
RESAMPLE_NS = 3  # DE-MCz history indices (row = partner slot)

_M0, _M1 = 0xD2511F53, 0xCD9E8D57          # Philox multipliers
_W0, _W1 = 0x9E3779B9, 0xBB67AE85          # Weyl key bumps
_MASK = 0xFFFFFFFF
TINY = 1.1754943508222875e-38              # float32 smallest normal


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
          device=None, row0: int = 0) -> torch.Tensor:
    """Word ``(seed, iteration, row, chain)`` for rows ``row0 ..
    row0+n_rows-1`` and chains ``0..n-1``, as a ``[n_rows, n]``
    torch.uint32 tensor."""
    return words_block(seed, iteration, 1, n_rows, n, ns, device, row0)[0]


def words_block(seed: int, iteration: int, n_iter: int, n_rows: int, n: int,
                ns: int = STEP_NS, device=None,
                row0: int = 0) -> torch.Tensor:
    """:func:`words` for the ``n_iter`` iterations from ``iteration`` on,
    as one ``[n_iter, n_rows, n]`` torch.uint32 tensor."""
    shape = (n_iter, n_rows, n)
    rows = torch.arange(row0, row0 + n_rows, dtype=torch.int64,
                        device=device)
    its = torch.arange(iteration, iteration + n_iter, dtype=torch.int64,
                       device=device) & _MASK
    c0 = torch.arange(n, dtype=torch.int64, device=device).expand(shape)
    c1 = (rows >> 2)[None, :, None].expand(shape)
    c2 = its[:, None, None].expand(shape)
    c3 = torch.full(shape, int(ns) & _MASK, dtype=torch.int64, device=device)
    out = torch.stack(philox4x32((c0, c1, c2, c3), seed_key(seed)))
    lane = (rows & 3)[None, None, :, None].expand((1,) + shape)
    return torch.gather(out, 0, lane)[0].to(torch.uint32)


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
