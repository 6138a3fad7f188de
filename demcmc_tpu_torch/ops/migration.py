"""Migration between groups: the wrapper of CUDA kernel K2
(``csrc/migration.cu``) and its plain PyTorch version.

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

import torch

from .. import rng
from . import _build

N_ROWS = 3        # rows 0-2 of an iteration's words: ranks, N, gumbels


def exchange(theta, w, u_key, n_active, gum):
    """One exchange on group-shaped values: ``theta [G, Np, d]``,
    ``w [G, Np]``, ``u_key [G]`` rank keys, ``n_active`` (0-d int tensor
    or int) and ``gum [G, Np]``; returns new ``(theta, w)``."""
    G, Np, d = theta.shape
    dev = theta.device
    gi = torch.arange(G, device=dev)
    vid = torch.argmax(gum - w, dim=1)                 # first max on ties
    vt = theta[gi, vid] + 0.0                          # [G, d]
    vw = w[gi, vid] + 0.0                              # [G]
    order = torch.sort(u_key, stable=True).indices     # ties by index
    n = torch.as_tensor(n_active, device=dev)
    src_pos = torch.where(gi < n, torch.remainder(gi - 1, n), gi)
    src = torch.empty_like(order)
    src[order] = order[src_pos]                        # dest -> source group
    new_theta = theta.clone()
    new_w = w.clone()
    new_theta[gi, vid] = vt[src]
    new_w[gi, vid] = vw[src]
    return new_theta, new_w


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
    CUDA tensors launch K2 (``migrate.launches`` counts the launches).
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
    rc = lib.migrate_f32(theta.data_ptr(), w.data_ptr(), fire.data_ptr(),
                         bits_ptr, k0, k1, int(it), G, Np, d,
                         torch.cuda.current_stream(theta.device).cuda_stream)
    migrate.launches += 1
    _build.check(lib, rc, "migrate_f32")


migrate.launches = 0


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
