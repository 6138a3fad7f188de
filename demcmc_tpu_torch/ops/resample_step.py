"""One DE-MCz iteration: the wrapper of CUDA kernel K3
(``csrc/de_step_resample.cu``) and its plain PyTorch version.

K3 is the port of the resample variant of the TPU kernel
``demcmc_tpu/ops/fused_step.py::build_fused_step``: the DE pair and the
snooker triple come from the history of past states of all chains
(``one_sweep_resample`` :2224-2246, reference ``crossover.jl:113-124``),
the γ₂ base select stays group-local, and the updated state is written to
history row ``it − 1`` (:2494-2517, ``store_samples!``).  The TPU kernel
has three history engines (in-VMEM ``fetch_hist_narrow`` :2178, the
streamed pre-gather ``_resample_pre`` :2688 and the wide one-hot permute
``fetch_hist_wide`` :2130); on the GPU the history stays in device memory
as ``[H, C, d]`` and a partner is a direct load, so one engine replaces
the three and there is no cap on C.

Partner indices are flat ``row·C + chain`` over the ``count·C`` past
(row, chain) pairs, ``count = max(it − 1, 1)``, drawn without replacement
within each pair and each triple (:func:`.proposals.resample_flat_indices`)
from Philox words of namespace ``RESAMPLE_NS``: word (seed, it, slot row,
chain), slot row ``member·n_slots + slot`` with slots 0-1 the pair and 2-4
the triple — one slot set per sub-sweep, like ``_resample_idx`` (:2637).
The JAX package draws these words with threefry; the port's draw cannot
reproduce that stream, so tests feed both the same indices (indices-in
mode, ``idx [n_members·n_slots, C]``) and the same step words (bits-in).
"""

from __future__ import annotations

import torch

from .. import rng
from . import _build
from . import fused_step as fused_ops
from . import proposals as proposal_ops


def index_rows(cfg) -> int:
    """Index word rows per iteration: one slot set per sub-sweep."""
    return cfg.rows.n_members * cfg.n_slots


def indices_from_words(cfg, words, it: int):
    """Flat history indices ``[n_members·n_slots, C]`` int64 from the
    ``RESAMPLE_NS`` words of iteration ``it`` (same shape, uint32): per
    sub-sweep, the pair and then the triple, each without replacement."""
    C, k = cfg.G * cfg.Np, cfg.n_slots
    count = max(int(it) - 1, 1)
    out = []
    for m in range(cfg.rows.n_members):
        w = words[m * k:(m + 1) * k]
        out.append(proposal_ops.resample_flat_indices(w[:2], count, C))
        if k == 5:
            out.append(proposal_ops.resample_flat_indices(w[2:], count, C))
    return torch.cat(out)


def indices(cfg, seed: int, it: int, device=None):
    """The history indices K3 draws for iteration ``it`` in Philox mode."""
    words = rng.words(seed, it, index_rows(cfg), cfg.G * cfg.Np,
                      ns=rng.RESAMPLE_NS, device=device)
    return indices_from_words(cfg, words, it)


def history_partners(cfg, hist, idx):
    """K3's partner source: the pair (and triple) of sub-sweep ``member``
    read from ``hist [H, C, d]`` at the flat indices ``idx``."""
    G, Np, d, k = cfg.G, cfg.Np, cfg.d, cfg.n_slots
    flat = hist.view(-1, d)

    def partners(th, member, off):
        def get(slot):
            return flat[idx[member * k + slot]].view(G, Np, d)
        triple = (get(2), get(3), get(4)) if k == 5 else None
        return get(0), get(1), triple

    return partners


def resample_step_plain(cfg, model, spec, theta, w, fire, hist, it: int,
                        words, idx, out=None):
    """Plain version of K3, in place on ``theta [C, d]``, ``w [C]``,
    ``fire [1]`` and history row ``it − 1`` of ``hist [H, C, d]``;
    ``words [n_words, C]`` uint32, ``idx [n_members·n_slots, C]`` int64
    flat history indices.  Returns each chain's accept margin."""
    margin = fused_ops.sweep_plain(cfg, model, spec, theta, w, fire, it,
                                   words, history_partners(cfg, hist, idx),
                                   out)
    hist[it - 1].copy_(theta)
    return margin


def resample_step(cfg, model, spec, theta, w, fire, hist, it: int,
                  seed: int = 0, out=None, bits=None, idx=None,
                  check: bool = True):
    """One DE-MCz iteration in place on ``theta [C, d]`` / ``w [C]``,
    writing the new state to history row ``it − 1`` of ``hist [H, C,
    d]``, the next gate (always 0: resample runs have no migration) to
    ``fire [1]`` and, with ``out``, the trajectory row (as
    :func:`.fused_step.de_step`).

    Words are Philox(seed, it) or ``bits [n_words, C]``; history indices
    are drawn from Philox ``RESAMPLE_NS`` words or given as ``idx``.  CPU
    tensors take the plain version; CUDA tensors launch K3
    (``resample_step.launches`` counts the launches); there is no
    fallback."""
    C = cfg.G * cfg.Np
    if not cfg.resample:
        raise ValueError("resample_step needs a resample configuration")
    H = hist.shape[0]
    if not 2 <= it <= H:
        raise ValueError(f"iteration {it} needs history rows 0..{it - 1}; "
                         f"the history has {H} rows")
    if theta.device.type == "cpu":
        words = (bits if bits is not None
                 else rng.words(seed, it, cfg.rows.n_words, C))
        if idx is None:
            idx = indices(cfg, seed, it)
        resample_step_plain(cfg, model, spec, theta, w, fire, hist, it,
                            words, idx, out)
        return
    if check:
        check_cuda(cfg, theta, w, fire, hist, bits, idx, out)
    lib = _build.library("de_step_resample")
    name = _build.entry("resample_step", cfg.density)
    o_t, o_w, o_a = (None, None, None) if out is None else (
        out[0].data_ptr(), out[1].data_ptr(), out[2].data_ptr())
    rc = getattr(lib, name)(
        theta.data_ptr(), w.data_ptr(), o_t, o_w, o_a, fire.data_ptr(),
        hist.data_ptr(), H, None if bits is None else bits.data_ptr(),
        None if idx is None else idx.data_ptr(),
        cfg.iargs(it, seed), cfg.fargs, cfg.sweep_args,
        cfg.theta_snooker_arg,
        torch.cuda.current_stream(theta.device).cuda_stream)
    resample_step.launches += 1
    _build.check(lib, rc, name)


resample_step.launches = 0


def check_cuda(cfg, theta, w, fire, hist, bits=None, idx=None, out=None):
    """Raise unless the tensors are what K3 takes on a CUDA device."""
    fused_ops.check_cuda(cfg, theta, w, fire, bits, out, "resample_step")
    C, d = cfg.G * cfg.Np, cfg.d
    want = [("hist", hist, torch.float32, (hist.shape[0], C, d))]
    if idx is not None:
        want.append(("idx", idx, torch.int64, (index_rows(cfg), C)))
    for name, t, dt, shape in want:
        if (t.device != theta.device or t.dtype != dt
                or tuple(t.shape) != shape or not t.is_contiguous()):
            raise ValueError(f"{name}: need a contiguous {dt} {shape} tensor "
                             f"on {theta.device}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
