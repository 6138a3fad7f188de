"""A window of DE-MCz iterations: the wrapper of CUDA kernel K3
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
chain), slot row ``set·n_slots + slot`` with slots 0-1 the pair and 2-4
the triple — one slot set per block sweep and sub-sweep, block-major, like
``_resample_idx`` (:2637).
The JAX package draws these words with threefry; the port's draw cannot
reproduce that stream, so tests feed both the same indices (indices-in
mode, ``idx [K·n_sets·n_slots, C]`` for a window of K iterations) and
the same step words (bits-in).

A window of K iterations runs as one launch, as K1's does
(:mod:`.fused_step`).  Iteration ``it + 1`` may read history row ``it −
1`` of any chain, so a window of K > 1 runs the whole population in one
CTA, or, on a density of ``_build.HOIST_DENSITIES`` (the Gaussian), in
one thread block cluster of CTAs of whole groups with the cluster barrier
between iterations.  How many chains it holds depends on the
instantiation (its registers per thread, the stage's shared memory) and,
for a cluster, on the CTAs the card co-schedules in one (16 where it can,
else 8); above that K3 takes one iteration per launch
(:func:`resample_super_k`, a rule on the configuration and the built
kernel, read once).

With migration (α > 0 and G > 1, the JAX kernel's ``mig_in_kernel`` on
the resample layout, :2061-2101) the iteration's words begin with the
three migration rows and K3 draws the next gate at its last row, as K1
does; the exchange is K2, launched between windows on the same θ and w
(``sampler.Step``).  The history is never migrated.  The JAX kernel
pads the population to whole lanes, and its pad groups rank last (key
2.0, ``G_mig`` :1412-1419) with N ~ U{2..G} over the real groups, so its
exchange is K2's over the G real groups.
"""

from __future__ import annotations

import ctypes

import torch

from .. import rng
from . import _build
from . import fused_step as fused_ops
from . import proposals as proposal_ops

MAX_WINDOW_C = fused_ops.MAX_BLOCK_CHAINS  # the most one CTA's window holds
# CTAs of a cluster window on the CPU's static rule: the portable cluster
# size (the card reads its own, csrc/step_body.cuh cluster_size)
CLUSTER_CTAS = 8
_window_chains: dict = {}
# Iterations per K3 window at most, chosen on an H100 by chip_smoke.py's K
# sweep on the MVN flagship (PERF.md: K = 4 to 256 within 4% of each
# other, K3 being bound by one thread's serial chain; 64 the lowest); any
# K gives the same draws.
RESAMPLE_SUPER_K = 64


def window_chains(cfg, device) -> int:
    """Chains a K3 window of K > 1 holds for this configuration: on a CUDA
    device read from the built library once per configuration
    (``csrc/step_body.cuh`` ``window_chains``): one CTA's, or on a density
    of ``_build.HOIST_DENSITIES`` one cluster's CTAs of whole groups of
    ``cfg.Np``; on the CPU the static rule, :data:`MAX_WINDOW_C` (one CTA)
    or :data:`CLUSTER_CTAS` CTAs of whole groups within
    :data:`MAX_WINDOW_C` chains each."""
    r, dens = cfg.rows, cfg.density
    device = torch.device(device)
    if device.type != "cuda":
        if dens is not None and dens.name in _build.HOIST_DENSITIES:
            return CLUSTER_CTAS * (MAX_WINDOW_C // cfg.Np) * cfg.Np
        return MAX_WINDOW_C
    _build.entry("resample_step", dens)              # raises if not built
    fn = "resample_window_chains_" + dens.name
    key = (fn, r.n_members > 1, r.snooker >= 0, r.n_blocks, cfg.Np,
           device.index)
    if key not in _window_chains:
        lib = _build.library("de_step_resample")
        n = ctypes.c_int()
        with torch.cuda.device(device):
            rc = getattr(lib, fn)(int(key[1]), int(key[2]), r.n_blocks,
                                  cfg.Np, ctypes.byref(n))
        _build.check(lib, rc, fn)
        _window_chains[key] = n.value
    return _window_chains[key]


def resample_super_k(cfg, device="cpu") -> int:
    """Iterations per K3 launch at most: :data:`RESAMPLE_SUPER_K`, or 1
    where the population is more than one CTA holds
    (:func:`window_chains`)."""
    return (RESAMPLE_SUPER_K if cfg.G * cfg.Np <= window_chains(cfg, device)
            else 1)


def index_rows(cfg) -> int:
    """Index word rows per iteration: one slot set per block sweep and
    sub-sweep (``StepConfig.n_sets``)."""
    return cfg.n_sets * cfg.n_slots


def indices_from_words(cfg, words, it: int, n_pop: int = None):
    """Flat history indices ``[n_sets·n_slots, c]`` int64 from the
    ``RESAMPLE_NS`` words of iteration ``it`` (same shape, uint32; the
    words of the launch's ``c`` chains): per slot set, the pair and then
    the triple, each without replacement, over the ``count·n_pop`` (row,
    chain) pairs of a population of ``n_pop`` chains (default the
    configuration's ``G·Np``; a shard's is the whole population's)."""
    C = cfg.G * cfg.Np if n_pop is None else int(n_pop)
    k = cfg.n_slots
    count = max(int(it) - 1, 1)
    out = []
    for m in range(cfg.n_sets):
        w = words[m * k:(m + 1) * k]
        out.append(proposal_ops.resample_flat_indices(w[:2], count, C))
        if k == 5:
            out.append(proposal_ops.resample_flat_indices(w[2:], count, C))
    return torch.cat(out)


def indices(cfg, seed: int, it: int, device=None, chain0: int = 0,
            n_pop: int = None):
    """The history indices K3 draws for iteration ``it`` in Philox mode,
    for chains ``chain0 ..`` of a population of ``n_pop`` chains (the
    whole population by default)."""
    words = rng.words(seed, it, index_rows(cfg), cfg.G * cfg.Np,
                      ns=rng.RESAMPLE_NS, device=device, chain0=chain0)
    return indices_from_words(cfg, words, it, n_pop)


def history_partners(cfg, hist, idx):
    """K3's partner source: the pair (and triple) of slot set ``slot_set``
    read from ``hist [H, C_pop, d]`` (the population's) at the flat
    indices ``idx``."""
    G, Np, d, k = cfg.G, cfg.Np, cfg.d, cfg.n_slots
    flat = hist.view(-1, d)

    def partners(th, slot_set, off):
        def get(slot):
            return flat[idx[slot_set * k + slot]].view(G, Np, d)
        triple = (get(2), get(3), get(4)) if k == 5 else None
        return get(0), get(1), triple

    return partners


def resample_step_plain(cfg, model, spec, theta, w, fire, hist, it: int,
                        words, idx, out=None, K: int = 1, emit=(0, 1),
                        phase: str = "all", chain0: int = 0):
    """Plain version of K3 for a window of ``K`` iterations from ``it``, in
    place on ``theta [C, d]``, ``w [C]``, ``fire [1]`` and the columns
    ``chain0 .. chain0 + C − 1`` of history rows ``it − 1 .. it + K − 2``
    of ``hist [H, C_pop, d]``: ``theta`` holds chains ``chain0 ..`` of a
    population of ``C_pop`` (a shard of a chain mesh, ``cfg`` its
    ``fused_step.local_config``; one iteration at a time), or the whole
    population (``chain0 = 0``, ``C_pop = C``).  ``words [K·n_words, n]``
    uint32 with the population's ``n >= chain0 + C`` columns (the gate
    from chain 0's), ``idx [K·n_sets·n_slots, C]`` int64 flat history
    indices of the launch's chains, ``out`` the window's trajectory slice
    (``fused_step.trajectory``).  Returns the accept margins
    (``fused_step.window_plain``)."""
    _check_window(cfg, hist, it, K, emit, phase, chain0)
    out = fused_ops.trajectory(cfg, out, K, emit)
    n, m, C = cfg.rows.n_words, index_rows(cfg), cfg.G * cfg.Np
    if words.shape[1] < chain0 + C:
        raise ValueError(f"words: {words.shape[1]} columns, need the "
                         f"population's {chain0 + C} or more")

    def one(k, it_k, slot):
        wk = words[k * n:(k + 1) * n, chain0:chain0 + C]
        gate = words[k * n + cfg.rows.fire, :1] if chain0 else None
        margin = fused_ops.sweep_plain(
            cfg, model, spec, theta, w, fire, it_k, wk,
            history_partners(cfg, hist, idx[k * m:(k + 1) * m]), slot, gate)
        hist[it_k - 1, chain0:chain0 + C].copy_(theta)
        return margin

    return fused_ops.window_plain(cfg, fire, it, K, emit, out, one)


def _check_window(cfg, hist, it, K, emit, phase, chain0=0):
    fused_ops.check_window(cfg, it, K, emit, phase)
    H, C_pop = hist.shape[0], hist.shape[1]
    if not (2 <= it and it + K - 1 <= H):
        raise ValueError(f"iterations {it}..{it + K - 1} need history rows "
                         f"0..{it + K - 2}; the history has {H} rows")
    C = cfg.G * cfg.Np
    if chain0 < 0 or chain0 + C > C_pop:
        raise ValueError(f"chains {chain0}..{chain0 + C - 1} of a history "
                         f"of {C_pop} chains")
    if K > 1 and (chain0 or C_pop != C):
        raise ValueError(f"a shard of a population (chains {chain0}.. of "
                         f"{C_pop}) steps one iteration a launch: the other "
                         f"shards write the rest of each history row")
    most = window_chains(cfg, hist.device)
    if K > 1 and cfg.G * cfg.Np > most:
        raise ValueError(f"a K3 window of K > 1 runs in one CTA (or one "
                         f"cluster), at most {most} chains for this "
                         f"configuration; this population has "
                         f"{cfg.G * cfg.Np} (resample_super_k gives 1)")


def resample_step(cfg, model, spec, theta, w, fire, hist, it: int,
                  seed: int = 0, out=None, bits=None, idx=None,
                  check: bool = True, K: int = 1, emit=(0, 1),
                  phase: str = "all", chain0: int = 0):
    """A window of ``K`` DE-MCz iterations from ``it`` in place on ``theta
    [C, d]`` / ``w [C]``, writing each iteration's state to history row
    ``it_k − 1`` of ``hist [H, C, d]``, the migration gate its last
    iteration draws to ``fire [1]`` (the window holds no open gate before
    its last iteration; K2 runs between windows, ``sampler.Step``) and,
    with ``out``, the trajectory rows of the emission rule ``emit`` (as
    :func:`.fused_step.de_step`).

    ``theta`` may be one shard of the population (``cfg`` its
    ``fused_step.local_config``): chains ``chain0 ..`` of it, with ``hist
    [H, C_pop, d]`` the population's history, one iteration a launch.  The
    shard draws the words of its chains (the gate from chain 0's), its
    history indices over the population's ``count·C_pop`` (row, chain)
    pairs, and writes its columns ``chain0 .. chain0 + C − 1`` of the
    history row.

    Words are Philox(seed, it + k) or ``bits [K·n_words, n]`` of the
    population's ``n`` chains; history indices are drawn from Philox
    ``RESAMPLE_NS`` words or given as ``idx [K·n_sets·n_slots, C]`` (the
    launch's chains).  CPU tensors take the plain version; CUDA tensors
    launch K3 once (``resample_step.launches`` counts the launches); there
    is no fallback."""
    C, C_pop = cfg.G * cfg.Np, hist.shape[1]
    if not cfg.resample:
        raise ValueError("resample_step needs a resample configuration")
    _check_window(cfg, hist, it, K, emit, phase, chain0)
    if theta.device.type == "cpu":
        if bits is None:
            n = chain0 + C
            bits = rng.words_block(seed, it, K, cfg.rows.n_words,
                                   n).view(-1, n)
        if idx is None:
            idx = torch.cat([indices(cfg, seed, it + k, chain0=chain0,
                                     n_pop=C_pop) for k in range(K)])
        resample_step_plain(cfg, model, spec, theta, w, fire, hist, it,
                            bits, idx, out, K, emit, phase, chain0)
        return
    if check:
        check_cuda(cfg, theta, w, fire, hist, bits, idx, out, K, emit,
                   chain0)
    lib = _build.library("de_step_resample")
    name = _build.entry("resample_step", cfg.density, cfg.mode)
    o_t, o_w, o_a = (None, None, None) if out is None else (
        out[0].data_ptr(), out[1].data_ptr(), out[2].data_ptr())
    _build.launch(
        lib, name, theta.device,
        theta.data_ptr(), w.data_ptr(), o_t, o_w, o_a, fire.data_ptr(),
        hist.data_ptr(), hist.shape[0],
        None if bits is None else bits.data_ptr(),
        None if idx is None else idx.data_ptr(),
        cfg.iargs(it, seed, K, emit, phase == "post",
                  None if bits is None else bits.shape[1]),
        cfg.fargs, cfg.sweep_args, cfg.theta_snooker_arg, int(chain0),
        int(C_pop))
    resample_step.launches += 1


resample_step.launches = 0


def check_cuda(cfg, theta, w, fire, hist, bits=None, idx=None, out=None,
               K: int = 1, emit=(0, 1), chain0: int = 0):
    """Raise unless the tensors are what K3 takes on a CUDA device for a
    window of ``K`` iterations storing by ``emit``, on chains ``chain0
    ..`` of the population whose history ``hist`` is."""
    fused_ops.check_cuda(cfg, theta, w, fire, bits, out, "resample_step",
                         K, emit, chain0)
    C, d = cfg.G * cfg.Np, cfg.d
    want = [("hist", hist, torch.float32,
             (hist.shape[0], max(hist.shape[1], chain0 + C), d))]
    if idx is not None:
        want.append(("idx", idx, torch.int64, (K * index_rows(cfg), C)))
    for name, t, dt, shape in want:
        if (t.device != theta.device or t.dtype != dt
                or tuple(t.shape) != shape or not t.is_contiguous()):
            raise ValueError(f"{name}: need a contiguous {dt} {shape} tensor "
                             f"on {theta.device}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
