"""Smoke test of the PyTorch/CUDA port (``demcmc_tpu_torch``) on one GPU.

Run from the root of a checkout, on a machine with an NVIDIA H100 and the
CUDA toolkit:

    python3 chip_smoke.py

Phases; any failure raises and the script exits non-zero:

1. build   the CUDA kernels from ``demcmc_tpu_torch/csrc`` (one ``nvcc``
           per source, all started together);
2. philox  device Philox words equal the plain torch words bit for bit;
3. K2      the migration kernel equals its plain version bit for bit, in
           bits-in mode, at (G, Np, d) = (8, 4, 2), (256, 16, 2) and
           (4096, 16, 2), with ±inf weights, -0.0 and tied uniforms;
4. K1      the DE-step kernel against its plain version at 4,096 chains:
           8 bits-in iterations crossing burn-in 4 with the migration gate
           set at the start, then one iteration on Philox words;
5. main    ``demcmc_tpu_torch.sample`` on the Gaussian (50 observations
           from numpy seed 0, G=256 groups of Np=16, burn-in 1,000, 3,000
           iterations) on ``cuda``: both kernels launched 3,000 times,
           posterior means and sds within 0.01 of the quadrature oracle,
           max R̂ < 1.01; then acceptance, chain-steps/s and µs/iteration;
6. trace   ``sample()`` as in phase 5 under ``torch.profiler``: both
           kernels appear 3,000 times each in the device trace; the
           device's busy time and idle share over the run;
7. timing  each kernel's device time per launch at the main path's
           shapes beside its plain version's and its bound;
8. K1-sync, K1-sequential  K1 with snooker (θs = 0.5) against its plain
           version at (G, Np, d) = (4096, 16, 2) synchronous and (4096, 4,
           2) sequential: 8 bits-in iterations crossing burn-in 4 with the
           gate set at the start, then one on Philox words; degenerate
           snooker draws (z = θ) must occur;
9. K3      the DE-MCz kernel against its plain version at the MVN shapes
           (C = 3, d = 30, n_initial = 124, sequential) and at C = 512 (G =
           128, Np = 4, synchronous), θs = 0.5: 8 iterations with random
           history indices and words crossing burn-in, then one on Philox
           words and indices; the history row written must agree too;
10. main-65k  path A, ``sample()`` on the 65,536-chain snooker Gaussian
           (G = 4,096, Np = 16, α = 0.1, θs = 0.1; burn-in 1,000, 3,000
           iterations, thin 10): K1 and K2 launched 3,000 times each,
           posterior within 0.01 of the oracle, max R̂ < 1.01;
11. main-mvn  path B, ``sample()`` on the 30-dim MVN DE-MCz flagship
           (burn-in 2,000, 50,000 iterations): K3 launched 50,000 times and
           the reference's four assertions;
12. main-wide  the C = 512 DE-MCz Gaussian through ``sample()``: K3
           launched 3,000 times, posterior within 0.01, max R̂ < 1.01;
13. main-seq  path A's configuration with Np = 4, so the sequential sweep
           (16,384 chains): K1 and K2 launched 3,000 times each, posterior
           within 0.01, max R̂ < 1.01;
14. trace2  the 65,536-chain cell (1,500 iterations) and the MVN cell
           (5,000 iterations) under ``torch.profiler``: every launch in the
           device trace, the device's idle share over each loop;
15. timing2  device ms per launch of K1 with snooker at 4,096 × 16 and
           sequential at 4,096 × 4, K2 fired and unfired at G = 4,096, K3
           at the MVN shape and at C = 512, beside the plain versions and
           the bounds.

The last three lines of standard output are the kernels' JSON line, the
card's name and power limit, and ``{"ok": true, "device": {...}}``.
"""

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

# comparison tolerance of K1 against its plain version, for θ and w:
# |kernel − plain| <= ATOL + RTOL·|plain|, about 8 float32 ulp
ATOL, RTOL = 1e-6, 1e-6
NEAR_TIE = 1e-4           # |log u − Δ| at or below this: accept may differ

# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, float32 non-tensor op/s
PEAK_BYTES, PEAK_OPS = 3.35e12, 67e12
PHILOX_OPS = 100          # one block: 10 rounds of 2 mul.hi, 2 mul.lo,
                          # 4 xor, 2 key adds
K1_F32_OPS = 70           # per chain: proposal, ε, Box–Muller, density, MH
K2_F32_OPS = 8            # per chain: uniform, two logs, subtraction, max

G, NP, D = 256, 16, 2     # the bench configuration: 4,096 chains
C = G * NP
N_ITER, BURNIN = 3000, 1000
OUT = Path(__file__).resolve().parent / "chiprun_out"


def log(phase, msg):
    print(f"[{phase}] {msg}", flush=True)


def ints(x):
    """Bit pattern of a float32 or uint32 tensor, for bitwise comparison."""
    return x.contiguous().view(torch.int32)


def random_words(rng, n_rows, n, dev):
    w = rng.integers(0, 2 ** 32, (n_rows, n), dtype=np.uint64)
    return torch.from_numpy(w.astype(np.uint32)).to(dev)


# ---------------------------------------------------------------- phases


def phase_build():
    from demcmc_tpu_torch.ops import _build
    t0 = time.perf_counter()
    paths = _build.build_all()
    log("build", f"{len(paths)} libraries in "
        f"{time.perf_counter() - t0:.2f} s: "
        + ", ".join(p.name for p in paths.values()))
    for name in paths:
        for line in (_build.BUILD / f"lib{name}.log").read_text().splitlines():
            if "registers" in line or "bytes stack" in line:
                log("build", f"{name}: {line.strip()}")


def phase_philox(dev):
    from demcmc_tpu_torch import rng
    from demcmc_tpu_torch.ops import fused_step
    seed, it = (0x9E3779B97F4A7C15, 1234)
    out = torch.empty((17, C), dtype=torch.uint32, device=dev)
    fused_step.philox_words_cuda(out, seed, it, rng.STEP_NS)
    want = rng.words(seed, it, 17, C, device=dev)
    torch.cuda.synchronize()
    if not torch.equal(ints(out), ints(want)):
        raise AssertionError("device Philox words differ from plain ones")
    log("philox", f"[17, {C}] device words equal the plain words bit for bit")


def _mig_case(rng, G_, Np_, dev):
    """θ with -0.0, w with ±inf, words whose odd groups' leader words tie
    with the previous group's (same top 23 bits)."""
    C_ = G_ * Np_
    theta = (rng.standard_normal((C_, D)) * 1e3
             + rng.random((C_, D)) * 1e-4).astype(np.float32)
    theta[rng.random((C_, D)) < 0.05] = -0.0
    w = rng.standard_normal(C_).astype(np.float32)
    w[rng.random(C_) < 0.1] = -np.inf
    w[rng.random(C_) < 0.05] = np.inf
    words = rng.integers(0, 2 ** 32, (3, C_), dtype=np.uint64)
    lead = np.arange(Np_, C_, 2 * Np_)
    words[0, lead] = ((words[0, lead - Np_] & ~np.uint64(0x1FF))
                      | rng.integers(0, 0x200, lead.size).astype(np.uint64))
    return (torch.tensor(theta, device=dev), torch.tensor(w, device=dev),
            torch.from_numpy(words.astype(np.uint32)).to(dev))


def phase_k2(dev):
    from demcmc_tpu_torch.ops import migration as mig
    rng = np.random.default_rng(2)
    worst = 0.0
    for G_, Np_ in ((8, 4), (256, 16), (4096, 16)):
        theta, w, words = _mig_case(rng, G_, Np_, dev)
        one = torch.ones(1, dtype=torch.int32, device=dev)
        tk, wk = theta.clone(), w.clone()
        tp, wp = theta.clone(), w.clone()
        mig.migrate(tk, wk, one, G_, Np_, bits=words)
        mig.migrate_plain(tp, wp, one, words, G_, Np_)
        zero = torch.zeros(1, dtype=torch.int32, device=dev)
        tz, wz = theta.clone(), w.clone()
        mig.migrate(tz, wz, zero, G_, Np_, bits=words)
        torch.cuda.synchronize()
        moved = int((ints(tp) != ints(theta)).any(1).sum())
        if not (torch.equal(ints(tk), ints(tp)) and torch.equal(ints(wk),
                                                                ints(wp))):
            raise AssertionError(f"K2 differs from its plain version at "
                                 f"G={G_}, Np={Np_}")
        if not (torch.equal(ints(tz), ints(theta))
                and torch.equal(ints(wz), ints(w))):
            raise AssertionError("K2 changed the state with fire = 0")
        if moved == 0:
            raise AssertionError("K2 comparison moved no chain")
        fin = torch.isfinite(wp)
        worst = max(worst, float((tk - tp).abs().max()),
                    float((wk[fin] - wp[fin]).abs().max()))
        log("K2", f"G={G_} Np={Np_}: bitwise equal ({moved} chains moved); "
            f"fire=0 leaves the state unchanged")
    return worst


def _k1_setup(dev, burnin):
    import demcmc_tpu_torch as tdm
    from demcmc_tpu_torch.models import gaussian
    from demcmc_tpu_torch.ops import fused_step
    data = np.random.default_rng(0).standard_normal(50).astype(np.float32)
    model, de = gaussian.make(data=data, Np=NP, n_groups=G, burnin=burnin)
    spec = tdm.make_spec(model, de)
    cfg = fused_step.StepConfig.make(model, de, spec)
    return tdm, model, de, spec, cfg


def _check_close(pairs, clear, what, it):
    """Kernel and plain values agree within ATOL + RTOL·|plain| on the
    chains ``clear`` of near-ties, with the same infinities; returns the
    largest difference."""
    worst = 0.0
    for a, b in pairs:
        a, b = a[clear], b[clear]
        if not torch.equal(torch.isfinite(a), torch.isfinite(b)):
            raise AssertionError(f"{what} finiteness differs at it={it}")
        fin = torch.isfinite(b)
        diff = (a[fin] - b[fin]).abs()
        if not bool((diff <= ATOL + RTOL * b[fin].abs()).all()):
            raise AssertionError(f"{what} differs from its plain version at "
                                 f"it={it}: max |diff| {float(diff.max())}")
        if not torch.equal(a[~fin], b[~fin]):
            raise AssertionError(f"{what} infinities differ at it={it}")
        worst = max(worst, float(diff.max()) if diff.numel() else 0.0)
    return worst


def _compare_iteration(cfg, model, spec, state, it, words=None, seed=0):
    """One iteration (K2 then K1) by the kernels and by the plain versions
    from the same state; returns the plain result, the largest θ/w
    difference, the number of chains excluded as near-ties and the
    number accepted."""
    from demcmc_tpu_torch import rng
    from demcmc_tpu_torch.ops import fused_step, migration as mig
    theta, w, fire = state
    dev = theta.device
    G_, Np_, C_ = cfg.G, cfg.Np, cfg.G * cfg.Np
    migrates = cfg.rows.mig >= 0
    k = [x.clone() for x in state]
    p = [x.clone() for x in state]
    ok = (torch.empty((C_, cfg.d), device=dev), torch.empty(C_, device=dev),
          torch.empty(C_, dtype=torch.bool, device=dev))
    op = tuple(torch.empty_like(x) for x in ok)
    if words is None:
        if migrates:
            mig.migrate(k[0], k[1], k[2], G_, Np_, seed=seed, it=it)
        fused_step.de_step(cfg, model, spec, *k, it, seed=seed, out=ok)
        words = rng.words(seed, it, cfg.rows.n_words, C_, device=dev)
    else:
        if migrates:
            mig.migrate(k[0], k[1], k[2], G_, Np_, bits=words)
        fused_step.de_step(cfg, model, spec, *k, it, out=ok, bits=words)
    if migrates:
        mig.migrate_plain(p[0], p[1], p[2], words, G_, Np_)
    margin = fused_step.de_step_plain(cfg, model, spec, *p, it, words,
                                      out=op)
    torch.cuda.synchronize()
    clear = margin.abs() > NEAR_TIE
    if not torch.equal(ok[2][clear], op[2][clear]):
        raise AssertionError(f"K1 accept flags differ at it={it}")
    if int(k[2][0]) != int(p[2][0]):
        raise AssertionError(f"K1 next migration gate differs at it={it}")
    worst = _check_close(((k[0], p[0]), (k[1], p[1]), (ok[0], op[0]),
                          (ok[1], op[1])), clear, "K1", it)
    return p, worst, int((~clear).sum()), int(op[2].sum())


def phase_k1(dev):
    tdm, model, de, spec, cfg = _k1_setup(dev, burnin=4)
    s = tdm.init_state(model, de, spec, 3, device=dev)
    state = [s.theta, s.weight, torch.ones(1, dtype=torch.int32, device=dev)]
    rng = np.random.default_rng(4)
    worst = 0.0
    for it in range(1, 9):
        words = random_words(rng, cfg.rows.n_words, C, dev)
        state, err, ties, n_acc = _compare_iteration(cfg, model, spec,
                                                     state, it, words=words)
        worst = max(worst, err)
        log("K1", f"bits-in it={it} ({'burn-in' if it <= 4 else 'sampling'}"
            f", fire in={'1' if it == 1 else 'drawn'}): {n_acc} accepted, "
            f"max |diff| {err:.3g}, {ties} near-ties excluded")
    state, err, ties, n_acc = _compare_iteration(cfg, model, spec, state, 9,
                                                 seed=77)
    worst = max(worst, err)
    log("K1", f"Philox it=9: {n_acc} accepted, max |diff| {err:.3g}, "
        f"{ties} near-ties excluded")
    log("K1", f"tolerance |kernel - plain| <= {ATOL:g} + {RTOL:g}|plain|; "
        f"max |diff| over all iterations {worst:.3g}")
    return worst


def phase_main(dev):
    import demcmc_tpu_torch as tdm
    from demcmc_tpu_torch.models import gaussian
    from demcmc_tpu_torch.ops import fused_step, migration as mig
    data = np.random.default_rng(0).standard_normal(50).astype(np.float32)
    model, de = gaussian.make(data=data, Np=NP, n_groups=G, burnin=BURNIN)
    n_iter = N_ITER

    fused_step.de_step.launches = 0
    mig.migrate.launches = 0
    chains = tdm.sample(model, de, n_iter, key=0)
    torch.cuda.synchronize()
    launches = {"de_step": fused_step.de_step.launches,
                "migrate": mig.migrate.launches}
    log("main", f"launches on the main path: {launches}")
    if launches != {"de_step": n_iter, "migrate": n_iter}:
        raise AssertionError(f"expected {n_iter} launches of each kernel")

    truth = gaussian.posterior_grid(data)
    for name in ("mu", "sigma"):
        m, s = chains.mean(name), chains.std(name)
        tm, ts = truth[name]["mean"], truth[name]["std"]
        log("main", f"{name}: mean {m:.5f} (oracle {tm:.5f}), sd {s:.5f} "
            f"(oracle {ts:.5f})")
        if abs(m - tm) >= 0.01 or abs(s - ts) >= 0.01:
            raise AssertionError(f"{name} posterior off the oracle")
    rhat = float(np.max(chains.rhat()))
    draws = chains.data
    if draws.shape != (n_iter - de.burnin, D, C) or not np.isfinite(
            draws).all():
        raise AssertionError(f"bad draws: shape {draws.shape}")
    acc = float(chains.acceptance.mean())
    log("main", f"max R-hat {rhat:.5f}, acceptance {acc:.4f}, "
        f"draws {draws.shape}")
    if not rhat < 1.01:
        raise AssertionError("max R-hat >= 1.01")

    # timed run after the warm-up above: the whole sample() call
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tdm.sample(model, de, n_iter, key=1)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    log("main", f"sample(): {n_iter} iterations in {dt:.4f} s = "
        f"{dt / n_iter * 1e6:.2f} us/iteration, "
        f"{C * n_iter / dt:.4g} chain-steps/s")

    # the plain PyTorch versions driven the same way on the card
    spec = tdm.make_spec(model, de)
    cfg = fused_step.StepConfig.make(model, de, spec)
    s = tdm.init_state(model, de, spec, 0, device=dev)
    st = [s.theta, s.weight, s.fire]
    plain_iteration(cfg, model, spec, st, 1)
    torch.cuda.synchronize()
    n_plain = 200
    t0 = time.perf_counter()
    for it in range(2, 2 + n_plain):
        plain_iteration(cfg, model, spec, st, it)
    torch.cuda.synchronize()
    dtp = time.perf_counter() - t0
    log("main", f"plain versions on the card: {dtp / n_plain * 1e6:.2f} "
        f"us/iteration")
    return launches, {"acceptance": acc, "rhat_max": rhat,
                      "us_per_iteration": dt / n_iter * 1e6,
                      "chain_steps_per_s": C * n_iter / dt,
                      "plain_us_per_iteration": dtp / n_plain * 1e6}


def plain_iteration(cfg, model, spec, st, it, seed=0):
    from demcmc_tpu_torch import rng
    from demcmc_tpu_torch.ops import fused_step, migration as mig
    words = rng.words(seed, it, cfg.rows.n_words, C, device=st[0].device)
    mig.migrate_plain(st[0], st[1], st[2], words, G, NP)
    fused_step.de_step_plain(cfg, model, spec, *st, it, words)


def _busy(spans, lo=-float("inf"), hi=float("inf")):
    """Length of the union of the (start, end) spans, clipped to [lo, hi]."""
    busy, end = 0.0, lo
    for a, b in sorted(spans):
        a, b = max(a, end), min(b, hi)
        if b > a:
            busy += b - a
            end = b
    return busy


def _trace_sample(tag, model, de, n_iter, names, first, last, fname,
                  key=2, thin=1):
    """``sample()`` under ``torch.profiler`` (CUPTI): the device trace must
    hold each kernel of ``names`` (key -> substring of the kernel's name)
    ``n_iter`` times.  Returns the device's busy time and idle share over
    the iteration loop (first ``first`` start to last ``last`` end) and
    over the whole call (first to last device event), and the time of the
    trajectory's copy to the host."""
    import demcmc_tpu_torch as tdm
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        tdm.sample(model, de, n_iter, key=key, thin=thin)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    OUT.mkdir(exist_ok=True)
    path = OUT / fname
    prof.export_chrome_trace(str(path))
    dev_ev = [e for e in json.loads(path.read_text())["traceEvents"]
              if e.get("ph") == "X" and e.get("cat") in
              ("kernel", "gpu_memcpy", "gpu_memset")]

    def spans(pred):
        return [(float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)))
                for e in dev_ev if pred(e)]

    ours = {k: spans(lambda e, n=n: e["cat"] == "kernel" and n in e["name"])
            for k, n in names.items()}
    counts = {k: len(v) for k, v in ours.items()}
    log(tag, f"kernels in the device trace: {counts}")
    if counts != {k: n_iter for k in names}:
        raise AssertionError(f"expected {n_iter} traced launches of each "
                             f"kernel")
    every = spans(lambda e: True)
    lo = min(a for a, _ in ours[first])
    hi = max(b for _, b in ours[last])
    loop_busy = _busy(every, lo, hi)
    call = max(b for _, b in every) - min(a for a, _ in every)
    call_busy = _busy(every)
    copy = _busy(spans(lambda e: e["cat"] == "gpu_memcpy"), hi)
    mean = {k: float(np.mean([b - a for a, b in v])) for k, v in ours.items()}
    out = {"traced_us_per_iteration": wall / n_iter * 1e6,
           "loop_us_per_iteration": (hi - lo) / n_iter,
           "loop_busy_us_per_iteration": loop_busy / n_iter,
           "loop_idle_share": 1.0 - loop_busy / (hi - lo),
           "call_idle_share": 1.0 - call_busy / call,
           "trajectory_copy_ms": copy / 1e3}
    log(tag, f"sample() traced: {out['traced_us_per_iteration']:.2f} "
        f"us/iteration on the host clock; iteration loop "
        f"{out['loop_us_per_iteration']:.2f} us/iteration on the device "
        f"clock, busy {out['loop_busy_us_per_iteration']:.3f}, idle share "
        f"{out['loop_idle_share']:.4f}; whole call {call / 1e3:.3f} ms, idle "
        f"share {out['call_idle_share']:.4f}; trajectory copy to the host "
        f"{out['trajectory_copy_ms']:.3f} ms; mean traced kernel time "
        + ", ".join(f"{k} {v:.3f} us" for k, v in mean.items())
        + f"; {len(every)} device events (trace in {path.name})")
    return out


# kernel names in the device trace: K1 and K3 are instantiations of
# step_body.cuh's sweep_kernel over their partner sources
K1_NAME, K2_NAME, K3_NAME = "GroupPartners", "migrate_kernel", \
    "HistoryPartners"


def phase_trace(dev):
    """``sample()`` as in phase 5 under ``torch.profiler``: both kernels
    appear ``N_ITER`` times each in the device trace; the device's busy
    time and idle share over the run."""
    from demcmc_tpu_torch.models import gaussian
    data = np.random.default_rng(0).standard_normal(50).astype(np.float32)
    model, de = gaussian.make(data=data, Np=NP, n_groups=G, burnin=BURNIN)
    return _trace_sample("trace", model, de, N_ITER,
                         {"de_step": K1_NAME, "migrate": K2_NAME},
                         "migrate", "de_step", "trace_main.json")


# ---------------------------------------------------------------- timing


_cycles_per_ms = []


def cycles_per_ms():
    """Clock of ``torch.cuda._sleep`` (the spin kernel that holds the
    stream while launches are queued behind it)."""
    if not _cycles_per_ms:
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(1_000_000)
        a.record()
        torch.cuda._sleep(20_000_000)
        b.record()
        torch.cuda.synchronize()
        _cycles_per_ms.append(20_000_000 / a.elapsed_time(b))
    return _cycles_per_ms[0]


def device_ms(fn, n):
    """Device time per call of ``fn``: ``n`` calls queued behind a spin
    kernel, so they run back to back whatever the host's enqueue time,
    timed with CUDA events.  Returns ``(ms, queued, host_ms)``: ``queued``
    is False when the spin ended before the host had queued every call
    (then the time includes host gaps); ``host_ms`` is the host's time to
    issue one call."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) * 1e3
    spin_ms = max(2.0 * n * host_ms, 5.0)
    for _ in range(3):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(int(spin_ms * cycles_per_ms()))
        a.record()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        issue_ms = (time.perf_counter() - t0) * 1e3 / n
        b.record()
        queued = not a.query()
        torch.cuda.synchronize()
        if queued:
            break
        spin_ms *= 4
    return a.elapsed_time(b) / n, queued, issue_ms


def phase_timing(dev, launches, errs):
    from demcmc_tpu_torch import rng
    from demcmc_tpu_torch.ops import fused_step, migration as mig
    tdm, model, de, spec, cfg = _k1_setup(dev, burnin=1000)
    s = tdm.init_state(model, de, spec, 5, device=dev)
    theta, w, fire = s.theta, s.weight, s.fire
    out = (torch.empty((C, D), device=dev), torch.empty(C, device=dev),
           torch.empty(C, dtype=torch.bool, device=dev))
    it = 2000                                 # past burn-in, as most are
    n_words = cfg.rows.n_words

    def k1():
        fused_step.de_step(cfg, model, spec, theta, w, fire, it, out=out)

    def k1_burnin():                          # the softmax base-select too
        fused_step.de_step(cfg, model, spec, theta, w, fire, 500, out=out)

    def k1_burnin_plain():
        words = rng.words(0, 500, n_words, C, device=dev)
        fused_step.de_step_plain(cfg, model, spec, theta, w, fire, 500, words,
                                 out=out)

    def k1_plain():
        words = rng.words(0, it, n_words, C, device=dev)
        fused_step.de_step_plain(cfg, model, spec, theta, w, fire, it, words,
                                 out=out)

    fired = torch.ones(1, dtype=torch.int32, device=dev)
    unfired = torch.zeros(1, dtype=torch.int32, device=dev)

    def k2():
        mig.migrate(theta, w, fired, G, NP, it=it)

    def k2_unfired():
        mig.migrate(theta, w, unfired, G, NP, it=it)

    def k2_plain():
        words = rng.words(0, it, mig.N_ROWS, C, device=dev)
        mig.migrate_plain(theta, w, fired, words, G, NP)

    # plain, kernel, kernel, plain: each reported time is the mean of two
    t = {}
    for name, fn, n in (("k1_plain", k1_plain, 2), ("k1", k1, 200),
                        ("k1", k1, 200), ("k1_plain", k1_plain, 2),
                        ("k1_burnin_plain", k1_burnin_plain, 2),
                        ("k1_burnin", k1_burnin, 200),
                        ("k1_burnin", k1_burnin, 200),
                        ("k1_burnin_plain", k1_burnin_plain, 2),
                        ("k2_plain", k2_plain, 2), ("k2", k2, 200),
                        ("k2_unfired", k2_unfired, 200), ("k2", k2, 200),
                        ("k2_plain", k2_plain, 2)):
        t.setdefault(name, []).append(device_ms(fn, n))
    ms = {k: float(np.mean([x for x, _, _ in v])) for k, v in t.items()}
    for k, v in t.items():
        log("timing", f"{k}: {ms[k]:.6f} ms per call on the device ("
            + ", ".join(f"{x:.6f}{'' if q else ' host-gapped'}"
                        for x, q, _ in v)
            + "); host issues a call in "
            + ", ".join(f"{h:.6f}" for _, _, h in v) + " ms")

    # least time for the same work: bytes (each input read once, each
    # output written once) over HBM bandwidth, operations over the
    # float32 peak.  K1's new θ and w are one output: the kernel writes
    # them twice (state and trajectory row), the bound counts them once.
    # Philox words count as whole 4-word blocks: a chain's own rows
    # (partners .. accept) and chain 0's gate row.
    r = cfg.rows
    own = {row >> 2 for row in range(r.partners, r.accept + 1)}
    k1_blocks = C * len(own) + (r.fire >> 2 not in own)
    k1_bytes = (C * (D + 1) * 4            # θ, w read
                + C * (D + 1) * 4 + C      # new θ, w and accept written
                + 4)                       # next migration gate
    k1_ops = k1_blocks * PHILOX_OPS + C * K1_F32_OPS
    k2_bytes = (4 + C * 4                  # gate, w read
                + G * (D + 1) * 4          # victims' θ, w read
                + G * (D + 1) * 4)         # victims' θ, w written
    k2_ops = (C * (PHILOX_OPS + K2_F32_OPS)
              + 4 * G * (G.bit_length() - 1) ** 2)
    # in burn-in K1 also selects the γ₂ base: two segmented scans, an exp
    # and Np compares per chain and the base term; an unfired K2 reads the
    # gate and returns
    k1b_ops = k1_ops + C * (2 * (NP.bit_length() - 1) + NP + 3 * D + 10)
    rows = []
    for name, src, repl, key, nbytes, nops, err, plain in (
            ("de_step", "demcmc_tpu_torch/csrc/de_step.cu",
             "demcmc_tpu/ops/fused_step.py:1858", "k1", k1_bytes, k1_ops,
             errs["k1"], "k1_plain"),
            ("migrate", "demcmc_tpu_torch/csrc/migration.cu",
             "demcmc_tpu/ops/fused_step.py:946", "k2", k2_bytes, k2_ops,
             errs["k2"], "k2_plain"),
            ("de_step/burn-in", "demcmc_tpu_torch/csrc/de_step.cu",
             "demcmc_tpu/ops/fused_step.py:2287", "k1_burnin", k1_bytes,
             k1b_ops, errs["k1"], "k1_burnin_plain"),
            ("migrate/unfired", "demcmc_tpu_torch/csrc/migration.cu",
             "demcmc_tpu/ops/fused_step.py:2066", "k2_unfired", 4, 0,
             errs["k2"], "k2_plain")):
        tb, to = nbytes / PEAK_BYTES * 1e3, nops / PEAK_OPS * 1e3
        rows.append({"name": name, "route": "cuda", "source": src,
                     "replaces": repl,
                     "launches": launches[name.split("/")[0]],
                     "max_abs_err": err, "ms": ms[key],
                     "plain_ms": ms[plain],
                     "bound_ms": max(tb, to),
                     "bound_by": "bytes" if tb >= to else "operations",
                     "library_ms": None})
        log("timing", f"{name}: {nbytes} bytes, {nops} operations")
    log("timing", f"migrate unfired: {ms['k2_unfired']:.5f} ms per launch")
    return rows


# ------------------------------------------ second slice: snooker, sequential
# sweep, DE-MCz resample (K3)

G65, N65 = 4096, 16                   # the 65,536-chain snooker Gaussian
NSEQ = 4                              # its groups cut to 4: sequential sweep
MVN_ITER, MVN_BURNIN = 50_000, 2_000  # the 30-dim MVN DE-MCz flagship
# float32 operations per chain and iteration, a·d + b, for the bounds of the
# second slice's kernels; each chain counts one of the three proposals, the
# one this run's words give it (_step_work)
F32_OPS_PER_DIM, F32_OPS = 2, 12          # every chain: bounds, MH
DE_F32_OPS_PER_DIM, DE_F32_OPS = 13, 18   # DE proposal, ε, κ; γ draws
SN_F32_OPS_PER_DIM, SN_F32_OPS = 24, 20   # snooker projection, correction,
                                          # ε, κ
BM_F32_OPS_PER_DIM = 13                   # Box–Muller normal + mutation
MVN_F32_OPS_PER_DIM, MVN_F32_OPS = 6, 20  # the MVN density
GAUSS_F32_OPS = 16                        # the Gaussian density
N_INITIAL = {"mvn": 124, "C512": 50}      # history seed rows of K3's cases


def _gauss_data():
    return np.random.default_rng(0).standard_normal(50).astype(np.float32)


def _degenerate(cfg, words):
    """Chains whose snooker gate is on and whose z is the chain itself (in
    their own sub-sweep block), read from the words."""
    from demcmc_tpu_torch import rng
    r = cfg.rows
    C_ = cfg.G * cfg.Np
    words = words.to(torch.int64)       # (no uint32 gather on CUDA)
    cols = torch.arange(C_, device=words.device)
    slot = cols % cfg.Np
    off = slot * r.stride if r.n_members > 1 else 0
    az = rng.randint(words[r.triple + off, cols], cfg.Np)
    on = rng.to_uni(words[r.snooker + 1 + off, cols]) <= np.float32(
        cfg.theta_snooker)
    return int(((az == slot) & on).sum())


def phase_k1_variants(dev):
    """K1 with snooker (θs = 0.5, synchronous, 4,096 × 16) and with the
    sequential sweep (θs = 0.5, 4,096 × 4) against the plain version: 8
    bits-in iterations crossing burn-in 4 with the gate set at the start,
    then one Philox iteration.  Returns the largest difference."""
    import demcmc_tpu_torch as tdm
    from demcmc_tpu_torch import rng as trng
    from demcmc_tpu_torch.models import gaussian
    from demcmc_tpu_torch.ops import fused_step
    worst = 0.0
    rng = np.random.default_rng(6)
    for sweep, Np_ in (("sync", 16), ("sequential", 4)):
        model, de = gaussian.make(data=_gauss_data(), Np=Np_, n_groups=G65,
                                  burnin=4, theta_snooker=0.5, sweep=sweep)
        spec = tdm.make_spec(model, de)
        cfg = fused_step.StepConfig.make(model, de, spec)
        s = tdm.init_state(model, de, spec, 7, device=dev)
        state = [s.theta, s.weight, torch.ones(1, dtype=torch.int32,
                                               device=dev)]
        degen = 0
        for it in range(1, 10):
            words = (random_words(rng, cfg.rows.n_words, G65 * Np_, dev)
                     if it < 9 else None)
            degen += _degenerate(cfg, words if words is not None else
                                 trng.words(78, it, cfg.rows.n_words,
                                            G65 * Np_, device=dev))
            state, err, ties, n_acc = _compare_iteration(
                cfg, model, spec, state, it, words=words, seed=78)
            worst = max(worst, err)
            log("K1-" + sweep, f"{'bits-in' if it < 9 else 'Philox'} it={it}"
                f" ({'burn-in' if it <= 4 else 'sampling'}): {n_acc} "
                f"accepted, max |diff| {err:.3g}, {ties} near-ties excluded")
        if degen == 0:
            raise AssertionError(f"K1 {sweep}: no degenerate snooker draw")
        log("K1-" + sweep, f"G={G65} Np={Np_} θs=0.5 n_members="
            f"{cfg.rows.n_members}: {degen} degenerate snooker draws (z = "
            f"θ) over 9 iterations, all equal to the plain version")
    return worst


def _resample_case(dev, which, burnin, theta_sn, key=3, extra_rows=10):
    """(model, spec, cfg, state) of a K3 configuration: the MVN flagship
    (C = 3, d = 30, n_initial = 124) or the C = 512 Gaussian DE-MCz of
    bench.py:216-219 (G = 128, Np = 4, synchronous, n_initial = 50), with
    ``extra_rows`` history rows to write."""
    import demcmc_tpu_torch as tdm
    from demcmc_tpu_torch.models import gaussian, mvnormal
    from demcmc_tpu_torch.ops import fused_step
    if which == "mvn":
        model, de = mvnormal.make(d=30, n_obs=100, key=1, burnin=burnin,
                                  theta_snooker=theta_sn)
    else:
        model, de = gaussian.make(data=_gauss_data(), n_groups=128, Np=4,
                                  alpha=0.0, sample="resample",
                                  n_initial=N_INITIAL[which], burnin=burnin,
                                  theta_snooker=theta_sn, sweep="sync")
    assert de.n_initial == N_INITIAL[which]
    spec = tdm.make_spec(model, de)
    cfg = fused_step.StepConfig.make(model, de, spec)
    s = tdm.sampler._grow_history(
        tdm.init_state(model, de, spec, key, device=dev), extra_rows)
    return model, spec, cfg, s


def _compare_resample(cfg, model, spec, state, it, words=None, idx=None,
                      seed=0):
    """One iteration by K3 and by its plain version from the same state
    (θ, w, fire, history); returns the plain result, the largest θ/w/
    history-row difference, the near-ties excluded and the accepts."""
    from demcmc_tpu_torch import rng
    from demcmc_tpu_torch.ops import resample_step as tres
    dev = state[0].device
    C_ = cfg.G * cfg.Np
    k = [x.clone() for x in state]
    p = [x.clone() for x in state]
    ok = (torch.empty((C_, cfg.d), device=dev), torch.empty(C_, device=dev),
          torch.empty(C_, dtype=torch.bool, device=dev))
    op = tuple(torch.empty_like(x) for x in ok)
    if words is None:
        tres.resample_step(cfg, model, spec, *k, it, seed=seed, out=ok)
        words = rng.words(seed, it, cfg.rows.n_words, C_, device=dev)
        idx = tres.indices(cfg, seed, it, device=dev)
    else:
        tres.resample_step(cfg, model, spec, *k, it, out=ok, bits=words,
                           idx=idx)
    margin = tres.resample_step_plain(cfg, model, spec, *p, it, words, idx,
                                      out=op)
    torch.cuda.synchronize()
    clear = margin.abs() > NEAR_TIE
    if not torch.equal(ok[2][clear], op[2][clear]):
        raise AssertionError(f"K3 accept flags differ at it={it}")
    if int(k[2][0]) != int(p[2][0]):
        raise AssertionError(f"K3 gate differs at it={it}")
    worst = _check_close(((k[0], p[0]), (k[1], p[1]), (ok[0], op[0]),
                          (ok[1], op[1]), (k[3][it - 1], p[3][it - 1])),
                         clear, "K3", it)
    if not torch.equal(ints(k[3][:it - 1]), ints(p[3][:it - 1])):
        raise AssertionError(f"K3 changed history rows before it-1={it - 1}")
    return p, worst, int((~clear).sum()), int(op[2].sum())


def phase_k3(dev):
    """K3 against its plain version at the MVN shapes and at C = 512,
    θs = 0.5: 8 iterations with random indices and words (indices-in +
    bits-in) crossing burn-in, then one on Philox words and indices."""
    from demcmc_tpu_torch.ops import resample_step as tres
    worst = 0.0
    rng = np.random.default_rng(8)
    for which in ("mvn", "C512"):
        it0 = N_INITIAL[which] + 1
        model, spec, cfg, s = _resample_case(dev, which, burnin=it0 + 3,
                                             theta_sn=0.5)
        state = [s.theta, s.weight, s.fire, s.history]
        C_ = cfg.G * cfg.Np
        for k in range(9):
            it = it0 + k
            words = idx = None
            if k < 8:
                words = random_words(rng, cfg.rows.n_words, C_, dev)
                idx = tres.indices_from_words(cfg, random_words(
                    rng, tres.index_rows(cfg), C_, dev), it)
            state, err, ties, n_acc = _compare_resample(
                cfg, model, spec, state, it, words=words, idx=idx, seed=91)
            worst = max(worst, err)
            log("K3-" + which, f"{'indices-in + bits-in' if k < 8 else 'Philox'}"
                f" it={it} ({'burn-in' if it <= it0 + 3 else 'sampling'}): "
                f"{n_acc} accepted, max |diff| {err:.3g}, {ties} near-ties "
                f"excluded")
        log("K3-" + which, f"C={C_} d={cfg.d} n_members={cfg.rows.n_members}"
            f" history {tuple(s.history.shape)}: equal to the plain version")
    return worst


def _reset_counts():
    from demcmc_tpu_torch.ops import fused_step, migration, resample_step
    fused_step.de_step.launches = 0
    migration.migrate.launches = 0
    resample_step.resample_step.launches = 0


def _counts():
    from demcmc_tpu_torch.ops import fused_step, migration, resample_step
    return {"de_step": fused_step.de_step.launches,
            "migrate": migration.migrate.launches,
            "resample_step": resample_step.resample_step.launches}


def _posterior_gate(tag, chains, data, n_draws, C_, tol=0.01):
    from demcmc_tpu_torch.models import gaussian
    truth = gaussian.posterior_grid(data)
    for name in ("mu", "sigma"):
        m, s = chains.mean(name), chains.std(name)
        tm, ts = truth[name]["mean"], truth[name]["std"]
        log(tag, f"{name}: mean {m:.5f} (oracle {tm:.5f}), sd {s:.5f} "
            f"(oracle {ts:.5f})")
        if abs(m - tm) >= tol or abs(s - ts) >= tol:
            raise AssertionError(f"{tag}: {name} posterior off the oracle")
    rhat = float(np.max(chains.rhat()))
    if chains.data.shape != (n_draws, 2, C_) or not np.isfinite(
            chains.data).all():
        raise AssertionError(f"{tag}: bad draws {chains.data.shape}")
    acc = float(chains.acceptance.mean())
    log(tag, f"max R-hat {rhat:.5f}, acceptance {acc:.4f}, draws "
        f"{chains.data.shape}")
    if not rhat < 1.01:
        raise AssertionError(f"{tag}: max R-hat >= 1.01")
    return rhat, acc


def phase_main_65k(dev):
    """Path A: ``sample()`` on the 65,536-chain snooker Gaussian
    (bench.py:186-188: G = 4,096, Np = 16, α = 0.1, θs = 0.1), burn-in
    1,000, 3,000 iterations, thin 10."""
    import demcmc_tpu_torch as tdm
    from demcmc_tpu_torch.models import gaussian
    data = _gauss_data()
    model, de = gaussian.make(data=data, Np=N65, n_groups=G65, burnin=1000,
                              alpha=0.1, theta_snooker=0.1)
    n_iter, thin = 3000, 10
    _reset_counts()
    chains = tdm.sample(model, de, n_iter, key=0, thin=thin)
    torch.cuda.synchronize()
    launches = _counts()
    log("main-65k", f"launches: {launches}")
    if launches != {"de_step": n_iter, "migrate": n_iter,
                    "resample_step": 0}:
        raise AssertionError(f"expected {n_iter} launches of K1 and K2")
    rhat, acc = _posterior_gate("main-65k", chains, data,
                                (n_iter - 1000) // thin, G65 * N65)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tdm.sample(model, de, n_iter, key=1, thin=thin)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    C_ = G65 * N65
    log("main-65k", f"sample(): {n_iter} iterations in {dt:.4f} s = "
        f"{dt / n_iter * 1e6:.2f} us/iteration, "
        f"{C_ * n_iter / dt:.4g} chain-steps/s")
    return launches, {"65k_rhat_max": rhat, "65k_acceptance": acc,
                      "65k_us_per_iteration": dt / n_iter * 1e6,
                      "65k_chain_steps_per_s": C_ * n_iter / dt}


def phase_main_mvn(dev):
    """Path B: ``sample()`` on the 30-dim MVN DE-MCz flagship (bench.py:205:
    Np = 3, one group, θs = 0.1, resample, n_initial = 124, sequential
    sweep), burn-in 2,000, 50,000 iterations, with the reference's four
    assertions (multivariate_normal_tests.jl:65-69)."""
    import demcmc_tpu_torch as tdm
    from demcmc_tpu_torch.models import mvnormal
    model, de = mvnormal.make(d=30, n_obs=100, key=1, burnin=MVN_BURNIN)
    if not (de.sequential_sweep and de.uses_resample and de.n_initial == 124):
        raise AssertionError("not the flagship configuration")
    _reset_counts()
    t0 = time.perf_counter()
    chains = tdm.sample(model, de, MVN_ITER, key=3)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = _counts()
    log("main-mvn", f"launches: {launches}")
    if launches != {"de_step": 0, "migrate": 0, "resample_step": MVN_ITER}:
        raise AssertionError(f"expected {MVN_ITER} launches of K3")
    mu = chains.group("mu")                        # [Ns, 30, 3]
    if mu.shape != (MVN_ITER - MVN_BURNIN, 30, 3) or not np.isfinite(
            chains.data).all():
        raise AssertionError(f"bad draws {chains.data.shape}")
    means = mu.mean(axis=(0, 2))
    sds = mu.std(axis=(0, 2), ddof=1)
    sd_means = means.std(ddof=1)
    r = np.corrcoef(means, np.asarray(model.data, np.float64).mean(0))[0, 1]
    checks = {"all |sd - 0.1| < 0.01": bool(np.all(np.abs(sds - 0.1) < 0.01)),
              "all |mean| < 0.3": bool(np.all(np.abs(means) < 0.3)),
              "|std(means) - 0.1| < 0.01": bool(abs(sd_means - 0.1) < 0.01),
              "cor(data means, post means) > 0.98": bool(r > 0.98)}
    log("main-mvn", f"max |sd - 0.1| {np.abs(sds - 0.1).max():.5f}, max "
        f"|mean| {np.abs(means).max():.5f}, std(means) {sd_means:.5f}, cor "
        f"{r:.5f}, acceptance {float(chains.acceptance.mean()):.4f}: "
        f"{checks}")
    if not all(checks.values()):
        raise AssertionError("the MVN flagship misses a reference assertion")
    log("main-mvn", f"sample(): {MVN_ITER} iterations in {dt:.4f} s = "
        f"{MVN_ITER / dt:.1f} iterations/s, {dt / MVN_ITER * 1e6:.2f} "
        f"us/iteration (first call, kernels already built)")
    return launches, {"mvn_iterations_per_s": MVN_ITER / dt,
                      "mvn_max_sd_dev": float(np.abs(sds - 0.1).max()),
                      "mvn_cor": float(r)}


def phase_main_wide(dev):
    """The C = 512 DE-MCz Gaussian of bench.py:216-219 (G = 128, Np = 4,
    α = 0, θs = 0.1, resample, n_initial = 50, synchronous sweep) through
    ``sample()``: burn-in 1,000, 3,000 iterations, K3 3,000 times,
    posterior within 0.01 of the oracle, max R̂ < 1.01."""
    import demcmc_tpu_torch as tdm
    from demcmc_tpu_torch.models import gaussian
    data = _gauss_data()
    model, de = gaussian.make(data=data, n_groups=128, Np=4, alpha=0.0,
                              sample="resample", n_initial=50, burnin=1000,
                              theta_snooker=0.1, sweep="sync")
    n_iter = 3000
    _reset_counts()
    t0 = time.perf_counter()
    chains = tdm.sample(model, de, n_iter, key=0)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = _counts()
    log("main-wide", f"launches: {launches}")
    if launches != {"de_step": 0, "migrate": 0, "resample_step": n_iter}:
        raise AssertionError(f"expected {n_iter} launches of K3")
    _posterior_gate("main-wide", chains, data, n_iter - 1000, 512)
    log("main-wide", f"sample(): {dt / n_iter * 1e6:.2f} us/iteration")
    return launches


def phase_main_seq(dev):
    """Path A's configuration with groups of Np = 4 (G = 4,096, 16,384
    chains, α = 0.1, θs = 0.1), where the default sweep is the sequential
    one (demcmc_tpu/config.py:86): ``sample()`` with burn-in 1,000, 3,000
    iterations, thin 10; K1 (sequential) and K2 launched 3,000 times each,
    posterior within 0.01 of the oracle, max R̂ < 1.01."""
    import demcmc_tpu_torch as tdm
    from demcmc_tpu_torch.models import gaussian
    data = _gauss_data()
    model, de = gaussian.make(data=data, Np=NSEQ, n_groups=G65, burnin=1000,
                              alpha=0.1, theta_snooker=0.1)
    if not de.sequential_sweep:
        raise AssertionError("Np = 4 should sweep sequentially")
    n_iter, thin = 3000, 10
    _reset_counts()
    t0 = time.perf_counter()
    chains = tdm.sample(model, de, n_iter, key=0, thin=thin)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = _counts()
    log("main-seq", f"launches: {launches}")
    if launches != {"de_step": n_iter, "migrate": n_iter,
                    "resample_step": 0}:
        raise AssertionError(f"expected {n_iter} launches of K1 and K2")
    _posterior_gate("main-seq", chains, data, (n_iter - 1000) // thin,
                    G65 * NSEQ)
    log("main-seq", f"sample(): {dt / n_iter * 1e6:.2f} us/iteration "
        f"(first call)")
    return launches


def phase_trace_slice2(dev):
    """The 65,536-chain snooker Gaussian (1,500 iterations, burn-in 1,000,
    thin 10) and the MVN flagship (5,000 iterations, burn-in 2,000) under
    ``torch.profiler``: every launch in the device trace, and the device's
    idle share over each loop."""
    from demcmc_tpu_torch.models import gaussian, mvnormal
    model, de = gaussian.make(data=_gauss_data(), Np=N65, n_groups=G65,
                              burnin=1000, alpha=0.1, theta_snooker=0.1)
    out = {"65k_" + k: v for k, v in _trace_sample(
        "trace-65k", model, de, 1500, {"de_step": K1_NAME,
                                       "migrate": K2_NAME},
        "migrate", "de_step", "trace_65k.json", thin=10).items()}
    model, de = mvnormal.make(d=30, n_obs=100, key=1, burnin=MVN_BURNIN)
    out.update({"mvn_" + k: v for k, v in _trace_sample(
        "trace-mvn", model, de, 5000, {"resample_step": K3_NAME},
        "resample_step", "resample_step", "trace_mvn.json").items()})
    return out


def _step_work(cfg, words, dens_ops):
    """(bytes, operations) that one K1 or K3 iteration needs for this run's
    words.  Each chain makes one of three proposals, and only its words,
    history rows and arithmetic count: the DE pair (kind 0), the snooker
    triple where the chain's snooker gate fired (1), or the mutation where
    its group's β gate fired (2, which replaces the other two and ε, κ).
    Philox words count as whole 4-word blocks, each chain's in its own
    sub-sweep block, plus the group leader's β gate and chain 0's gate of
    the next iteration; K3's history indices come from RESAMPLE_NS blocks.
    Bytes: θ and w read once, the new θ, w, accept flags and gate written
    once; for K3 also the history rows read and the row written."""
    from demcmc_tpu_torch import rng
    r, d = cfg.rows, cfg.d
    G_, Np_ = cfg.G, cfg.Np
    C_ = G_ * Np_
    w64 = words.to(torch.int64)         # (no uint32 gather on CUDA)
    cols = torch.arange(C_, device=words.device)
    member = cols % Np_ if r.n_members > 1 else torch.zeros_like(cols)
    kind = torch.zeros_like(cols)
    if r.snooker >= 0:
        u = rng.to_uni(w64[r.snooker + 1 + member * r.stride, cols])
        kind[u <= np.float32(cfg.theta_snooker)] = 1
    if r.gate >= 0:
        u = rng.to_uni(w64[r.gate].view(G_, Np_)[:, 0])
        kind[(u <= np.float32(cfg.beta)).repeat_interleave(Np_)] = 2
    lead = (cols % Np_ == 0).to(torch.int64)

    def span(start, n):
        return list(range(start, start + n)) if start >= 0 else []

    sn_gate = span(r.snooker + 1, 1) if r.snooker >= 0 else []
    ek = span(r.eps, d) + span(r.kappa, d)
    rows = {0: span(r.partners, 2) + span(r.gamma, 3) + sn_gate + ek,
            1: span(r.triple, 3) + span(r.snooker, 2) + ek,
            2: span(r.normal, 2 * d)}
    slots = {0: [0, 1], 1: [2, 3, 4], 2: []} if cfg.resample else {}
    f32 = {0: DE_F32_OPS_PER_DIM * d + DE_F32_OPS,
           1: SN_F32_OPS_PER_DIM * d + SN_F32_OPS,
           2: BM_F32_OPS_PER_DIM * d}
    def own(m, k, ld):
        blk = {(x + m * r.stride) >> 2 for x in rows[k] + span(r.accept, 1)}
        if ld and r.gate >= 0:
            blk.add(r.gate >> 2)                # the group's β gate
        return blk

    n = torch.bincount((member * 3 + kind) * 2 + lead,
                       minlength=r.n_members * 6).tolist()
    # chain 0 also reads the next iteration's migration gate
    blocks = int(r.fire >> 2 not in own(0, int(kind[0]), 1))
    n_hist = ops = 0
    for m in range(r.n_members):
        for k in range(3):
            for ld in (0, 1):
                idx = {(m * cfg.n_slots + s) >> 2 for s in slots.get(k, [])}
                cnt = n[(m * 3 + k) * 2 + ld]
                blocks += cnt * (len(own(m, k, ld)) + len(idx))
                n_hist += cnt * len(slots.get(k, []))
                ops += cnt * f32[k]
    ops += blocks * PHILOX_OPS + C_ * (F32_OPS_PER_DIM * d + F32_OPS
                                       + dens_ops)
    nbytes = (C_ * (d + 1) * 4 * 2 + C_ + 4     # θ, w in; θ, w, acc, gate out
              + (n_hist + C_ * cfg.resample) * d * 4)  # history in, row out
    return nbytes, ops


def phase_timing_slice2(dev, launches, errs):
    """Device time per launch of K1 with snooker at 4,096 × 16 and
    sequential at 4,096 × 4, K2 fired and unfired at G = 4,096, K3 at the
    MVN shape and at C = 512, each beside its plain version (plain,
    kernel, kernel, plain) and its bound."""
    import demcmc_tpu_torch as tdm
    from demcmc_tpu_torch import rng
    from demcmc_tpu_torch.models import gaussian
    from demcmc_tpu_torch.ops import fused_step, migration as mig
    from demcmc_tpu_torch.ops import resample_step as tres
    model, de = gaussian.make(data=_gauss_data(), Np=N65, n_groups=G65,
                              burnin=1000, alpha=0.1, theta_snooker=0.1)
    spec = tdm.make_spec(model, de)
    cfg = fused_step.StepConfig.make(model, de, spec)
    s = tdm.init_state(model, de, spec, 5, device=dev)
    C_ = G65 * N65
    theta, w, fire = s.theta, s.weight, s.fire
    out = (torch.empty((C_, 2), device=dev), torch.empty(C_, device=dev),
           torch.empty(C_, dtype=torch.bool, device=dev))
    it = 2000
    fired = torch.ones(1, dtype=torch.int32, device=dev)
    unfired = torch.zeros(1, dtype=torch.int32, device=dev)

    def k1():
        fused_step.de_step(cfg, model, spec, theta, w, fire, it, out=out)

    def k1_plain():
        words = rng.words(0, it, cfg.rows.n_words, C_, device=dev)
        fused_step.de_step_plain(cfg, model, spec, theta, w, fire, it, words,
                                 out=out)

    def k2():
        mig.migrate(theta, w, fired, G65, N65, it=it)

    def k2_unfired():
        mig.migrate(theta, w, unfired, G65, N65, it=it)

    def k2_plain():
        words = rng.words(0, it, mig.N_ROWS, C_, device=dev)
        mig.migrate_plain(theta, w, fired, words, G65, N65)

    # K1 sequential at phase main-seq's shape
    model_q, de_q = gaussian.make(data=_gauss_data(), Np=NSEQ, n_groups=G65,
                                  burnin=1000, alpha=0.1, theta_snooker=0.1)
    spec_q = tdm.make_spec(model_q, de_q)
    cfg_q = fused_step.StepConfig.make(model_q, de_q, spec_q)
    s_q = tdm.init_state(model_q, de_q, spec_q, 5, device=dev)
    Cq = G65 * NSEQ
    out_q = (torch.empty((Cq, 2), device=dev), torch.empty(Cq, device=dev),
             torch.empty(Cq, dtype=torch.bool, device=dev))

    def k1q():
        fused_step.de_step(cfg_q, model_q, spec_q, s_q.theta, s_q.weight,
                           s_q.fire, it, out=out_q)

    def k1q_plain():
        words = rng.words(0, it, cfg_q.rows.n_words, Cq, device=dev)
        fused_step.de_step_plain(cfg_q, model_q, spec_q, s_q.theta,
                                 s_q.weight, s_q.fire, it, words, out=out_q)

    cases = {}
    for which, it3 in (("mvn", 2500), ("C512", 1500)):
        m3, spec3, cfg3, s3 = _resample_case(dev, which, burnin=(
            MVN_BURNIN if which == "mvn" else 1000), theta_sn=0.1, key=4,
            extra_rows=3000)
        C3 = cfg3.G * cfg3.Np
        st3 = (s3.theta, s3.weight, s3.fire, s3.history)
        o3 = (torch.empty((C3, cfg3.d), device=dev),
              torch.empty(C3, device=dev),
              torch.empty(C3, dtype=torch.bool, device=dev))

        def k3(a=(cfg3, m3, spec3, st3, it3, o3)):
            c3, mm, sp, st, i3, o = a
            tres.resample_step(c3, mm, sp, *st, i3, out=o)

        def k3_plain(a=(cfg3, m3, spec3, st3, it3, o3)):
            c3, mm, sp, st, i3, o = a
            C3_ = c3.G * c3.Np
            words = rng.words(0, i3, c3.rows.n_words, C3_, device=dev)
            idx = tres.indices(c3, 0, i3, device=dev)
            tres.resample_step_plain(c3, mm, sp, *st, i3, words, idx, out=o)

        cases[which] = (cfg3, it3, k3, k3_plain)

    t = {}
    seq = [("k1sn_plain", k1_plain, 2), ("k1sn", k1, 200), ("k1sn", k1, 200),
           ("k1sn_plain", k1_plain, 2),
           ("k1seq_plain", k1q_plain, 2), ("k1seq", k1q, 200),
           ("k1seq", k1q, 200), ("k1seq_plain", k1q_plain, 2),
           ("k2g_plain", k2_plain, 2), ("k2g", k2, 100),
           ("k2g_unfired", k2_unfired, 200), ("k2g", k2, 100),
           ("k2g_plain", k2_plain, 2)]
    for which, (_, _, k3, k3_plain) in cases.items():
        seq += [(f"k3{which}_plain", k3_plain, 2), (f"k3{which}", k3, 200),
                (f"k3{which}", k3, 200), (f"k3{which}_plain", k3_plain, 2)]
    for name, fn, n in seq:
        t.setdefault(name, []).append(device_ms(fn, n))
    ms = {k: float(np.mean([x for x, _, _ in v])) for k, v in t.items()}
    for k, v in t.items():
        log("timing2", f"{k}: {ms[k]:.6f} ms per call on the device ("
            + ", ".join(f"{x:.6f}{'' if q else ' host-gapped'}"
                        for x, q, _ in v)
            + "); host issues a call in "
            + ", ".join(f"{h:.6f}" for _, _, h in v) + " ms")

    # bounds: bytes (each input read once, each output written once) over
    # HBM bandwidth and operations over the float32 peak, for the work this
    # run's words need (_step_work)
    def bound(nbytes, nops):
        tb, to = nbytes / PEAK_BYTES * 1e3, nops / PEAK_OPS * 1e3
        return max(tb, to), "bytes" if tb >= to else "operations"

    d = 2
    k1_bytes, k1_ops = _step_work(
        cfg, rng.words(0, it, cfg.rows.n_words, C_, device=dev),
        GAUSS_F32_OPS)
    k1q_bytes, k1q_ops = _step_work(
        cfg_q, rng.words(0, it, cfg_q.rows.n_words, Cq, device=dev),
        GAUSS_F32_OPS)
    k2_bytes = 4 + C_ * 4 + 2 * G65 * (d + 1) * 4
    k2_ops = (C_ * (PHILOX_OPS + K2_F32_OPS)
              + 4 * G65 * (G65.bit_length() - 1) ** 2)
    rows = []
    specs = [("de_step/snooker-65536", "demcmc_tpu_torch/csrc/de_step.cu",
              "demcmc_tpu/ops/fused_step.py:2322", "k1sn", k1_bytes, k1_ops,
              errs["k1_variants"], launches["65k"]["de_step"]),
             ("de_step/sequential-16384", "demcmc_tpu_torch/csrc/de_step.cu",
              "demcmc_tpu/ops/fused_step.py:2453", "k1seq", k1q_bytes,
              k1q_ops, errs["k1_variants"], launches["seq"]["de_step"]),
             ("migrate/G4096", "demcmc_tpu_torch/csrc/migration.cu",
              "demcmc_tpu/ops/fused_step.py:946", "k2g", k2_bytes, k2_ops,
              errs["k2"], launches["65k"]["migrate"])]
    for which, (cfg3, it3, _, _) in cases.items():
        C3, d3 = cfg3.G * cfg3.Np, cfg3.d
        dens = (MVN_F32_OPS_PER_DIM * d3 + MVN_F32_OPS if which == "mvn"
                else GAUSS_F32_OPS)
        nbytes, nops = _step_work(
            cfg3, rng.words(0, it3, cfg3.rows.n_words, C3, device=dev), dens)
        key = "mvn" if which == "mvn" else "wide"
        specs.append((f"resample_step/{'mvn30-C3' if which == 'mvn' else 'gauss-C512'}",
                      "demcmc_tpu_torch/csrc/de_step_resample.cu",
                      "demcmc_tpu/ops/fused_step.py:2224", f"k3{which}",
                      nbytes, nops, errs["k3"],
                      launches[key]["resample_step"]))
    for name, src, repl, key, nbytes, nops, err, n in specs:
        b, by = bound(nbytes, nops)
        rows.append({"name": name, "route": "cuda", "source": src,
                     "replaces": repl, "launches": n, "max_abs_err": err,
                     "ms": ms[key], "plain_ms": ms[key + "_plain"],
                     "bound_ms": b, "bound_by": by, "library_ms": None})
        log("timing2", f"{name}: {nbytes} bytes, {nops} operations, bound "
            f"{b:.3g} ms ({by})")
    rows.append({"name": "migrate/G4096-unfired", "route": "cuda",
                 "source": "demcmc_tpu_torch/csrc/migration.cu",
                 "replaces": "demcmc_tpu/ops/fused_step.py:2066",
                 "launches": launches["65k"]["migrate"],
                 "max_abs_err": errs["k2"], "ms": ms["k2g_unfired"],
                 "plain_ms": ms["k2g_plain"],
                 "bound_ms": 4 / PEAK_BYTES * 1e3, "bound_by": "bytes",
                 "library_ms": None})
    return rows


def gpu_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    return out.splitlines()[0]


def main():
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: torch.cuda.is_available() is false; "
                 "this script needs an NVIDIA GPU")
    import demcmc_tpu_torch  # noqa: F401  (fails outside a checkout)
    dev = torch.device("cuda")
    log("env", f"python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}")
    t_start = time.perf_counter()
    phase_build()
    phase_philox(dev)
    errs = {"k2": phase_k2(dev), "k1": phase_k1(dev)}
    launches, metrics = phase_main(dev)
    metrics.update(phase_trace(dev))
    rows = phase_timing(dev, launches, errs)
    errs["k1_variants"] = phase_k1_variants(dev)
    errs["k3"] = phase_k3(dev)
    paths = {}
    paths["65k"], m = phase_main_65k(dev)
    metrics.update(m)
    paths["mvn"], m = phase_main_mvn(dev)
    metrics.update(m)
    paths["wide"] = phase_main_wide(dev)
    paths["seq"] = phase_main_seq(dev)
    metrics.update(phase_trace_slice2(dev))
    rows += phase_timing_slice2(dev, paths, errs)
    log("end", f"all phases passed in {time.perf_counter() - t_start:.1f} s;"
        f" {json.dumps(metrics)}")
    print(json.dumps({"kernels": rows}))
    print(gpu_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
