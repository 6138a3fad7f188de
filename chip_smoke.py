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
           shapes beside its plain version's and its bound.

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


def _compare_iteration(cfg, model, spec, state, it, words=None, seed=0):
    """One iteration (K2 then K1) by the kernels and by the plain versions
    from the same state; returns the plain result, the largest θ/w
    difference and the number of chains excluded as near-ties."""
    from demcmc_tpu_torch import rng
    from demcmc_tpu_torch.ops import fused_step, migration as mig
    theta, w, fire = state
    dev = theta.device
    k = [x.clone() for x in state]
    p = [x.clone() for x in state]
    ok = (torch.empty((C, D), device=dev), torch.empty(C, device=dev),
          torch.empty(C, dtype=torch.bool, device=dev))
    op = tuple(torch.empty_like(x) for x in ok)
    if words is None:
        mig.migrate(k[0], k[1], k[2], G, NP, seed=seed, it=it)
        fused_step.de_step(cfg, model, spec, *k, it, seed=seed, out=ok)
        words = rng.words(seed, it, cfg.rows.n_words, C, device=dev)
    else:
        mig.migrate(k[0], k[1], k[2], G, NP, bits=words)
        fused_step.de_step(cfg, model, spec, *k, it, out=ok, bits=words)
    mig.migrate_plain(p[0], p[1], p[2], words, G, NP)
    margin = fused_step.de_step_plain(cfg, model, spec, *p, it, words,
                                      out=op)
    torch.cuda.synchronize()
    clear = margin.abs() > NEAR_TIE
    if not torch.equal(ok[2][clear], op[2][clear]):
        raise AssertionError(f"K1 accept flags differ at it={it}")
    if int(k[2][0]) != int(p[2][0]):
        raise AssertionError(f"K1 next migration gate differs at it={it}")
    worst = 0.0
    for a, b in ((k[0], p[0]), (k[1], p[1]), (ok[0], op[0]), (ok[1], op[1])):
        a, b = a[clear], b[clear]
        if not torch.equal(torch.isfinite(a), torch.isfinite(b)):
            raise AssertionError(f"K1 finiteness differs at it={it}")
        fin = torch.isfinite(b)
        diff = (a[fin] - b[fin]).abs()
        if not bool((diff <= ATOL + RTOL * b[fin].abs()).all()):
            raise AssertionError(f"K1 differs from its plain version at "
                                 f"it={it}: max |diff| {float(diff.max())}")
        if not torch.equal(a[~fin], b[~fin]):
            raise AssertionError(f"K1 infinities differ at it={it}")
        worst = max(worst, float(diff.max()) if diff.numel() else 0.0)
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


def phase_trace(dev):
    """``sample()`` as in phase 5 under ``torch.profiler`` (CUPTI): the
    device trace must hold each kernel ``N_ITER`` times.  Returns the
    device's busy time and idle share over the iteration loop (first K2
    start to last K1 end) and over the whole call (first to last device
    event), and the time of the trajectory's copy to the host."""
    import demcmc_tpu_torch as tdm
    from demcmc_tpu_torch.models import gaussian
    from torch.profiler import ProfilerActivity, profile
    data = np.random.default_rng(0).standard_normal(50).astype(np.float32)
    model, de = gaussian.make(data=data, Np=NP, n_groups=G, burnin=BURNIN)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        tdm.sample(model, de, N_ITER, key=2)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    OUT.mkdir(exist_ok=True)
    path = OUT / "trace_main.json"
    prof.export_chrome_trace(str(path))
    dev_ev = [e for e in json.loads(path.read_text())["traceEvents"]
              if e.get("ph") == "X" and e.get("cat") in
              ("kernel", "gpu_memcpy", "gpu_memset")]

    def spans(pred):
        return [(float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)))
                for e in dev_ev if pred(e)]

    names = {"de_step": "de_step_kernel", "migrate": "migrate_kernel"}
    ours = {k: spans(lambda e, n=n: e["cat"] == "kernel" and n in e["name"])
            for k, n in names.items()}
    counts = {k: len(v) for k, v in ours.items()}
    log("trace", f"kernels in the device trace: {counts}")
    if counts != {"de_step": N_ITER, "migrate": N_ITER}:
        raise AssertionError(f"expected {N_ITER} traced launches of each "
                             f"kernel")
    every = spans(lambda e: True)
    lo = min(a for a, _ in ours["migrate"])
    hi = max(b for _, b in ours["de_step"])
    loop_busy = _busy(every, lo, hi)
    call = max(b for _, b in every) - min(a for a, _ in every)
    call_busy = _busy(every)
    copy = _busy(spans(lambda e: e["cat"] == "gpu_memcpy"), hi)
    mean = {k: float(np.mean([b - a for a, b in v])) for k, v in ours.items()}
    out = {"traced_us_per_iteration": wall / N_ITER * 1e6,
           "loop_us_per_iteration": (hi - lo) / N_ITER,
           "loop_busy_us_per_iteration": loop_busy / N_ITER,
           "loop_idle_share": 1.0 - loop_busy / (hi - lo),
           "call_idle_share": 1.0 - call_busy / call,
           "trajectory_copy_ms": copy / 1e3}
    log("trace", f"sample() traced: {out['traced_us_per_iteration']:.2f} "
        f"us/iteration on the host clock; iteration loop "
        f"{out['loop_us_per_iteration']:.2f} us/iteration on the device "
        f"clock, busy {out['loop_busy_us_per_iteration']:.3f}, idle share "
        f"{out['loop_idle_share']:.4f}; whole call {call / 1e3:.3f} ms, idle "
        f"share {out['call_idle_share']:.4f}; trajectory copy to the host "
        f"{out['trajectory_copy_ms']:.3f} ms; mean traced kernel time "
        f"de_step {mean['de_step']:.3f} us, migrate {mean['migrate']:.3f} "
        f"us; {len(every)} device events (trace in {path.name})")
    return out


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
                        ("k1_burnin", k1_burnin, 200),
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
    rows = []
    for name, src, repl, key, nbytes, nops, err in (
            ("de_step", "demcmc_tpu_torch/csrc/de_step.cu",
             "demcmc_tpu/ops/fused_step.py:1858", "k1", k1_bytes, k1_ops,
             errs["k1"]),
            ("migrate", "demcmc_tpu_torch/csrc/migration.cu",
             "demcmc_tpu/ops/fused_step.py:946", "k2", k2_bytes, k2_ops,
             errs["k2"])):
        tb, to = nbytes / PEAK_BYTES * 1e3, nops / PEAK_OPS * 1e3
        rows.append({"name": name, "route": "cuda", "source": src,
                     "replaces": repl, "launches": launches[name],
                     "max_abs_err": err, "ms": ms[key],
                     "plain_ms": ms[key + "_plain"],
                     "bound_ms": max(tb, to),
                     "bound_by": "bytes" if tb >= to else "operations",
                     "library_ms": None})
        log("timing", f"{name}: {nbytes} bytes, {nops} operations")
    log("timing", f"migrate unfired: {ms['k2_unfired']:.5f} ms per launch")
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
    log("end", f"all phases passed in {time.perf_counter() - t_start:.1f} s;"
        f" {json.dumps(metrics)}")
    print(json.dumps({"kernels": rows}))
    print(gpu_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
