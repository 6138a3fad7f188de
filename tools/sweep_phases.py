"""Where K1's and K3's time goes inside one iteration, on one GPU: clock64
phase stamps in a copy of the sweep bodies.

    python3 tools/sweep_phases.py [CASE ...]

Copies ``demcmc_tpu_torch/csrc`` of the tree it runs in to
``chiprun_out/phases/csrc`` and inserts ``clock64()`` stamps into the copy
of each sweep body at fixed places of its text (``BODIES``): each stamp
adds the cycles since the previous one to its phase, in the thread of
chain 0's lane 0 alone, and the kernel adds its sums to a device array
when it ends.  The shipped sources are not touched, and the copy builds
into ``chiprun_out/phases/build``.  A place that is not found in the text
stops the script.

The cases (``CASES``; all by default, or those named): K1 on the
4,096-chain Gaussian (G = 256 × Np = 16, synchronous), on ``main-seq``'s
16,384 chains (4,096 × 4, the sequential sweep, θs = 0.1) and on the
blocked cell (the Gaussian 4,096 with the blocks (μ), (σ)); K3 on the
C = 512 DE-MCz Gaussian (128 × 4, synchronous, θs = 0.1) and on the 30-dim
MVN flagship (C = 3, sequential).  Each runs 20 windows of 64 iterations
in burn-in (phase 'all') and 20 past it (phase 'post'), K1's from a start
with no migration gate open inside the window, with the instrumented
kernel, and the same windows with the unchanged kernel for its device
time (CUDA events).  Prints cycles and µs per iteration for each phase,
the SM clock, and the per-function registers and stack (``cuobjdump
-res-usage``) of the unchanged K1 and K3 on the Gaussian, then the card's
name and power limit.

The body a case runs is the first of its ``bodies`` that the tree has
(a redesigned kernel's own body first).  In the sequential sweep chain 0
proposes in sub-sweep 0 and waits while the other slots run theirs.  A
stamp is a serialising clock read, but the compiler may still move
arithmetic and barriers across it, so a phase's cycles are where the
thread waited, not strictly what its code issued.
"""

import ctypes
import re
import shutil
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
OUT = ROOT / "chiprun_out"
K, WINDOWS = 64, 20
N_PH = 20

# Per body: (phase, text, 'before'/'after', name) -- a stamp PH(phase) goes
# before or after the first occurrence of the text, and charges the cycles
# since the previous stamp to its phase; then the text before which the
# accumulators start, the iteration's first line (a stamp before it), the
# end of the window loop (a stamp after its barrier) and the text the
# kernel's sums are added before.
SUB = ("        if (kSeq) __syncthreads();  // the commit, before the next "
       "sub-sweep\n")
BODIES = {
    # one thread a chain (sweep_kernel), words drawn where they are used
    "sweep_body.cuh": dict(
        stamps=(
            (0, "      for (int m = 0; m < (kSeq ? a.n_members : 1); ++m) {\n",
             "after", "sub-sweep loop top (the β gate)"),
            (1, "        // The synchronous sweep runs every thread through "
             "the body", "before", "γ₂ softmax scan (burn-in)"),
            (2, "          sk.pair(st, Wc, s, a, s_th, pm, pn);\n", "after",
             "partner index words and the pair's modulo"),
            (3, "          // snooker, per chain with probability theta_sn",
             "before", "γ words, base select, DE proposal (the pair's loads)"),
            (4, "          if (a.r_eps >= 0)\n", "before",
             "snooker triple, its loads, four dots, gsn"),
            (5, "          if (a.r_kappa >= 0)\n", "before", "ε words"),
            (6, "          const bool mut = kSeq ? mut_sweep : beta_gate();",
             "before", "κ, blocks, the snooker correction's dot and logs"),
            (7, "          if (mut) adj = 0.0f;  // a mutation carries no "
             "snooker correction\n", "after", "β mutation normals"),
            (8, "          float lp;\n", "before", "snap and bounds"),
            (9, "          const float bad = ", "before", "density"),
            (10, SUB, "before", "accept word, accept, stage write"),
            (11, SUB, "after",
             "sub-sweep barrier (the other chains' sub-sweeps)"),
            (12, "    const bool emit =", "before", "block refresh"),
            (13, "    t_out += emit;\n", "after",
             "trajectory row, history commit"),
        ),
        top="  float th[D], prop[D];\n",
        head="    const WordSource W = a.words.at(k, (uint32_t)it, "
             "a.n_words);\n",
        close="      __syncthreads();\n    }\n  }\n\n",
        bottom="  if (!valid || !lead_lane) return;"),
    # one thread a chain, the draws before the state (sweep_kernel_hoist)
    "sweep_hoist.cuh": dict(
        stamps=(
            (0, "      acc_any = false;  // the last block's accepts are "
             "recorded\n", "after", "block sweep top"),
            (1, "      // partners: K1's group slots", "before",
             "word table (the Philox blocks together)"),
            (2, "      float ub = 0.0f, g1 = 0.0f, g2 = 0.0f;\n", "before",
             "partner indices; K3: index words, cluster wait, loads "
             "issued"),
            (3, "      // log u of the accept", "before",
             "γ, snooker, ε and κ draws"),
            (4, "      // beta mutation: one gate per group and sweep",
             "before", "log u"),
            (5, "      // ---- the state's part", "before",
             "β gate and Box–Muller normals"),
            (6, "        // the synchronous sweep runs every thread through "
             "the body", "before", "γ₂ softmax scan (burn-in)"),
            (7, "          if (a.random_gamma) {\n            // past "
             "burn-in", "before", "partners' loads (sequential sweep)"),
            (8, "          // snooker: project the triple's", "before",
             "base select, DE proposal"),
            (9, "          if (a.r_eps >= 0)\n", "before",
             "snooker loads, dots, quotients"),
            (10, "          bool inb = true;\n", "before",
             "ε, κ, blocks, snooker correction, mutation"),
            (11, "          float lp;\n", "before", "bounds"),
            (12, "          const float bad = ", "before", "density"),
            (13, SUB, "before", "accept, stage write"),
            (14, SUB, "after",
             "sub-sweep barrier (the other chains' sub-sweeps)"),
            (15, "    // the emission rule: k >= emit_first", "before",
             "block refresh"),
            (16, "    t_out += emit;\n", "after",
             "trajectory row, history commit"),
        ),
        top="  float th[D], prop[D];\n",
        head="    const WordSource W = a.words.at(k, (uint32_t)it, "
             "a.n_words);\n",
        close="      __syncthreads();\n    }\n  }\n\n",
        bottom="  if (!valid) return;",
        rec="valid && c == 0"),
    # lanes over the dimensions (sweep_kernel_dims)
    "sweep_dims.cuh": dict(
        stamps=(
            (0, "    for (int mi = 0; mi < n_sub; ++mi) {\n", "after",
             "sub-sweep loop top (the β gate)"),
            (1, "      if (kSeq ? valid && p == m : true) {\n", "before",
             "γ₂ softmax scan (burn-in)"),
            (2, "        auto shared = [&](int r) {\n", "before",
             "shared words (one a lane) and the indices' modulo"),
            (3, "        // random gamma, with the gamma_2 base select",
             "before", "partners' loads, ε words"),
            (4, "        bool sn = false, degen = false;\n", "before",
             "γ words, base select, DE proposal"),
            (5, "          ln.template fold<D>(v, q);\n", "before",
             "snooker products"),
            (6, "          ln.template fold<D>(v, q);\n", "after",
             "snooker fold (three sums)"),
            (7, "#pragma unroll\n        for (int j = 0; j < S; ++j) {\n"
             "          const int i = ln.dim(j);\n          if (i >= D) "
             "continue;\n          if (a.r_eps", "before",
             "snooker tail (degenerate, quotients, gsn, proposal)"),
            (8, "        // snooker MH correction on the final proposal",
             "before", "ε"),
            (9, "        // Box-Muller normals", "before",
             "snooker correction (fold, logs)"),
            (10, "        if (mut) adj = 0.0f;\n", "after",
             "β mutation normals"),
            (12, "        const float lp = dens(prop, ln);\n", "before",
             "bounds and their vote"),
            (13, "        const float lp = dens(prop, ln);\n", "after",
             "density (two folds, logs)"),
            (14, SUB[2:], "before", "accept, stage write"),
            (15, SUB[2:], "after", "sub-sweep barrier"),
            (17, "    t_out += emit;\n", "after",
             "trajectory row, history commit"),
        ),
        top="  float th[S], prop[S];\n",
        head="    const WordSource W = a.words.at(k, (uint32_t)it, "
             "a.n_words);\n",
        close="      __syncthreads();\n    }\n  }\n\n",
        bottom="  if (!valid) return;"),
}
HEAD_NAME = (18, "iteration head (words, gate) and the last iteration's "
             "barrier")
END_NAME = (19, "iteration barrier, stage refresh")
HEAD = """
// clock64() stamps (tools/sweep_phases.py): per phase, chain 0's cycles
__device__ unsigned long long g_ph[%d];
""" % N_PH
TOP = """
  const bool ph_rec = %s;
  unsigned ph_acc[%d];
#pragma unroll
  for (int i = 0; i < %d; ++i) ph_acc[i] = 0u;
  long long ph_t = clock64();
#define PH(i) do { if (ph_rec) { const long long t_ = clock64(); \\
    ph_acc[i] += (unsigned)(t_ - ph_t); ph_t = t_; } } while (0)
"""
BOTTOM = """
  if (ph_rec) {
#pragma unroll
    for (int i = 0; i < %d; ++i)
      atomicAdd(&g_ph[i], (unsigned long long)ph_acc[i]);
  }
""" % N_PH
TAIL = """
extern "C" int phase_stamps(unsigned long long* host, int reset) {
  cudaError_t e =
      cudaMemcpyFromSymbol(host, demcmc::g_ph, sizeof(demcmc::g_ph));
  if (e == cudaSuccess && reset) {
    unsigned long long z[%d] = {};
    e = cudaMemcpyToSymbol(demcmc::g_ph, z, sizeof(z));
  }
  return (int)e;
}
""" % N_PH

# the cases: (name, kernel library, bodies in order of preference)
ONE_THREAD = ("sweep_hoist.cuh", "sweep_body.cuh")
CASES = {
    "k1-gauss-4096": ("de_step", ONE_THREAD),
    "k1-seq-4096x4": ("de_step", ONE_THREAD),
    "k1-blocked-4096": ("de_step", ONE_THREAD),
    "k3-C512": ("de_step_resample", ONE_THREAD),
    "k3-mvn": ("de_step_resample", ("sweep_dims.cuh", "sweep_body.cuh")),
}


def insert(text, anchor, add, where):
    i = text.find(anchor)
    if i < 0:
        sys.exit(f"sweep_phases: the place {anchor!r} is not in the body")
    j = i if where == "before" else i + len(anchor)
    return text[:j] + add + text[j:]


def stamp_body(text, spec):
    """A body's text with its stamps, accumulators and sums inserted."""
    for ph, anchor, where, _ in spec["stamps"]:
        text = insert(text, anchor, f"PH({ph});\n", where)
    top = TOP % (spec.get("rec", "valid && c == 0 && lead_lane"), N_PH,
                 N_PH)
    text = insert(text, spec["top"], top, "before")
    text = insert(text, spec["head"], f"PH({HEAD_NAME[0]});\n", "before")
    end = spec["close"] + spec["bottom"]
    if end not in text:
        sys.exit("sweep_phases: the window loop's end is not in the body")
    close = spec["close"]
    cut = close.rstrip("\n").rfind("\n  }")
    return text.replace(end, close[:cut] + f"\n    PH({END_NAME[0]});"
                        + close[cut:] + BOTTOM + "\n" + spec["bottom"], 1)


def patched_sources(dst: Path, bodies):
    """The instrumented copy of csrc at ``dst``, stamps in each of
    ``bodies``."""
    src = ROOT / "demcmc_tpu_torch" / "csrc"
    if dst.exists():
        shutil.rmtree(dst)
    shutil.copytree(src, dst)
    for body_file in bodies:
        body = dst / body_file
        body.write_text(stamp_body(body.read_text(), BODIES[body_file]))
    step = (dst / "step_body.cuh").read_text()
    step = insert(step, "constexpr int kThreadsTarget", HEAD, "before")
    (dst / "step_body.cuh").write_text(step)
    for lib in ("de_step.cu", "de_step_resample.cu"):
        (dst / lib).write_text((dst / lib).read_text() + TAIL)


def body_of(case):
    csrc = ROOT / "demcmc_tpu_torch" / "csrc"
    return next(b for b in CASES[case][1] if (csrc / b).exists())


def res_usage(lib, keep):
    """Lines of ``cuobjdump -res-usage`` for the functions whose names
    hold ``keep``, with their template flags decoded."""
    run = subprocess.run(["/usr/local/cuda/bin/cuobjdump", "-res-usage",
                          str(lib)], capture_output=True, text=True)
    lines = run.stdout.splitlines()
    out = []
    for i, line in enumerate(lines):
        if "Function" in line and keep in line:
            m = re.search(r"Lb(\d)ELb(\d)ELb(\d)ELi(\d)ELi(\d)E", line)
            flags = ("seq=%s snooker=%s post=%s blocks=%s mode=%s" % m.groups()
                     if m else "")
            kind = re.search(r"demcmc\d+(sweep_kernel\w*?)I", line)
            res = lines[i + 1].strip() if i + 1 < len(lines) else ""
            out.append(f"{kind.group(1) if kind else '?':20s} {flags:45s} "
                       f"{res}")
    return out, run.stdout


def make_case(cs, case, dev, burnin_window):
    """A function launching one window of K of the case (in burn-in or
    past it) on a state it keeps."""
    import demcmc_tpu_torch as tdm
    import port_cells as pc
    from demcmc_tpu_torch.models import gaussian
    from demcmc_tpu_torch.ops import fused_step, resample_step
    phase = "all" if burnin_window else "post"
    if case.startswith("k3-"):
        model, spec, cfg, s = cs._resample_case(
            dev, "mvn" if case == "k3-mvn" else "C512",
            burnin=2000, theta_sn=0.1, key=4, extra_rows=3000)
        st = (s.theta, s.weight, s.fire, s.history)
        it0 = 300 if burnin_window else 2500
        C = cfg.G * cfg.Np
        out = (torch.empty((K, C, cfg.d), device=dev),
               torch.empty((K, C), device=dev),
               torch.empty((K, C), dtype=torch.bool, device=dev))
        return lambda: resample_step.resample_step(
            cfg, model, spec, *st, it0, out=out, K=K, phase=phase)
    data = cs._gauss_data()
    if case == "k1-gauss-4096":
        model, de = gaussian.make(data=data, Np=16, n_groups=256,
                                  burnin=1000)
    elif case == "k1-seq-4096x4":
        model, de = gaussian.make(data=data, Np=4, n_groups=4096,
                                  burnin=1000, alpha=0.1, theta_snooker=0.1)
    else:
        cell = pc.BLOCKED_CELL
        model, de = gaussian.make(data=data, Np=cell["Np"],
                                  n_groups=cell["n_groups"],
                                  burnin=cell["burnin"],
                                  blocks=cell["blocks"], blocking_on=True)
    spec = tdm.make_spec(model, de)
    cfg = fused_step.StepConfig.make(model, de, spec)
    s = tdm.init_state(model, de, spec, 5, device=dev)
    lo, hi = (100, de.burnin - K) if burnin_window else (2000, 2000 + 4096)
    seed, it0 = cs.quiet_start(0, cfg, lo, hi, K)
    C = de.n_chains
    st = (s.theta, s.weight, s.fire)
    out = (torch.empty((K, C, cfg.d), device=dev),
           torch.empty((K, C), device=dev),
           torch.empty((K, C), dtype=torch.bool, device=dev))
    return lambda: fused_step.de_step(cfg, model, spec, *st, it0, seed=seed,
                                      out=out, K=K, phase=phase)


def windows(cs, case, dev, phase_stamps=None):
    """Device ms per window of K, and the phase sums per iteration, in
    burn-in and past it."""
    res = {}
    for tag, burn in (("burn-in", True), ("post", False)):
        run = make_case(cs, case, dev, burn)
        run()
        torch.cuda.synchronize()
        sums = None
        if phase_stamps:
            buf = (ctypes.c_ulonglong * N_PH)()
            phase_stamps(buf, 1)
            for _ in range(WINDOWS):
                run()
            torch.cuda.synchronize()
            phase_stamps(buf, 1)
            sums = [v / (WINDOWS * K) for v in buf]
        res[tag] = (cs.device_ms(run, WINDOWS)[0], sums)
    return res


def main():
    if not torch.cuda.is_available():
        sys.exit("sweep_phases: needs a CUDA GPU")
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from demcmc_tpu_torch.ops import _build, fused_step

    cases = sys.argv[1:] or list(CASES)
    unknown = set(cases) - set(CASES)
    if unknown:
        sys.exit(f"sweep_phases: no case {sorted(unknown)}; the cases: "
                 f"{list(CASES)}")
    dev = torch.device("cuda")
    OUT.mkdir(exist_ok=True)
    libs = _build.build_all(("de_step", "de_step_resample"))
    plain = {case: windows(cs, case, dev) for case in cases}
    for name in ("de_step", "de_step_resample"):
        lines, full = res_usage(libs[name], "Gaussian")
        (OUT / f"phases_{name}.res").write_text(full)
        print(f"res-usage {name} (Gaussian): {len(lines)} functions")
        for line in lines:
            print("  " + line)

    # the instrumented copy
    work = OUT / "phases"
    bodies = sorted({body_of(case) for case in cases})
    patched_sources(work / "csrc", bodies)
    _build.CSRC, _build.BUILD = work / "csrc", work / "build"
    _build._loaded.clear()
    fused_step._block_chains.clear()
    _build.build_all(("de_step", "de_step_resample"))
    cyc_per_us = cs.cycles_per_ms() / 1e3
    print(f"stamps in {', '.join(bodies)}; SM clock (torch.cuda._sleep "
          f"cycles): {cyc_per_us:.1f} per µs")
    for case in cases:
        lib = _build.library(CASES[case][0])
        lib.phase_stamps.argtypes = [ctypes.c_void_p, ctypes.c_int]
        lib.phase_stamps.restype = ctypes.c_int
        stamped = windows(cs, case, dev, lambda b, r, lib=lib: _build.check(
            lib, lib.phase_stamps(ctypes.cast(b, ctypes.c_void_p), r),
            "phase_stamps"))
        body = body_of(case)
        names = dict([HEAD_NAME, END_NAME] + [
            (ph, name) for ph, _, _, name in BODIES[body]["stamps"]])
        for tag in ("burn-in", "post"):
            ms, _ = plain[case][tag]
            ms_i, sums = stamped[tag]
            total = sum(sums)
            print(f"[{case} {tag}] window of {K}: {ms:.6f} ms "
                  f"({ms * 1e3 / K:.3f} µs per iteration); instrumented "
                  f"{ms_i:.6f} ms ({ms_i * 1e3 / K:.3f}); chain 0's stamps "
                  f"in {body}: {total:.0f} cycles per iteration "
                  f"({total / cyc_per_us:.3f} µs)")
            for ph in [HEAD_NAME[0]] + sorted(
                    p for p in names if p not in (HEAD_NAME[0],
                                                  END_NAME[0])) + [
                    END_NAME[0]]:
                v = sums[ph]
                print(f"  {ph:2d} {names[ph]:62s} {v:9.0f} cycles "
                      f"{v / cyc_per_us:7.3f} µs "
                      f"{100 * v / max(total, 1):5.1f}%")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())


if __name__ == "__main__":
    main()
