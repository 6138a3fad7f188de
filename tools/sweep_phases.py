"""Where K3's time goes inside one iteration at the 30-dim MVN DE-MCz
flagship (C = 3, d = 31, sequential sweep, θs = 0.1), on one GPU.

    python3 tools/sweep_phases.py

Copies ``demcmc_tpu_torch/csrc`` of the tree it runs in to
``chiprun_out/phases/csrc`` and inserts ``clock64()`` stamps into the copy
of the body the flagship runs -- ``sweep_dims.cuh`` (lanes over the
dimensions) where the tree has it, else ``sweep_body.cuh`` (one thread a
chain) -- at fixed places of its text (``BODIES``): each stamp adds the
cycles since the previous one to its phase, in the thread of chain 0's
lane 0 alone, and the kernel adds its sums to a device array when it
ends.  The shipped sources are not touched, and the copy builds into
``chiprun_out/phases/build``.  A place that is not found in the text
stops the script.

In the sequential sweep chain 0 proposes in sub-sweep 0 and waits while
chains 1 and 2 run theirs (burn-in; past it, with lanes over the
dimensions, the three run at once).  A stamp is a serialising clock
read, but the compiler may still move arithmetic and barriers across
it, so a phase's cycles are where the thread waited, not strictly what
its code issued.

Runs 20 windows of 64 iterations in burn-in (phase 'all') and 20 past it
(phase 'post') with the instrumented K3, and the same windows with the
unchanged K3 for its device time (CUDA events); prints cycles and µs per
iteration for each phase, the SM clock, and the per-function registers
and stack (``cuobjdump -res-usage``) of the unchanged K3 on the MVN
density and of K1 on LBA, writes the SASS of the flagship's post-burn-in
instantiations to ``chiprun_out/phases_mvn_post.sass``, then prints the
card's name and power limit.
"""

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
    # one thread a chain (sweep_kernel): the parent's K3 on the MVN
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
            (10, SUB, "before", "accept, stage write"),
            (11, SUB, "after",
             "sub-sweep barrier (the other chains' sub-sweeps)"),
            (12, "    const bool emit =", "before", "block refresh"),
            (13, "    t_out += emit;\n", "after",
             "trajectory row, history commit"),
        ),
        top="  float th[D], prop[D];\n",
        head="    const WordSource W = a.words.at(k, (uint32_t)it, "
             "a.n_words);\n",
        bottom="  if (!valid || !lead_lane) return;"),
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
        bottom="  if (!valid) return;"),
}
# the barrier that closes an iteration of the window loop
LOOP_CLOSE = "      __syncthreads();\n    }\n"
HEAD_NAME = (18, "iteration head (words, gate) and the last iteration's "
             "barrier")
END_NAME = (19, "iteration barrier, stage refresh")
HEAD = """
// clock64() stamps (tools/sweep_phases.py): per phase, chain 0's cycles
__device__ unsigned long long g_ph[%d];
""" % N_PH
TOP = """
  const bool ph_rec = valid && c == 0 && lead_lane;
  unsigned ph_acc[%d];
#pragma unroll
  for (int i = 0; i < %d; ++i) ph_acc[i] = 0u;
  long long ph_t = clock64();
#define PH(i) do { if (ph_rec) { const long long t_ = clock64(); \\
    ph_acc[i] += (unsigned)(t_ - ph_t); ph_t = t_; } } while (0)
""" % (N_PH, N_PH)
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


def insert(text, anchor, add, where):
    i = text.find(anchor)
    if i < 0:
        sys.exit(f"sweep_phases: the place {anchor!r} is not in the body")
    j = i if where == "before" else i + len(anchor)
    return text[:j] + add + text[j:]


def patched_sources(dst: Path, body_file: str):
    """The instrumented copy of csrc at ``dst``, its stamps in
    ``body_file``."""
    src = ROOT / "demcmc_tpu_torch" / "csrc"
    if dst.exists():
        shutil.rmtree(dst)
    shutil.copytree(src, dst)
    spec = BODIES[body_file]
    body = (dst / body_file).read_text()
    for ph, anchor, where, _ in spec["stamps"]:
        body = insert(body, anchor, f"PH({ph});\n", where)
    body = insert(body, spec["top"], TOP, "before")
    body = insert(body, spec["head"], f"PH({HEAD_NAME[0]});\n", "before")
    end = LOOP_CLOSE + "  }\n\n" + spec["bottom"]
    if end not in body:
        sys.exit("sweep_phases: the window loop's end is not in the body")
    body = body.replace(end, LOOP_CLOSE + f"    PH({END_NAME[0]});\n  }}\n"
                        + BOTTOM + "\n" + spec["bottom"], 1)
    (dst / body_file).write_text(body)
    step = (dst / "step_body.cuh").read_text()
    step = insert(step, "constexpr int kThreadsTarget", HEAD, "before")
    (dst / "step_body.cuh").write_text(step)
    k3 = dst / "de_step_resample.cu"
    k3.write_text(k3.read_text() + TAIL)


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
            kind = "lanes" if "lanes" in line else ("dims" if "dims" in line
                                                    else "one")
            res = lines[i + 1].strip() if i + 1 < len(lines) else ""
            out.append(f"{kind:5s} {flags:45s} {res}")
    return out, run.stdout


def windows(cs, resample_step, dev, phase_stamps=None):
    """Device ms per window of K, and the phase sums, in burn-in and past
    it."""
    res = {}
    for tag, it0, phase in (("burn-in", 300, "all"), ("post", 2500, "post")):
        model, spec, cfg, s = cs._resample_case(dev, "mvn", burnin=2000,
                                                theta_sn=0.1, key=4,
                                                extra_rows=3000)
        st = (s.theta, s.weight, s.fire, s.history)
        out = (torch.empty((K, 3, cfg.d), device=dev),
               torch.empty((K, 3), device=dev),
               torch.empty((K, 3), dtype=torch.bool, device=dev))

        def run():
            resample_step.resample_step(cfg, model, spec, *st, it0, out=out,
                                        K=K, phase=phase)
        run()
        torch.cuda.synchronize()
        sums = None
        if phase_stamps:
            import ctypes
            buf = (ctypes.c_ulonglong * N_PH)()
            phase_stamps(buf, 1)
            for _ in range(WINDOWS):
                run()
            torch.cuda.synchronize()
            phase_stamps(buf, 1)
            sums = [v / (WINDOWS * K) for v in buf]
        ms = cs.device_ms(run, WINDOWS)[0]
        res[tag] = (ms, sums)
    return res


def main():
    if not torch.cuda.is_available():
        sys.exit("sweep_phases: needs a CUDA GPU")
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from demcmc_tpu_torch.ops import _build, fused_step, resample_step

    dev = torch.device("cuda")
    OUT.mkdir(exist_ok=True)
    body_file = ("sweep_dims.cuh" if (_build.CSRC / "sweep_dims.cuh").exists()
                 else "sweep_body.cuh")
    libs = _build.build_all(("de_step", "de_step_resample"))
    plain = windows(cs, resample_step, dev)
    for name, keep in (("de_step_resample", "MvNormal"),
                       ("de_step", "Lba")):
        lines, full = res_usage(libs[name], keep)
        (OUT / f"phases_{name}.res").write_text(full)
        print(f"res-usage {name} ({keep}): {len(lines)} functions")
        for line in lines:
            print("  " + line)
    # the SASS of the MVN flagship's instantiation past burn-in
    sass = subprocess.run(["/usr/local/cuda/bin/cuobjdump", "-sass",
                           str(libs["de_step_resample"])],
                          capture_output=True, text=True).stdout
    parts = re.split(r"(?=\n\s*Function : )", sass)
    (OUT / "phases_mvn_post.sass").write_text("".join(
        p for p in parts if "MvNormal" in p.split("\n", 2)[1]
        and "Lb1ELb1ELb1E" in p.split("\n", 2)[1]))

    # the instrumented copy
    work = OUT / "phases"
    patched_sources(work / "csrc", body_file)
    _build.CSRC, _build.BUILD = work / "csrc", work / "build"
    _build._loaded.clear()
    fused_step._block_chains.clear()
    lib = _build.library("de_step_resample")
    import ctypes
    lib.phase_stamps.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.phase_stamps.restype = ctypes.c_int
    stamped = windows(cs, resample_step, dev, lambda b, r: _build.check(
        lib, lib.phase_stamps(ctypes.cast(b, ctypes.c_void_p), r),
        "phase_stamps"))
    names = dict([HEAD_NAME, END_NAME] + [
        (ph, name) for ph, _, _, name in BODIES[body_file]["stamps"]])
    cyc_per_us = cs.cycles_per_ms() / 1e3
    print(f"stamps in {body_file}; SM clock (torch.cuda._sleep cycles): "
          f"{cyc_per_us:.1f} per µs")
    for tag in ("burn-in", "post"):
        ms, _ = plain[tag]
        ms_i, sums = stamped[tag]
        total = sum(sums)
        print(f"[{tag}] K3 window of {K}: {ms:.6f} ms "
              f"({ms * 1e3 / K:.3f} µs per iteration); instrumented "
              f"{ms_i:.6f} ms ({ms_i * 1e3 / K:.3f}); chain 0's stamps "
              f"{total:.0f} cycles per iteration ({total / cyc_per_us:.3f} "
              f"µs)")
        for ph in [HEAD_NAME[0]] + sorted(
                p for p in names if p not in (HEAD_NAME[0], END_NAME[0])) + [
                END_NAME[0]]:
            v = sums[ph]
            print(f"  {ph:2d} {names[ph]:62s} {v:9.0f} cycles "
                  f"{v / cyc_per_us:7.3f} µs {100 * v / total:5.1f}%")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())


if __name__ == "__main__":
    main()
