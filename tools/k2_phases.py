"""Where K2's time goes in one fired exchange, per source tree, on one GPU.

    python3 tools/k2_phases.py LABEL=DIR [LABEL=DIR ...]

Each DIR is the root of a checkout (for example ``git archive`` of the
parent unpacked under ``_verify/parent``, and ``.``).  For each tree this
copies its ``demcmc_tpu_torch/csrc`` to ``chiprun_out/k2phases/<label>/``
and builds the copy of ``migration.cu`` with two changes, the shipped
sources untouched:

* the one-CTA kernel (``migrate_kernel``) gets ``clock64()`` stamps in its
  thread 0 at its start, after the victims' barrier, after the sort's last
  barrier and after a barrier added past the scatter: cycles of the victim
  search, the sort and the scatter, converted to µs with the SM clock of
  ``torch.cuda._sleep`` (``chip_smoke.cycles_per_ms``);
* where the tree has the spread form, its entry can stop after the victims'
  launch or after the ranks' (a host switch): device time of the first
  phase, the first two, and all three, with ``chip_smoke.device_ms``.

Fires K2 on Philox words at (G, Np) = (8, 16), (32, 16), (64, 16), (128,
16), (256, 16), (64, 4), (128, 4), (256, 4), (512, 4), (4,096, 16), (4,096,
4) and (8,192, 16), d = 2; prints µs per phase for each tree, form and
shape, then the card's name and power limit.
"""

import ctypes
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
OUT = ROOT / "chiprun_out" / "k2phases"
SHAPES = ((8, 16), (32, 16), (64, 16), (128, 16), (256, 16), (64, 4),
          (128, 4), (256, 4), (512, 4), (4096, 16), (4096, 4), (8192, 16))
D = 2
STAMPS = 20          # one-CTA launches whose stamps are averaged
TIMED = 200          # launches a device_ms call queues

STAMP_DECL = """
__device__ long long k2_stamps[4];
static int k2_stop = 0;
extern "C" void k2_set_stop(int s) { k2_stop = s; }
extern "C" int k2_read_stamps(long long* out) {
  return (int)cudaMemcpyFromSymbol(out, k2_stamps, sizeof(k2_stamps));
}
"""
# (text, text inserted after it) in migrate_kernel; each must be found
ONE_CTA = (
    ("  const int T = blockDim.x, tid = threadIdx.x;\n",
     "  if (tid == 0) k2_stamps[0] = clock64();\n"),
    ("    vals[g * (D + 1) + D] = w[c] + 0.0f;\n  }\n  __syncthreads();\n",
     "  if (tid == 0) k2_stamps[1] = clock64();\n"),
    ("      __syncthreads();\n    }\n  }\n",
     "  if (tid == 0) k2_stamps[2] = clock64();\n"),
    ("    w[c] = vals[src * (D + 1) + D];\n  }\n",
     "  __syncthreads();\n  if (tid == 0) k2_stamps[3] = clock64();\n"),
)
# (text, text inserted before it) in the spread form's entry
SPREAD = (
    ("    demcmc::migrate_rank_kernel<<<",
     "    if (k2_stop == 1) return 0;\n"),
    ("    const int n = G * (D + 1);\n    demcmc::migrate_scatter_kernel",
     "    if (k2_stop == 2) return 0;\n"),
)


def instrument(label: str, tree: Path):
    """Build the instrumented copy of ``tree``'s K2; returns (library,
    whether it has the spread form)."""
    sys.path.insert(0, str(ROOT))
    from demcmc_tpu_torch.ops import _build
    dst = OUT / label
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(tree / "demcmc_tpu_torch" / "csrc", dst / "csrc")
    src = dst / "csrc" / "migration.cu"
    text = src.read_text()
    spread = "migrate_victims_kernel" in text
    ns = "namespace demcmc {\n"
    text = text.replace(ns, STAMP_DECL + "\n" + ns, 1)
    for place, add in ONE_CTA:
        if place not in text:
            sys.exit(f"{label}: one-CTA stamp place not found: {place!r}")
        text = text.replace(place, place + add, 1)
    if spread:
        for place, add in SPREAD:
            if place not in text:
                sys.exit(f"{label}: spread stop place not found: {place!r}")
            text = text.replace(place, add + place, 1)
    src.write_text(text)
    lib_path = dst / "libk2.so"
    run = subprocess.run([_build.nvcc(), *_build.FLAGS, "-I",
                          str(dst / "csrc"), "-o", str(lib_path), str(src)],
                         capture_output=True, text=True)
    if run.returncode:
        sys.exit(f"{label}: nvcc failed\n{run.stdout}\n{run.stderr}")
    lib = ctypes.CDLL(str(lib_path))
    P, I, U = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32
    args = [P, P, P, P, U, U, I, I, I, I] + ([P, I] if spread else []) + [P]
    lib.migrate_f32.argtypes = args
    lib.migrate_f32.restype = I
    lib.k2_set_stop.argtypes = [I]
    lib.k2_read_stamps.argtypes = [P]
    lib.k2_read_stamps.restype = I
    if spread:
        lib.migrate_scratch_bytes.argtypes = [I, I]
        lib.migrate_scratch_bytes.restype = I
    return lib, spread


def main():
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    trees = [a.split("=", 1) for a in sys.argv[1:]]
    dev = torch.device("cuda")
    per_ms = cs.cycles_per_ms()
    print(f"[k2-phases] SM clock (torch.cuda._sleep cycles): "
          f"{per_ms / 1e3:.1f} MHz")
    for label, d in trees:
        lib, spread = instrument(label, Path(d).resolve())
        for G, Np in SHAPES:
            C = G * Np
            g = np.random.default_rng(G + Np)
            theta = torch.tensor(g.standard_normal((C, D)),
                                 dtype=torch.float32, device=dev)
            w = torch.tensor(g.standard_normal(C), dtype=torch.float32,
                             device=dev)
            fire = torch.ones(1, dtype=torch.int32, device=dev)
            scratch = (torch.empty(lib.migrate_scratch_bytes(G, D) // 8 + 1,
                                   dtype=torch.int64, device=dev)
                       if spread else None)

            def launch(form, it=[0]):
                it[0] += 1
                stream = torch.cuda.current_stream().cuda_stream
                extra = ([scratch.data_ptr(), int(form == "spread")]
                         if spread else [])
                rc = lib.migrate_f32(theta.data_ptr(), w.data_ptr(),
                                     fire.data_ptr(), None, 7, 0, it[0], G,
                                     Np, D, *extra, stream)
                if rc:
                    raise RuntimeError(f"migrate_f32: CUDA error {rc}")

            lib.k2_set_stop(0)
            cyc = np.zeros(3)
            stamps = (ctypes.c_longlong * 4)()
            for _ in range(STAMPS):
                launch("one-CTA")
                torch.cuda.synchronize()
                if lib.k2_read_stamps(ctypes.addressof(stamps)):
                    raise RuntimeError("k2_read_stamps failed")
                cyc += np.diff(np.array(stamps[:], dtype=np.float64))
            us = cyc / STAMPS / per_ms * 1e3
            full = cs.device_ms(lambda: launch("one-CTA"), TIMED)[0]
            print(f"[k2-phases] {label} one-CTA G={G} Np={Np}: victims "
                  f"{us[0]:.3f} us, sort {us[1]:.3f} us, scatter "
                  f"{us[2]:.3f} us (stamped); launch {full * 1e3:.3f} us "
                  f"on the device", flush=True)
            if not spread:
                continue
            t = {}
            for stop in (1, 2, 0):
                lib.k2_set_stop(stop)
                t[stop] = cs.device_ms(lambda: launch("spread"), TIMED)[0]
            lib.k2_set_stop(0)
            print(f"[k2-phases] {label} spread G={G} Np={Np}: victims "
                  f"{t[1] * 1e3:.3f} us, ranks {(t[2] - t[1]) * 1e3:.3f} "
                  f"us, scatter {(t[0] - t[2]) * 1e3:.3f} us; all "
                  f"{t[0] * 1e3:.3f} us on the device", flush=True)
    print(cs.gpu_line())


if __name__ == "__main__":
    main()
