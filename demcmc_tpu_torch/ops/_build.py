"""Build and load the hand-written CUDA kernels.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` into its own shared library
with a plain C interface, loaded with ``ctypes`` (no PyTorch headers, so a
build takes seconds).  Libraries go to ``demcmc_tpu_torch/_build/`` under
a name keyed by a hash of every source and header and the flags, so an
edited source rebuilds and an unchanged one loads at once.  ``build_all``
starts one ``nvcc`` per source, all together.  A failed build raises with
the compiler's output; ``-Xptxas -v`` register and shared-memory reports
are kept in ``_build/<lib>.log``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

PKG = Path(__file__).resolve().parent.parent
CSRC = PKG / "csrc"
BUILD = PKG / "_build"
SOURCES = ("de_step", "de_step_resample", "migration")
# no --use_fast_math: logf/expf/cosf stay full precision; -fmad=false keeps
# each float operation rounded like the plain PyTorch versions
FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_U32P = ctypes.POINTER(ctypes.c_uint32)
_F32P = ctypes.POINTER(ctypes.c_float)
_I, _U, _F = ctypes.c_int, ctypes.c_uint32, ctypes.c_float
# the csrc/densities each step kernel is instantiated on: K1 (de_step) for
# the models that run it, K3 (resample_step) for the DE-MCz ones
KERNEL_DENSITIES = {"de_step": ("gaussian", "lba", "binomial_abc",
                                "discrete_binomial"),
                    "resample_step": ("gaussian", "mvnormal30")}
_K1 = [_P, _P, _P, _P, _P, _P, _P, _U32P, _F32P, _U32P, _F, _P, _P]
_K3 = [_P, _P, _P, _P, _P, _P, _P, _I, _P, _P, _U32P, _F32P, _U32P, _F, _P]
SIGNATURES = {
    "de_step": {
        **{f"de_step_{d}": _K1 for d in KERNEL_DENSITIES["de_step"]},
        "philox_fill": [_P, _I, _I, _U, _U, _U, _U, _P],
    },
    "de_step_resample": {f"resample_step_{d}": _K3
                         for d in KERNEL_DENSITIES["resample_step"]},
    "migration": {
        "migrate_f32": [_P, _P, _P, _P, _U, _U, _I, _I, _I, _I, _P],
    },
}

_loaded: dict = {}


def nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                       "machine with the CUDA toolkit")


def _digest() -> str:
    h = hashlib.sha256(" ".join(FLAGS).encode())
    for f in sorted(CSRC.rglob("*")):
        if f.suffix in (".cu", ".cuh"):
            h.update(str(f.relative_to(CSRC)).encode())
            h.update(f.read_bytes())
    return h.hexdigest()[:16]


def _lib_path(name: str) -> Path:
    return BUILD / f"lib{name}-{_digest()}.so"


def build_all(names=SOURCES) -> dict:
    """Compile every missing library in parallel; returns {name: path}."""
    BUILD.mkdir(parents=True, exist_ok=True)
    paths = {n: _lib_path(n) for n in names}
    jobs = {}
    for n, path in paths.items():
        if path.exists():
            continue
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc(), *FLAGS, "-I", str(CSRC), "-o", str(tmp),
               str(CSRC / f"{n}.cu")]
        jobs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True),
                   tmp, path)
    errors = []
    for n, (proc, tmp, path) in jobs.items():
        out, _ = proc.communicate()
        (BUILD / f"lib{n}.log").write_text(out)
        if proc.returncode != 0:
            errors.append(f"nvcc failed for {n}.cu:\n{out}")
            continue
        os.replace(tmp, path)
    if errors:
        raise RuntimeError("\n".join(errors))
    return paths


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu`` (built at first use), with
    argument and return types declared for each entry point."""
    lib = _loaded.get(name)
    if lib is None:
        path = build_all((name,))[name]
        lib = ctypes.CDLL(str(path))
        for fn, argtypes in SIGNATURES[name].items():
            f = getattr(lib, fn)
            f.argtypes = argtypes
            f.restype = ctypes.c_int
        lib.error_string.argtypes = [ctypes.c_int]
        lib.error_string.restype = ctypes.c_char_p
        _loaded[name] = lib
    return lib


def entry(kernel: str, density) -> str:
    """The C entry point of ``kernel`` (``de_step`` or ``resample_step``)
    on a model's ``CudaDensity``; raises where none is built."""
    if density is None:
        raise ValueError("the model names no CUDA density "
                         "(DEModel.cuda_density); run it with device='cpu'")
    if density.name not in KERNEL_DENSITIES[kernel]:
        raise ValueError(f"{kernel} is built for the densities "
                         f"{KERNEL_DENSITIES[kernel]}, not {density.name!r}; "
                         f"run this configuration with device='cpu'")
    return f"{kernel}_{density.name}"


def check(lib: ctypes.CDLL, rc: int, what: str):
    """Raise if a C entry point returned a CUDA error code."""
    if rc != 0:
        msg = lib.error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")


def u32_array(values) -> ctypes.Array:
    vals = [int(v) & 0xFFFFFFFF for v in values]
    return (ctypes.c_uint32 * len(vals))(*vals)


def f32_array(values) -> ctypes.Array:
    vals = [float(v) for v in values]
    return (ctypes.c_float * len(vals))(*vals)
