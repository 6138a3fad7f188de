"""Checkpoint and resume for the sampler's state (the port's
``demcmc_tpu.utils.checkpoint``).

A run's whole state is one :class:`demcmc_tpu_torch.sampler.SamplerState`
(θ, w, the Philox key, the next iteration, the migration gate, the DE-MCz
history), so a snapshot is a plain ``.npz`` of its named fields.
``sample(..., checkpoint_every=K, checkpoint_path=...)`` saves
periodically; :func:`load_state` and ``sample(..., state=...)`` resume,
bit for bit the uninterrupted run.

Writes are **atomic** (a temporary file, then ``os.replace``), so a crash
mid-write leaves the previous snapshot whole, and optionally
**asynchronous** (``async_=True``).  The steps update the state's tensors
in place, so the snapshot is taken on the caller's thread before it
returns: a CUDA tensor is copied, without blocking the host, into pinned
host memory on its device's current stream, so the copy is ordered
before the next launch; a CPU tensor is cloned.  Only the wait for that
copy, the serialisation and the disk I/O go to the single writer thread.
"""

from __future__ import annotations

import concurrent.futures
import os
import tempfile
import time

import numpy as np
import torch

from ..ops import _build

FORMAT = "demcmc_tpu_torch/1"   # written beside the fields; a file without
                                # it was not written by this package
_writer = None            # the single writer thread, made at first use


def _norm_path(path) -> str:
    # np.savez appends '.npz' to a path without it: normalise both sides
    path = str(path)
    return path if path.endswith(".npz") else path + ".npz"


def _write_atomic(path: str, arrays: dict) -> None:
    d = os.path.dirname(path) or "."
    fd, tmp = tempfile.mkstemp(suffix=".npz.tmp", dir=d)
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, **arrays)
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def _snapshot(state):
    """The state's fields on the host, or on their way there: ``(fields,
    events)``, the CUDA copies' completion events."""
    fields, events = {}, []
    for name, val in state._asdict().items():
        if val is None:
            continue
        if not isinstance(val, torch.Tensor):
            fields[name] = np.asarray(val)
        elif val.device.type == "cpu":
            fields[name] = val.detach().clone()
        else:
            host = torch.empty(val.shape, dtype=val.dtype, pin_memory=True)
            host.copy_(val, non_blocking=True)
            ev = torch.cuda.Event()
            ev.record(_build.stream(val.device))
            fields[name], events = host, events + [ev]
    return fields, events


def _write(path: str, fields: dict, events) -> dict:
    """Wait for the snapshot's copies, then write it; returns the write's
    host times (``perf_counter`` seconds at its start and end)."""
    t0 = time.perf_counter()
    for ev in events:
        ev.synchronize()
    arrays = {k: v.numpy() if isinstance(v, torch.Tensor) else v
              for k, v in fields.items()}
    arrays["format"] = np.asarray(FORMAT)
    _write_atomic(path, arrays)
    return {"start": t0, "end": time.perf_counter()}


def save_state(path, state, async_: bool = False):
    """Snapshot ``state`` to ``path`` (atomically).  With ``async_=True``
    the write runs on a background thread and a
    ``concurrent.futures.Future`` is returned: ``.result()`` joins it
    (exceptions surface there) and gives the write's host times."""
    fields, events = _snapshot(state)
    if not async_:
        _write(_norm_path(path), fields, events)
        return None
    global _writer
    if _writer is None:
        _writer = concurrent.futures.ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="demcmc-torch-ckpt")
    return _writer.submit(_write, _norm_path(path), fields, events)


def _refuse(path, why: str):
    raise ValueError(
        f"{path}: not a demcmc_tpu_torch checkpoint ({why}). A state "
        f"written by the JAX package (demcmc_tpu) does not load here: its "
        f"key does not carry over. Pass its arrays to "
        f"demcmc_tpu_torch.state_from_numpy instead")


def load_state(path):
    """The :class:`~demcmc_tpu_torch.sampler.SamplerState` saved at
    ``path``, its tensors on the CPU (``sample(state=...)`` moves them to
    the run's device).  A file the JAX package wrote is refused, naming
    :func:`~demcmc_tpu_torch.sampler.state_from_numpy`."""
    from ..sampler import SamplerState
    path = _norm_path(path)
    with np.load(path) as z:
        files = dict((k, z[k]) for k in z.files)
    if "n_leaves" in files:
        _refuse(path, "the JAX package's positional format")
    if "format" not in files or str(files["format"]) != FORMAT:
        _refuse(path, "no format field")
    if files["key"].shape != () or files["theta"].ndim != 2:
        _refuse(path, f"key {files['key'].shape}, theta "
                      f"{files['theta'].shape}")

    def tensor(k):
        return None if k not in files else torch.from_numpy(files[k])
    return SamplerState(theta=tensor("theta"), weight=tensor("weight"),
                        key=int(files["key"]),
                        iteration=int(files["iteration"]),
                        fire=tensor("fire"), history=tensor("history"))
