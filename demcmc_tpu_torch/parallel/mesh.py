"""Chain meshes: the devices a run's groups are split over (the port's
twin of ``demcmc_tpu.parallel.mesh``).

Groups never interact inside an iteration, so a run can hold a contiguous
run of whole groups on each device of a 1-axis ``chains`` mesh and step
each shard alone; migration, the only operation across groups, runs on
the whole population (``sampler.ShardedStep``); a replicated run splits
its replications over the devices instead (:func:`shard_replications`).
A device may appear more than once, and its shards then share it:
``chain_mesh(devices=["cuda:0"] * 4)`` runs four shards on one card and
``chain_mesh(devices=["cpu"] * 8)`` eight on the CPU (the twin of the JAX
test harness's virtual CPU devices).  The likelihood's data axis
(``data_mesh``, ``shard_data``) is not carried yet.
"""

from __future__ import annotations

import numpy as np
import torch

AXIS = "chains"


class Mesh:
    """A 1-axis mesh: ``devices``, a numpy array of ``torch.device`` in
    shard order, ``axis_names`` ``("chains",)`` and ``shape`` ``{"chains":
    n}``, as ``jax.sharding.Mesh`` names them."""

    axis_names = (AXIS,)

    def __init__(self, devices):
        self.devices = np.empty(len(devices), dtype=object)
        self.devices[:] = [torch.device(d) for d in devices]

    @property
    def shape(self) -> dict:
        return {AXIS: int(self.devices.size)}

    def __repr__(self):
        return f"Mesh({[str(d) for d in self.devices]})"


def chain_mesh(n_devices: int = None, devices=None) -> Mesh:
    """A 1-axis ``chains`` mesh over ``devices`` (``torch.device`` or
    names; repeats allowed) or, by default, every visible CUDA device;
    ``n_devices`` keeps the first that many.  Raises with no CUDA device
    and no ``devices``: there is no silent CPU mesh."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: chain_mesh() spans the visible GPUs; pass "
                "devices= (e.g. ['cpu'] * 8) for a mesh of other devices")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    if n_devices is not None:
        if not 1 <= n_devices <= len(devices):
            raise ValueError(f"n_devices={n_devices}: the mesh has "
                             f"{len(devices)} devices")
        devices = devices[:n_devices]
    if not devices:
        raise ValueError("a mesh needs at least one device")
    kinds = {d.type for d in devices}
    if len(kinds) > 1 or not kinds <= {"cpu", "cuda"}:
        raise ValueError(f"a mesh holds cpu or cuda devices of one kind, "
                         f"not {sorted(kinds)}")
    if "cuda" in kinds:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device for a cuda mesh")
        devices = [d if d.index is not None else
                   torch.device("cuda", torch.cuda.current_device())
                   for d in devices]
    return Mesh(devices)


def mesh_devices(mesh) -> list:
    """The devices of a chain mesh, in shard order; raises for anything
    else."""
    if not isinstance(mesh, Mesh):
        raise TypeError(f"mesh must be a chain mesh "
                        f"(demcmc_tpu_torch.parallel.chain_mesh), not "
                        f"{type(mesh).__name__}")
    return list(mesh.devices)


def shard_replications(n_reps: int, devices) -> list:
    """The replications of a replicated run over a mesh's devices (the
    JAX ``_shard_replications``, ``demcmc_tpu/sampler.py:1668-1685``):
    ``[(device, r0, n), ...]``, each device ``n = R / n_dev`` whole
    replications from ``r0`` in mesh order, which it runs as one batch.
    Raises ``ValueError`` unless R divides over the devices."""
    devices = list(devices)
    if not devices or n_reps % len(devices):
        raise ValueError(f"{n_reps} replications must divide over "
                         f"{len(devices)} devices")
    n = n_reps // len(devices)
    return [(d, i * n, n) for i, d in enumerate(devices)]


def _data_axis():
    raise NotImplementedError(
        "a mesh with a data axis (data_mesh, shard_data: the likelihood's "
        "observations split over devices, summed across them) is not "
        "ported to demcmc_tpu_torch yet (ROADMAP.md A10 rest); use "
        "demcmc_tpu for it")


def data_mesh(n_chain_devices: int, n_data_devices: int, devices=None):
    """The JAX package's ``chains × data`` mesh: not carried yet;
    raises, naming ROADMAP.md A10 rest."""
    _data_axis()


def shard_data(data, mesh, axis: int = 0, mesh_axis: str = "data"):
    """The JAX package's data sharding over a mesh's ``data`` axis: not
    carried yet; raises, naming ROADMAP.md A10 rest."""
    _data_axis()
