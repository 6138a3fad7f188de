"""Device meshes: the devices a run's groups, and its likelihood's data,
are split over (the port's twin of ``demcmc_tpu.parallel.mesh``).

Groups never interact inside an iteration, so a run can hold a contiguous
run of whole groups on each device of a ``chains`` axis and step each
shard alone; migration, the only operation across groups, runs on the
whole population (``sampler.ShardedStep``); a replicated run splits its
replications over the devices instead (:func:`shard_replications`).  A
second ``data`` axis (:func:`data_mesh`) splits the likelihood's
observations: :func:`shard_data` cuts a dataset into one piece per data
column, each chain shard evaluates its log-likelihood piece by piece on
its row's data devices, and the partial log-likelihoods are summed, in
piece order, on the chain shard's device (the JAX package's psum over the
``data`` axis).  A device may appear more than once, and its shards then
share it: ``chain_mesh(devices=["cuda:0"] * 4)`` runs four shards on one
card and ``data_mesh(4, 2, devices=["cpu"] * 8)`` a 4 × 2 mesh on the CPU
(the twin of the JAX test harness's virtual CPU devices).  A mesh over
several processes (``distributed.global_chain_mesh``) records the rank
that owns each shard.
"""

from __future__ import annotations

import numpy as np
import torch

AXIS = "chains"
DATA_AXIS = "data"


class Mesh:
    """A mesh: ``devices``, a numpy array of ``torch.device`` (``[n]`` for
    a 1-axis ``chains`` mesh, ``[n_chains, n_data]`` for a ``chains ×
    data`` mesh), ``axis_names`` and ``shape`` (a dict of each axis's
    size), as ``jax.sharding.Mesh`` names them; ``owners``, the rank of
    the process that owns each chain shard, or None for a mesh of one
    process."""

    def __init__(self, devices, axis_names=(AXIS,), owners=None):
        grid = np.empty(np.shape(devices)[:len(axis_names)], dtype=object)
        for ix in np.ndindex(grid.shape):
            grid[ix] = torch.device(devices[ix[0]] if len(ix) == 1
                                    else devices[ix[0]][ix[1]])
        self.devices = grid
        self.axis_names = tuple(axis_names)
        self.owners = None if owners is None else [int(r) for r in owners]

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, (int(n) for n in
                                          self.devices.shape)))

    def __repr__(self):
        return (f"Mesh({[str(d) for d in self.devices.reshape(-1)]}, "
                f"{self.shape})")


def _devices(devices, what: str) -> list:
    """``devices`` as ``torch.device``s, or by default every visible CUDA
    device; raises with no CUDA device and no ``devices``, and for a mix
    of kinds."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"no CUDA device: {what}() spans the visible GPUs; pass "
                f"devices= (e.g. ['cpu'] * 8) for a mesh of other devices")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in np.asarray(
        devices, dtype=object).reshape(-1)]
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
    return devices


def chain_mesh(n_devices: int = None, devices=None) -> Mesh:
    """A 1-axis ``chains`` mesh over ``devices`` (``torch.device`` or
    names; repeats allowed) or, by default, every visible CUDA device;
    ``n_devices`` keeps the first that many.  Raises with no CUDA device
    and no ``devices``: there is no silent CPU mesh."""
    devices = _devices(devices, "chain_mesh")
    if n_devices is not None:
        if not 1 <= n_devices <= len(devices):
            raise ValueError(f"n_devices={n_devices}: the mesh has "
                             f"{len(devices)} devices")
        devices = devices[:n_devices]
    return Mesh(devices)


def data_mesh(n_chain_devices: int, n_data_devices: int,
              devices=None) -> Mesh:
    """A 2-axis ``chains × data`` mesh (``demcmc_tpu/parallel/mesh.py:
    31-39``): groups shard over ``chains``, the likelihood's dataset over
    ``data`` (:func:`shard_data`).  ``devices`` (repeats allowed) or, by
    default, every visible CUDA device, the first ``n_chain_devices ·
    n_data_devices`` of them in row-major order: chain shard i on row i,
    its data pieces on the row's columns, the state on column 0.  Raises
    ``ValueError`` when there are too few devices, and with no CUDA device
    and no ``devices``."""
    devices = _devices(devices, "data_mesh")
    n_c, n_d = int(n_chain_devices), int(n_data_devices)
    if n_c < 1 or n_d < 1 or n_c * n_d > len(devices):
        raise ValueError(f"a {n_c} × {n_d} mesh needs {n_c * n_d} devices; "
                         f"{len(devices)} given")
    grid = [devices[i * n_d:(i + 1) * n_d] for i in range(n_c)]
    return Mesh(grid, (AXIS, DATA_AXIS))


def has_data_axis(mesh) -> bool:
    return DATA_AXIS in getattr(mesh, "axis_names", ())


def mesh_devices(mesh) -> list:
    """The chain shards' devices of a mesh, in shard order: its devices,
    or for a ``chains × data`` mesh each chain row's first (where that
    shard's state lives); raises for anything else."""
    if not isinstance(mesh, Mesh):
        raise TypeError(f"mesh must be a chain mesh or a data mesh "
                        f"(demcmc_tpu_torch.parallel.chain_mesh, "
                        f"data_mesh), not {type(mesh).__name__}")
    if mesh.devices.ndim == 2:
        return list(mesh.devices[:, 0])
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


class ShardedData:
    """A dataset cut into D equal, contiguous pieces along one axis over a
    mesh's ``data`` axis (:func:`shard_data`): ``devices [n_rows, D]``,
    piece j of chain row i a tensor on ``devices[i, j]``.  A model whose
    data this is evaluates its log-likelihood piece by piece (``DEModel.
    log_like_cols``): θ copied to each piece's device, ``loglike(piece_j,
    θ)`` there, the partial copied back and the partials summed in piece
    order, on its first chain row's devices (a chain shard of the run gets
    its own row, :meth:`row`).  A model takes the form of a piece its
    loglike needs once, when it is made (:meth:`map`).  It has no
    ``__array__``: nothing gathers it silently; :attr:`pieces` hands out
    the pieces themselves."""

    def __init__(self, rows, devices):
        self._rows = [list(r) for r in rows]
        self.devices = devices

    @property
    def n_rows(self) -> int:
        return int(self.devices.shape[0])

    @property
    def n_pieces(self) -> int:
        return int(self.devices.shape[1])

    @property
    def pieces(self) -> list:
        """The D pieces of the first chain row, in order."""
        return list(self._rows[0])

    def parts(self):
        """``(piece, device)`` of the first chain row, in piece order."""
        return list(zip(self._rows[0], self.devices[0]))

    def row(self, i: int) -> "ShardedData":
        """Chain row ``i`` alone: what chain shard i evaluates."""
        return ShardedData([self._rows[i]], self.devices[i:i + 1])

    def map(self, fn) -> "ShardedData":
        """Every piece of every row through ``fn`` (a model's form of its
        data, such as the Gaussian's sufficient statistics), on the same
        devices."""
        return ShardedData([[fn(p) for p in r] for r in self._rows],
                           self.devices)

    def __repr__(self):
        return (f"ShardedData({self.n_pieces} pieces, {self.n_rows} chain "
                f"rows)")


def _leaves(data):
    if isinstance(data, (tuple, list)):
        return list(data)
    return [data]


def _cut(x, axis: int, j: int, m: int, device):
    """Piece ``j`` (``m`` long along ``axis``) of one leaf, a numpy array
    or a torch tensor: a tensor of its dtype on ``device``, its own
    copy."""
    sl = [slice(None)] * np.ndim(x)
    sl[axis] = slice(j * m, (j + 1) * m)
    if isinstance(x, torch.Tensor):
        return x[tuple(sl)].to(device, copy=True).contiguous()
    return torch.tensor(np.asarray(x)[tuple(sl)], device=device)


def host(piece):
    """A piece (a tensor, or a tuple or list of them) copied to the host as
    numpy: for a model's per-piece statistics, which are taken once, on
    the host, as they are of unsharded data."""
    if isinstance(piece, (tuple, list)):
        return type(piece)(host(p) for p in piece)
    return piece.detach().cpu().numpy()


def shard_data(data, mesh, axis: int = 0, mesh_axis: str = DATA_AXIS):
    """A dataset split along ``axis`` over ``mesh_axis`` of a
    :func:`data_mesh` (``demcmc_tpu/parallel/mesh.py:42-60``): a
    :class:`ShardedData` of D equal, contiguous pieces, piece j a tensor
    on data column j's device of each chain row.  ``data`` is an array or
    tensor, or a tuple or list of them cut alike (LBA's ``(choice,
    rt)``).

    The likelihood must be a sum of terms over the sharded axis: the port
    evaluates ``loglike(piece_j, θ)`` for each piece and sums the partials
    in piece order, which is the full data's log-likelihood only for such
    a likelihood (the Gaussian's sufficient statistics are taken per
    piece; LBA sums its trials).  Raises ``ValueError`` (the JAX
    messages) where the mesh has no such axis or the size along ``axis``
    does not divide over it, and ``NotImplementedError`` under a process
    group (ROADMAP.md A10 rest 6)."""
    from . import distributed
    if distributed.is_active():
        raise NotImplementedError(
            "a data axis under a process group (shard_data across ranks) "
            "is not ported to demcmc_tpu_torch yet (ROADMAP.md A10 rest "
            "6); run the data mesh in one process")
    if mesh_axis not in mesh.axis_names:
        raise ValueError(f"mesh has no axis {mesh_axis!r}")
    if mesh_axis != DATA_AXIS:
        raise ValueError(f"shard_data splits over the mesh's {DATA_AXIS!r} "
                         f"axis, not {mesh_axis!r}")
    n_shards = mesh.shape[mesh_axis]
    leaves = _leaves(data)
    size = np.shape(leaves[0])[axis]
    if size % n_shards:
        raise ValueError(
            f"data size {size} along axis {axis} is not divisible by the "
            f"{n_shards}-way {mesh_axis!r} mesh axis")
    if any(np.shape(x)[axis] != size for x in leaves):
        raise ValueError(f"every part of the data needs size {size} along "
                         f"axis {axis}")
    m = size // n_shards
    grid = mesh.devices
    rows = []
    for i in range(grid.shape[0]):
        row = []
        for j in range(n_shards):
            parts = [_cut(x, axis, j, m, grid[i, j]) for x in leaves]
            row.append(tuple(parts) if isinstance(data, tuple)
                       else parts if isinstance(data, list) else parts[0])
        rows.append(row)
    return ShardedData(rows, grid)
