"""Several processes, one card each (the port's twin of
``demcmc_tpu.parallel.distributed``), over ``torch.distributed``.

The JAX package runs one program on every host of a TPU pod under
``jax.distributed.initialize`` and lets GSPMD insert the collectives.
Here each process (rank) owns the chain shards on its own device of a
:func:`global_chain_mesh`, steps only those, and the operations across
shards are collectives (``sampler.ShardedStep``): the gather of θ and w
before each migration is an ``all_gather`` (a concatenation, no
reduction, so the bits are fixed); every rank then runs the exchange on
the same gathered population and keeps its own rows; DE-MCz's new
history rows are all-gathered every iteration; at the end ``sample``
all-gathers the kept rows and ``optimize`` the population, so every rank
returns the same result, bit for bit the single-process unsharded run.

Typical launch, one process per card (``torchrun --nproc-per-node=N
script.py``)::

    from demcmc_tpu_torch.parallel import distributed as dist

    dist.initialize()                     # no-op outside torchrun
    mesh = dist.global_chain_mesh()       # one shard per rank, rank order
    chains = sample(model, de, n_iter, mesh=mesh, key=0)
    if dist.is_coordinator():
        print(chains.summary())

The backend follows the layout and is recorded (:func:`layout`): NCCL
where every rank has a card of its own (``cuda:LOCAL_RANK``), gloo for
CPU ranks (``device="cpu"``), and gloo for ranks that share a card (NCCL
refuses two ranks on one GPU), whose θ, w and history rows then go
through pinned host memory.
"""

from __future__ import annotations

import os
from typing import NamedTuple, Optional

import torch
import torch.distributed as dist

from .mesh import Mesh, chain_mesh

ENV = ("RANK", "WORLD_SIZE", "MASTER_ADDR")     # torchrun's environment


class Layout(NamedTuple):
    """A process's place in the group: the ``backend``, the ``device`` its
    shards run on, and ``staged``: gloo between ranks on cards, so
    collectives copy through pinned host memory."""
    backend: str
    device: torch.device
    staged: bool


_layout: Optional[Layout] = None


def _choose(device, backend, rank: int, local_rank: int,
            local_world: int) -> Layout:
    n_cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if device is None:
        if n_cards == 0:
            raise RuntimeError(
                f"rank {rank} has no CUDA device: demcmc_tpu_torch runs a "
                f"rank on a card unless initialize() is given device='cpu' "
                f"(gloo)")
        device = torch.device("cuda", local_rank % n_cards)
    device = torch.device(device)
    if device.type == "cuda":
        if n_cards == 0:
            raise RuntimeError(f"rank {rank} has no CUDA device for "
                               f"{device}")
        if device.index is None:
            device = torch.device("cuda", local_rank % n_cards)
    elif device.type != "cpu":
        raise ValueError(f"a rank runs on cpu or cuda, not {device}")
    if backend is None:
        shared = device.type == "cuda" and local_world > n_cards
        backend = "nccl" if device.type == "cuda" and not shared else "gloo"
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"backend must be 'nccl' or 'gloo', not "
                         f"{backend!r}")
    if backend == "nccl" and device.type != "cuda":
        raise ValueError("NCCL runs between cards: a CPU rank takes gloo")
    return Layout(backend, device, backend == "gloo"
                  and device.type == "cuda")


def initialize(init_method: str = None, world_size: int = None,
               rank: int = None, backend: str = None, device=None):
    """Join this process to the group (``torch.distributed.
    init_process_group``) and record its :class:`Layout`; returns it.

    With no ``init_method``, ``world_size`` or ``rank`` it reads
    torchrun's environment (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``,
    ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``), and without that environment
    it is a no-op returning None (one process).  ``device`` is the rank's
    device, by default ``cuda:LOCAL_RANK`` (modulo the cards: ranks beyond
    them share); a rank with no CUDA device raises unless given
    ``device="cpu"``.  ``backend``, by default from the layout: NCCL where
    each rank has a card of its own, gloo for CPU ranks and for ranks
    that share a card.  A failure is re-raised with a pointer, never
    swallowed: a run that silently fell back to one process is the worst
    outcome."""
    global _layout
    env = all(k in os.environ for k in ENV)
    if init_method is None and world_size is None and rank is None \
            and not env:
        return None
    if dist.is_initialized():
        return layout()
    rank = int(os.environ["RANK"] if rank is None else rank)
    world_size = int(os.environ["WORLD_SIZE"] if world_size is None
                     else world_size)
    local_rank = int(os.environ.get("LOCAL_RANK", rank))
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world_size))
    lay = _choose(device, backend, rank, local_rank, local_world)
    try:
        if lay.device.type == "cuda":
            torch.cuda.set_device(lay.device)
        dist.init_process_group(lay.backend, init_method=init_method or
                                "env://", world_size=world_size, rank=rank)
    except Exception as e:
        raise RuntimeError(
            f"torch.distributed.init_process_group({lay.backend!r}) failed "
            f"for rank {rank} of {world_size}: call demcmc_tpu_torch."
            f"parallel.distributed.initialize() in every process, with the "
            f"same init_method (or under torchrun), before any run. "
            f"Original error: {e}") from e
    _layout = lay
    return lay


def is_active() -> bool:
    """True where this process is in a process group."""
    return dist.is_available() and dist.is_initialized()


def layout() -> Optional[Layout]:
    """This process's :class:`Layout` (None outside a process group);
    raises for a group made without :func:`initialize`, whose device and
    staging it cannot know."""
    if not is_active():
        return None
    if _layout is None:
        raise RuntimeError("the process group was made without demcmc_tpu_"
                           "torch.parallel.distributed.initialize(): call "
                           "it instead, so that each rank's device and "
                           "backend are known")
    return _layout


def rank() -> int:
    return dist.get_rank() if is_active() else 0


def world_size() -> int:
    return dist.get_world_size() if is_active() else 1


def global_chain_mesh() -> Mesh:
    """A 1-axis ``chains`` mesh over every rank's device, in rank order,
    each shard owned by its rank (``Mesh.owners``); with no process group,
    :func:`~.mesh.chain_mesh` over the visible cards."""
    if not is_active():
        return chain_mesh()
    names = [None] * world_size()
    dist.all_gather_object(names, str(layout().device))
    return Mesh([torch.device(n) for n in names],
                owners=range(len(names)))


def is_coordinator() -> bool:
    """True on the process that prints and saves results: rank 0, or the
    one process without a group."""
    return rank() == 0


def all_gather_chains(x: torch.Tensor, counts, dim: int = 0):
    """The concatenation along ``dim`` of every rank's ``x`` (rank r's
    holds ``counts[r]`` entries along ``dim``), in rank order, on ``x``'s
    device: an ``all_gather`` of copies padded to the largest count, so
    no value is combined with another and the bits are every rank's own.
    Under gloo a card's tensor goes through pinned host memory."""
    lay = layout()
    counts = [int(c) for c in counts]
    if x.shape[dim] != counts[rank()]:
        raise ValueError(f"rank {rank()} holds {x.shape[dim]} entries, "
                         f"not {counts[rank()]}")
    top, dev, dtype = max(counts), x.device, x.dtype
    y = x.movedim(dim, 0)
    if dtype == torch.bool:
        y = y.to(torch.uint8)
    if lay.backend == "nccl":
        y = y.to(lay.device)
    elif y.device.type == "cuda":
        host = torch.empty(y.shape, dtype=y.dtype, pin_memory=True)
        y = host.copy_(y)
    pad = y.new_zeros((top,) + tuple(y.shape[1:]))
    pad[:y.shape[0]].copy_(y)
    if lay.backend == "nccl":
        out = pad.new_empty((len(counts) * top,) + tuple(pad.shape[1:]))
        dist.all_gather_into_tensor(out, pad)
        parts = list(out.split(top))
    else:
        parts = [torch.empty_like(pad) for _ in counts]
        dist.all_gather(parts, pad)
    full = torch.cat([p[:c] for p, c in zip(parts, counts)])
    if full.device != dev:
        full = full.to(dev, non_blocking=full.is_pinned())
    if dtype == torch.bool:
        full = full.to(torch.bool)
    return full.movedim(0, dim).contiguous()
