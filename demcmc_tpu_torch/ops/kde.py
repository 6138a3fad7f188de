"""The log Epanechnikov-KDE density: the wrapper of CUDA kernel K4
(``csrc/kde.cu``) and its plain PyTorch version.

K4 is the port of ``demcmc_tpu/ops/pallas_kde.py::kde_logpdf_pallas``
(kernel ``_kde_kernel`` :35, ``pallas_call`` :86), the density of the
synthetic likelihood in ``models/abc_kde.py``: for each chain c and
evaluation point e, ``log(max(Σ_s 0.75 (1 − u²) 1[|u| ≤ 1] / (n_sim ·
h_c), floor))`` with ``u = (x_e − sim_cs) / h_c``.  The TPU kernel runs
one chain per call, vmapped by the XLA step; K4 takes the chains as a
batch.  It sums like the TPU kernel: in index order within tiles of
:func:`sim_tile` simulations, and the tile sums in tile order.

The plain version is the batched torch form of ``epanechnikov_logpdf``
(``utils/kde.py``): it takes the mean and then divides by h, and it sums
in torch's order, so K4 agrees with it to a tolerance, not bit for bit.
"""

from __future__ import annotations

import torch

from ..utils import kde as kde_utils
from . import _build

SIM_TILE = 2048          # the TPU kernel's SIM_TILE (pallas_kde.py:26)
PLAIN_CHUNK = 1 << 24    # plain version: kernel-matrix elements per chunk


def sim_tile(n_sim: int) -> int:
    """Simulations per tile, the TPU kernel's ``T`` (``pallas_kde.py:
    76``): ``min(2048, max(128, n_sim rounded up to 128))``."""
    return min(SIM_TILE, max(128, -(-n_sim // 128) * 128))


def kde_logpdf_plain(x, sims, h, floor: float = 1e-10):
    """Plain version of K4: ``x [E]``, ``sims [C, S]``, ``h [C]`` ->
    ``[C, E]``, in chunks of chains that bound the ``[c, E, S]`` kernel
    matrix to ``PLAIN_CHUNK`` elements."""
    C, S = sims.shape
    step = max(1, PLAIN_CHUNK // max(1, x.shape[0] * S))
    return torch.cat([kde_utils.epanechnikov_logpdf(
        x, sims[c:c + step], h[c:c + step], floor)
        for c in range(0, C, step)])


def kde_logpdf(x, sims, h, floor: float = 1e-10):
    """log KDE density of the evaluation points ``x [E]`` under each
    chain's simulations ``sims [C, S]`` with bandwidths ``h [C]``
    (float32); returns ``[C, E]``.  CPU tensors take the plain version;
    CUDA tensors launch K4 (``kde_logpdf.launches`` counts the
    launches).  The call is the operator ``demcmc_tpu_torch::kde_logpdf``,
    whose vmap rule (:func:`_kde_vmap`) folds a ``torch.func.vmap`` batch
    into the chains: a custom fitness slot that runs per cell launches K4
    once for the whole population."""
    if sims.device.type not in ("cpu", "cuda"):
        raise ValueError(f"kde_logpdf runs on cpu or cuda, not "
                         f"{sims.device}")
    return _kde_op(x, sims, h, float(floor))


kde_logpdf.launches = 0


@torch.library.custom_op("demcmc_tpu_torch::kde_logpdf", mutates_args=())
def _kde_op(x: torch.Tensor, sims: torch.Tensor, h: torch.Tensor,
            floor: float) -> torch.Tensor:
    if sims.device.type == "cpu":
        return kde_logpdf_plain(x, sims, h, floor)
    check_cuda(x, sims, h)
    C, S = sims.shape
    E = x.shape[0]
    out = torch.empty((C, E), dtype=torch.float32, device=sims.device)
    lib = _build.library("kde")
    _build.launch(lib, "kde_logpdf_f32", sims.device, x.data_ptr(),
                  sims.data_ptr(), h.data_ptr(), out.data_ptr(), C, E, S,
                  sim_tile(S), floor)
    kde_logpdf.launches += 1
    return out


@_kde_op.register_vmap
def _kde_vmap(info, in_dims, x, sims, h, floor):
    """The batch of a vmap over :func:`kde_logpdf`, ``sims [B, C, S]`` and
    ``h [B, C]``, runs as one call on ``[B·C, S]`` chains; only a batch of
    evaluation points ``x [B, E]`` takes one call per batch member."""
    B = info.batch_size
    x_dim, sims_dim, h_dim, _ = in_dims

    def front(t, dim):
        return t.movedim(dim, 0) if dim is not None else t.expand(
            (B,) + tuple(t.shape))

    sims, h = front(sims, sims_dim), front(h, h_dim)
    if x_dim is not None:
        x = x.movedim(x_dim, 0)
        return torch.stack([_kde_op(x[b], sims[b].contiguous(),
                                    h[b].contiguous(), floor)
                            for b in range(B)]), 0
    C, S = sims.shape[1:]
    out = _kde_op(x, sims.reshape(B * C, S).contiguous(),
                  h.reshape(B * C).contiguous(), floor)
    return out.reshape(B, C, -1), 0


def check_cuda(x, sims, h):
    """Raise unless the tensors are what K4 takes on a CUDA device."""
    dev = sims.device
    if dev.type != "cuda":
        raise ValueError(f"kde_logpdf runs on cpu or cuda, not {dev}")
    if sims.dim() != 2 or sims.shape[0] < 1 or sims.shape[1] < 1:
        raise ValueError(f"sims: need a [C, S] tensor, got "
                         f"{tuple(sims.shape)}")
    C = sims.shape[0]
    for name, t, dims in (("x", x, 1), ("sims", sims, 2), ("h", h, 1)):
        if (t.device != dev or t.dtype != torch.float32 or t.dim() != dims
                or not t.is_contiguous()):
            raise ValueError(f"{name}: need a contiguous float32 {dims}-D "
                             f"tensor on {dev}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
    if h.shape[0] != C or x.shape[0] < 1:
        raise ValueError(f"h: need [{C}] and x at least one point, got "
                         f"{tuple(h.shape)} and {tuple(x.shape)}")
