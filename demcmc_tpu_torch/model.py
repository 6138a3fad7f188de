"""Model protocol and parameter-space description (port of
``demcmc_tpu.model``).

The whole population lives in one flat float32 tensor ``[C, d]``; a
:class:`ParamSpec` records how a flat vector scatters back into the
user's parameter list, with per-dimension bounds (out-of-bounds is a hard
reject, weight ``-inf``) and integer leaves rounded on unflatten.

A :class:`DEModel` carries chains-last batched densities written in torch
(the plain path, and the CPU oracle of the kernels) and, optionally, the
name of a CUDA density header under ``csrc/densities/`` with its scalar
arguments, which the hand-written DE-step kernel is instantiated on.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Optional, Sequence, Tuple

import numpy as np
import torch

from . import rng


@dataclass(frozen=True)
class ParamSpec:
    """Static description of the parameter space: names, per-parameter
    shapes, integer flags and flat ``[d]`` float64 bounds."""

    names: Tuple[str, ...]
    shapes: Tuple[Tuple[int, ...], ...]
    is_int: Tuple[bool, ...]
    lo: np.ndarray
    hi: np.ndarray

    @property
    def sizes(self) -> Tuple[int, ...]:
        return tuple(int(np.prod(s)) if s else 1 for s in self.shapes)

    @property
    def dim(self) -> int:
        return int(sum(self.sizes))

    @property
    def offsets(self) -> Tuple[int, ...]:
        out, acc = [], 0
        for s in self.sizes:
            out.append(acc)
            acc += s
        return tuple(out)

    @property
    def int_mask(self) -> np.ndarray:
        m = np.zeros(self.dim, dtype=bool)
        for off, sz, isi in zip(self.offsets, self.sizes, self.is_int):
            if isi:
                m[off:off + sz] = True
        return m

    @property
    def has_int(self) -> bool:
        return any(self.is_int)

    def flatten(self, params: Sequence[Any]) -> torch.Tensor:
        """Pack a list of parameter values (matching ``names``) into a
        flat ``[d]`` tensor of the default float dtype."""
        segs = [torch.as_tensor(p, dtype=torch.get_default_dtype())
                .reshape(-1) for p in params]
        return torch.cat(segs) if len(segs) > 1 else segs[0]

    def unflatten(self, x: torch.Tensor) -> list:
        """Split flat ``[d]`` into the parameter list; integer parameters
        are rounded and cast to int32, scalars come back 0-d."""
        out = []
        for off, sz, shape, isi in zip(self.offsets, self.sizes,
                                       self.shapes, self.is_int):
            a = x[off:off + sz].reshape(shape)
            if isi:
                a = torch.round(a).to(torch.int32)
            out.append(a)
        return out

    def unflatten_cols(self, x2: torch.Tensor) -> list:
        """Split ``[d, *cs]`` into chain-LAST parameter arrays: a scalar
        parameter becomes ``[*cs]``, a ``(k,)`` parameter ``[k, *cs]``."""
        cs = tuple(x2.shape[1:])
        out = []
        for off, sz, shape, isi in zip(self.offsets, self.sizes,
                                       self.shapes, self.is_int):
            a = x2[off:off + sz].reshape(tuple(shape) + cs)
            if isi:
                a = torch.round(a).to(torch.int32)
            out.append(a)
        return out

    def flat_names(self) -> list:
        """Flattened scalar names with 1-based indices (``"b[2]"``,
        ``"m[1,2]"``), row-major."""
        out = []
        for name, shape in zip(self.names, self.shapes):
            if not shape:
                out.append(str(name))
            else:
                for idx in np.ndindex(*shape):
                    out.append(
                        f"{name}[{','.join(str(i + 1) for i in idx)}]")
        return out

    @staticmethod
    def from_example(names, example: Sequence[Any], bounds) -> "ParamSpec":
        """Build a spec from one example parameter list plus DE bounds."""
        names = tuple(str(n) for n in names)
        example = list(example) if isinstance(example, (list, tuple)) \
            else [example]
        if len(example) != len(names):
            raise ValueError(
                f"example has {len(example)} parameters but "
                f"{len(names)} names were given")
        shapes, is_int = [], []
        for p in example:
            a = np.asarray(p)
            shapes.append(tuple(a.shape))
            is_int.append(bool(np.issubdtype(a.dtype, np.integer)))
        if bounds is None:
            bounds = tuple(((-np.inf, np.inf),) * len(names))
        if len(bounds) != len(names):
            raise ValueError(
                f"{len(bounds)} bounds for {len(names)} parameters")
        sizes = [int(np.prod(s)) if s else 1 for s in shapes]
        lo = np.concatenate([np.full(sz, float(b[0]))
                             for sz, b in zip(sizes, bounds)])
        hi = np.concatenate([np.full(sz, float(b[1]))
                             for sz, b in zip(sizes, bounds)])
        return ParamSpec(names=names, shapes=tuple(shapes),
                         is_int=tuple(is_int), lo=lo, hi=hi)


@dataclass(frozen=True)
class CudaDensity:
    """A log-posterior written as a CUDA ``__device__`` functor in
    ``csrc/densities/<name>.cuh``; ``params`` are the float32 scalars the
    functor takes (in its constructor order)."""

    name: str
    params: Tuple[float, ...]


@dataclass
class DEModel:
    """User model bundle (the reference's ``DEModel``).

    ``loglike_batched(data, *params)`` and ``prior_loglike_batched(*params)``
    are chains-last torch densities: a scalar parameter arrives as a
    ``[*cs]`` tensor.  ``sample_prior(uniform, n)`` returns ``n`` prior
    draws as a parameter list of ``[n, *shape]`` tensors, taking its
    randomness only from ``uniform(k)`` — ``k`` fresh float32 uniform rows
    ``[k, n]`` from the init Philox namespace.  ``cuda_density`` names the
    kernel's density; without one the model runs the plain torch step
    only on the CPU.
    """

    loglike_batched: Callable = None
    prior_loglike_batched: Callable = None
    sample_prior: Callable = None
    names: Tuple = ()
    data: Any = None
    cuda_density: Optional[CudaDensity] = None

    def __post_init__(self):
        if self.loglike_batched is None or self.prior_loglike_batched is None:
            raise ValueError("loglike_batched and prior_loglike_batched "
                             "are required")
        if self.sample_prior is None:
            raise ValueError("sample_prior is required")
        self.names = tuple(self.names)

    def log_posterior_cols(self, spec: ParamSpec, x2: torch.Tensor):
        """Batched log posterior of ``[d, *cs]`` columns: prior + loglike
        in that order (``fused_step.py:1523-1527``)."""
        cols = spec.unflatten_cols(x2)
        ll = self.loglike_batched(self.data, *cols)
        return self.prior_loglike_batched(*cols) + ll

    def init_population(self, spec: ParamSpec, key: int, n: int,
                        device=None) -> torch.Tensor:
        """``[n, d]`` float32 prior draws from the init Philox namespace
        (reference ``init_particle``, ``src/utilities.jl:13-22``)."""
        next_row = [0]

        def uniform(k):
            r0 = next_row[0]
            next_row[0] = r0 + k
            return rng.to_uni(rng.words(key, 0, k, n, ns=rng.INIT_NS,
                                        device=device, row0=r0))

        params = self.sample_prior(uniform, n)
        x = torch.cat([torch.as_tensor(p, dtype=torch.float32,
                                       device=device).reshape(n, -1)
                       for p in params], 1)
        if spec.has_int:
            mask = torch.as_tensor(spec.int_mask, device=device)
            x = torch.where(mask, torch.round(x), x)
        return x
