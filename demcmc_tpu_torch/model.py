"""Model protocol and parameter-space description (port of
``demcmc_tpu.model``).

The whole population lives in one flat tensor ``[C, d]`` of the
configuration's dtype (float32 or float64); a
:class:`ParamSpec` records how a flat vector scatters back into the
user's parameter list, with per-dimension bounds (out-of-bounds is a hard
reject, weight ``-inf``) and integer leaves rounded on unflatten.

A :class:`DEModel` carries its densities written in torch, per cell or
chains-last batched (the unfused step, the plain versions of the kernels
and their CPU oracle) and, optionally, the name of a CUDA density header
under ``csrc/densities/`` with its scalar arguments, which the
hand-written DE-step kernels are instantiated on.
"""

from __future__ import annotations

from dataclasses import dataclass, field
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
    functor takes (in its constructor order), ``data`` an optional float32
    array (trials, a table) the functor reads through a device pointer."""

    name: str
    params: Tuple[float, ...]
    data: Optional[np.ndarray] = field(default=None, compare=False)
    _on: dict = field(default_factory=dict, compare=False, repr=False)

    def data_on(self, device) -> Optional[torch.Tensor]:
        """``data`` as a contiguous float32 tensor on ``device``, copied
        once per device and kept here while kernels may read it."""
        if self.data is None:
            return None
        key = str(torch.device(device))
        t = self._on.get(key)
        if t is None:
            t = self._on[key] = torch.tensor(
                np.ascontiguousarray(self.data, np.float32), device=device)
        return t


@dataclass(frozen=True)
class DensityTable:
    """R models' :class:`CudaDensity` stacked for one replicated K1 launch
    (``sampler.sample_replicated``): the density's name, its constants as
    a ``[R, P]`` float32 table (row r replication r's ``params``) and its
    data buffers as ``[R, n]`` float32 (row r replication r's ``data``,
    flattened; None for a density without one).  The kernel reads row r
    at ``r·P`` and ``r·n``."""

    name: str
    params: np.ndarray
    data: Optional[np.ndarray] = field(default=None, compare=False)
    _on: dict = field(default_factory=dict, compare=False, repr=False)

    @staticmethod
    def stack(densities) -> "DensityTable":
        """The table of ``densities`` (one per replication); raises
        ``ValueError`` unless they name one density with as many
        constants and data of one shape."""
        densities = list(densities)
        if not densities or any(d is None for d in densities):
            raise ValueError("a replicated K1 launch needs a CUDA density "
                             "for every replication")
        d0 = densities[0]
        shape0 = None if d0.data is None else np.shape(d0.data)
        for r, d in enumerate(densities):
            shape = None if d.data is None else np.shape(d.data)
            if (d.name != d0.name or len(d.params) != len(d0.params)
                    or shape != shape0):
                raise ValueError(
                    f"replication {r}'s density ({d.name}, "
                    f"{len(d.params)} constants, data {shape}) differs from "
                    f"replication 0's ({d0.name}, {len(d0.params)}, "
                    f"{shape0}): one replicated launch takes one density "
                    f"with data of one shape")
        params = np.array([d.params for d in densities], dtype=np.float32)
        data = None
        if shape0 is not None:
            data = np.stack([np.asarray(d.data, np.float32).reshape(-1)
                             for d in densities])
        return DensityTable(d0.name, params, data)

    @property
    def n_reps(self) -> int:
        return int(self.params.shape[0])

    def on(self, device) -> tuple:
        """``(params [R, P], data [R, n] or None)`` as contiguous float32
        tensors on ``device``, copied once per device and kept here while
        kernels may read them."""
        key = str(torch.device(device))
        t = self._on.get(key)
        if t is None:
            t = self._on[key] = tuple(
                None if a is None else torch.tensor(
                    np.ascontiguousarray(a), device=device)
                for a in (self.params, self.data))
        return t


class DeviceArrays:
    """A model's numpy arrays as tensors, copied once per device and kept
    here while densities read them (a density reads ``on(x.device)``, so
    the data goes to the card once, not at every evaluation)."""

    def __init__(self, *arrays):
        self.arrays = tuple(np.ascontiguousarray(a) for a in arrays)
        self._on = {}

    def on(self, device) -> tuple:
        key = str(torch.device(device))
        t = self._on.get(key)
        if t is None:
            t = self._on[key] = tuple(torch.tensor(a, device=device)
                                      for a in self.arrays)
        return t


@dataclass
class DEModel:
    """User model bundle (the reference's ``DEModel``).

    A density comes in one of two forms.  The per-cell form is the JAX
    ``DEModel``'s (``demcmc_tpu/model.py:192-330``): ``loglike(data,
    *params)`` and ``prior_loglike(*params)`` of one parameter vector,
    written in torch with no ``.item()`` and no branch on a value, since
    the step batches them over the chains with ``torch.func.vmap``.  The
    batched form, ``loglike_batched(data, *params)`` and
    ``prior_loglike_batched(*params)``, is chains-last: a scalar parameter
    arrives as a ``[*cs]`` tensor.  Each density needs one of its two
    forms; where both are given the batched one runs.  The prior is
    optional, as in the JAX ``DEModel``: a model without one is for
    optimization only (``evaluate_fitness='fun'`` scores the loglike
    alone).  ``sample_prior(uniform, n)`` returns ``n`` prior draws as a
    parameter list of ``[n, *shape]`` tensors, taking its randomness only
    from ``uniform(k)`` — ``k`` fresh uniform rows ``[k, n]`` of the
    configuration's dtype from the init Philox namespace.
    ``cuda_density`` names the DE-step kernels'
    density; a model without one runs the unfused step
    (:func:`demcmc_tpu_torch.build_step`), on the card as on the CPU.

    A model with a ``noise_shape`` is stochastic (pseudo-marginal): it
    re-simulates on every evaluation, ``loglike_batched(data, *params,
    noise=u)`` taking a fresh float32 uniform panel ``u [*noise_shape,
    *cs]`` (the JAX ``DEModel``'s ``noise_shape``), drawn by the step from
    the words of the evaluation.
    """

    loglike_batched: Callable = None
    prior_loglike_batched: Callable = None
    sample_prior: Callable = None
    names: Tuple = ()
    data: Any = None
    cuda_density: Optional[CudaDensity] = None
    noise_shape: Optional[Tuple[int, ...]] = None
    loglike: Callable = None
    prior_loglike: Callable = None

    def __post_init__(self):
        if self.loglike_batched is None and self.loglike is None:
            raise ValueError("loglike or loglike_batched is required")
        if self.sample_prior is None:
            raise ValueError("sample_prior is required")
        self.names = tuple(self.names)
        if self.noise_shape is not None:
            self.noise_shape = tuple(int(n) for n in self.noise_shape)
            if not self.noise_shape or min(self.noise_shape) < 1:
                raise ValueError("noise_shape needs at least one uniform "
                                 "per evaluation")
            if self.loglike_batched is None:
                raise ValueError("a stochastic model needs loglike_batched "
                                 "(it takes the noise panel)")

    @property
    def stochastic(self) -> bool:
        """True for a pseudo-marginal model (one with a noise panel)."""
        return self.noise_shape is not None

    @property
    def noise_words(self) -> int:
        """Uniforms per chain and evaluation (0 unless stochastic)."""
        return int(np.prod(self.noise_shape)) if self.stochastic else 0

    def _no_prior(self):
        raise ValueError("this model has no prior (prior_loglike or "
                         "prior_loglike_batched): it is for optimization "
                         "only, with evaluate_fitness='fun'")

    def log_prior_flat(self, spec: ParamSpec, x: torch.Tensor):
        """Per-cell log prior of one flat ``[d]`` vector."""
        if self.prior_loglike is None:
            self._no_prior()
        return self.prior_loglike(*spec.unflatten(x))

    def log_like_flat(self, spec: ParamSpec, x: torch.Tensor, data=None):
        """Per-cell log likelihood of one flat ``[d]`` vector (on
        ``data``, by default the model's)."""
        return self.loglike(self.data if data is None else data,
                            *spec.unflatten(x))

    @staticmethod
    def _vmapped(fn, spec: ParamSpec, x2: torch.Tensor):
        """A per-cell density ``fn(spec, x [d])`` over ``[d, *cs]``
        columns, through ``torch.func.vmap``; returns ``[*cs]``."""
        cs = tuple(x2.shape[1:])
        x = x2.reshape(x2.shape[0], -1).T
        out = torch.func.vmap(lambda v: fn(spec, v))(x)
        return out.reshape(cs)

    def log_like_cols(self, spec: ParamSpec, x2: torch.Tensor,
                      noise: torch.Tensor = None):
        """Batched log likelihood (the optimization objective) of ``[d,
        *cs]`` columns, in its batched form where the model gives one and
        else per cell; a stochastic model's loglike gets the panel ``noise
        [n_noise, *cs]`` reshaped to ``[*noise_shape, *cs]``.

        Data sharded over a mesh's ``data`` axis (a
        :class:`~demcmc_tpu_torch.parallel.ShardedData`, ``shard_data``):
        the columns (and panel) copied to each piece's device, the
        likelihood of the piece there, the partials copied back and summed
        in piece order, the psum of ``demcmc_tpu/parallel/mesh.py:1-11``
        (the likelihood must be a sum over the sharded axis)."""
        from .parallel.mesh import ShardedData
        if not isinstance(self.data, ShardedData):
            return self._like_cols(self.data, spec, x2, noise)
        total = None
        for piece, dev in self.data.parts():
            part = self._like_cols(
                piece, spec, x2.to(dev),
                None if noise is None else noise.to(dev)).to(x2.device)
            total = part if total is None else total + part
        return total

    def _like_cols(self, data, spec: ParamSpec, x2: torch.Tensor, noise):
        if self.stochastic:
            if noise is None:
                raise ValueError("a stochastic model's density needs its "
                                 "noise panel")
            noise = noise.reshape(self.noise_shape + tuple(x2.shape[1:]))
            return self.loglike_batched(data, *spec.unflatten_cols(x2),
                                        noise=noise)
        if self.loglike_batched is not None:
            return self.loglike_batched(data, *spec.unflatten_cols(x2))
        return self._vmapped(
            lambda sp, v: self.log_like_flat(sp, v, data), spec, x2)

    def log_posterior_cols(self, spec: ParamSpec, x2: torch.Tensor,
                           noise: torch.Tensor = None):
        """Batched log posterior of ``[d, *cs]`` columns: prior + loglike
        in that order (``fused_step.py:1523-1541``), each in its batched
        form where the model gives one and else per cell
        (:meth:`log_like_cols`).  A model without a prior raises."""
        if self.prior_loglike_batched is not None:
            prior = self.prior_loglike_batched(*spec.unflatten_cols(x2))
        elif self.prior_loglike is not None:
            prior = self._vmapped(self.log_prior_flat, spec, x2)
        else:
            self._no_prior()
        return prior + self.log_like_cols(spec, x2, noise)

    def init_population(self, spec: ParamSpec, key: int, n: int,
                        device=None, dtype=torch.float32) -> torch.Tensor:
        """``[n, d]`` prior draws of ``dtype`` from the init Philox namespace
        (reference ``init_particle``, ``src/utilities.jl:13-22``): a
        float32 uniform row from one row of words, a float64 one from two
        (the pool's word rule, :mod:`.rng`)."""
        next_row = [0]
        wide = dtype == torch.float64

        def uniform(k):
            r0 = next_row[0]
            rows = 2 * k if wide else k
            next_row[0] = r0 + rows
            w = rng.words(key, 0, rows, n, ns=rng.INIT_NS, device=device,
                          row0=r0)
            if wide:
                w = w.to(torch.int64)
                return rng._uniform53(w[:k], w[k:])
            return rng.to_uni(w)

        params = self.sample_prior(uniform, n)
        x = torch.cat([torch.as_tensor(p, dtype=dtype,
                                       device=device).reshape(n, -1)
                       for p in params], 1)
        if spec.has_int:
            mask = torch.as_tensor(spec.int_mask, device=device)
            x = torch.where(mask, torch.round(x), x)
        return x
