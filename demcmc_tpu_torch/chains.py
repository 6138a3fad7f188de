"""Chains output container (the port's copy of ``demcmc_tpu.chains``).

The reference wraps posterior draws in ``MCMCChains.Chains`` with internals
``["acceptance", "lp"]`` (reference ``src/main.jl:222-250``); this is
the native analogue: a host-side numpy container with the same flattened
parameter naming (``"β0[3]"``, ``"m[1,2]"``), per-chain acceptance/lp
internals, and built-in mean/std/quantile/R̂/ESS summaries.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from . import diagnostics


class Chains:
    """Posterior draws ``[Ns, n_params, n_chains]`` plus internals.

    ``len(chains)`` is the number of stored draws per chain, matching the
    reference's burnin-accounting tests (``test/utility_tests.jl:32-39``).
    Index with a flat parameter name (``chains["mu"]`` → ``[Ns, C]``) or a
    user-level name covering array parameters (``chains.group("beta")`` →
    ``[Ns, k, C]``).
    """

    internals = ("acceptance", "lp")

    def __init__(self, data: np.ndarray, names: Sequence[str],
                 acceptance: np.ndarray, lp: np.ndarray,
                 param_names: Sequence[str] = ()):
        data = np.asarray(data)
        if data.ndim != 3:
            raise ValueError("data must be [draws, params, chains]")
        if data.shape[1] != len(names):
            raise ValueError(f"{data.shape[1]} columns, {len(names)} names")
        self.data = data
        self.names = list(names)
        self.acceptance = np.asarray(acceptance)
        self.lp = np.asarray(lp)
        self.param_names = list(param_names) or list(names)

    @classmethod
    def from_samples(cls, theta: np.ndarray, acc: np.ndarray,
                     lp: np.ndarray, spec) -> "Chains":
        """theta [Ns, C, d], acc/lp [Ns, C]."""
        data = np.moveaxis(np.asarray(theta), 2, 1)   # [Ns, d, C]
        return cls(data, spec.flat_names(), np.asarray(acc), np.asarray(lp),
                   param_names=list(spec.names))

    # -- container protocol -----------------------------------------------
    def __len__(self) -> int:
        return self.data.shape[0]

    @property
    def n_chains(self) -> int:
        return self.data.shape[2]

    @property
    def n_params(self) -> int:
        return self.data.shape[1]

    def _col(self, name: str) -> int:
        try:
            return self.names.index(name)
        except ValueError:
            raise KeyError(f"unknown parameter {name!r}; have {self.names}")

    def __getitem__(self, name):
        if name == "acceptance":
            return self.acceptance
        if name == "lp":
            return self.lp
        return self.data[:, self._col(name), :]

    def group(self, base: str) -> np.ndarray:
        """All flat columns of one user-level (possibly array) parameter."""
        cols = [i for i, n in enumerate(self.names)
                if n == base or n.startswith(base + "[")]
        if not cols:
            raise KeyError(f"no parameter named {base!r}")
        return self.data[:, cols, :]

    # -- summaries ----------------------------------------------------------
    def mean(self, name: Optional[str] = None):
        if name is not None:
            return float(self[name].mean())
        return np.array([self.data[:, i, :].mean()
                         for i in range(self.n_params)])

    def std(self, name: Optional[str] = None, ddof: int = 1):
        if name is not None:
            return float(self[name].reshape(-1).std(ddof=ddof))
        return np.array([self.data[:, i, :].reshape(-1).std(ddof=ddof)
                         for i in range(self.n_params)])

    def quantile(self, q, name: Optional[str] = None):
        if name is not None:
            return np.quantile(self[name], q)
        return np.stack([np.quantile(self.data[:, i, :], q)
                         for i in range(self.n_params)])

    def rhat(self, name: Optional[str] = None):
        """Rank-normalized split-R̂ (the MCMCChains default)."""
        if name is not None:
            return diagnostics.rank_normalized_rhat(self[name])
        tables = {}     # every parameter's draws are of one size
        return np.array([diagnostics.rank_normalized_rhat(self.data[:, i, :],
                                                          tables)
                         for i in range(self.n_params)])

    def ess(self, name: Optional[str] = None):
        if name is not None:
            return diagnostics.ess_bulk(self[name])
        tables = {}
        return np.array([diagnostics.ess_bulk(self.data[:, i, :], tables)
                         for i in range(self.n_params)])

    def ess_tail(self, name: Optional[str] = None):
        """Tail ESS (Stan/ArviZ ``ess_tail``): chain resolution at the
        5%/95% quantiles — bulk ESS can overstate it for sticky tails."""
        if name is not None:
            return diagnostics.ess_tail(self[name])
        return np.array([diagnostics.ess_tail(self.data[:, i, :])
                         for i in range(self.n_params)])

    def describe(self) -> dict:
        return {n: diagnostics.summary_stats(self.data[:, i, :])
                for i, n in enumerate(self.names)}

    def summary(self) -> str:
        rows = self.describe()
        hdr = (f"{'parameter':>14} {'mean':>10} {'std':>10} {'mcse':>10} "
               f"{'q2.5':>10} {'q97.5':>10} {'ess':>9} {'rhat':>7}")
        lines = [f"Chains: {len(self)} draws x {self.n_chains} chains, "
                 f"mean acceptance {self.acceptance.mean():.3f}", hdr]
        for n, s in rows.items():
            lines.append(
                f"{n:>14} {s['mean']:>10.4f} {s['std']:>10.4f} "
                f"{s['mcse']:>10.4f} {s['q2.5']:>10.4f} {s['q97.5']:>10.4f} "
                f"{s['ess']:>9.1f} {s['rhat']:>7.4f}")
        return "\n".join(lines)

    def __repr__(self) -> str:
        return (f"Chains({len(self)} draws, {self.n_params} params, "
                f"{self.n_chains} chains)")

    # -- export ---------------------------------------------------------
    def to_numpy(self, include_internals: bool = True) -> np.ndarray:
        """Dense ``[Ns, n_params(+2), C]`` array like the reference's
        bundled array (``src/main.jl:240``)."""
        if not include_internals:
            return self.data
        extras = np.stack([self.acceptance.astype(self.data.dtype),
                           self.lp.astype(self.data.dtype)], axis=1)
        return np.concatenate([self.data, extras], axis=1)

    def to_inference_data(self):
        """ArviZ export (``demcmc_tpu/chains.py:157-167``): ``arviz`` is
        optional, and its absence raises ``ImportError``."""
        try:
            import arviz as az
        except ImportError as e:
            raise ImportError("arviz is not installed") from e
        return az.from_dict(**self._inference_dict())

    def _inference_dict(self) -> dict:
        """What :meth:`to_inference_data` hands ``arviz.from_dict``: each
        parameter's draws ``[C, Ns]``, and the acceptance and lp."""
        posterior = {n: self.data[:, i, :].T
                     for i, n in enumerate(self.names)}
        return {"posterior": posterior,
                "sample_stats": {"acceptance": self.acceptance.T,
                                 "lp": self.lp.T}}
