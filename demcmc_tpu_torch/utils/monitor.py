"""Streaming convergence monitoring: live split-R̂ and ESS during a run
(the port's own copy of ``demcmc_tpu.utils.monitor``, numpy only).

The reference's only run-time observability is a ProgressMeter bar
(``src/main.jl:30``); convergence is assessed post hoc.  Here
:class:`ConvergenceMonitor` consumes trajectory chunks ``[T, C, d]`` as
they reach the host (``run_scan`` streams them there for bundling
anyway, so monitoring costs nothing on the card) and keeps per-parameter
running statistics:

* streaming **split-R̂** (Vehtari et al. 2021 / Gelman-Rubin over the 2C
  half-chains): draws accumulate into fixed-size buckets of sufficient
  statistics (count/sum/sum of squares per chain), and the split point
  is the bucket boundary nearest n/2, so each chain is split into halves
  without keeping the trajectory.  Buckets merge pairwise once 512
  exist, keeping the boundary within n/1024 of the midpoint; the
  statistic converges to :func:`demcmc_tpu_torch.diagnostics.split_rhat`.
  A within-chain trend inflates the live R̂ as it does the post-hoc one.
* streaming **ESS**: Geyer's truncated autocovariance sum on the stored
  bucket-mean series (batching keeps the long-run variance, so the
  spectral estimate needs no trajectory); a lag-1 ``N·(1-ρ₁)/(1+ρ₁)``
  fallback covers the first draws.

The arithmetic is the JAX module's, operation for operation, so the same
chunks give the same bits.  ``sample(..., monitor=True)`` feeds the
post-burn-in draws and shows ``R̂max`` in the progress line;
``sample(..., stop_rhat=r)`` stops the run at the first chunk boundary
where the streaming split-R̂max reaches the target.
"""

from __future__ import annotations

import numpy as np

__all__ = ["ConvergenceMonitor"]

_MAX_BUCKETS = 512
# bucket-store host-memory budget: each bucket holds two float64 [C, d]
# arrays, so the cap shrinks toward this budget at large chain counts
# (coarser buckets only move the live split point: at the floor of 8
# buckets it is within n/16 of the midpoint).  The floor bounds the worst
# case at 8 buckets, which can exceed the budget at extreme C·d.
_BUCKET_MEM_BUDGET = 64 * 1024 * 1024


class ConvergenceMonitor:
    """Accumulates draws chunk by chunk; ``theta`` chunks are
    ``[T, C, d]``."""

    def __init__(self):
        self.n = 0
        self._s1 = None      # [C, d] running sum
        self._s2 = None      # [C, d] running sum of squares
        self._sx1 = None     # [C, d] running sum of x_t * x_{t-1}
        self._prev = None    # [C, d] last draw of the previous chunk
        # split-R̂ bucket store: per-bucket (count, sum [C,d], sumsq [C,d])
        self._bn = []        # bucket counts (python ints)
        self._bs1 = []       # bucket sums
        self._bs2 = []       # bucket sums of squares
        self._bucket_size = 1
        self._max_buckets = _MAX_BUCKETS     # memory-capped on first chunk

    def update(self, theta_chunk) -> None:
        x = np.asarray(theta_chunk, np.float64)
        if x.ndim != 3:
            raise ValueError(f"a chunk is [T, C, d], got shape {x.shape}")
        if x.shape[0] == 0:
            return
        if self._s1 is None:
            C, d = x.shape[1:]
            self._s1 = np.zeros((C, d))
            self._s2 = np.zeros((C, d))
            self._sx1 = np.zeros((C, d))
            per_bucket = 2 * C * d * 8               # two f64 [C, d]
            self._max_buckets = int(min(
                _MAX_BUCKETS, max(8, _BUCKET_MEM_BUDGET // per_bucket)))
        self._s1 += x.sum(axis=0)
        x2 = x * x
        self._s2 += x2.sum(axis=0)
        lagged = x[:-1] if self._prev is None else np.concatenate(
            [self._prev[None], x[:-1]], axis=0)
        self._sx1 += (x[-len(lagged):] * lagged).sum(axis=0)
        self._prev = x[-1]
        self.n += x.shape[0]
        self._fill_buckets(x, x2)

    # ---- split-R̂ bucket plumbing

    def _fill_buckets(self, x, x2) -> None:
        t = 0
        T = x.shape[0]
        while t < T:
            if not self._bn or self._bn[-1] >= self._bucket_size:
                self._bn.append(0)
                self._bs1.append(np.zeros_like(self._s1))
                self._bs2.append(np.zeros_like(self._s2))
            take = min(self._bucket_size - self._bn[-1], T - t)
            self._bn[-1] += take
            self._bs1[-1] += x[t:t + take].sum(axis=0)
            self._bs2[-1] += x2[t:t + take].sum(axis=0)
            t += take
            if len(self._bn) > self._max_buckets:
                self._merge_buckets()

    def _merge_buckets(self) -> None:
        """Pairwise-merge adjacent buckets, doubling the granularity."""
        bn, bs1, bs2 = [], [], []
        for i in range(0, len(self._bn), 2):
            if i + 1 < len(self._bn):
                bn.append(self._bn[i] + self._bn[i + 1])
                bs1.append(self._bs1[i] + self._bs1[i + 1])
                bs2.append(self._bs2[i] + self._bs2[i + 1])
            else:
                bn.append(self._bn[i])
                bs1.append(self._bs1[i])
                bs2.append(self._bs2[i])
        self._bn, self._bs1, self._bs2 = bn, bs1, bs2
        self._bucket_size *= 2

    @staticmethod
    def _half_stats(bn, bs1, bs2):
        n = sum(bn)
        s1 = sum(bs1)
        s2 = sum(bs2)
        mean = s1 / n                                     # [C, d]
        var = (s2 - n * mean * mean) / (n - 1)            # [C, d] ddof=1
        return n, mean, var

    def rhat(self):
        """Per-parameter streaming split-R̂ (None until >= 8 draws): each
        chain splits at the bucket boundary nearest n/2, and the classic
        R̂ runs over the 2C half-chains (Vehtari et al. 2021 eq. 4 form;
        :func:`demcmc_tpu_torch.diagnostics.split_rhat` is the exact
        post-hoc equivalent)."""
        if self.n < 8 or len(self._bn) < 2:
            return None
        # bucket boundary nearest the midpoint (both sides non-empty)
        cum = np.cumsum(self._bn)
        j = int(np.argmin(np.abs(cum[:-1] - self.n / 2))) + 1
        nA, meanA, varA = self._half_stats(
            self._bn[:j], self._bs1[:j], self._bs2[:j])
        nB, meanB, varB = self._half_stats(
            self._bn[j:], self._bs1[j:], self._bs2[j:])
        if nA < 2 or nB < 2:
            return None
        means = np.concatenate([meanA, meanB], axis=0)    # [2C, d]
        vars = np.concatenate([varA, varB], axis=0)       # [2C, d]
        n_half = 0.5 * (nA + nB)
        W = vars.mean(axis=0)                             # [d]
        B_over_n = means.var(axis=0, ddof=1)              # [d]
        var_plus = (n_half - 1) / n_half * W + B_over_n
        with np.errstate(divide="ignore", invalid="ignore"):
            r = np.sqrt(var_plus / W)
        return r

    def max_rhat(self):
        r = self.rhat()
        return None if r is None else float(np.nanmax(r))

    def ess_stream(self):
        """Per-parameter streaming ESS, summed over chains (None until
        >= 4 draws): Geyer's initial-monotone-positive-sequence estimator
        (Vehtari et al. 2021 §3.2) on the per-chain bucket-mean series.
        Batches of size b keep the long-run variance (``sigma2_inf(batch
        means) = sigma2_inf / b``), so ``ESS_c = n * var_c / (b *
        sigma2_bm)`` with ``sigma2_bm`` estimated spectrally from the
        <= 512 stored bucket means.  Falls back to the lag-1 estimate
        while fewer than 16 full buckets exist."""
        full = [i for i in range(len(self._bn))
                if self._bn[i] == self._bucket_size]
        K = len(full)
        if K < 16:
            return self.ess_rough()
        b = self._bucket_size
        means = np.stack([self._bs1[i] for i in full]) / b   # [K, C, d]
        s1 = np.sum([self._bs1[i] for i in full], axis=0)
        s2 = np.sum([self._bs2[i] for i in full], axis=0)
        n_used = K * b
        mu = s1 / n_used
        var = (s2 - n_used * mu * mu) / (n_used - 1)         # [C, d]
        # per-(chain, param) autocovariance of the bucket-mean series
        xc = means - means.mean(axis=0)
        size = 2 ** int(np.ceil(np.log2(2 * K)))
        f = np.fft.rfft(xc, n=size, axis=0)
        acov = np.fft.irfft(f * np.conj(f), n=size,
                            axis=0)[:K].real / K             # [K, C, d]
        # Geyer: sigma2 = -c0 + 2 * sum of the initial monotone positive
        # sequence of paired sums G_m = c_{2m} + c_{2m+1}
        sigma2 = -acov[0]
        run_min = np.full_like(acov[0], np.inf)
        alive = np.ones(acov[0].shape, dtype=bool)
        for m in range(K // 2):
            g = acov[2 * m] + acov[2 * m + 1]
            alive = alive & (g > 0)
            run_min = np.minimum(run_min, g)
            sigma2 = sigma2 + 2.0 * np.where(alive, run_min, 0.0)
        with np.errstate(divide="ignore", invalid="ignore"):
            per_chain = n_used * var / (b * np.maximum(sigma2, 1e-300))
        return np.nansum(np.minimum(per_chain, n_used), axis=0)

    def ess_rough(self):
        """Per-parameter rough ESS from the streaming lag-1
        autocorrelation, summed over chains (None until >= 4 draws).
        Prefer :meth:`ess_stream`, which is accurate beyond AR(1)."""
        if self.n < 4:
            return None
        n = self.n
        mean = self._s1 / n
        var = (self._s2 - n * mean * mean) / n
        # autocovariance at lag 1 around the running mean
        cov1 = self._sx1 / (n - 1) - mean * mean
        with np.errstate(divide="ignore", invalid="ignore"):
            rho1 = np.clip(cov1 / var, -0.999, 0.999)
            per_chain = n * (1.0 - rho1) / (1.0 + rho1)
        return np.nansum(per_chain, axis=0)
