"""Convergence diagnostics: split-R̂, rank-normalized R̂, bulk/tail ESS.

A numpy copy of ``demcmc_tpu.diagnostics`` (Vehtari, Gelman, Simpson,
Carpenter & Bürkner 2021) that needs no scipy: average ranks follow
``scipy.stats.rankdata(method="average")`` and the inverse normal CDF is
the Cephes ``ndtri`` that ``scipy.special.ndtri`` evaluates, with the
same operation order and the C library's ``log`` (``math.log``), so the
results are bitwise those of the JAX package's scipy-based functions.
All host-side float64 — diagnostics are never the hot path.
"""

from __future__ import annotations

import math

import numpy as np

# Cephes ndtri coefficients (scipy's xsf/cephes/ndtri.h)
_S2PI = 2.50662827463100050242E0
_P0 = (-5.99633501014107895267E1, 9.80010754185999661536E1,
       -5.66762857469070293439E1, 1.39312609387279679503E1,
       -1.23916583867381258016E0)
_Q0 = (1.95448858338141759834E0, 4.67627912898881538453E0,
       8.63602421390890590575E1, -2.25462687854119370527E2,
       2.00260212380060660359E2, -8.20372256168333339912E1,
       1.59056225126211695515E1, -1.18331621121330003142E0)
_P1 = (4.05544892305962419923E0, 3.15251094599893866154E1,
       5.71628192246421288162E1, 4.40805073893200834700E1,
       1.46849561928858024014E1, 2.18663306850790267539E0,
       -1.40256079171354495875E-1, -3.50424626827848203418E-2,
       -8.57456785154685413611E-4)
_Q1 = (1.57799883256466749731E1, 4.53907635128879210584E1,
       4.13172038254672030440E1, 1.50425385692907503408E1,
       2.50464946208309415979E0, -1.42182922854787788574E-1,
       -3.80806407691578277194E-2, -9.33259480895457427372E-4)
_P2 = (3.23774891776946035970E0, 6.91522889068984211695E0,
       3.93881025292474443415E0, 1.33303460815807542389E0,
       2.01485389549179081538E-1, 1.23716634817820021358E-2,
       3.01581553508235416007E-4, 2.65806974686737550832E-6,
       6.23974539184983293730E-9)
_Q2 = (6.02427039364742014255E0, 3.67983563856160859403E0,
       1.37702099489081330271E0, 2.16236993594496635890E-1,
       1.34204006088543189037E-2, 3.28014464682127739104E-4,
       2.89247864745380683936E-6, 6.79019408009981274425E-9)
_EXPM2 = 0.13533528323661269189        # exp(-2)


def _polevl(x, coef):
    ans = np.full_like(x, coef[0])
    for c in coef[1:]:
        ans = ans * x + c
    return ans


def _p1evl(x, coef):
    ans = x + coef[0]
    for c in coef[1:]:
        ans = ans * x + c
    return ans


def _libm_log(x: np.ndarray) -> np.ndarray:
    # math.log is the C library's log, which scipy's compiled ndtri calls;
    # numpy's vectorized log differs from it in the last bit on some inputs
    return np.fromiter(map(math.log, x.tolist()), dtype=np.float64,
                       count=x.size)


def ndtri(p) -> np.ndarray:
    """Inverse of the standard normal CDF (Cephes ``ndtri``)."""
    y0 = np.asarray(p, dtype=np.float64)
    shape = y0.shape
    y0 = y0.reshape(-1)
    out = np.full(y0.shape, np.nan)
    out[y0 == 0.0] = -np.inf
    out[y0 == 1.0] = np.inf
    ok = (y0 > 0.0) & (y0 < 1.0)
    y = y0.copy()
    upper = ok & (y > 1.0 - _EXPM2)
    y[upper] = 1.0 - y[upper]
    mid = ok & (y > _EXPM2)
    if mid.any():
        ym = y[mid] - 0.5
        y2 = ym * ym
        xm = ym + ym * (y2 * _polevl(y2, _P0) / _p1evl(y2, _Q0))
        out[mid] = xm * _S2PI
    tail = ok & ~mid
    if tail.any():
        yt = y[tail]
        x = np.sqrt(-2.0 * _libm_log(yt))
        x0 = x - _libm_log(x) / x
        z = 1.0 / x
        small = x < 8.0
        x1 = np.where(small, z * _polevl(z, _P1) / _p1evl(z, _Q1),
                      z * _polevl(z, _P2) / _p1evl(z, _Q2))
        xt = x0 - x1
        out[tail] = np.where(upper[tail], xt, -xt)
    return out.reshape(shape)


def _f32_keys(a: np.ndarray):
    """Order keys ``[n]`` uint32 of float64 ``a`` where every value is a
    float32 (a sampler's draws are) and none is NaN, else None: the bits
    of ``v + 0`` (−0.0 made +0.0), sign bit set on positives and every
    bit flipped on negatives, so the keys order as the values and tie
    exactly where they do."""
    if a.dtype != np.float64 or a.size >= 2 ** 32:
        return None
    f = a.astype(np.float32)
    if not np.array_equal(f, a):        # inexact, out of range, or NaN
        return None
    b = (f + np.float32(0.0)).view(np.uint32)
    return b ^ ((np.uint32(0) - (b >> np.uint32(31)))
                | np.uint32(0x80000000))


def _tie_runs(a: np.ndarray):
    """``a``'s sort order and its runs of equal values: the permutation
    ``sorter`` and, for each run of ties in sorted order, its first
    position and the position past its end (0-based)."""
    # ties are averaged, so the order among them (an unstable sort's, or
    # the index's) does not matter
    key = _f32_keys(a)
    if key is None:
        sorter = np.argsort(a)
        arr = a[sorter]
    else:           # each key above its index: one sort of 64-bit words
        packed = np.sort((key.astype(np.uint64) << np.uint64(32))
                         | np.arange(a.size, dtype=np.uint64))
        sorter = (packed & np.uint64(0xFFFFFFFF)).astype(np.intp)
        arr = packed >> np.uint64(32)
    start = np.flatnonzero(np.r_[True, arr[1:] != arr[:-1]])
    end = np.r_[start[1:], a.size]
    return sorter, start, end


def rankdata_average(a) -> np.ndarray:
    """Average (fractional) ranks, 1-based — ``scipy.stats.rankdata``'s
    ``method="average"`` algorithm: a run of ties at sorted positions
    [start, end) gets (start + end + 1) / 2."""
    a = np.asarray(a).reshape(-1)
    sorter, start, end = _tie_runs(a)
    out = np.empty(a.size)
    out[sorter] = np.repeat(0.5 * (start + end + 1), end - start)
    return out


def _split(x: np.ndarray) -> np.ndarray:
    """[N, C] -> [N//2, 2C]: split each chain in half."""
    n = (x.shape[0] // 2) * 2
    half = n // 2
    return np.concatenate([x[:half], x[half:n]], axis=1)


def _rhat_from_splits(x: np.ndarray) -> float:
    """Classic R̂ on already-split draws [n, m]."""
    n, m = x.shape
    if n < 2 or m < 2:
        return np.nan
    chain_means = x.mean(axis=0)
    chain_vars = x.var(axis=0, ddof=1)
    w = chain_vars.mean()
    b = n * chain_means.var(ddof=1)
    var_plus = (n - 1) / n * w + b / n
    if w <= 0:
        return 1.0 if var_plus <= 0 else np.inf
    return float(np.sqrt(var_plus / w))


def _as2d(x) -> np.ndarray:
    x = np.asarray(x, dtype=np.float64)
    return x[:, None] if x.ndim == 1 else x


def split_rhat(x) -> float:
    """Split-R̂ of draws ``[N, C]`` (N draws, C chains)."""
    return _rhat_from_splits(_split(_as2d(x)))


def _rank_normalize(x: np.ndarray, tables: dict = None) -> np.ndarray:
    """Fractional ranks (ties averaged) -> inverse-normal scores:
    ``ndtri((rankdata_average(x) - 3/8) / (x.size - 3/4 + 1))`` bit for
    bit.  ``tables`` (size S -> table) lets calls on draws of one size
    share their ndtri values: slot k of S's table holds ndtri of the
    quantile of the average rank r = 1 + k/2 (a multiple of 1/2 in [1, S]),
    NaN until a call needs it, so ndtri runs once per distinct rank and not
    once per draw and call; ndtri is elementwise, so a slot holds the
    direct call's value.  None: a table for this call alone."""
    flat = x.reshape(-1)
    size = flat.size
    if size == 0:
        return np.empty(x.shape)
    if tables is None:
        tables = {}
    table = tables.get(size)
    if table is None:
        table = tables[size] = np.full(2 * size - 1, np.nan)
    sorter, start, end = _tie_runs(flat)
    slot = start + end - 1              # 2·rank − 2 of each run
    score = table[slot]
    todo = np.isnan(score)
    if todo.any():
        new = slot[todo]
        r = 1.0 + 0.5 * new
        score[todo] = table[new] = ndtri(
            (r - 3.0 / 8.0) / (size - 2.0 * 3.0 / 8.0 + 1.0))
    z = np.empty(size)
    z[sorter] = score if score.size == size else np.repeat(score,
                                                           end - start)
    return z.reshape(x.shape)


def rank_normalized_rhat(x, tables: dict = None) -> float:
    """max(bulk R̂, tail R̂) — the MCMCChains/Stan default ``rhat``.
    ``tables``: a dict that calls on draws of one size may share, so that
    each rank's inverse-normal score is computed once (:func:`_rank_normalize`;
    None: this call's own)."""
    tables = {} if tables is None else tables
    s = _split(_as2d(x))
    bulk = _rhat_from_splits(_rank_normalize(s, tables))
    folded = np.abs(s - np.median(s))
    tail = _rhat_from_splits(_rank_normalize(folded, tables))
    return float(max(bulk, tail))


def _autocov_fft(x: np.ndarray) -> np.ndarray:
    """Biased autocovariance per chain via FFT.  x: [n, m] -> [n, m]."""
    n, m = x.shape
    xc = x - x.mean(axis=0, keepdims=True)
    size = 2 ** int(np.ceil(np.log2(2 * n)))
    f = np.fft.rfft(xc, n=size, axis=0)
    acov = np.fft.irfft(f * np.conj(f), n=size, axis=0)[:n].real
    return acov / n


def _ess_from_splits(s: np.ndarray) -> float:
    n, m = s.shape
    if n < 4:
        return np.nan
    chain_vars = s.var(axis=0, ddof=1)
    w = chain_vars.mean()
    if w <= 0 or not np.isfinite(w):
        return np.nan
    b = n * s.mean(axis=0).var(ddof=1) if m > 1 else 0.0
    var_plus = (n - 1) / n * w + b / n
    acov = _autocov_fft(s)
    rho = 1.0 - (w - acov.mean(axis=1)) / var_plus
    # Geyer: sum consecutive pairs while positive, enforce monotone decrease
    max_t = (n - 2) if (n - 2) % 2 == 0 else (n - 3)
    pair = rho[:max_t + 2].reshape(-1, 2).sum(axis=1)
    pos = pair > 0
    k = int(np.argmin(pos)) if not pos.all() else len(pair)
    pair = np.minimum.accumulate(pair[:k]) if k > 0 else pair[:0]
    tau = -1.0 + 2.0 * pair.sum()
    tau = max(tau, 1.0 / np.log10(n * m + 10))   # Stan's lower clamp
    return float(n * m / tau)


def ess(x) -> float:
    """Bulk-style ESS of draws ``[N, C]`` (split chains, Geyer's initial
    monotone positive sequence), without rank normalization."""
    return _ess_from_splits(_split(_as2d(x)))


def ess_bulk(x, tables: dict = None) -> float:
    """Rank-normalized bulk ESS (Stan / MCMCChains ``ess_bulk``);
    ``tables`` as in :func:`rank_normalized_rhat`."""
    return _ess_from_splits(_rank_normalize(_split(_as2d(x)), tables))


def ess_tail(x) -> float:
    """Tail ESS: the minimum ESS of the 5% and 95% quantile indicators."""
    x = _as2d(x)
    q05, q95 = np.quantile(x, [0.05, 0.95])
    lo = _ess_from_splits(_split((x <= q05).astype(np.float64)))
    hi = _ess_from_splits(_split((x <= q95).astype(np.float64)))
    return float(min(lo, hi))


def summary_stats(x) -> dict:
    """Posterior summary of draws [N, C]: mean/std/mcse/quantiles/rhat/ess."""
    x = _as2d(x)
    flat = x.reshape(-1)
    e = ess(x)
    return {
        "mean": float(flat.mean()),
        "std": float(flat.std(ddof=1)),
        "mcse": (float(flat.std(ddof=1) / np.sqrt(e))
                 if e and np.isfinite(e) else np.nan),
        "q2.5": float(np.quantile(flat, 0.025)),
        "q50": float(np.quantile(flat, 0.5)),
        "q97.5": float(np.quantile(flat, 0.975)),
        "ess": e,
        "ess_bulk": ess_bulk(x),
        "ess_tail": ess_tail(x),
        "rhat": rank_normalized_rhat(x),
    }
