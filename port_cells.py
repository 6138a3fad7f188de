"""The cells of the PyTorch/CUDA port's slices from the third on (LBA,
ABC binomial, discrete binomial; abc_kde, the unfused Gaussian, LNR; the
DE-MCz, blocked and hierarchical cells; the optimization cells; the
fresh-noise abc_kde, the fixed-noise ABC binomial, the custom slots and
Lotka–Volterra): their
sizes and run lengths, the float64 posterior oracles and the gates that
``chip_smoke.py`` holds the GPU's ``sample()`` to, and that
``tools/port_oracles_cpu.py`` holds the JAX package and the port's plain
path to on the CPU.

numpy and scipy only: nothing of either package, so an oracle stays
independent of the code it judges.
"""

import numpy as np

# The cells.  LBA: bench.py:173-176 (100 trials, 4,096 chains); ABC:
# binomial.make(N=10, k=6, abc=True, fresh_noise=True) at n_sim = 10,000
# (Binomial_ABC.jl); discrete: discrete_binomial.make(n_groups=256) with
# the model's Np = 12 (3,072 chains).  Run lengths: the JAX package's XLA
# step on the CPU reads max R̂ 1.0105 for LBA and 1.019 for the discrete
# binomial at 3,000 iterations, so those two cells run until it meets
# R̂ < 1.01 with room (tools/port_oracles_cpu.py, PERF.md).
LBA_CELL = dict(n_groups=256, Np=16, burnin=1000, n_iter=5000)
ABC_CELL = dict(n_groups=512, Np=8, burnin=1000, n_iter=3000)
DISC_CELL = dict(n_groups=256, Np=12, burnin=1000, n_iter=11000)
N_SIM = 10_000
RHAT_MAX = 1.01           # max rank-normalized R̂ of every cell
# LBA: each posterior mean within LBA_MEAN_SD oracle sds of the oracle's,
# each sd within LBA_SD_REL of the oracle's; the oracle's ESS at least
# LBA_MIN_ESS.  Discrete: the same for N and p against the exact oracle,
# fixed before the GPU's run from the JAX package's CPU run of the cell,
# which reads 0.0016 sd off and sd +0.78% at worst (PERF.md).
LBA_MEAN_SD, LBA_SD_REL, LBA_MIN_ESS = 0.1, 0.1, 10_000
DISC_MEAN_SD, DISC_SD_REL = 0.05, 0.05


def lba_log_posterior64(x, choice, rt, min_rt):
    """float64 LBA log posterior of ``x [n, 5]`` (ν₀, ν₁, A, k, τ), written
    from Brown & Heathcote (2008) with drift sd 1 and the exact normal
    CDF: Normal(1, 5) priors on ν, Normal(0.8, 0.2) on A, Normal(0.2, 0.1)
    on k, Uniform(0, min_rt) on τ; the chosen accumulator's defective
    density times the other's survivor."""
    from scipy.special import ndtr
    c0 = 0.5 * np.log(2.0 * np.pi)

    def normlp(v, mu, sd):
        return -0.5 * ((v - mu) / sd) ** 2 - np.log(sd) - c0

    x = np.atleast_2d(np.asarray(x, np.float64))
    out = np.empty(len(x))
    for s0 in range(0, len(x), 20_000):
        xs = x[s0:s0 + 20_000]
        nu, A, k, tau = xs[:, :2], xs[:, 2:3], xs[:, 3:4], xs[:, 4:5]
        prior = (normlp(nu, 1.0, 5.0).sum(1) + normlp(A[:, 0], 0.8, 0.2)
                 + normlp(k[:, 0], 0.2, 0.1) - np.log(min_rt))
        t = rt[None, :] - tau
        ok = ((nu >= 0).all(1) & (A[:, 0] > 0) & (k[:, 0] >= 0)
              & (tau[:, 0] >= 0) & (tau[:, 0] <= min_rt) & (t > 0).all(1))
        t = np.where(t > 0, t, 1.0)
        b = A + k
        ll = np.zeros(t.shape)
        for i in (0, 1):
            v = nu[:, i:i + 1]
            z1, z2 = (k - t * v) / t, (b - t * v) / t
            d1, d2 = np.exp(-0.5 * z1 * z1 - c0), np.exp(-0.5 * z2 * z2 - c0)
            P1, P2 = ndtr(z1), ndtr(z2)
            pdf = (-v * P1 + d1 + v * P2 - d2) / A
            cdf = 1.0 + (k - t * v) / A * P1 - (b - t * v) / A * P2 \
                + t / A * (d1 - d2)
            with np.errstate(divide="ignore", invalid="ignore"):
                ll += np.where(choice[None, :] == i,
                               np.log(np.maximum(pdf, 1e-300)),
                               np.log(np.maximum(1.0 - cdf, 1e-300)))
        out[s0:s0 + 20_000] = np.where(ok, prior + ll.sum(1), -np.inf)
    return out


def _laplace_importance(logpost_y, y, n_draws, seed):
    """Self-normalised importance sampling of a posterior in unconstrained
    coordinates: the MAP from ``y`` (Nelder–Mead, then BFGS), the Laplace
    covariance (central differences), a multivariate-t(5) proposal with
    that covariance × 1.3, ``n_draws`` draws.  Returns the draws and their
    normalised weights."""
    from scipy import optimize, stats
    for method in ("Nelder-Mead", "BFGS"):
        y = optimize.minimize(lambda v: -logpost_y(v)[0], y, method=method,
                              options={"maxiter": 40_000}).x
    k = len(y)
    h, eye = 1e-4, np.eye(k)
    H = np.empty((k, k))
    for i in range(k):
        for j in range(k):
            a, b = eye[i] * h, eye[j] * h
            H[i, j] = (logpost_y(y + a + b)[0] - logpost_y(y + a - b)[0]
                       - logpost_y(y - a + b)[0]
                       + logpost_y(y - a - b)[0]) / (4 * h * h)
    prop = stats.multivariate_t(loc=y, shape=np.linalg.inv(-H) * 1.3, df=5,
                                seed=np.random.default_rng(seed))
    Y = prop.rvs(n_draws)
    lw = logpost_y(Y) - prop.logpdf(Y)
    w = np.exp(lw - lw.max())
    return Y, w / w.sum()


def _moments(X, w):
    """(mean, sd, effective sample size) of weighted draws."""
    mean = w @ X
    return mean, np.sqrt(w @ (X - mean) ** 2), float(1.0 / np.sum(w * w))


def lba_oracle(choice, rt, n_draws=200_000, seed=0):
    """Posterior means and sds of (ν₀, ν₁, A, k, τ) by importance sampling
    (:func:`_laplace_importance`) in the unconstrained coordinates (log ν,
    log A, log k, logit τ/min_rt).  Returns (mean, sd, effective sample
    size)."""
    from scipy.special import expit, logit
    choice = np.asarray(choice, np.int64)
    rt = np.asarray(rt, np.float64)
    min_rt = float(np.float32(rt.min()))

    def to_x(y):
        y = np.atleast_2d(y)
        return np.column_stack([np.exp(y[:, :4]), min_rt * expit(y[:, 4])])

    def logpost_y(y):
        y = np.atleast_2d(y)
        jac = (y[:, :4].sum(1) + np.log(min_rt) + np.log(expit(y[:, 4]))
               + np.log(expit(-y[:, 4])))
        return lba_log_posterior64(to_x(y), choice, rt, min_rt) + jac

    x0 = np.array([3.0, 2.0, 0.8, 0.2, 0.9 * min_rt])
    y = np.concatenate([np.log(x0[:4]), [logit(x0[4] / min_rt)]])
    Y, w = _laplace_importance(logpost_y, y, n_draws, seed)
    return _moments(to_x(Y), w)


def lba_gate(draws, oracle):
    """(ok, (mean, sd, mean off in oracle sds, |sd / oracle sd − 1|)) of
    ``draws [n, 5, C]`` against ``lba_oracle``'s result."""
    mean, sd, _ = oracle
    x = np.moveaxis(np.asarray(draws, np.float64), 1, -1).reshape(-1, 5)
    m, s = x.mean(0), x.std(0, ddof=1)
    dm, ds = np.abs(m - mean) / sd, np.abs(s / sd - 1.0)
    return (bool((dm < LBA_MEAN_SD).all() and (ds < LBA_SD_REL).all()),
            (m, s, dm, ds))


def discrete_oracle(data, n_max=40, n_p=20_001):
    """Exact float64 posterior of (N, p) under N ~ U{0..40}, p ~ U(0, 1):
    for each integer N the binomial likelihood of the data integrated over
    p on a uniform grid of ``n_p`` points (p = 0 and 1 left out, where
    the integrand is 0).  Returns {"N": (mean, sd), "p": (mean, sd)}."""
    from scipy.special import gammaln
    k = np.asarray(data, np.float64)
    p = np.linspace(0.0, 1.0, n_p)[1:-1]
    logw = np.full((n_max + 1, p.size), -np.inf)
    for N in range(int(k.max()), n_max + 1):
        logw[N] = (np.sum(gammaln(N + 1.0) - gammaln(k + 1.0)
                          - gammaln(N - k + 1.0))
                   + k.sum() * np.log(p) + (N * k.size - k.sum())
                   * np.log1p(-p))
    w = np.exp(logw - logw.max())
    w /= w.sum()
    out = {}
    for name, v, wv in (("N", np.arange(n_max + 1.0), w.sum(1)),
                        ("p", p, w.sum(0))):
        m = float(wv @ v)
        out[name] = (m, float(np.sqrt(wv @ (v - m) ** 2)))
    return out


def discrete_gate(N, p, oracle):
    """(ok, {name: (mean, sd, mean off in oracle sds, |sd / oracle sd −
    1|)}) of the draws of N and p against ``discrete_oracle``'s result."""
    rows, ok = {}, True
    for name, v in (("N", N), ("p", p)):
        v = np.asarray(v, np.float64)
        mean, sd = float(v.mean()), float(v.std(ddof=1))
        tm, ts = oracle[name]
        dm, ds = abs(mean - tm) / ts, abs(sd / ts - 1.0)
        ok = ok and dm < DISC_MEAN_SD and ds < DISC_SD_REL
        rows[name] = (mean, sd, dm, ds)
    return ok, rows


# ---------------------------------------------------------------- slice 4
# The unfused step's cells.  abc_kde: the model's own widths
# (demcmc_tpu/models/abc_kde.py:22-24: 50 observations, 10,000
# simulations per evaluation, Np = 6) at G = 512, 3,072 chains; data and
# panel from numpy seeds 0 and 7.  The 4,096-chain Gaussian of the main
# path, through the unfused step.  LNR: the model's Np = 24 and its
# default data (``demcmc_tpu_torch/models/lnr.py::make``: 100 trials from
# numpy seed 0, ν = (−2, −2, −3, −3), τ = 0.5) at G = 128, 3,072 chains.
# Run lengths: fixed from the JAX package's XLA step on the CPU before the
# GPU's run (tools/port_oracles_cpu.py, PERF.md).
KDE_CELL = dict(n_groups=512, Np=6, burnin=1000, n_iter=3000)
GAUSS_UNFUSED_CELL = dict(n_groups=256, Np=16, burnin=1000, n_iter=3000)
LNR_CELL = dict(n_groups=128, Np=24, burnin=2000, n_iter=6000)
KDE_N_OBS, KDE_N_SIM, KDE_FLOOR = 50, 10_000, 1e-10
# abc_kde: posterior means and sds of (μ, σ) within KDE_TOL of the grid
# quadrature, as the Gaussian cells; LNR: each posterior mean and sd within
# LNR_RTOL relative of the importance-sampling oracle, the reference's
# tolerance against NUTS (test/lognormal_race_tests.jl), with the oracle's
# ESS at least LNR_MIN_ESS.
KDE_TOL, LNR_RTOL, LNR_MIN_ESS = 0.01, 0.05, 10_000


def kde_inputs(key=0, sim_key=7):
    """The abc_kde cell's data ``[50]`` and panel ``[10,000]``, float32,
    from numpy seeds (``models/abc_kde.py``'s defaults)."""
    return (np.random.default_rng(key).standard_normal(KDE_N_OBS)
            .astype(np.float32),
            np.random.default_rng(sim_key).standard_normal(KDE_N_SIM)
            .astype(np.float32))


def _silverman64(s):
    """Silverman's bandwidth of ascending ``s`` in float64: 0.9 · min(sd,
    IQR / 1.34) · n^(−1/5)."""
    std = s.std()
    iqr = np.quantile(s, 0.75) - np.quantile(s, 0.25)
    width = min(std, iqr / 1.34)
    return 0.9 * (width if width > 0 else max(std, 1e-6)) * len(s) ** -0.2


def kde_log_like64(mu, sigma, data, noise):
    """The fixed-panel synthetic log likelihood in float64 at (μ, σ > 0)
    of any shape: the simulations are μ + σ·noise, whose bandwidth is
    σ·h₀ (h₀ the panel's), so the KDE at x is f₀((x − μ)/σ)/σ with f₀ the
    panel's own KDE, evaluated exactly from prefix sums of the sorted
    panel over each kernel's window; Σ over the data of log(max(·,
    1e-10))."""
    s = np.sort(np.asarray(noise, np.float64))
    n = len(s)
    h0 = _silverman64(s)
    p1 = np.concatenate([[0.0], np.cumsum(s)])
    p2 = np.concatenate([[0.0], np.cumsum(s * s)])
    mu, sigma = np.asarray(mu, np.float64), np.asarray(sigma, np.float64)
    out = np.zeros(np.broadcast(mu, sigma).shape)
    for x in np.asarray(data, np.float64):
        y = (x - mu) / sigma
        lo = np.searchsorted(s, y - h0, "left")
        hi = np.searchsorted(s, y + h0, "right")
        cnt, s1, s2 = hi - lo, p1[hi] - p1[lo], p2[hi] - p2[lo]
        tot = cnt - (cnt * y * y - 2.0 * y * s1 + s2) / (h0 * h0)
        dens = 0.75 * tot / (n * h0) / sigma
        out += np.log(np.maximum(dens, KDE_FLOOR))
    return out


def kde_oracle(data, noise, n_grid=301):
    """Posterior means and sds of (μ, σ) under the fixed-panel synthetic
    likelihood, μ ~ Normal(0, 1), σ ~ half-Cauchy(0, 1), by quadrature on
    an ``n_grid``² grid over x̄ ± 6 s/√n × [0.4 s, 2.5 s] (s the data's
    sd), in float64.  Returns {"mu": (mean, sd), "sigma": (mean, sd)};
    raises if the grid's edge holds mass."""
    x = np.asarray(data, np.float64)
    m, sd = x.mean(), x.std()
    mu = np.linspace(m - 6 * sd / np.sqrt(len(x)),
                     m + 6 * sd / np.sqrt(len(x)), n_grid)
    sg = np.linspace(0.4 * sd, 2.5 * sd, n_grid)
    MU, SG = np.meshgrid(mu, sg, indexing="ij")
    logp = (-0.5 * MU ** 2 - np.log1p(SG ** 2)
            + kde_log_like64(MU, SG, x, noise))
    w = np.exp(logp - logp.max())
    w /= w.sum()
    edge = max(w[0].max(), w[-1].max(), w[:, 0].max(), w[:, -1].max())
    if edge > 1e-6 * w.max():
        raise ValueError("the grid's edge holds posterior mass")
    out = {}
    for name, v in (("mu", MU), ("sigma", SG)):
        mean = float((w * v).sum())
        out[name] = (mean, float(np.sqrt((w * (v - mean) ** 2).sum())))
    return out


def kde_gate(mu, sigma, oracle):
    """(ok, {name: (mean, sd)}) of draws of μ and σ: each mean and sd
    within KDE_TOL of the oracle's (``kde_oracle``, ``kde_fresh_oracle``)."""
    rows, ok = {}, True
    for name, v in (("mu", mu), ("sigma", sigma)):
        v = np.asarray(v, np.float64)
        mean, sd = float(v.mean()), float(v.std(ddof=1))
        tm, ts = oracle[name]
        ok = ok and abs(mean - tm) < KDE_TOL and abs(sd - ts) < KDE_TOL
        rows[name] = (mean, sd)
    return ok, rows


def lnr_log_posterior64(x, choice, rt, min_rt):
    """float64 LNR log posterior of ``x [n, 5]`` (ν₀..ν₃, τ), written from
    the model (σ = 1): Normal(0, 3) priors on ν, Uniform(0, min_rt) on τ;
    each trial the winner's lognormal density at rt − τ and the others'
    log survivors log Φ(−z)."""
    from scipy.special import log_ndtr
    x = np.atleast_2d(np.asarray(x, np.float64))
    out = np.empty(len(x))
    onehot = np.eye(4)[choice]                            # [T, 4]
    c0 = 0.5 * np.log(2.0 * np.pi)
    for s0 in range(0, len(x), 20_000):
        xs = x[s0:s0 + 20_000]
        nu, tau = xs[:, :4], xs[:, 4:5]
        prior = ((-0.5 * (nu / 3.0) ** 2 - np.log(3.0) - c0).sum(1)
                 - np.log(min_rt))
        t = rt[None, :] - tau
        ok = (t > 0).all(1) & (tau[:, 0] >= 0) & (tau[:, 0] <= min_rt)
        lt = np.log(np.where(t > 0, t, 1.0))[:, :, None]
        z = lt - nu[:, None, :]
        ll = (onehot * (-lt - c0 - 0.5 * z * z)
              + (1.0 - onehot) * log_ndtr(-z)).sum((1, 2))
        out[s0:s0 + 20_000] = np.where(ok, prior + ll, -np.inf)
    return out


def lnr_oracle(choice, rt, n_draws=200_000, seed=0):
    """Posterior means and sds of (ν₀..ν₃, τ) by importance sampling
    (:func:`_laplace_importance`) in the coordinates (ν, logit τ/min_rt).
    Returns (mean, sd, effective sample size)."""
    from scipy.special import expit, logit
    choice = np.asarray(choice, np.int64)
    rt = np.asarray(rt, np.float64)
    min_rt = float(np.float32(rt.min()))

    def to_x(y):
        y = np.atleast_2d(y)
        return np.column_stack([y[:, :4], min_rt * expit(y[:, 4])])

    def logpost_y(y):
        y = np.atleast_2d(y)
        jac = (np.log(min_rt) + np.log(expit(y[:, 4]))
               + np.log(expit(-y[:, 4])))
        return lnr_log_posterior64(to_x(y), choice, rt, min_rt) + jac

    y = np.array([-2.0, -2.0, -3.0, -3.0, logit(0.8)])
    Y, w = _laplace_importance(logpost_y, y, n_draws, seed)
    return _moments(to_x(Y), w)


def lnr_gate(draws, oracle):
    """(ok, (mean, sd, |mean / oracle mean − 1|, |sd / oracle sd − 1|)) of
    ``draws [n, 5, C]`` against ``lnr_oracle``'s result: each within
    LNR_RTOL."""
    mean, sd, _ = oracle
    x = np.moveaxis(np.asarray(draws, np.float64), 1, -1).reshape(-1, 5)
    m, s = x.mean(0), x.std(0, ddof=1)
    dm, ds = np.abs(m / mean - 1.0), np.abs(s / sd - 1.0)
    return (bool((dm < LNR_RTOL).all() and (ds < LNR_RTOL).all()),
            (m, s, dm, ds))


# ---------------------------------------------------------------- slice 6
# DE-MCz as users call it.  mcz-mig: bench.py:216-219's DE-MCz Gaussian
# (G = 128 × Np = 4, n_initial = 50, burn-in 1,000, θs = 0.1, synchronous)
# with the reference's default α = 0.1 in place of that entry's α = 0
# (K3, and K2 between K3 windows).  blocked: the 4,096-chain bench Gaussian
# (G = 256 × Np = 16) with the blocks (μ), (σ) swept every iteration, the
# configuration of tests/test_blocking.py:15-18 (K1 with two blocks).
# hier: the hierarchical model at its full width (20 subjects × 50
# observations from numpy seed 0, d = 23, Np = 3 × 2 groups, DE-MCz with
# snooker 0.1, α = 0.1, two blocks, burn-in 2,000), through the unfused
# step.  Run lengths: fixed from the JAX package's XLA step on the CPU
# before the GPU's run (tools/port_oracles_cpu.py, PERF.md): mcz-mig meets
# its gates at 5,000 iterations (max R̂ 1.0024, means within 5e-4 of the
# oracle; 1.0005 at 20,000), blocked at 3,000 (1.0037).
MCZ_MIG_CELL = dict(n_groups=128, Np=4, n_initial=50, burnin=1000,
                    theta_snooker=0.1, alpha=0.1, n_iter=5000)
BLOCKED_CELL = dict(n_groups=256, Np=16, burnin=1000, n_iter=3000,
                    blocks=((True, False), (False, True)))
HIER_CELL = dict(n_subj=20, n_data=50, key=0, burnin=2000, n_iter=22_000)
# The JAX package's XLA step on the CPU reads max R̂ 1.06–1.15 for the
# hierarchical cell at 6,000 to 40,000 kept draws (1.034 at 60,000): R̂ <
# 1.01 is out of reach at 6 chains, so its R̂ is written down, not gated.
# μβ0 mixes slowly: over nine keys of the JAX run the gate below fails
# 3 times at 6,000 kept draws, 2 at 10,000, 1 at 15,000 and none at
# 20,000 (μβ0 0.122 off at worst, the limit 0.130), so the cell keeps
# 20,000.
# Its gate: the posterior means of μβ0, σβ0 and σ within
# |mean − oracle| <= HIER_ATOL + HIER_RTOL·|oracle| (the JAX package's HMC
# test, tests/test_hierarchical_vs_hmc.py:45-52), each β0ᵢ's within
# HIER_B0_ATOL of the oracle's
HIER_RTOL, HIER_ATOL, HIER_B0_ATOL = 0.1, 0.05, 0.15


def _hier_logpost64(mu, a, c, ybar, ssw, n):
    """float64 log posterior of the hierarchical Gaussian with the
    subject effects integrated out, in (μβ0, a = log σβ0, c = log σ) with
    the Jacobian σβ0·σ: μβ0 ~ N(1, 1), σβ0 and σ half-Cauchy(0, 1), and
    per subject the within sum of squares ``ssw`` at σ² and the subject
    mean ``ybar`` ~ N(μβ0, σβ0² + σ²/n).  Broadcasts its three grids."""
    sb2, s2 = np.exp(2.0 * a), np.exp(2.0 * c)
    v = sb2 + s2 / n                              # var of a subject mean
    lp = -0.5 * (mu - 1.0) ** 2 + 2 * np.log(2.0 / np.pi) \
        - np.log1p(sb2) - np.log1p(s2) + a + c
    S = len(ybar)
    lp = lp - 0.5 * (n - 1) * S * np.log(s2) - ssw.sum() / (2.0 * s2) \
        - 0.5 * S * np.log(v)
    for yb in ybar:
        lp = lp - (yb - mu) ** 2 / (2.0 * v)
    return lp


def hier_oracle(data, n_grid=121):
    """Posterior means and sds of μβ0, σβ0 and σ and the posterior means of
    the β0ᵢ, by quadrature: β0 integrated out analytically (normal–normal
    given μβ0, σβ0, σ), a coarse grid over (μβ0, log σβ0, log σ) to find
    where the posterior lives, then an ``n_grid``³ grid over the box where
    the log posterior is within 30 of its peak; E[β0ᵢ | y] from the
    conditional means σβ0² / (σβ0² + σ²/n) · (ȳᵢ − μβ0)."""
    y = np.asarray(data, np.float64)
    n = y.shape[1]
    ybar = y.mean(1)
    ssw = ((y - ybar[:, None]) ** 2).sum(1)
    box = [(ybar.mean() - 4.0, ybar.mean() + 4.0), (-6.0, 4.0),
           (-5.0, 3.0)]
    for m in (101, n_grid):
        axes = [np.linspace(lo, hi, m) for lo, hi in box]
        lp = _hier_logpost64(axes[0][:, None, None], axes[1][None, :, None],
                             axes[2][None, None, :], ybar, ssw, n)
        keep = lp > lp.max() - 30.0
        step = [ax[1] - ax[0] for ax in axes]
        box = [(ax[np.flatnonzero(keep.any(axis=tuple(j for j in range(3)
                                                       if j != i)))].min()
                - step[i],
                ax[np.flatnonzero(keep.any(axis=tuple(j for j in range(3)
                                                      if j != i)))].max()
                + step[i]) for i, ax in enumerate(axes)]
    w = np.exp(lp - lp.max())
    w /= w.sum()
    mu = axes[0][:, None, None]
    sb2 = np.exp(2.0 * axes[1])[None, :, None]
    s2 = np.exp(2.0 * axes[2])[None, None, :]
    out = {}
    for name, x in (("mu_b0", mu + 0 * w), ("sigma_b0", np.sqrt(sb2) + 0 * w),
                    ("sigma", np.sqrt(s2) + 0 * w)):
        mean = float((w * x).sum())
        out[name] = (mean, float(np.sqrt((w * (x - mean) ** 2).sum())))
    shrink = sb2 / (sb2 + s2 / n)
    out["b0"] = np.array([float((w * shrink * (yb - mu)).sum())
                          for yb in ybar])
    out["mass_at_edge"] = bool(
        any(keep.take(0, axis=i).any() or keep.take(-1, axis=i).any()
            for i in range(3)))
    return out


def hier_gate(means, b0_means, oracle):
    """(ok, rows) of the posterior means ``{name: mean}`` of μβ0, σβ0 and σ
    and ``b0_means [S]`` against :func:`hier_oracle`'s result: rows[name]
    = (mean, oracle mean, |diff|, allowed)."""
    rows, ok = {}, True
    for name in ("mu_b0", "sigma_b0", "sigma"):
        want = oracle[name][0]
        diff, lim = abs(means[name] - want), HIER_ATOL + HIER_RTOL * abs(want)
        rows[name] = (means[name], want, diff, lim)
        ok = ok and diff <= lim
    db0 = float(np.abs(np.asarray(b0_means) - oracle["b0"]).max())
    rows["b0"] = (db0, HIER_B0_ATOL)
    return ok and db0 <= HIER_B0_ATOL, rows


# ---------------------------------------------------- slice 7: optimization
#
# opt-rastrigin: the 2-d Rastrigin (A = 10, U(−5, 5)) minimized in float32
# through K1's greedy min accept at the width of the fused cells, G = 256 ×
# Np = 16, burn-in 1,000, 3,000 iterations, α = 0.1, key 0.  opt-mle: the
# bench Gaussian (50 observations from numpy seed 0) maximized with the
# objective alone through K1's greedy max accept, the same size.  The two
# float64 cells are the reference's own, through the unfused step:
# examples/optimize.py (Np = 10 × 4 groups, 10,000 iterations, key 0) and
# tests/test_optimization.py::test_gaussian_mle (100 draws of N(2, 1.5)
# from numpy seed 3, Np = 12 × 4, 8,000 iterations, key 1).
OPT_RASTRIGIN_CELL = dict(n_dim=2, n_groups=256, Np=16, burnin=1000,
                          n_iter=3000, key=0)
OPT_MLE_CELL = dict(n_groups=256, Np=16, burnin=1000, n_iter=3000, key=0,
                    n_obs=50, seed=0)
OPT_F64_RASTRIGIN_CELL = dict(n_dim=2, n_groups=4, Np=10, n_iter=10_000,
                              key=0)
OPT_F64_MLE_CELL = dict(n_groups=4, Np=12, n_iter=8000, key=1, n_obs=100,
                        loc=2.0, scale=1.5, seed=3)
# Gates.  float32, fixed from the port's plain path on the CPU at the
# cells' size before the GPU's run (tools/port_oracles_cpu.py opt; PERF.md):
# the Rastrigin's best exactly 0 at keys 0-2, its argmin within 5.1e-5 of
# 0 (the float32 objective is exactly 0 wherever cos(2πx) rounds to 1), so
# best within 4 ulp of A·n = 20 and argmin within 2e-4; the MLE's μ̂ and σ̂
# within 1.7e-4 of the closed form at keys 0-2, where the float32
# objective resolves them to about sqrt(2 ulp(|ll|) / (n / σ²)) ≈ 5e-4, the
# gate.  float64: the reference's own, 1e-8 and 1e-5, and 1e-4.
OPT_BEST_F32 = 4 * float(np.spacing(np.float32(20.0)))
OPT_ARGMIN_F32 = 2e-4
OPT_MLE_F32 = 5e-4
OPT_BEST_F64, OPT_ARGMIN_F64, OPT_MLE_F64 = 1e-8, 1e-5, 1e-4


def opt_mle_data(cell):
    """The MLE cell's observations: float32 standard normals for the
    float32 cell (the bench Gaussian's data), float64 N(loc, scale) draws
    for the reference's float64 cell."""
    rng = np.random.default_rng(cell["seed"])
    if "loc" in cell:
        return rng.normal(cell["loc"], cell["scale"], size=cell["n_obs"])
    return rng.standard_normal(cell["n_obs"]).astype(np.float32)


def rastrigin_gate(best, argmin, best_tol, argmin_tol):
    """(ok, rows): the optimum's value within ``best_tol`` of 0 and its
    location within ``argmin_tol`` of 0 in every dimension."""
    dx = float(np.abs(np.asarray(argmin, dtype=np.float64)).max())
    rows = {"best": (float(best), best_tol), "argmin": (dx, argmin_tol)}
    return abs(float(best)) <= best_tol and dx <= argmin_tol, rows


def mle_gate(mu, sigma, data, tol):
    """(ok, rows): μ̂ and σ̂ within ``tol`` of the closed form, the mean and
    the standard deviation with ddof = 0, in float64."""
    x = np.asarray(data, dtype=np.float64)
    rows = {"mu": (float(mu), float(x.mean())),
            "sigma": (float(sigma), float(x.std()))}
    return all(abs(a - b) <= tol for a, b in rows.values()), rows


# ------------------------------------------------ slice 14: stochastic models
# and custom slots in the unfused step.
#
# kde-fresh: the abc_kde cell's model with fresh_noise=True (the reference
# example's own semantics, Examples/KDE_Example.jl: a new simulation at
# every evaluation), at KDE_CELL's sizes and data.  A pseudo-marginal chain
# targets the prior times the synthetic likelihood averaged over panels,
# E_z[L̂(θ; z)]: the oracle averages kde_log_like64's likelihood over
# KDE_FRESH_PANELS independent panels (numpy seeds 1000 + m, logsumexp)
# on a KDE_FRESH_GRID² grid.  Each panel moves the fixed-panel posterior
# mean of μ by about σ·mean(z) ≈ 0.01, so the average of 32 sits within
# ~0.002 of the limit.  The gate is kde_gate's KDE_TOL, as the fixed
# cell's: tools/port_oracles_cpu.py kde-fresh runs the JAX package's XLA
# step (96 chains, the cell's length) through it, 0.0048 off at worst
# (PERF.md).
KDE_FRESH_CELL = dict(KDE_CELL)
KDE_FRESH_PANELS, KDE_FRESH_GRID = 32, 201
# abc-fixed: the fixed-noise ABC binomial (binomial.make(N=10, k=6,
# abc=True), Binomial_ABC.jl's model with common random numbers) at
# ABC_CELL's 4,096 chains and n_sim = 10,000, its [n_sim, N] uniform panel
# from numpy seed ABC_PANEL_SEED.  Its likelihood is a step function of θ:
# simulation s hits k exactly for θ in (u_s,(k), u_s,(k+1)], its k-th and
# (k+1)-th smallest uniforms, so the posterior under the U(0, 1) prior has
# exact moments (abc_fixed_oracle); the gate ABC_FIXED_TOL.
ABC_FIXED_CELL = dict(ABC_CELL, N=10, k=6)
ABC_PANEL_SEED, ABC_FIXED_TOL = 123, 0.01
# custom: the unfused 4,096-chain Gaussian (GAUSS_UNFUSED_CELL's sizes and
# data) with custom slots: delegating slots against the built-in run, bit
# for bit, over CUSTOM_BITWISE_ITER iterations; the random-walk proposal
# (σ = 0.15 from its key, the JAX test's bounded start; CUSTOM_RW) within
# the JAX test's bounds (0.05, 0.07) of the quadrature posterior;
# tempering at T = 2 (CUSTOM_TEMPER: the sd of μ above 1.25 times the
# untempered run's; √2 in the limit); always-accept (CUSTOM_ALWAYS
# iterations, acceptance exactly 1).  Lengths fixed on the CPU
# (tests/test_torch_custom_slots.py at 24 chains: the walk's means within
# 0.003 of the posterior's at 1,500 iterations, the sd ratio 1.50).
CUSTOM_BITWISE_ITER = 300
CUSTOM_RW = dict(burnin=750, n_iter=1500, mu_tol=0.05, sigma_tol=0.07)
CUSTOM_TEMPER = dict(burnin=500, n_iter=1500, ratio=1.25)
CUSTOM_ALWAYS = 100
# custom-kde: the tempered fitness (T = 2, the slot taking the cell's panel
# as its fifth argument) on the fresh-noise abc_kde cell (KDE_FRESH_CELL's
# 3,072 chains) for CUSTOM_KDE's iterations: run per cell under vmap, K4's
# vmap rule folds the cells into one launch an evaluation; on one panel
# the slot is half the built-in fitness within CUSTOM_KDE_RTOL relative
# (of 1 + |w|: the same K4 launch on the same simulations, sums of the
# same terms).
CUSTOM_KDE = dict(burnin=150, n_iter=300)
CUSTOM_KDE_RTOL = 1e-6
# lv: Lotka–Volterra at the reference example's width
# (Examples/Predator_Prey_Example.jl; demcmc_tpu/models/lotka_volterra.py:
# Np = 12, 3 groups, 36 chains; data from the true rates (1.5, 1.0, 3.0,
# 1.0) with noise 0.5, numpy seed 0).  One evaluation is 500 RK4 steps of
# elementwise torch operations, about 15,000 launches: the reference's
# 3,000 iterations do not fit the script's budget, so the cell runs
# LV_CELL's n_iter, with its µs per iteration and no posterior gate
# (ROADMAP.md, beside the unfused step's CUDA graph).  Its density on the
# card is held to the CPU's on LV_DENSITY_DRAWS prior draws within
# LV_DENSITY_RTOL / LV_DENSITY_ATOL (the solve has no transcendental, so
# only the likelihood's log and the sums' order differ).
LV_CELL = dict(Np=12, n_groups=3, burnin=50, n_iter=100)
LV_DENSITY_DRAWS, LV_DENSITY_RTOL, LV_DENSITY_ATOL = 4096, 1e-5, 1e-4


def _grid_posterior(data, log_like, n_grid):
    """Posterior means and sds of (μ, σ) under μ ~ Normal(0, 1), σ ~
    half-Cauchy(0, 1) and ``log_like(MU, SG)`` by quadrature on an
    ``n_grid``² grid over x̄ ± 6 s/√n × [0.4 s, 2.5 s], in float64; raises
    if the grid's edge holds mass."""
    x = np.asarray(data, np.float64)
    m, sd = x.mean(), x.std()
    mu = np.linspace(m - 6 * sd / np.sqrt(len(x)),
                     m + 6 * sd / np.sqrt(len(x)), n_grid)
    sg = np.linspace(0.4 * sd, 2.5 * sd, n_grid)
    MU, SG = np.meshgrid(mu, sg, indexing="ij")
    logp = -0.5 * MU ** 2 - np.log1p(SG ** 2) + log_like(MU, SG)
    w = np.exp(logp - logp.max())
    w /= w.sum()
    edge = max(w[0].max(), w[-1].max(), w[:, 0].max(), w[:, -1].max())
    if edge > 1e-6 * w.max():
        raise ValueError("the grid's edge holds posterior mass")
    out = {}
    for name, v in (("mu", MU), ("sigma", SG)):
        mean = float((w * v).sum())
        out[name] = (mean, float(np.sqrt((w * (v - mean) ** 2).sum())))
    return out


def kde_fresh_oracle(data, n_sim=KDE_N_SIM, n_panels=KDE_FRESH_PANELS,
                     n_grid=KDE_FRESH_GRID):
    """Posterior means and sds of (μ, σ) of the fresh-noise abc_kde model:
    the synthetic likelihood averaged over ``n_panels`` panels of
    ``n_sim`` standard normals (numpy seeds 1000 + m), combined by
    logsumexp.  Returns {"mu": (mean, sd), "sigma": (mean, sd)}."""
    x = np.asarray(data, np.float64)

    def log_like(MU, SG):
        ll = np.stack([kde_log_like64(
            MU, SG, x, np.random.default_rng(1000 + m).standard_normal(
                n_sim)) for m in range(n_panels)])
        top = ll.max(0)
        return top + np.log(np.exp(ll - top).mean(0))

    return _grid_posterior(x, log_like, n_grid)


def abc_panel(n_sim, N, seed=ABC_PANEL_SEED):
    """The fixed ABC binomial's ``[n_sim, N]`` float32 uniforms from numpy
    seed ``seed`` (``demcmc_tpu_torch/models/binomial.py::abc_panel``'s
    draw, restated here so the oracle imports neither package)."""
    return np.random.default_rng(seed).random((n_sim, N), dtype=np.float32)


def abc_fixed_oracle(panel, k):
    """Exact posterior mean and sd of θ under the fixed-panel ABC
    likelihood (the fraction of the panel's simulations whose count
    Σ_j 1{u_j < θ} equals ``k``) and θ ~ U(0, 1), in float64: simulation s
    hits for θ in (a_s, b_s], its k-th and (k+1)-th smallest uniforms
    (0 and 1 past the ends), so the moments are sums of (b^p − a^p) / p."""
    u = np.sort(np.asarray(panel, np.float64), axis=1)
    n, N = u.shape
    a = u[:, k - 1] if k > 0 else np.zeros(n)
    b = u[:, k] if k < N else np.ones(n)
    z, m1, m2 = ((b ** p - a ** p).sum() / p for p in (1, 2, 3))
    mean = m1 / z
    return mean, float(np.sqrt(m2 / z - mean * mean))


def abc_fixed_gate(draws, oracle):
    """(ok, (mean, sd)) of draws of θ: mean and sd each within
    ABC_FIXED_TOL of :func:`abc_fixed_oracle`'s."""
    v = np.asarray(draws, np.float64)
    mean, sd = float(v.mean()), float(v.std(ddof=1))
    return (abs(mean - oracle[0]) < ABC_FIXED_TOL
            and abs(sd - oracle[1]) < ABC_FIXED_TOL, (mean, sd))


# ------------------------------------------------ slice 15: replicated runs
#
# rep: bench.py:133-161's packed cell (bench_packed_alpha), the repo's own
# width for replicated runs: R = 64 replications of the Gaussian, each 50
# observations (one [64, 50] standard-normal draw from numpy seed 5), Np =
# 4 × G = 4 (16 chains a replication, 1,024 in all), burn-in 100, α = 0.1.
# Users run such batches for per-subject fits and simulation-based
# calibration: many small runs, each 16 chains.  The bench times 100,000
# iterations; the cell runs REP_CELL's n_iter (burn-in and 10,000 kept
# draws), with room for all 64 replications at the gates below
# (tools/port_oracles_cpu.py rep, PERF.md): each replication's μ and σ
# posterior means within REP_TOL of its own dataset's quadrature
# (models/gaussian.py posterior_grid), max R̂ over every replication and
# parameter < RHAT_MAX.  On the CPU the JAX package's sample_replicated
# reads 0.00542 off at worst and R̂ 1.00503 at a third of the length,
# 0.00315 and 1.00194 at it; the port's plain path on four replications
# 0.00192 and 1.00180.  opt-rep's gate: the JAX package on all 64 datasets
# 3.79e-4 off at worst, the port's plain path on 8 1.87e-4.
# opt-rep: tests/test_replicated.py:105-131's width (G = 2, Np = 12, 60
# observations, 1,500 iterations, burn-in 0) at R = 64: the datasets
# N(μ_r, 1) with μ_r evenly from -2 to 2, numpy seed 4; each MLE within
# OPT_REP_TOL of its dataset's mean and standard deviation (ddof = 0).
REP_CELL = dict(n_reps=64, n_groups=4, Np=4, n_obs=50, seed=5, burnin=100,
                alpha=0.1, n_iter=10_100, key=0)
REP_TOL = 0.01
OPT_REP_CELL = dict(n_reps=64, n_groups=2, Np=12, n_obs=60, seed=4,
                    n_iter=1500, key=2)
OPT_REP_TOL = 1e-3


def rep_datasets(cell=REP_CELL):
    """The replicated cell's datasets ``[R, n_obs]`` float32."""
    return np.random.default_rng(cell["seed"]).normal(
        0.0, 1.0, (cell["n_reps"], cell["n_obs"])).astype(np.float32)


def opt_rep_datasets(cell=OPT_REP_CELL):
    """The replicated optimization cell's datasets ``[R, n_obs]``
    float32: N(μ_r, 1), μ_r evenly spaced over [-2, 2]."""
    mus = np.linspace(-2.0, 2.0, cell["n_reps"])
    return np.random.default_rng(cell["seed"]).normal(
        mus[:, None], 1.0, (cell["n_reps"], cell["n_obs"])).astype(
            np.float32)
