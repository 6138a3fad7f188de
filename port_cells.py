"""The LBA, ABC binomial and discrete binomial cells of the PyTorch/CUDA
port: their sizes and run lengths, the float64 posterior oracles and the
gates that ``chip_smoke.py`` holds the GPU's ``sample()`` to, and that
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


def lba_oracle(choice, rt, n_draws=200_000, seed=0):
    """Posterior means and sds of (ν₀, ν₁, A, k, τ) by self-normalised
    importance sampling: in the unconstrained coordinates (log ν, log A,
    log k, logit τ/min_rt) the MAP (Nelder–Mead, then BFGS) and the
    Laplace covariance (central differences), a multivariate-t(5)
    proposal with that covariance × 1.3, ``n_draws`` draws.  Returns
    (mean, sd, effective sample size)."""
    from scipy import optimize, stats
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
    for method in ("Nelder-Mead", "BFGS"):
        y = optimize.minimize(lambda v: -logpost_y(v)[0], y, method=method,
                              options={"maxiter": 40_000}).x
    h, eye = 1e-4, np.eye(5)
    H = np.empty((5, 5))
    for i in range(5):
        for j in range(5):
            a, b = eye[i] * h, eye[j] * h
            H[i, j] = (logpost_y(y + a + b)[0] - logpost_y(y + a - b)[0]
                       - logpost_y(y - a + b)[0]
                       + logpost_y(y - a - b)[0]) / (4 * h * h)
    prop = stats.multivariate_t(loc=y, shape=np.linalg.inv(-H) * 1.3, df=5,
                                seed=np.random.default_rng(seed))
    Y = prop.rvs(n_draws)
    lw = logpost_y(Y) - prop.logpdf(Y)
    w = np.exp(lw - lw.max())
    w /= w.sum()
    X = to_x(Y)
    mean = w @ X
    return mean, np.sqrt(w @ (X - mean) ** 2), float(1.0 / np.sum(w * w))


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
