"""The oracles and gates of the port's cells (``port_cells.py``, which
``chip_smoke.py`` holds the GPU's ``sample()`` to): the LBA and LNR
oracles' float64 densities against the JAX models', the LBA importance
sampler on a small data set, the exact discrete oracle against the closed
form of its p integral, the abc_kde oracle's exact window sums against a
direct float64 KDE and the port's float32 density, and the gates on draws
of known moments."""

import jax.numpy as jnp
import numpy as np
import pytest
from scipy.special import betaln, gammaln

import port_cells as pc
import torch
from demcmc_tpu.models import lba as jlba
from demcmc_tpu.models import lnr as jlnr
from demcmc_tpu_torch.models import abc_kde as tabc
from demcmc_tpu_torch.models import lba as tlba
from demcmc_tpu_torch.models import lnr as tlnr

LBA_DATA = tlba.simulate(np.random.default_rng(0), 100, **tlba.TRUE)
LNR_DATA = tlnr.simulate(np.random.default_rng(0), 100, **tlnr.TRUE)


def _lba_points(rng, n):
    """Points within 1.5 posterior sd of the posterior mean (ν ≈ (3.54,
    2.27), A ≈ 0.87, k ≈ 0.24), τ in (0.26, 0.30) (its posterior 0.296 ±
    0.017, min_rt 0.35): no trial's density or survivor reaches the clips
    (1e-30 in the JAX model, 1e-300 in the oracle), which a τ within 0.03
    of the fastest trial does."""
    mean = np.array([3.54, 2.27, 0.87, 0.24])
    sd = np.array([0.47, 0.41, 0.15, 0.077])
    return np.column_stack([mean + 1.5 * sd * rng.uniform(-1.0, 1.0, (n, 4)),
                            rng.uniform(0.26, 0.30, n)])


def test_lba_oracle_density_matches_jax_model():
    """float64 and exact Φ here, the JAX model's A&S erfc (absolute error
    ~1.5e-7, relative to a survivor near 1e-3 it is ~1e-4 in log) there,
    in float64 under the harness's x64, over 100 trials: the log
    posteriors agree within 2e-3 at 200 points around the posterior
    (largest difference 4.6e-4), and τ past min_rt gives −inf."""
    choice, rt = LBA_DATA
    min_rt = float(rt.min())
    jm, _ = jlba.make(data=LBA_DATA)
    x = _lba_points(np.random.default_rng(3), 200)
    x[:3, 4] = min_rt + 0.01              # τ past min_rt: out of bounds
    ours = pc.lba_log_posterior64(x, choice, rt.astype(np.float64), min_rt)
    cols = jnp.asarray(x.T, jnp.float64)
    ref = np.asarray(jm.prior_loglike_batched(cols[:2], cols[2], cols[3],
                                              cols[4])
                     + jm.loglike_batched(jm.data, cols[:2], cols[2],
                                          cols[3], cols[4]))
    assert np.isneginf(ours[:3]).all()
    np.testing.assert_allclose(ours[3:], ref[3:], rtol=0, atol=2e-3)


def test_lba_oracle_importance_sampler_is_stable():
    """The cell's 100 trials, 20,000 draws: the effective sample size is
    over a quarter of the draws (the t(5) proposal fits), and two seeds
    agree to 0.05 posterior sd."""
    a = pc.lba_oracle(*LBA_DATA, n_draws=20_000, seed=0)
    b = pc.lba_oracle(*LBA_DATA, n_draws=20_000, seed=1)
    assert a[2] > 5_000 and b[2] > 5_000
    np.testing.assert_array_less(np.abs(a[0] - b[0]) / a[1], 0.05)
    np.testing.assert_array_less(np.abs(a[1] / b[1] - 1.0), 0.05)


def test_discrete_oracle_matches_beta_closed_form():
    """∫ p^S (1 − p)^(N·n − S) dp = B(S + 1, N·n − S + 1) for each N: the
    grid's moments of N and p agree with the closed form's within 1e-6
    relative."""
    k = np.random.default_rng(0).binomial(10, 0.6, 50).astype(np.float64)
    S, n = k.sum(), k.size
    Ns = np.arange(int(k.max()), 41)
    logw = np.array([np.sum(gammaln(N + 1.0) - gammaln(k + 1.0)
                            - gammaln(N - k + 1.0))
                     + betaln(S + 1, N * n - S + 1) for N in Ns])
    w = np.exp(logw - logw.max())
    w /= w.sum()
    mN = w @ Ns
    Ep = (S + 1) / (Ns * n + 2)
    Ep2 = Ep * (S + 2) / (Ns * n + 3)
    mp = w @ Ep
    out = pc.discrete_oracle(k)
    np.testing.assert_allclose(out["N"], (mN, np.sqrt(w @ (Ns - mN) ** 2)),
                               rtol=1e-6)
    np.testing.assert_allclose(out["p"], (mp, np.sqrt(w @ Ep2 - mp ** 2)),
                               rtol=1e-6)


@pytest.mark.parametrize("shift,scale,ok", [(0.0, 1.0, True),
                                            (0.15, 1.0, False),
                                            (0.0, 1.15, False)])
def test_gates_on_draws_of_known_moments(shift, scale, ok):
    """Draws whose mean is ``shift`` oracle sds off and whose sd is
    ``scale`` times the oracle's pass both gates only when both are
    inside the gates (LBA 0.1 sd and 10%, discrete 0.05 sd and 5%)."""
    rng = np.random.default_rng(1)
    mean, sd = np.array([3.5, 2.3, 0.9, 0.24, 0.3]), np.linspace(0.4, 0.02, 5)
    z = rng.standard_normal((4000, 5, 16))
    z = (z - z.mean((0, 2), keepdims=True)) / z.std((0, 2), ddof=1,
                                                    keepdims=True)
    draws = (mean + shift * sd)[None, :, None] + scale * sd[None, :, None] * z
    assert pc.lba_gate(draws, (mean, sd, 1e5))[0] == ok
    oracle = {"N": (mean[0], sd[0]), "p": (mean[1], sd[1])}
    assert pc.discrete_gate(draws[:, 0], draws[:, 1], oracle)[0] == ok


def test_cells_keep_their_widths():
    """The cells keep their sources' widths: bench.py's 4,096 LBA chains,
    4,096 ABC chains at Binomial_ABC.jl's n_sim = 10,000, 3,072 discrete
    chains; every run keeps at least 2,000 draws past burn-in."""
    for cell, C in ((pc.LBA_CELL, 4096), (pc.ABC_CELL, 4096),
                    (pc.DISC_CELL, 3072)):
        assert cell["n_groups"] * cell["Np"] == C
        assert cell["n_iter"] - cell["burnin"] >= 2000
    assert pc.N_SIM == 10_000 and pc.RHAT_MAX == 1.01
    for cell in (pc.KDE_CELL, pc.LNR_CELL):
        assert cell["n_groups"] * cell["Np"] == 3072
        assert cell["n_iter"] - cell["burnin"] >= 2000
    assert pc.KDE_CELL["Np"] == 6 and pc.LNR_CELL["Np"] == 24
    assert (pc.KDE_N_OBS, pc.KDE_N_SIM) == (50, 10_000)
    assert pc.GAUSS_UNFUSED_CELL["n_groups"] * 16 == 4096


def test_slice4_inputs_are_the_models_defaults():
    """The cells' data come from the port's models' own numpy seeds."""
    data, noise = pc.kde_inputs()
    model, _ = tabc.make()
    np.testing.assert_array_equal(model.data, data)
    assert noise.shape == (10_000,) and data.shape == (50,)
    choice, rt = tlnr.make()[0].data
    assert choice.dtype == np.int64 and rt.dtype == np.float32
    np.testing.assert_array_equal(choice, LNR_DATA[0])
    np.testing.assert_array_equal(rt, LNR_DATA[1])


def test_kde_oracle_likelihood_is_the_direct_kde():
    """The window sums (prefix sums over the sorted panel) equal the
    direct float64 kernel sum with bandwidth σ·h₀, and the port's float32
    density (through the plain version of K4) within 2e-4 relative."""
    data, noise = pc.kde_inputs()
    data, noise = data[:20], noise[:3000]
    mu = np.array([0.0, 0.2, -0.3, 0.14])
    sg = np.array([1.0, 0.8, 1.3, 0.95])
    got = pc.kde_log_like64(mu, sg, data, noise)
    h0 = pc._silverman64(np.sort(noise.astype(np.float64)))
    want = []
    for m, s in zip(mu, sg):
        u = (data[:, None] - m - s * noise[None, :].astype(np.float64)) / (
            s * h0)
        k = np.where(np.abs(u) <= 1, 0.75 * (1 - u * u), 0.0)
        want.append(np.log(np.maximum(k.mean(1) / (s * h0), 1e-10)).sum())
    np.testing.assert_allclose(got, want, rtol=1e-10)
    model, _ = tabc.make(data=data, noise=noise)
    port = model.loglike_batched(None, torch.tensor(mu, dtype=torch.float32),
                                 torch.tensor(sg, dtype=torch.float32))
    np.testing.assert_allclose(port.numpy(), got, rtol=2e-4)


def test_kde_oracle_grid_holds_the_posterior():
    """The cell's oracle: finite moments near the data's mean and sd, no
    mass on the grid's edge (else it raises)."""
    out = pc.kde_oracle(*pc.kde_inputs(), n_grid=101)
    data = pc.kde_inputs()[0]
    assert abs(out["mu"][0] - data.mean()) < 0.05
    assert 0.05 < out["mu"][1] < 0.3 and 0.05 < out["sigma"][1] < 0.3


def test_lnr_oracle_density_matches_jax_model():
    """float64 and scipy's log_ndtr here, float64 under the harness's x64
    there: the LNR log posteriors agree within 1e-8 relative at 50 points,
    and τ past min_rt gives −inf."""
    choice, rt = LNR_DATA
    min_rt = float(rt.min())
    jm, jde = jlnr.make(data=(choice, rt))
    rng = np.random.default_rng(4)
    x = np.column_stack([rng.normal(-2.5, 0.5, (50, 4)),
                         rng.uniform(0.3, 0.99, 50) * min_rt])
    x[:2, 4] = min_rt + 0.01
    ours = pc.lnr_log_posterior64(x, choice, rt.astype(np.float64), min_rt)
    ref = np.array([float(jm.prior_loglike(v[:4], v[4])
                          + jm.loglike(jm.data, v[:4], v[4])) for v in x])
    assert np.isneginf(ours[:2]).all() and np.isneginf(ref[:2]).all()
    np.testing.assert_allclose(ours[2:], ref[2:], rtol=1e-8)


@pytest.mark.parametrize("shift,scale,ok", [(0.0, 1.0, True),
                                            (0.06, 1.0, False),
                                            (0.0, 1.06, False)])
def test_lnr_gate_on_draws_of_known_moments(shift, scale, ok):
    """Draws whose means are off by ``shift`` relative and sds ``scale``
    times the oracle's pass the 5% gate only inside it."""
    rng = np.random.default_rng(2)
    mean, sd = np.array([-2.0, -1.8, -3.0, -2.9, 0.5]), np.array(
        [0.19, 0.2, 0.13, 0.13, 0.001])
    z = rng.standard_normal((4000, 5, 16))
    z = (z - z.mean((0, 2), keepdims=True)) / z.std((0, 2), ddof=1,
                                                    keepdims=True)
    draws = (mean * (1 + shift))[None, :, None] + scale * sd[None, :,
                                                              None] * z
    assert pc.lnr_gate(draws, (mean, sd, 1e5))[0] == ok


def test_hier_marginal_is_the_b0_integral():
    """The hierarchical oracle's log posterior, β0 integrated out in closed
    form, equals the log of a numerical integral over each β0ᵢ of the full
    float64 density (priors, half-Cauchy scales, Jacobian σβ0·σ) at a few
    points, up to the constant the closed form drops."""
    from scipy.integrate import quad
    from scipy.stats import norm
    rng = np.random.default_rng(4)
    y = 1.0 + rng.normal(0.0, 1.0, (3, 1)) + 0.5 * rng.normal(0, 1, (3, 5))
    n, ybar = y.shape[1], y.mean(1)
    ssw = ((y - ybar[:, None]) ** 2).sum(1)
    got, want = [], []
    for mu, sb, s in ((0.8, 0.9, 0.5), (1.3, 0.4, 0.7), (0.2, 1.7, 0.3)):
        lp = pc._hier_logpost64(mu, np.log(sb), np.log(s), ybar, ssw, n)
        full = (norm.logpdf(mu, 1.0, 1.0) + np.log(2 / np.pi / (1 + sb ** 2))
                + np.log(2 / np.pi / (1 + s ** 2)) + np.log(sb * s))
        for yi in y:
            f = lambda b, yi=yi: np.exp(norm.logpdf(b, 0.0, sb) + norm.logpdf(
                yi, mu + b, s).sum() + 10.0)
            full += np.log(quad(f, -8, 8, points=[yi.mean() - mu])[0]) - 10.0
        got.append(lp)
        want.append(full)
    diff = np.array(got) - np.array(want)
    np.testing.assert_allclose(diff, diff[0], atol=1e-8)


def test_hier_oracle_and_gate():
    """The quadrature oracle of the hierarchical cell's data keeps its
    mass inside its box and agrees with a finer grid; the gate passes the
    oracle's own means and fails a μβ0 off by more than its limit."""
    from demcmc_tpu_torch.models import hierarchical as thier
    cell = pc.HIER_CELL
    model, de = thier.make(n_subj=cell["n_subj"], n_data=cell["n_data"],
                           key=cell["key"])
    assert de.n_chains == 6 and model.data.shape == (20, 50)
    o = pc.hier_oracle(model.data)
    fine = pc.hier_oracle(model.data, n_grid=161)
    assert not o["mass_at_edge"]
    for k in ("mu_b0", "sigma_b0", "sigma"):
        np.testing.assert_allclose(o[k], fine[k], rtol=1e-6)
    means = {k: o[k][0] for k in ("mu_b0", "sigma_b0", "sigma")}
    assert pc.hier_gate(means, o["b0"], o)[0]
    lim = pc.HIER_ATOL + pc.HIER_RTOL * abs(o["mu_b0"][0])
    bad = dict(means, mu_b0=o["mu_b0"][0] + 1.01 * lim)
    assert not pc.hier_gate(bad, o["b0"], o)[0]
    assert not pc.hier_gate(means, o["b0"] + 0.16, o)[0]


def test_abc_fixed_oracle_is_the_counted_posterior():
    """The exact moments of the fixed-panel ABC posterior equal a
    quadrature of the port's own hit counts on a fine θ grid (to the
    grid's resolution), and the panel is the port model's default."""
    from demcmc_tpu_torch.models import binomial as tbin
    panel = pc.abc_panel(2000, 10)
    np.testing.assert_array_equal(panel, tbin.abc_panel(2000, 10))
    th = np.linspace(0.0, 1.0, 20_001)[1:-1].astype(np.float32)
    hits = tbin.abc_hits(torch.tensor(panel), 10, 6,
                         torch.tensor(th)).numpy().astype(np.float64)
    w = hits / hits.sum()
    mean = float(w @ th)
    sd = float(np.sqrt(w @ (th - mean) ** 2))
    got = pc.abc_fixed_oracle(panel, 6)
    assert abs(got[0] - mean) < 2e-4 and abs(got[1] - sd) < 2e-4
    z = np.random.default_rng(0).standard_normal(1000)
    z = (z - z.mean()) / z.std(ddof=1)
    assert pc.abc_fixed_gate(got[0] + got[1] * z, got)[0]
    assert not pc.abc_fixed_gate(got[0] + 0.011 + got[1] * z, got)[0]
    assert not pc.abc_fixed_gate(got[0] + 1.1 * got[1] * z, got)[0]


def test_kde_fresh_oracle_of_one_panel_is_the_fixed_oracle():
    """The panel-averaged oracle over one panel is the fixed-panel oracle
    on that panel (the same likelihood), and averaging over panels moves
    the posterior by less than a panel's own shift."""
    data = pc.kde_inputs()[0]
    one = pc.kde_fresh_oracle(data, n_panels=1, n_grid=121)
    panel = np.random.default_rng(1000).standard_normal(pc.KDE_N_SIM)
    fixed = pc._grid_posterior(
        data, lambda MU, SG: pc.kde_log_like64(MU, SG, data, panel), 121)
    for name in ("mu", "sigma"):
        np.testing.assert_allclose(one[name], fixed[name], rtol=1e-12)
    many = pc.kde_fresh_oracle(data, n_panels=3, n_grid=121)
    assert abs(many["mu"][0] - one["mu"][0]) < 0.05
