"""The oracles and gates of the port's LBA and discrete binomial cells
(``port_cells.py``, which ``chip_smoke.py`` holds the GPU's ``sample()``
to): the LBA oracle's float64 density against the JAX model's, its
importance sampler on a small data set, the exact discrete oracle against
the closed form of its p integral, and both gates on draws of known
moments."""

import jax.numpy as jnp
import numpy as np
import pytest
from scipy.special import betaln, gammaln

import port_cells as pc
from demcmc_tpu.models import lba as jlba
from demcmc_tpu_torch.models import lba as tlba

LBA_DATA = tlba.simulate(np.random.default_rng(0), 100, **tlba.TRUE)


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
