"""The port's LBA, pseudo-marginal ABC binomial and discrete binomial models
against the JAX package on the CPU: the special functions the CUDA
densities share (lgamma32, the Φ/φ pair, the integer powers and binomial
coefficients, the snap's rounding), each batched density, the row layout
of the noise panel, ``state_from_numpy`` of a JAX state, and short
``sample()`` runs."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import demcmc_tpu as jdm
from demcmc_tpu.models import binomial as jbin
from demcmc_tpu.models import discrete_binomial as jdisc
from demcmc_tpu.models import lba as jlba
from demcmc_tpu.ops import fused_step as jfused

import demcmc_tpu_torch as tdm
from demcmc_tpu_torch.models import binomial as tbin
from demcmc_tpu_torch.models import discrete_binomial as tdisc
from demcmc_tpu_torch.models import lba as tlba
from demcmc_tpu_torch.ops import fused_step as tfused
from demcmc_tpu_torch.utils import dists as tdists

LBA_DATA = tlba.simulate(np.random.default_rng(5), 32, **tlba.TRUE)


def _ulps(a, b):
    """|a − b| in float32 ulps of b."""
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return np.abs(a.astype(np.float64) - b) / np.spacing(np.abs(b))


def _lgamma_grid():
    """``test_lgamma_override_accuracy``'s grid (tests/test_fused_step.py)."""
    return np.concatenate([np.linspace(0.05, 2, 200),
                           np.linspace(2, 50, 300),
                           np.linspace(50, 5000, 200),
                           np.geomspace(5e3, 1e6, 100)]).astype(np.float32)


def test_lgamma32_matches_jax_kernel_and_scipy():
    """lgamma32 against the JAX kernel's ``_lgamma32`` on the same float32
    inputs within 2 ulp of the larger of |lgamma| and 16 (XLA's log and
    torch's differ by an ulp; below x = 8 the result is the difference of
    two logs of up to ~16, where lgamma itself nears 0), and against
    scipy's float64 gammaln to rel 1e-5 as the JAX test holds
    ``_lgamma32``."""
    from scipy.special import gammaln
    x = _lgamma_grid()
    got = tdists.lgamma32(torch.tensor(x)).numpy()
    want = np.asarray(jfused._lgamma32(jnp.asarray(x)))
    assert got.dtype == np.float32 and np.isfinite(got).all()
    scale = np.spacing(np.maximum(np.abs(want), np.float32(16.0)))
    assert (np.abs(got.astype(np.float64) - want) / scale).max() <= 2
    ref = gammaln(x.astype(np.float64))
    assert (np.abs(got - ref) / np.maximum(np.abs(ref), 1.0)).max() < 1e-5


def test_phi_phi_matches_jax():
    """The shared-exp Φ/φ pair against ``lba._Phi_phi`` in float32 within
    2 ulp, and Φ against the normal CDF to 4e-7 (the JAX test's bound)."""
    from scipy.stats import norm
    x = np.linspace(-8.0, 8.0, 8001).astype(np.float32)
    with jax.enable_x64(False):
        jP, jp = (np.asarray(v) for v in jlba._Phi_phi(jnp.asarray(x)))
    P, p = (v.numpy() for v in tlba._Phi_phi(torch.tensor(x)))
    assert P.dtype == np.float32
    assert _ulps(P, jP)[jP > 0].max() <= 2
    assert _ulps(p, jp)[jp > 0].max() <= 2
    assert np.abs(P - norm.cdf(x.astype(np.float64))).max() < 4e-7


def test_binomial_coefficients_and_integer_powers():
    """``comb_f32`` (exact, rounded once) equals the float32 rounding of
    scipy's ``comb``, which the JAX model uses, for every N ≤ 64; the
    square-and-multiply power equals JAX's ``x ** j`` bit for bit."""
    from scipy.special import comb
    for N in range(1, tbin.MAX_N + 1):
        want = [float(np.float32(comb(N, j))) for j in range(N)]
        assert tbin.comb_f32(N) == want
    x = np.random.default_rng(1).uniform(0.0, 1.0, 257).astype(np.float32)
    for j in range(13):
        got = tbin.integer_pow(torch.tensor(x), j).numpy()
        with jax.enable_x64(False):
            want = np.asarray(jax.jit(lambda v: v ** j)(jnp.asarray(x)))
        np.testing.assert_array_equal(got.view(np.int32),
                                      want.view(np.int32))


def test_snap_rounds_half_to_even():
    """The snap's rounding equals ``jnp.round`` on exact ties (the CUDA
    kernel uses ``rintf``, which does the same)."""
    x = np.array([-2.5, -1.5, -0.5, 0.5, 1.5, 2.5, 3.5, 2.4999998, 7.0],
                 np.float32)
    got = torch.round(torch.tensor(x)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jnp.round(x)))
    np.testing.assert_array_equal(got, [-2, -2, -0, 0, 2, 2, 4, 2, 7])


def test_lba_density_matches_jax():
    """The batched LBA log posterior in float32 against JAX's ``prior +
    loglike_batched`` on the same numpy parameters, rtol 1e-5 (XLA sums
    the trials in its own order); out-of-support τ and A give −inf in
    both; the per-trial form agrees with the batched one."""
    rng = np.random.default_rng(2)
    C = 64
    min_rt = float(LBA_DATA[1].min())
    nu = np.abs(rng.normal(2.5, 0.8, (2, C))).astype(np.float32)
    A = rng.uniform(0.3, 1.2, C).astype(np.float32)
    k = rng.uniform(0.05, 0.4, C).astype(np.float32)
    tau = rng.uniform(0.0, min_rt, C).astype(np.float32)
    tau[:4] = [min_rt * 1.5, -0.1, min_rt, 0.0]
    with jax.enable_x64(False):
        jm, _ = jlba.make(data=LBA_DATA)
        args = [jnp.asarray(v) for v in (nu, A, k, tau)]
        want = np.asarray(jm.prior_loglike_batched(*args)
                          + jm.loglike_batched(jm.data, *args))
    model, de = tlba.make(data=LBA_DATA)
    spec = tdm.make_spec(model, de)
    theta = torch.tensor(np.concatenate([nu, A[None], k[None], tau[None]]).T)
    got = model.log_posterior_cols(spec, theta.T).numpy()
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want))
    assert np.isneginf(got[:2]).all() and np.isfinite(got[4:]).all()
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=1e-5)
    ll = tlba.loglike_batched(model.data, *(torch.tensor(v) for v in
                                            (nu, A, k, tau)))
    choice, rt = (torch.tensor(v) for v in model.data)
    for c in (4, 17, 63):
        per = tlba.lba_logpdf(choice, rt, torch.tensor(nu[:, c]),
                              float(A[c]), float(k[c]), float(tau[c])).sum()
        assert abs(float(per) - float(ll[c])) < 1e-4 * abs(float(per))
    assert model.cuda_density.data.shape == (len(LBA_DATA[1]), 2)


def test_abc_density_matches_jax_on_the_same_uniforms():
    """The inverse-CDF ABC log likelihood against JAX's
    ``loglike_abc_batched`` fed the same uniform panel: equal hit counts,
    so equal within an ulp of the log; θ = 0 and 1 give the degenerate
    counts 0 and N."""
    rng = np.random.default_rng(3)
    theta = rng.uniform(0.0, 1.0, (4, 16)).astype(np.float32)
    theta[0, :3] = [0.0, 1.0, 0.6]
    u = rng.uniform(0.0, 1.0, (500, 4, 16)).astype(np.float32)
    for N, k in ((10, 6), (10, 0), (10, 10), (40, 17)):
        with jax.enable_x64(False):
            want = np.asarray(jbin.loglike_abc_batched(
                {"N": N, "k": k}, jnp.asarray(theta), noise=jnp.asarray(u)))
        got = tbin.loglike_abc_batched({"N": N, "k": k}, torch.tensor(theta),
                                       noise=torch.tensor(u)).numpy()
        np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want))
        fin = np.isfinite(want)
        np.testing.assert_allclose(got[fin], want[fin], rtol=1e-6)
        if k == 0:
            assert got[0, 0] == 0.0          # θ = 0: every count is 0
        if k == N:
            assert got[0, 1] == 0.0          # θ = 1: every count is N


def test_discrete_density_matches_jax():
    """The folded discrete-binomial log posterior against JAX's batched
    form (whose lgamma here is XLA's, not ``_lgamma32``) on integer N
    across the support: −inf where N < max k in both, else within 2e-3
    (one ulp of 50·lgamma(N + 1) ~ 5e-4)."""
    model, de = tdisc.make(key=0, n_obs=50, dtype=np.float32)
    jm, _ = jdisc.make(key=0, n_obs=50, dtype=np.float32)
    np.testing.assert_array_equal(model.data, np.asarray(jm.data))
    N = np.arange(0, 41, dtype=np.int32).repeat(3)
    p = np.tile(np.array([0.3, 0.6, 0.85], np.float32), 41)
    with jax.enable_x64(False):
        want = np.asarray(jm.prior_loglike_batched(jnp.asarray(N),
                                                   jnp.asarray(p))
                          + jm.loglike_batched(jm.data, jnp.asarray(N),
                                               jnp.asarray(p)))
    spec = tdm.make_spec(model, de)
    assert spec.is_int == (True, False)
    x = torch.tensor(np.stack([N, p]).astype(np.float32))
    got = model.log_posterior_cols(spec, x).numpy()
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want))
    fin = np.isfinite(want)
    assert 0 < fin.sum() < len(N)
    np.testing.assert_allclose(got[fin], want[fin], rtol=1e-6, atol=2e-3)


@pytest.mark.parametrize("sweep", ["sync", "sequential"])
def test_noise_rows_sit_before_the_accept_row(sweep):
    """The noise panel takes n_sim rows of every sub-sweep block, after the
    Box–Muller rows and before the accept row; the word count equals the
    JAX kernel's (``fused_step.py:1824``), in the sequential sweep too."""
    kw = dict(N=10, k=6, abc=True, fresh_noise=True, n_sim=40, Np=4,
              n_groups=16, burnin=5, sweep=sweep)
    jm, jde = jbin.make(**kw)
    kern = jfused.build_fused_step(jm, jde, jdm.make_spec(jm, jde),
                                   interpret=True, K=1, mig_in_kernel=True)
    model, de = tbin.make(**kw)
    r = tfused.draw_rows(de, 1, model.noise_words)
    assert r.n_words == kern.n_words
    assert r.noise == r.normal + 2 and r.accept == r.noise + 40
    assert r.n_noise == 40
    plain = tfused.draw_rows(de, 1)
    assert r.stride == plain.stride + 40
    assert r.n_members == (4 if sweep == "sequential" else 1)


def test_kernel_arguments_of_the_new_densities():
    """K1's sweep arguments carry the integer-dimension mask and the noise
    row; the densities' constants and data buffers have the layouts the
    CUDA headers read."""
    model, de = tdisc.make(dtype=np.float32)
    cfg = tfused.StepConfig.make(model, de, tdm.make_spec(model, de))
    assert cfg.int_dims == (0,)
    assert list(cfg.sweep_args)[4:] == [1, 0xFFFFFFFF]
    dens = model.cuda_density
    assert len(dens.params) == 6 and dens.data.shape[1] == 2
    assert dens.params[3] == dens.data[:, 0].max()
    model, de = tbin.make(N=10, k=6, abc=True, fresh_noise=True, Np=8,
                          n_groups=4)
    cfg = tfused.StepConfig.make(model, de, tdm.make_spec(model, de))
    assert list(cfg.sweep_args)[4:] == [0, cfg.rows.noise]
    assert cfg.rows.n_noise == 10_000
    assert model.cuda_density.params == (10.0, 6.0, 10_000.0)
    model, de = tlba.make(data=LBA_DATA)
    assert len(model.cuda_density.params) == 12
    assert model.cuda_density.params[11] == len(LBA_DATA[1])
    buf = model.cuda_density.data_on("cpu")
    assert buf is model.cuda_density.data_on("cpu")
    assert buf.dtype == torch.float32 and buf.is_contiguous()
    tdm.sampler.Step(model, de, tdm.make_spec(model, de), "cuda")
    from demcmc_tpu_torch.ops import _build
    for name in ("lba", "binomial_abc", "discrete_binomial"):
        assert _build.SIGNATURES["de_step"][f"de_step_{name}"] == _build._K1
        assert f"resample_step_{name}" not in _build.SIGNATURES[
            "de_step_resample"]


def test_unported_binomial_variants_raise():
    with pytest.raises(NotImplementedError, match="unfused step"):
        tbin.make(N=10, k=6)
    with pytest.raises(NotImplementedError, match="unfused step"):
        tbin.make(N=10, k=6, abc=True)
    with pytest.raises(NotImplementedError, match="float64"):
        tdisc.make()
    with pytest.raises(ValueError, match="noise_shape"):
        tdm.DEModel(loglike_batched=tbin.loglike_abc_batched,
                    prior_loglike_batched=tbin.prior_loglike_batched,
                    sample_prior=tbin.sample_prior, noise_shape=())
    model, _ = tbin.make(N=10, k=6, abc=True, fresh_noise=True, n_sim=400)
    assert model.stochastic and model.noise_words == 400
    assert not tlba.make()[0].stochastic


def test_abc_sample_matches_conjugate():
    """Pseudo-marginal ABC (n_sim = 400, Np = 8, 16 groups, 1,200
    iterations, burn-in 300; the JAX test's configuration,
    tests/test_fused_step.py:496-512): posterior mean and sd of θ within
    0.03 of Beta(7, 5)."""
    model, de = tbin.make(N=10, k=6, abc=True, fresh_noise=True, n_sim=400,
                          Np=8, n_groups=16, burnin=300)
    ch = tdm.sample(model, de, 1200, key=7, device="cpu")
    truth = tbin.conjugate_posterior(10, 6)
    assert abs(ch.mean("theta") - truth["mean"]) < 0.03
    assert abs(float(ch.data.std()) - truth["std"]) < 0.03
    assert 0.2 < ch.acceptance.mean() < 0.95


def test_discrete_sample_stays_integral():
    """N stays integral and inside its bounds in every stored draw, and the
    chains cover the true N = 10."""
    model, de = tdisc.make(key=0, n_obs=50, dtype=np.float32, Np=8,
                           n_groups=16, burnin=100)
    ch = tdm.sample(model, de, 400, key=3, device="cpu")
    N = ch.group("N")
    assert np.all(N == np.round(N)) and N.min() >= 0 and N.max() <= 40
    assert N.min() <= 10 <= N.max()
    assert np.isfinite(ch.lp).all()


def test_lba_sample_runs():
    """A short LBA run on the CPU: finite draws inside the bounds."""
    model, de = tlba.make(data=LBA_DATA, Np=8, n_groups=4, burnin=50)
    ch = tdm.sample(model, de, 150, key=2, device="cpu")
    assert ch.data.shape == (100, 5, 32) and np.isfinite(ch.data).all()
    assert (ch.data >= 0).all()
    assert (ch.group("tau") <= float(LBA_DATA[1].min())).all()


@pytest.mark.parametrize("name", ["lba", "abc", "discrete"])
def test_state_from_numpy_of_jax_states(name):
    """A JAX ``init_state`` of each model converts to the port's state with
    the same values (the discrete N arrives as a float that is an
    integer and stays one), and the port samples on from it."""
    if name == "lba":
        kw = dict(Np=4, n_groups=8, burnin=0, discard_burnin=False)
        jm, jde = jlba.make(data=LBA_DATA, **kw)
        model, de = tlba.make(data=LBA_DATA, **kw)
    elif name == "abc":
        kw = dict(N=10, k=6, abc=True, fresh_noise=True, n_sim=100, Np=8,
                  n_groups=4, burnin=0, discard_burnin=False)
        jm, jde = jbin.make(**kw)
        model, de = tbin.make(**kw)
    else:
        kw = dict(key=0, n_obs=50, dtype=np.float32, Np=8, n_groups=4,
                  burnin=0, discard_burnin=False)
        jm, jde = jdisc.make(**kw)
        model, de = tdisc.make(**kw)
    with jax.enable_x64(False):
        js = jdm.init_state(jm, jde, jdm.make_spec(jm, jde), 4)
    s = tdm.state_from_numpy(np.asarray(js.theta), np.asarray(js.weight),
                             np.asarray(js.iteration), None, "flat",
                             device="cpu")
    d = s.theta.shape[1]
    np.testing.assert_array_equal(
        s.theta.numpy(), np.asarray(js.theta, np.float32).reshape(-1, d))
    np.testing.assert_array_equal(s.weight.numpy(),
                                  np.asarray(js.weight, np.float32).ravel())
    if name == "discrete":
        assert torch.equal(s.theta[:, 0], torch.round(s.theta[:, 0]))
    ch = tdm.sample(model, de, 4, state=s, device="cpu")
    assert ch.data.shape == (4, d, de.n_chains)
    if name == "discrete":
        N = ch.group("N")
        assert np.all(N == np.round(N))
    assert not math.isnan(float(np.nanmax(ch.lp)))
