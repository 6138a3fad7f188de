"""The port's DE-MCz path (``demcmc_tpu_torch.ops.resample_step``, the CPU
version of CUDA kernel K3; the MVN model; history seeding and growth; the
JAX resample state converter) against the JAX package.

The JAX kernel draws its history indices with threefry in XLA
(``_resample_idx``), which the port does not reproduce: the step is held
against the JAX kernel with the JAX indices and words fed to the port
(indices-in + bits-in), and the port's ``resample_flat_indices`` against
JAX's on the same words.  As in ``test_torch_fused_step.py``, the JAX
kernel's within-group gather (the γ₂ base select) is replaced in this
process by the JAX package's own linear-select gather (ROADMAP.md, C).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import demcmc_tpu as jdm
from demcmc_tpu import rng as jrng
from demcmc_tpu.models import mvnormal as jmvn
from demcmc_tpu.ops import fused_step as jfused
from demcmc_tpu.ops import proposals as jprop

import demcmc_tpu_torch as tdm
from demcmc_tpu_torch.models import mvnormal as tmvn
from demcmc_tpu_torch.ops import fused_step as tfused
from demcmc_tpu_torch.ops import proposals as tprop
from demcmc_tpu_torch.ops import resample_step as tres

D_MU, N_INIT, K = 3, 16, 4
DATA = np.asarray(np.random.default_rng(5).standard_normal((40, D_MU)),
                  np.float32)


@pytest.fixture()
def member_gather(monkeypatch):
    def one(x, idx, p, Np):
        return jfused._seg_gather(jfused._roll_dict(x, p, Np), idx, p, Np)

    def multi(x, idxs, p, Np):
        rolls = jfused._roll_dict(x, p, Np)
        return [jfused._seg_gather(rolls, i, p, Np) for i in idxs]

    monkeypatch.setattr(jfused, "_seg_gather_bin", one)
    monkeypatch.setattr(jfused, "_seg_gather_bin_multi", multi)


class _Words:
    """A draw source with JAX ``KeyDraws.randuint``'s interface returning
    fixed words modulo the span, one row per call."""

    def __init__(self, words):
        self.words, self.i = words, 0

    def randuint(self, shape, span):
        w = jnp.asarray(self.words[self.i].reshape(shape))
        self.i += 1
        return w % span


@pytest.mark.parametrize("n,count,C", [(2, 5, 3), (3, 1, 3), (3, 7, 512),
                                       (2, 70000, 65536)])
def test_resample_flat_indices_equal_jax(n, count, C):
    """The same words give JAX's (row, chain) pairs exactly, as flat
    indices row·C + chain, distinct within each tuple — up to a span past
    2³¹ (uint32 in JAX, int64 masked to 32 bits here)."""
    words = np.random.default_rng(count).integers(
        0, 2 ** 32, (n, 4, 64), dtype=np.uint64).astype(np.uint32)
    rows, chains = jprop.resample_flat_indices(
        _Words(words), n, jnp.asarray(count, jnp.int32), C, (4, 64))
    want = (np.asarray(rows, np.int64) * C + np.asarray(chains, np.int64))
    got = tprop.resample_flat_indices(
        torch.from_numpy(words.astype(np.int64)), count, C).numpy()
    np.testing.assert_array_equal(got, want)
    for a in range(n):
        for b in range(a):
            assert (got[a] != got[b]).all()
    assert got.min() >= 0 and got.max() < count * C


def _population(seed, C, H):
    """Prior-like history seeds [H, C, d] and row 0's log posterior (the
    port's density, which equals JAX's to rtol 1e-6: see below)."""
    rng = np.random.default_rng(seed)
    mu = rng.normal(DATA.mean(0), 0.3, (H, C, D_MU))
    sigma = np.abs(rng.normal(1.0, 0.2, (H, C, 1))) + 0.05
    hist = np.concatenate([mu, sigma], -1).astype(np.float32)
    model, de = tmvn.make(d=D_MU, data=DATA)
    w = tdm.ops.accept.compute_posterior(model, tdm.make_spec(model, de), de,
                                         torch.tensor(hist[0]))
    return hist, w.numpy()


def _jax_indices(key2, it, n_members, C, snooker):
    """JAX's history indices for iteration ``it`` as ``_resample_idx``
    (``fused_step.py:2637-2686``) draws them, flat row·C + chain,
    ``[n_members · n_slots, C]``."""
    key = jax.random.wrap_key_data(jnp.asarray(key2), impl="threefry2x32")
    kd = jrng.KeyDraws(jax.random.fold_in(
        jax.random.fold_in(key, jrng.RESAMPLE), it))
    count = jnp.maximum(jnp.int32(it) - 1, 1)
    rows, chains = jprop.resample_flat_indices(kd, 2, count, C,
                                               (n_members, C))
    if snooker:
        r2, c2 = jprop.resample_flat_indices(kd, 3, count, C, (n_members, C))
        rows, chains = jnp.concatenate([rows, r2]), jnp.concatenate(
            [chains, c2])
    flat = np.asarray(rows, np.int64) * C + np.asarray(chains, np.int64)
    return torch.from_numpy(np.ascontiguousarray(
        flat.transpose(1, 0, 2).reshape(-1, C)))


_JAX_STEPS = {}


def _jax_resample_step(**kw):
    """The JAX package's fused resample step for the MVN d=3 model (built
    once per configuration in this process; interpret mode)."""
    key = tuple(sorted(kw.items()))
    if key not in _JAX_STEPS:
        jm, jde = jmvn.make(d=D_MU, data=DATA, n_initial=N_INIT, **kw)
        spec = jdm.make_spec(jm, jde)
        with pytest.MonkeyPatch.context() as mp:
            mp.setenv("DEMCMC_FUSED", "interpret")
            step = jdm.sampler.build_step(jm, jde, spec)
        assert getattr(step, "resample_fused", False)
        _JAX_STEPS[key] = jm, jde, spec, step
    return _JAX_STEPS[key]


KW = dict(burnin=N_INIT + 2, theta_snooker=0.5)


def _jax_state(jstep, seed, C, D, K):
    """A JAX (flat-layout) resample state at iteration n_initial + 1: the
    seeds of :func:`_population` with room for K more history rows."""
    hist0, w0 = _population(seed, C, N_INIT)
    return jdm.sampler.SamplerState(
        theta=jnp.asarray(hist0[0].reshape(1, C, D)),
        weight=jnp.asarray(w0.reshape(1, C)), key=jax.random.PRNGKey(0),
        iteration=jnp.int32(N_INIT + 1),
        history=jnp.asarray(np.concatenate(
            [hist0, np.zeros((K, C, D), np.float32)])), fire=None)


def test_plain_resample_step_matches_jax_kernel(member_gather):
    """MVN d=3 (D=4), C=3 (Np=3, one group), the sequential sweep, θsnooker
    = 0.5, K = 4 iterations from n_initial + 1 across the burn-in boundary,
    indices-in + bits-in: θ and w to rtol 1e-5 / atol 1e-6 (the sums over
    d may round in another order in XLA), accept flags exactly (no near-
    ties at this seed), and the history rows written equal."""
    it0 = N_INIT + 1
    kw = KW
    jm, jde, spec, jstep = _jax_resample_step(**kw)
    C, D = jde.n_chains, spec.dim
    H = N_INIT + K
    hist0, w0 = _population(0, C, N_INIT)
    js = _jax_state(jstep, 0, C, D, K)
    fs = jstep.to_fused(js)
    S = fs.history.shape[0]
    kern = jfused.build_fused_step(jm, jde, spec, interpret=True, K=K,
                                   hist_S=S)
    key2 = np.array([0x5151, 0xC0DE], np.uint32)
    jt, jw, jacc, _, jhist = (np.asarray(o) for o in jax.jit(kern)(
        fs.theta, fs.weight, jnp.asarray(key2), jnp.int32(it0),
        jnp.zeros((1, 1), jnp.int32), fs.history))
    jhist = jdm.sampler._unpack_fused_state(
        fs._replace(history=jnp.asarray(jhist)), 1, C, D).history

    model, de = tmvn.make(d=D_MU, data=DATA, n_initial=N_INIT, **kw)
    assert de.sequential_sweep
    tspec = tdm.make_spec(model, de)
    cfg = tfused.StepConfig.make(model, de, tspec)
    assert cfg.rows.n_words == kern.n_words
    th, ww = torch.tensor(hist0[0]), torch.tensor(w0)
    hist = torch.zeros((H, C, D))
    hist[:N_INIT] = torch.tensor(hist0)
    fire = torch.zeros(1, dtype=torch.int32)
    R, Cf = jt.shape[2:]
    for k in range(K):
        it = it0 + k
        key = jax.random.wrap_key_data(jnp.asarray(key2),
                                       impl="threefry2x32")
        words = np.asarray(jax.random.bits(jax.random.fold_in(key, it),
                                           (kern.n_words, R * Cf),
                                           jnp.uint32))[:, :C]
        idx = _jax_indices(key2, it, cfg.rows.n_members, C, True)
        assert idx.shape == (tres.index_rows(cfg), C)
        margin = tres.resample_step_plain(
            cfg, model, tspec, th, ww, fire, hist, it,
            torch.from_numpy(words.astype(np.int64)).to(torch.uint32), idx)
        assert (margin.abs() > 1e-4).all(), "near-tie at this seed"
        np.testing.assert_allclose(th.numpy(), jt[k][:, 0, :C].T,
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(ww.numpy(), jw[k][0, :C],
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_array_equal((margin <= 0).numpy(),
                                      jacc[k][0, :C])
    np.testing.assert_allclose(hist.numpy(), np.asarray(jhist)[:H],
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(hist[:N_INIT].numpy(), hist0)
    assert int(fire[0]) == 0


def test_init_state_seeds_and_grows_the_history():
    """``init_state`` seeds ``n_initial`` rows of prior draws per chain,
    starts from row 0 at iteration n_initial + 1; ``_grow_history`` adds
    zero rows; a run writes its states to rows n_initial .. and leaves
    the seeds alone; n_initial = 0 with resample raises."""
    model, de = tmvn.make(d=D_MU, data=DATA, n_initial=8, burnin=2)
    spec = tdm.make_spec(model, de)
    s = tdm.init_state(model, de, spec, 4, device="cpu")
    C, D = de.n_chains, spec.dim
    assert s.history.shape == (8, C, D) and s.iteration == 9
    assert torch.equal(s.theta, s.history[0])
    assert (s.history[..., D_MU] > 0).all()
    g = tdm.sampler._grow_history(s, 6)
    assert g.history.shape == (14, C, D)
    assert torch.equal(g.history[:8], s.history) and not g.history[8:].any()
    chains, end = tdm.sample(model, de, 6, key=4, device="cpu",
                             return_state=True)
    assert end.iteration == 15 and end.history.shape == (14, C, D)
    assert torch.equal(end.history[:8], s.history)
    # the kept draws (iterations 3..6 of the run) are history rows 10..13
    np.testing.assert_array_equal(end.history[10:].numpy(),
                                  np.moveaxis(chains.data, 1, 2))
    assert torch.equal(end.history[13], end.theta)
    plain, de2 = tmvn.make(d=D_MU, data=DATA, sample=None, n_initial=0)
    s2 = tdm.init_state(plain, de2, tdm.make_spec(plain, de2), 0,
                        device="cpu")
    assert s2.history is None and s2.iteration == 1
    assert tdm.sampler._grow_history(s2, 5).history is None
    with pytest.raises(ValueError, match="n_initial"):
        tdm.init_state(model, de.replace(n_initial=0), spec, 0, device="cpu")


@pytest.mark.parametrize("form", ["packed", "flat"])
def test_state_from_numpy_reads_jax_resample_state(form):
    """A JAX resample state converts to the port's state: the fused
    resample layout (θ [d, 8, 128] with the chains as the row-0 prefix,
    history packed [S, d, 128] by ``pack_history``) or the flat one
    (θ [G, Np, d], history [H, C, d]); the port then samples on from it."""
    jm, jde, spec, jstep = _jax_resample_step(**KW)
    C, D, H = jde.n_chains, spec.dim, N_INIT + 4
    js = _jax_state(jstep, 3, C, D, K=4)
    if form == "packed":
        fs = jstep.to_fused(js)
        assert fs.history.shape[1:] == (D, 128)
        st = tdm.state_from_numpy(fs.theta, fs.weight, fs.iteration,
                                  fs.fire, "resample", device="cpu",
                                  history=fs.history, n_chains=C)
        assert st.history.shape[0] >= H and not st.history[H:].any()
    else:
        st = tdm.state_from_numpy(js.theta, js.weight, js.iteration, None,
                                  "flat", device="cpu", history=js.history)
        assert st.history.shape == (H, C, D)
    np.testing.assert_array_equal(st.history[:H].numpy(),
                                  np.asarray(js.history, np.float32))
    np.testing.assert_array_equal(st.theta.numpy(),
                                  np.asarray(js.theta, np.float32)
                                  .reshape(C, D))
    np.testing.assert_array_equal(st.weight.numpy(),
                                  np.asarray(js.weight, np.float32)
                                  .reshape(C))
    assert st.iteration == N_INIT + 1 and int(st.fire[0]) == 0
    model, de = tmvn.make(d=D_MU, data=DATA, n_initial=N_INIT, burnin=0,
                          discard_burnin=False)
    chains, end = tdm.sample(model, de, 3, state=st, device="cpu",
                             return_state=True)
    assert chains.data.shape == (3, D, C) and end.iteration == N_INIT + 4
    assert torch.equal(end.history[:N_INIT], st.history[:N_INIT])


def test_mvnormal_density_matches_jax():
    """The batched MVN log posterior (prior + centered sufficient-statistic
    likelihood, sums over d in index order) against the JAX model's at
    rtol 1e-6 (XLA may sum in another order); σ ≤ 0 gives -inf."""
    rng = np.random.default_rng(8)
    mu = rng.normal(0.0, 0.5, (D_MU, 300)).astype(np.float32)
    sigma = np.abs(rng.normal(1.0, 0.5, 300)).astype(np.float32)
    sigma[:5] = -sigma[:5]
    jm, _ = jmvn.make(d=D_MU, data=DATA)
    want = np.asarray(jm.prior_loglike_batched(mu, sigma)
                      + jm.loglike_batched(DATA, mu, sigma))
    model, de = tmvn.make(d=D_MU, data=DATA)
    spec = tdm.make_spec(model, de)
    x = torch.tensor(np.concatenate([mu, sigma[None]]))
    got = model.log_posterior_cols(spec, x).numpy()
    ok = sigma > 0
    np.testing.assert_allclose(got[ok], want[ok], rtol=1e-6)
    post = tdm.ops.accept.compute_posterior(model, spec, de, x.T).numpy()
    assert np.isneginf(post[~ok]).all()
    assert model.cuda_density is None          # no kernel built for d = 3
    m30, _ = tmvn.make()
    assert m30.cuda_density.name == "mvnormal30"
    assert len(m30.cuda_density.params) == 7 + 30


def test_kernel_entry_points():
    """K3 is built on the MVN density and K1 is not (no configuration
    steps the MVN model through K1): a CUDA step of the MVN model without
    resample raises, the DE-MCz one builds."""
    from demcmc_tpu_torch.ops import _build
    m30, de = tmvn.make()
    spec = tdm.make_spec(m30, de)
    assert _build.entry("resample_step", m30.cuda_density) == \
        "resample_step_mvnormal30"
    assert "de_step_mvnormal30" not in _build.SIGNATURES["de_step"]
    tdm.sampler.Step(m30, de, spec, "cuda")
    with pytest.raises(ValueError, match="mvnormal30"):
        tdm.sampler.Step(m30, de.replace(sample="current", n_initial=0),
                         spec, "cuda")


def test_resample_wrapper_takes_plain_version_on_cpu():
    """On CPU tensors ``resample_step`` (the K3 wrapper) runs the plain
    version with the indices drawn from the RESAMPLE namespace: same
    result as the plain version with those indices, no launch counted;
    an iteration without a history row to write raises."""
    model, de = tmvn.make(d=D_MU, data=DATA, n_initial=N_INIT,
                          theta_snooker=0.5, burnin=30)
    spec = tdm.make_spec(model, de)
    cfg = tfused.StepConfig.make(model, de, spec)
    s = tdm.sampler._grow_history(
        tdm.init_state(model, de, spec, 2, device="cpu"), 3)
    a = [s.theta.clone(), s.weight.clone(), s.fire.clone(),
         s.history.clone()]
    b = [x.clone() for x in a]
    it = s.iteration
    before = tres.resample_step.launches
    tres.resample_step(cfg, model, spec, *a, it, seed=7)
    words = tdm.rng.words(7, it, cfg.rows.n_words, de.n_chains)
    idx = tres.indices(cfg, 7, it)
    assert idx.shape == (3 * 5, de.n_chains)
    assert (idx < (it - 1) * de.n_chains).all()
    tres.resample_step_plain(cfg, model, spec, *b, it, words, idx)
    assert tres.resample_step.launches == before
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    assert torch.equal(a[3][it - 1], a[0])
    with pytest.raises(ValueError, match="history"):
        tres.resample_step(cfg, model, spec, *a, a[3].shape[0] + 1)


def test_mvn_posterior_on_cpu():
    """A short CPU DE-MCz run of the MVN model (d = 3, 100 observations,
    Np = 3, one group, snooker 0.1, 700 iterations, burn-in 200) against
    the analytic posterior of μ at σ = 1 (sd 0.0995): means and sds of μ
    within 0.04, about 4 Monte Carlo standard errors at this length."""
    data = np.asarray(np.random.default_rng(1).standard_normal((100, D_MU)),
                      np.float32)
    model, de = tmvn.make(d=D_MU, data=data, burnin=200)
    chains = tdm.sample(model, de, 700, key=2, device="cpu")
    mu = chains.group("mu")
    truth = tmvn.analytic_posterior(data)
    np.testing.assert_allclose(mu.mean(axis=(0, 2)), truth["mean"],
                               atol=0.04)
    np.testing.assert_allclose(mu.std(axis=(0, 2), ddof=1), truth["std"],
                               atol=0.04)
    assert abs(chains.mean("sigma") - 1.0) < 0.1
