"""Replicated runs in the port (``sample_replicated``,
``sample_replicated_packed``, ``optimize_replicated``; ``sampler.RepStep``)
on the CPU, where the replicated K1 and the segmented K2 run their plain
versions.

(a) Each replication of ``sample_replicated`` and ``optimize_replicated``
    is bit for bit its solo ``sample()``/``optimize()`` (on the kernels'
    step's plain version, and with ``allow_fused=False``), with and without
    an 8-shard CPU mesh; a configuration that takes no replicated K1 runs
    its replications in turn, each its solo run.
(b) Each replication recovers its own dataset's posterior (the quadrature
    oracle), within Monte Carlo error of one JAX ``sample_replicated`` run
    on the same datasets.
(c) Packed runs: at α = 0 each replication's moments; at α > 0 every
    exchange stays inside its replication; the event schedule is the same
    for windows of 1 and of ``SUPER_K``.
(d) The plain replicated K1 against the JAX packed fused kernel in
    interpret mode, bits in; the plain segmented K2 against the
    per-segment migration oracle.
(e) What the replicated entry points refuse.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import demcmc_tpu as dm
from demcmc_tpu import sampler as jsampler
from demcmc_tpu.models import gaussian as jgauss
from demcmc_tpu.ops import fused_step as jfused

import demcmc_tpu_torch as tdm
from demcmc_tpu_torch import rng as trng
from demcmc_tpu_torch import sampler
from demcmc_tpu_torch.models import gaussian as tgauss
from demcmc_tpu_torch.ops import _build as tbuild
from demcmc_tpu_torch.ops import fused_step as tfused
from demcmc_tpu_torch.ops import migration as tmig

from test_fused_step import _np_migration_oracle
from test_torch_fused_step import _bits

DATASETS = np.random.default_rng(0).normal(0.0, 1.0, (3, 40)).astype(
    np.float32)


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture()
def member_gather(monkeypatch):
    """The JAX kernel with a within-group gather that returns the drawn
    member (``tests/test_torch_fused_step.py``; ROADMAP.md C)."""
    def one(x, idx, p, Np):
        return jfused._seg_gather(jfused._roll_dict(x, p, Np), idx, p, Np)

    def multi(x, idxs, p, Np):
        rolls = jfused._roll_dict(x, p, Np)
        return [jfused._seg_gather(rolls, i, p, Np) for i in idxs]

    monkeypatch.setattr(jfused, "_seg_gather_bin", one)
    monkeypatch.setattr(jfused, "_seg_gather_bin_multi", multi)


def _de(**kw):
    kw.setdefault("Np", 4)
    kw.setdefault("n_groups", 4)
    kw.setdefault("burnin", 20)
    kw.setdefault("bounds", tgauss.BOUNDS)
    return tdm.DE(**kw)


def _same(a, b):
    for x, y in ((a.data, b.data), (a.lp, b.lp),
                 (a.acceptance, b.acceptance)):
        np.testing.assert_array_equal(x, y)


# ------------------------------------------------ (a) bit for bit, solo


@pytest.mark.parametrize("allow_fused,thin", [(True, 1), (True, 2),
                                              (False, 1)])
def test_replicated_is_each_solo_run_bitwise(allow_fused, thin):
    """Replication r is ``sample(make_model(datasets[r]), de, n_iter,
    key=seeds[r])`` bit for bit: through the replicated kernels' step
    (its plain version; α = 0.1 opens many gates, so many windows of one
    iteration and segmented exchanges) and, with ``allow_fused=False``, in
    turn through the unfused step; the seeds are
    ``rng.replication_seeds(key, R)``."""
    de = _de()
    reps = tdm.sample_replicated(tgauss.make_model, de, 60, DATASETS, key=5,
                                 thin=thin, device="cpu",
                                 allow_fused=allow_fused)
    seeds = trng.replication_seeds(5, 3)
    assert len(reps) == 3 and len(reps[0]) == (60 - 20) // thin
    for r in range(3):
        solo = tdm.sample(tgauss.make_model(DATASETS[r]), de, 60,
                          key=seeds[r], thin=thin, device="cpu",
                          allow_fused=allow_fused)
        _same(reps[r], solo)


def test_replicated_runs_one_batch_through_the_replicated_step(monkeypatch):
    """A configuration of K1 runs the replications as one batch: one
    replicated K1 window for every window of the plan over the
    replications' gates (a window ends where any opens), the segmented K2
    where a window opens, no solo ``sample()``; the explicit ``keys`` are
    the seeds; a second same-shape call builds no kernel (the port traces
    nothing, so it keeps no jit cache) and returns the same bits."""
    calls = {"k1": 0, "k2": 0}
    k1, k2 = tfused.de_step_rep, tmig.migrate_segments

    def count_k1(*a, **k):
        calls["k1"] += 1
        return k1(*a, **k)

    def count_k2(*a, **k):
        calls["k2"] += 1
        return k2(*a, **k)

    monkeypatch.setattr(tfused, "de_step_rep", count_k1)
    monkeypatch.setattr(tmig, "migrate_segments", count_k2)
    monkeypatch.setattr(sampler, "sample", None)     # no run in turn
    monkeypatch.setattr(tbuild, "library", None)     # no kernel built
    de = _de()
    keys = [7, 8, 9]
    a = tdm.sample_replicated(tgauss.make_model, de, 60, DATASETS,
                              keys=keys, device="cpu")
    models = [tgauss.make_model(x) for x in DATASETS]
    spec = tdm.make_spec(models[0], de)
    state = sampler._rep_state(models, de, spec, keys, "cpu")
    step = sampler.RepStep(models, de, spec, "cpu", keys)
    plan = step.plan(state, 60, switch=20, skip=20)
    assert calls == {"k1": len(plan), "k2": sum(w.migrate for w in plan)}
    assert sum(w.migrate for w in plan) > 5
    gates = trng.rep_gates(keys, 1, 60, step.cfg.rows.fire, 0.1)
    assert gates.shape == (60, 3)
    b = tdm.sample_replicated(tgauss.make_model, de, 60, DATASETS,
                              keys=keys, device="cpu")
    for x, y in zip(a, b):
        _same(x, y)


def test_replicated_resample_history_path_runs_in_turn():
    """DE-MCz (``test_replicated_resample_history_path``'s model: a
    per-cell Gaussian location model, Np = 3, one group, snooker 0.3,
    n_initial 12) takes no replicated K1: its replications run in turn,
    each its solo run bit for bit, and recover the conjugate mean."""
    def make_model(data):
        def loglike(data, mu):
            return -0.5 * torch.sum((torch.as_tensor(data) - mu) ** 2)

        def prior_loglike(mu):
            return -0.5 * torch.sum(mu ** 2)

        def sample_prior(uniform, n):
            u = uniform(2 * 2).view(2, 2, n)
            z = torch.sqrt(-2.0 * torch.log(torch.clamp_min(u[0], 1e-30)))
            return [(z * torch.cos(2.0 * np.pi * u[1])).T]

        return tdm.DEModel(loglike=loglike, prior_loglike=prior_loglike,
                           sample_prior=sample_prior, names=("mu",),
                           data=data)

    g = np.random.default_rng(2)
    mus = np.array([[-1.0, 1.0], [2.0, 0.0]])
    datasets = g.normal(mus[:, None, :], 1.0, (2, 30, 2)).astype(np.float32)
    de = tdm.DE(Np=3, n_groups=1, alpha=0.0, theta_snooker=0.3,
                sample="resample", n_initial=12, burnin=100,
                bounds=((-np.inf, np.inf),))
    models = [make_model(x) for x in datasets]
    assert not sampler.rep_supported(models, de, "cpu")
    reps = tdm.sample_replicated(make_model, de, 400, datasets, key=3,
                                 device="cpu")
    seeds = trng.replication_seeds(3, 2)
    for r in range(2):
        _same(reps[r], tdm.sample(make_model(datasets[r]), de, 400,
                                  key=seeds[r], device="cpu"))
        got = reps[r].group("mu").mean(axis=(0, 2))
        want = datasets[r].mean(axis=0) * 30 / 31
        np.testing.assert_allclose(got, want, atol=0.2)


def test_replicated_checks_raise():
    """The JAX checks: ``n_iter`` and ``burnin`` divisible by ``thin``, R
    keys, one leading replication axis on every leaf; no data."""
    de = _de(burnin=20)
    run = tdm.sample_replicated
    with pytest.raises(ValueError, match="thin"):
        run(tgauss.make_model, de, 61, DATASETS, thin=2, device="cpu")
    with pytest.raises(ValueError, match="burnin"):
        run(tgauss.make_model, _de(burnin=21), 60, DATASETS, thin=2,
            device="cpu")
    with pytest.raises(ValueError, match="keys for 3 replications"):
        run(tgauss.make_model, de, 60, DATASETS, keys=[1], device="cpu")
    with pytest.raises(ValueError, match="leading replication axis"):
        run(lambda d: tgauss.make_model(d[0]), de, 60,
            (DATASETS, DATASETS[:2]), device="cpu")
    with pytest.raises(ValueError, match="empty"):
        run(tgauss.make_model, de, 60, [], device="cpu")
    with pytest.raises(ValueError, match="thin"):
        tdm.sample_replicated_packed(tgauss.make_model, de, 61, DATASETS,
                                     thin=2, device="cpu")


def test_optimize_replicated_is_each_solo_optimize_and_finds_the_mle():
    """``optimize_replicated`` (K1's greedy max on the Gaussian's
    likelihood, one batch) returns R ``Population``s, each bit for bit its
    solo ``optimize()``; each replication's optimum is its dataset's MLE
    (mean, uncorrected sd), ``test_optimize_replicated_per_dataset_mle``'s
    width: G = 2, Np = 12, 60 observations, 1,500 iterations (the bitwise
    check on a run of 150)."""
    g = np.random.default_rng(4)
    mus = np.array([-1.5, 2.0])
    datasets = g.normal(mus[:, None], 1.0, (2, 60)).astype(np.float32)
    de = tdm.DE(bounds=tgauss.BOUNDS, n_groups=2, Np=12, burnin=0,
                update_particle="maximize", evaluate_fitness="fun")
    pops = tdm.optimize_replicated(tgauss.make_model, de, 1500, datasets,
                                   key=2, device="cpu")
    short = tdm.optimize_replicated(tgauss.make_model, de, 150, datasets,
                                    key=2, device="cpu")
    seeds = trng.replication_seeds(2, 2)
    assert len(pops) == 2
    for r in range(2):
        assert isinstance(pops[r], tdm.Population)
        model = tgauss.make_model(datasets[r])
        solo = tdm.optimize(model, de, 150, key=seeds[r], device="cpu")
        np.testing.assert_array_equal(short[r].theta, solo.theta)
        np.testing.assert_array_equal(short[r].weight, solo.weight)
        theta, _ = tdm.get_optimal(de, model, pops[r])
        x = datasets[r].astype(np.float64)
        assert abs(float(theta["mu"]) - x.mean()) < 1e-3, r
        assert abs(float(theta["sigma"]) - x.std()) < 1e-3, r


def test_replicated_over_an_8_shard_mesh_is_the_unsharded_run():
    """``mesh=chain_mesh(devices=["cpu"] * 8)`` runs R/8 whole
    replications on each shard (``RepShardedStep``), bit for bit the
    unsharded run, for ``sample_replicated`` and ``optimize_replicated``;
    6 replications do not divide over 8 shards."""
    g = np.random.default_rng(5)
    datasets = g.normal(np.tile([[-1.0], [0.0], [1.0], [2.0]], (2, 1)), 1.0,
                        (8, 40)).astype(np.float32)
    de = _de(burnin=10)
    mesh = tdm.parallel.chain_mesh(devices=["cpu"] * 8)
    plain = tdm.sample_replicated(tgauss.make_model, de, 30, datasets, key=9,
                                  device="cpu")
    shard = tdm.sample_replicated(tgauss.make_model, de, 30, datasets, key=9,
                                  mesh=mesh)
    for a, b in zip(plain, shard):
        _same(a, b)
    ode = dataclasses.replace(de, update_particle="maximize",
                              evaluate_fitness="fun", burnin=0)
    pa = tdm.optimize_replicated(tgauss.make_model, ode, 20, datasets, key=1,
                                 device="cpu")
    pb = tdm.optimize_replicated(tgauss.make_model, ode, 20, datasets, key=1,
                                 mesh=mesh)
    for a, b in zip(pa, pb):
        np.testing.assert_array_equal(a.theta, b.theta)
    with pytest.raises(ValueError, match="6 replications must divide over "
                                         "8 devices"):
        tdm.sample_replicated(tgauss.make_model, de, 60, datasets[:6],
                              key=9, mesh=mesh)
    assert tdm.parallel.shard_replications(8, ["cpu"] * 4)[1] == ("cpu", 2, 2)


# ------------------------------------------------ (b) statistics


@pytest.fixture(scope="module")
def shifted():
    """Three datasets of 80 observations at means -2, 0, 3 (numpy seed 1),
    ``test_replicated_recovers_per_dataset_posteriors``'s, with the JAX
    package's ``sample_replicated`` on them (burn-in 300, 1,000
    iterations)."""
    g = np.random.default_rng(1)
    mus = np.array([-2.0, 0.0, 3.0])
    datasets = g.normal(mus[:, None], 1.0, (3, 80)).astype(np.float32)
    jde = dm.DE(Np=4, n_groups=4, burnin=300, bounds=jgauss.BOUNDS)
    jreps = dm.sample_replicated(jgauss.make_model, jde, 1000,
                                 jnp.asarray(datasets), key=7)
    return datasets, jreps


def test_replicated_recovers_each_datasets_posterior(shifted):
    """Each replication converges on its own dataset's posterior: μ and σ
    means within 0.1 of the quadrature oracle (the JAX test's gate), and
    within 5 Monte Carlo standard errors of the JAX package's replicated
    run on the same datasets (each side's error from its bulk ESS)."""
    datasets, jreps = shifted
    de = _de(burnin=300)
    reps = tdm.sample_replicated(tgauss.make_model, de, 1000, datasets,
                                 key=7, device="cpu")
    for r in range(3):
        want = tgauss.posterior_grid(datasets[r])
        for name in ("mu", "sigma"):
            got = reps[r].mean(name)
            assert abs(got - want[name]["mean"]) < 0.1, (r, name)
            se = np.hypot(reps[r].std(name) / np.sqrt(reps[r].ess(name)),
                          jreps[r].std(name) / np.sqrt(jreps[r].ess(name)))
            assert abs(got - jreps[r].mean(name)) < 5 * se, (r, name)


# ------------------------------------------------ (c) packed runs


def test_packed_at_alpha_zero_matches_each_posterior(shifted):
    """``sample_replicated_packed`` at α = 0 (groups never interact): each
    replication's μ and σ means within 0.1 of its quadrature oracle."""
    datasets, _ = shifted
    de = _de(burnin=300, alpha=0.0)
    reps = tdm.sample_replicated_packed(tgauss.make_model, de, 1000,
                                        datasets, key=4, device="cpu")
    for r in range(3):
        want = tgauss.posterior_grid(datasets[r])
        for name in ("mu", "sigma"):
            assert abs(reps[r].mean(name) - want[name]["mean"]) < 0.1


def _tagged(data):
    """The Gaussian with a third, integer parameter, a provenance tag: its
    prior puts each chain's tag at its replication's id (the data's last
    entry) and the density ignores it.  A group's tags are all equal, so
    the DE difference moves none, and the integer snap undoes ε and a
    mutation's small step: a chain carries its start's replication
    wherever migration moves it.  (The plain versions score it with its
    torch density; the table's Gaussian constants are not read.)"""
    rid = int(data[-1])
    base = tgauss.make_model(data[:-1])

    def sample_prior(uniform, n):
        mu, sigma = tgauss.sample_prior(uniform, n)
        return [mu, sigma, torch.full(mu.shape, rid, dtype=torch.int32)]

    def prior(mu, sigma, tag):
        return base.prior_loglike_batched(mu, sigma)

    def like(d, mu, sigma, tag):
        return base.loglike_batched(d[:-1], mu, sigma)

    return tdm.DEModel(loglike_batched=like, prior_loglike_batched=prior,
                       sample_prior=sample_prior,
                       names=("mu", "sigma", "tag"), data=data,
                       cuda_density=base.cuda_density)


def test_packed_exchanges_stay_inside_each_replication(monkeypatch):
    """At α = 0.5 the packed run exchanges often (segmented K2's events),
    and every chain's provenance tag stays its own replication's id in
    every stored draw, while migration does move chains between the
    groups of each replication."""
    R = 4
    de = _de(alpha=0.5, burnin=10,
             bounds=tgauss.BOUNDS + ((-0.5, R - 0.5),))
    g = np.random.default_rng(6)
    data = np.concatenate([g.normal(0, 1, (R, 30)),
                           np.arange(R, dtype=np.float64)[:, None]], 1)
    models = [_tagged(x) for x in data]
    spec = tdm.make_spec(models[0], de)
    assert spec.is_int == (False, False, True)
    moved = []
    real = tmig.migrate_segments_plain

    def spy(theta, w, *a, **k):
        before = theta.clone()
        real(theta, w, *a, **k)
        moved.append(int((before != theta).any(1).sum()))
    monkeypatch.setattr(tmig, "migrate_segments_plain", spy)
    seeds = trng.replication_seeds(3, R)
    step = sampler.RepStep(models, de, spec, "cpu", seeds, packed_key=3)
    step.__dict__["superstep_k"] = 4         # windows of 4: 15 replays
    state = sampler._rep_state(models, de, spec, seeds, "cpu")
    _, ys = sampler.run_scan(step, state, 60)
    tags = ys.theta[..., 2]                          # [T, C]
    np.testing.assert_array_equal(
        tags, np.broadcast_to(np.repeat(np.arange(R), de.n_chains),
                              tags.shape))
    assert len(moved) > 5 and sum(moved) > 0


def test_packed_event_schedule_is_the_same_for_any_window(monkeypatch):
    """The packed events are a pure function of (key, iteration,
    replication): the windows of ``SUPER_K`` replay the same events as
    windows of one iteration (the counts of a window are the sums of its
    iterations').  Two packed runs, one in windows of one iteration and
    one in windows of ``SUPER_K``, replay the same (replication,
    iteration) events through the segmented K2, each once: those of
    ``rng.packed_events`` over the run."""
    R, K = 5, tfused.SUPER_K
    whole = trng.packed_events(11, 1, 3 * K, R, 0.1)
    for w0 in range(0, 3 * K, K):
        win = trng.packed_events(11, 1 + w0, K, R, 0.1)
        np.testing.assert_array_equal(win, whole[w0:w0 + K])
        counts, its, _ = tmig.segment_events(win, R)
        np.testing.assert_array_equal(counts, win.sum(0))
        for r in range(R):
            np.testing.assert_array_equal(its[r, :counts[r]],
                                          np.flatnonzero(win[:, r]))
    assert whole.any() and not trng.packed_events(11, 1, K, R, 0.0).any()
    replayed = []
    real = tmig.migrate_segments_plain

    def spy(theta, w, G, Np, reps, it, fire=None, events=None):
        assert fire is None and not reps.local
        for r in range(reps.n_reps):
            replayed[-1] += [(r, it + int(t))
                             for t in events.its[r, :events.counts[r]]]
        real(theta, w, G, Np, reps, it, fire, events)
    monkeypatch.setattr(tmig, "migrate_segments_plain", spy)
    models = [tgauss.make_model(x) for x in DATASETS]
    de = _de(alpha=0.2, burnin=0)
    spec = tdm.make_spec(models[0], de)
    seeds = trng.replication_seeds(2, 3)
    for k_max in (1, K):
        replayed.append([])
        step = sampler.RepStep(models, de, spec, "cpu", seeds, packed_key=2)
        step.__dict__["superstep_k"] = k_max
        state = sampler._rep_state(models, de, spec, seeds, "cpu")
        plan = step.plan(state, 2 * K)
        assert len(plan) == 2 * K // k_max
        _, ys = sampler.run_scan(step, state, 2 * K)
        assert np.isfinite(ys.theta).all()
    ev = trng.packed_events(2, 1, 2 * K, 3, 0.2)
    want = sorted((int(r), 1 + int(i)) for i, r in zip(*np.nonzero(ev)))
    assert len(want) > 10
    assert sorted(replayed[0]) == want and sorted(replayed[1]) == want


def test_packed_refuses_what_takes_no_replicated_k1():
    """DE-MCz (K3, not K1), float64 and a model without a CUDA density
    raise ``ValueError`` naming ``sample_replicated``."""
    for de in (_de(sample="resample", n_initial=10, n_groups=1),
               _de(dtype=np.float64)):
        with pytest.raises(ValueError, match="use sample_replicated"):
            tdm.sample_replicated_packed(tgauss.make_model, de, 40,
                                         DATASETS, device="cpu")
    with pytest.raises(ValueError, match="use sample_replicated"):
        tdm.sample_replicated_packed(
            lambda x: dataclasses.replace(tgauss.make_model(x),
                                          cuda_density=None),
            _de(), 40, DATASETS, device="cpu")


# ------------------------------------------------ (d) the kernels' plain
# versions against their references


def test_plain_replicated_k1_matches_jax_packed_kernel(member_gather,
                                                       monkeypatch):
    """The plain replicated K1 (global chain words, as a packed run draws
    them) against the JAX package's packed fused kernel in interpret mode
    (``build_fused_step`` on ``_packed_setup``'s packed model: each data
    leaf a per-chain constant, α = 0) on the same words, R = 4, G = 4,
    Np = 4, K = 4 iterations crossing burn-in: θ and w to rtol 1e-5 /
    atol 1e-6 (XLA fuses a·b + c on the CPU), accept flags exactly away
    from near-ties."""
    R, G_, Np_, K, burnin = 4, 4, 4, 4, 2
    C_ = R * G_ * Np_
    datasets = np.random.default_rng(8).normal(
        np.linspace(-1, 1, R)[:, None], 1.0, (R, 50)).astype(np.float32)
    jde = dm.DE(Np=Np_, n_groups=G_, burnin=burnin, bounds=jgauss.BOUNDS)
    built = {}

    class Built(Exception):
        """The packed model reached ``build_step`` (on the CPU the JAX
        package steps through XLA, so the setup stops there)."""

    def capture(model, de, spec, *a, **k):
        built.update(model=model, de=de, spec=spec)
        raise Built
    monkeypatch.setattr(jsampler, "build_step", capture)
    with pytest.raises(Built):
        jsampler._packed_setup(jgauss.make_model, jde,
                               jnp.asarray(datasets), 0)
    assert built["de"].n_groups == R * G_ and built["de"].alpha == 0.0
    kern = jfused.build_fused_step(built["model"], built["de"],
                                   built["spec"], interpret=True, K=K,
                                   mig_in_kernel=True)
    g = np.random.default_rng(9)
    mu = g.normal(np.repeat(datasets.mean(1), G_ * Np_), 0.2)
    sigma = np.abs(g.normal(1.0, 0.2, C_)) + 0.05
    theta = np.stack([mu, sigma], 1).astype(np.float32)
    w = np.concatenate([np.asarray(
        jgauss.prior_loglike_batched(theta[sl, 0], theta[sl, 1])
        + jgauss.loglike_batched(datasets[r], theta[sl, 0], theta[sl, 1]),
        np.float32) for r, sl in enumerate(
            slice(r * G_ * Np_, (r + 1) * G_ * Np_) for r in range(R))])
    key2 = np.array([0x51, 0xC0DE], np.uint32)
    it0 = 1
    Rr, Cf = 8, C_ // 8
    jt, jw, jacc, _ = (np.asarray(o) for o in jax.jit(kern)(
        jnp.asarray(theta.T.reshape(2, Rr, Cf)), jnp.asarray(w.reshape(Rr, Cf)),
        jnp.asarray(key2), jnp.int32(it0), jnp.zeros((1, 1), jnp.int32)))

    models = [tgauss.make_model(x) for x in datasets]
    de = tdm.DE(Np=Np_, n_groups=G_, burnin=burnin, bounds=tgauss.BOUNDS)
    spec = tdm.make_spec(models[0], de)
    step = sampler.RepStep(models, de, spec, "cpu", [0] * R, packed_key=0)
    cfg = step.cfg
    assert cfg.rows.n_words == kern.n_words and not cfg.reps.local
    th, ww = torch.tensor(theta), torch.tensor(w)
    fire = torch.zeros(R, dtype=torch.int32)
    for k in range(K):
        words = _bits(key2, it0 + k, kern.n_words, C_)
        margin = tfused.de_step_rep_plain(cfg, spec, th, ww, fire, it0 + k,
                                          words)
        assert (margin.abs() > 1e-4).all(), "near-tie at this seed"
        np.testing.assert_allclose(th.numpy(), jt[k].reshape(2, C_).T,
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(ww.numpy(), jw[k].reshape(C_),
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_array_equal((margin <= 0).numpy(),
                                      jacc[k].reshape(C_))


@pytest.mark.parametrize("mode", ["fire-local", "fire-global", "events"])
def test_plain_segmented_k2_matches_the_oracle_per_segment(mode):
    """The plain segmented K2 on R = 6 replications of 4 groups of 5: each
    replication's exchange is ``_np_migration_oracle`` on its own words
    (its seed; local or global chain words; a packed window's events each
    on the words of its own iteration, ``PACKED_MIG_NS``), and nothing
    moves between replications."""
    R, G_, Np_, d = 6, 4, 5, 2
    Cr = G_ * Np_
    g = np.random.default_rng(12)
    seeds = [int(x) for x in g.integers(0, 2 ** 62, R)]
    theta = g.normal(size=(R * Cr, d)).astype(np.float32)
    w = g.normal(size=R * Cr).astype(np.float32)
    local = mode == "fire-local"
    fire = events = None
    if mode.startswith("fire"):
        fire = torch.tensor([1, 0, 1, 1, 0, 1], dtype=torch.int32)
    else:
        ev = np.zeros((8, R), dtype=bool)
        ev[[0, 3, 7], 0] = ev[[2], 2] = ev[[1, 2], 5] = True
        events = tmig.segment_events(ev, R)
    th, ww = torch.tensor(theta), torch.tensor(w)
    reps = tfused.Replicas(tuple(seeds), local, Cr, None, ())
    tmig.migrate_segments(th, ww, G_, Np_, reps, 31, fire=fire,
                          events=events)
    tn = theta.reshape(R, G_, Np_, d).copy()
    wn = w.reshape(R, G_, Np_).copy()
    for r in range(R):
        if fire is not None:
            its, ns = ([31] if int(fire[r]) else []), trng.STEP_NS
        else:
            its = [31 + int(x) for x in events[1][r, :events[0][r]]]
            ns = trng.PACKED_MIG_NS
        for t in its:
            words = trng.words(seeds[r], t, tmig.N_ROWS, Cr, ns=ns,
                               chain0=0 if local else r * Cr)
            u, n_act, gum = tmig.draws(words, G_, Np_)
            tn[r], wn[r] = _np_migration_oracle(tn[r], wn[r], u.numpy(),
                                                int(n_act), gum.numpy())
    np.testing.assert_array_equal(th.numpy(), tn.reshape(-1, d))
    np.testing.assert_array_equal(ww.numpy(), wn.reshape(-1))
    assert not np.array_equal(th.numpy(), theta)


def test_plain_replicated_k1_is_each_solo_plain_k1():
    """The plain replicated K1 with local chain words: each replication's
    slice after a window of 8 (α = 0) is the solo plain K1 on its model,
    seed and chains; at α = 0.5, iteration by iteration, so are its chains
    and its gate in ``fire[r]`` (both gate values seen); the wrapper takes
    the plain version on CPU tensors and counts no launch."""
    models = [tgauss.make_model(x) for x in DATASETS]
    seeds = [21, 22, 23]
    for alpha, K, its in ((0.0, 8, (3,)), (0.5, 1, range(3, 11))):
        de = _de(alpha=alpha, burnin=2)
        spec = tdm.make_spec(models[0], de)
        step = sampler.RepStep(models, de, spec, "cpu", seeds)
        state = sampler._rep_state(models, de, spec, seeds, "cpu")
        th, ww, fire = (state.theta.clone(), state.weight.clone(),
                        state.fire.clone())
        Cr = step.reps.c_rep
        solo = [[state.theta[r * Cr:(r + 1) * Cr].clone(),
                 state.weight[r * Cr:(r + 1) * Cr].clone(),
                 state.fire[r:r + 1].clone()] for r in range(3)]
        gates = set()
        before = tfused.de_step_rep.launches
        for it in its:
            tfused.de_step_rep(step.cfg, spec, th, ww, fire, it, K=K,
                               phase="post")
            for r in range(3):
                sl = slice(r * Cr, (r + 1) * Cr)
                cfg = tfused.StepConfig.make(models[r], de, spec)
                tfused.de_step(cfg, models[r], spec, *solo[r], it,
                               seed=seeds[r], K=K, phase="post")
                assert torch.equal(th[sl], solo[r][0])
                assert torch.equal(ww[sl], solo[r][1])
                assert int(fire[r]) == int(solo[r][2][0])
                gates.add(int(fire[r]))
        assert tfused.de_step_rep.launches == before
        if alpha > 0.0:
            assert gates == {0, 1}


# ------------------------------------------------ (e) refusals


def test_density_table_refuses_mixed_densities():
    """One replicated launch takes one density with data of one shape:
    two densities, or constants of two lengths, raise."""
    from demcmc_tpu_torch.model import CudaDensity, DensityTable
    a = CudaDensity("gaussian", (1.0, 2.0))
    with pytest.raises(ValueError, match="differs from replication 0"):
        DensityTable.stack([a, CudaDensity("rastrigin", (1.0, 2.0))])
    with pytest.raises(ValueError, match="differs from replication 0"):
        DensityTable.stack([a, CudaDensity("gaussian", (1.0,))])
    with pytest.raises(ValueError, match="differs from replication 0"):
        DensityTable.stack([
            CudaDensity("lba", (1.0,), data=np.zeros((3, 2))),
            CudaDensity("lba", (1.0,), data=np.zeros((4, 2)))])
    t = DensityTable.stack([
        CudaDensity("lba", (1.0,), data=np.zeros((3, 2))),
        CudaDensity("lba", (2.0,), data=np.ones((3, 2)))])
    assert t.params.shape == (2, 1) and t.data.shape == (2, 6)
    assert t.n_reps == 2 and t.params[1, 0] == 2.0


def test_replication_seeds_are_a_pure_function_of_the_key():
    """``rng.replication_seeds``: R distinct 64-bit seeds, the same for the
    same key, a prefix for fewer replications, others for another key."""
    a = trng.replication_seeds(5, 8)
    assert a == trng.replication_seeds(5, 8) and a[:3] == \
        trng.replication_seeds(5, 3)
    assert len(set(a)) == 8 and all(0 <= x < 2 ** 64 for x in a)
    assert not set(a) & set(trng.replication_seeds(6, 8))


def test_replicated_cells_keep_the_bench_width():
    """The card's replicated cells (``port_cells.REP_CELL``,
    ``OPT_REP_CELL``) keep ``bench.py:133-161``'s width (64 replications
    of the Gaussian, Np = 4 × G = 4, burn-in 100, α = 0.1, the datasets
    one [64, 50] draw from numpy seed 5) and
    ``tests/test_replicated.py:105-131``'s (G = 2, Np = 12, 60
    observations, 1,500 iterations)."""
    import port_cells as pc
    c = pc.REP_CELL
    assert (c["n_reps"], c["Np"], c["n_groups"], c["burnin"], c["alpha"],
            c["n_obs"]) == (64, 4, 4, 100, 0.1, 50)
    np.testing.assert_array_equal(
        pc.rep_datasets(), np.random.default_rng(5).normal(
            0, 1, (64, 50)).astype(np.float32))
    o = pc.OPT_REP_CELL
    assert (o["n_groups"], o["Np"], o["n_obs"], o["n_iter"]) == \
        (2, 12, 60, 1500)
    assert pc.opt_rep_datasets().shape == (64, 60)
