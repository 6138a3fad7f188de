"""DE-MCz under a chain mesh in the port (``sampler.ShardedStep`` with a
history), on the CPU, where a mesh of ``["cpu"] * D`` runs D shards in
one process and K3 runs its plain version.

(a) K3's plain version on a shard (``resample_step(..., chain0=)`` on the
    shard's ``local_config`` and the population's history) equals the
    shard's slice of the whole population's K3, bits-in and on Philox
    words, across burn-in; the history columns a shard writes are its own.
(b) ``sample`` under 1, 2, 3 (uneven groups), 4 and 8 shards equals the
    unsharded run bit for bit, history included: the 512-chain mcz-mig
    Gaussian (α = 0.1, gates open), the two-block DE-MCz Gaussian, the
    unfused DE-MCz (``allow_fused=False``); a mesh of distinct devices
    (one history replica each, rows copied between them); a resume; and
    ``optimize`` of DE-MCz.
(c) The JAX package's ``test_sharded_resample_history`` configuration on
    8 shards: finite, bit for bit the port's unsharded run, its means in
    statistical agreement with the JAX package's 8-device run.
"""

import functools

import numpy as np
import pytest
import torch

import demcmc_tpu as dm
from demcmc_tpu.models import mvnormal as jmvn
from demcmc_tpu.parallel import chain_mesh as jchain_mesh

import demcmc_tpu_torch as tdm
from demcmc_tpu_torch.models import gaussian as tgauss
from demcmc_tpu_torch.models import mvnormal as tmvn
from demcmc_tpu_torch.ops import fused_step as tfused
from demcmc_tpu_torch.ops import resample_step as tres

DATA = np.asarray(np.random.default_rng(3).normal(0.3, 1.2, 50), np.float32)
SHARDS = (1, 2, 3, 4, 8)
N_ITER, BURNIN = 24, 12
K3_BURNIN = 54      # (a)'s eight iterations from n_initial + 1 = 51 cross it


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _mesh(D):
    return tdm.chain_mesh(devices=["cpu"] * D)


def _mcz_mig(**kw):
    """The mcz-mig cell's configuration (``port_cells.MCZ_MIG_CELL``: G =
    128 × Np = 4, n_initial 50, θs = 0.1, α = 0.1, synchronous), with a
    short burn-in."""
    kw = {"n_groups": 128, "Np": 4, "n_initial": 50, "theta_snooker": 0.1,
          "alpha": 0.1, "sweep": "sync", "burnin": BURNIN,
          "discard_burnin": False, "sample": "resample", **kw}
    return tgauss.make(data=DATA, **kw)


def _small(**kw):
    kw = {"n_groups": 8, "Np": 4, "n_initial": 10, "alpha": 0.5,
          "burnin": BURNIN, "discard_burnin": False, "sample": "resample",
          **kw}
    return tgauss.make(data=DATA, **kw)


CASES = {
    "mcz-mig": (_mcz_mig, {}),
    "blocks": (functools.partial(_small, blocks=[[True, False],
                                                 [False, True]],
                                 blocking_on=True), {}),
    "unfused": (functools.partial(_small, theta_snooker=0.2),
                {"allow_fused": False}),
}


@functools.lru_cache(maxsize=None)
def _unsharded(case):
    make, kw = CASES[case]
    model, de = make()
    return tdm.sample(model, de, N_ITER, key=5, device="cpu",
                      return_state=True, **kw)


def _same_state(a, b):
    for k in ("theta", "weight", "fire", "history"):
        assert torch.equal(getattr(a, k), getattr(b, k)), k
    assert a.iteration == b.iteration and a.key == b.key


# ------------------------------------------------------------------ (a)


@pytest.mark.parametrize("words", ["bits", "philox"])
def test_plain_k3_on_a_shard_is_a_slice_of_the_population_step(words):
    """Eight iterations crossing burn-in, from a state whose gate is set,
    on the mcz-mig configuration (α = 0.1, snooker): each of 3 shards
    (uneven groups), stepped alone with its ``chain0`` on its own copy of
    the population's history, equals its slice of the whole population's
    K3, writes its own columns of row ``it − 1`` and no other, and writes
    the population's gate (α = 0.5 here, so it takes both values).
    Between iterations the shards' copies take the population's row, as
    the mesh's exchange gives it."""
    model, de = _mcz_mig(burnin=K3_BURNIN, theta_snooker=0.5, alpha=0.5)
    spec = tdm.make_spec(model, de)
    cfg = tfused.StepConfig.make(model, de, spec)
    full = tdm.sampler._grow_history(
        tdm.init_state(model, de, spec, 2, device="cpu"), 10)
    full.fire.fill_(1)
    C = de.n_chains
    groups = tfused.shard_groups(de.n_groups, 3)
    shards = []
    for g0, n in groups:
        a, b = g0 * de.Np, (g0 + n) * de.Np
        shards.append((tfused.local_config(cfg, n), a, b,
                       full.theta[a:b].clone(), full.weight[a:b].clone(),
                       full.fire.clone(), full.history.clone()))
    gen = np.random.default_rng(0)
    it0 = full.iteration
    fires = set()
    for it in range(it0, it0 + 8):
        bits = idx = None
        if words == "bits":
            bits = torch.from_numpy(gen.integers(
                0, 2 ** 32, (cfg.rows.n_words, C),
                dtype=np.uint64).astype(np.uint32))
            idx = tres.indices_from_words(cfg, torch.from_numpy(gen.integers(
                0, 2 ** 32, (tres.index_rows(cfg), C),
                dtype=np.uint64).astype(np.uint32)), it)
        before = full.history.clone()
        tres.resample_step(cfg, model, spec, full.theta, full.weight,
                           full.fire, full.history, it, seed=6, bits=bits,
                           idx=idx)
        for scfg, a, b, th, w, fire, hist in shards:
            tres.resample_step(scfg, model, spec, th, w, fire, hist, it,
                               seed=6, bits=bits,
                               idx=None if idx is None else idx[:, a:b],
                               chain0=a)
            assert torch.equal(th, full.theta[a:b])
            assert torch.equal(w, full.weight[a:b])
            assert torch.equal(fire, full.fire)
            assert torch.equal(hist[it - 1, a:b], full.history[it - 1, a:b])
            assert torch.equal(hist[it - 1, :a], before[it - 1, :a])
            assert torch.equal(hist[it - 1, b:], before[it - 1, b:])
            hist[it - 1].copy_(full.history[it - 1])
        fires.add(int(full.fire[0]))
    assert fires == {0, 1}


def test_k3_shard_refuses_windows_and_foreign_columns():
    """A shard steps one iteration a launch, on chains inside the
    population's history."""
    model, de = _small()
    spec = tdm.make_spec(model, de)
    cfg = tfused.StepConfig.make(model, de, spec)
    s = tdm.sampler._grow_history(
        tdm.init_state(model, de, spec, 2, device="cpu"), 10)
    scfg = tfused.local_config(cfg, 2)
    th, w = s.theta[8:16].clone(), s.weight[8:16].clone()
    with pytest.raises(ValueError, match="one iteration a launch"):
        tres.resample_step(scfg, model, spec, th, w, s.fire.clone(),
                           s.history, s.iteration, K=2, chain0=8)
    with pytest.raises(ValueError, match="history of 32 chains"):
        tres.resample_step(scfg, model, spec, th, w, s.fire.clone(),
                           s.history, s.iteration, chain0=28)


# ------------------------------------------------------------------ (b)


@pytest.mark.parametrize("D", SHARDS)
@pytest.mark.parametrize("case", list(CASES))
def test_sharded_mcz_equals_unsharded(case, D):
    make, kw = CASES[case]
    model, de = make()
    ref, ref_state = _unsharded(case)
    chains, state = tdm.sample(model, de, N_ITER, key=5, device="cpu",
                               mesh=_mesh(D), return_state=True, **kw)
    np.testing.assert_array_equal(chains.data, ref.data)
    np.testing.assert_array_equal(chains.acceptance, ref.acceptance)
    np.testing.assert_array_equal(chains.lp, ref.lp)
    _same_state(state, ref_state)
    if D > 1:
        step = tdm.build_step(model, de, tdm.make_spec(model, de),
                              mesh=_mesh(D),
                              allow_fused=kw.get("allow_fused", True))
        assert step.fused is (case != "unfused")
        if step.fused:          # K3 one iteration a launch on a shard
            assert step.superstep_k == 1


def test_mcz_mig_gates_open_under_the_mesh():
    """The mcz-mig case's run crosses open gates: K2 runs on the gathered
    population (so migration and the history meet in the bitwise cases
    above)."""
    model, de = _mcz_mig()
    spec = tdm.make_spec(model, de)
    step = tdm.build_step(model, de, spec, mesh=_mesh(4))
    state = step.split(tdm.sampler._grow_history(
        tdm.init_state(model, de, spec, 5, device="cpu"), N_ITER))
    assert sum(w.migrate for w in step.plan(state, N_ITER)) >= 2


@pytest.mark.parametrize("allow_fused", [True, False],
                         ids=["kernels", "unfused"])
def test_distinct_devices_share_history_rows(allow_fused):
    """A mesh of ``cpu`` and ``cpu:0`` (two ``torch.device``s of the one
    CPU, as two cards are): one history replica a device, each shard's
    new rows copied to the other replica after every iteration; equal to
    the unsharded run, and both replicas end whole."""
    case = "mcz-mig" if allow_fused else "unfused"
    make, kw = CASES[case]
    model, de = make()
    ref, ref_state = _unsharded(case)
    spec = tdm.make_spec(model, de)
    mesh = tdm.chain_mesh(devices=["cpu", "cpu:0", "cpu", "cpu:0"])
    step = tdm.build_step(model, de, spec, mesh=mesh, **kw)
    state = step.split(tdm.sampler._grow_history(
        tdm.init_state(model, de, spec, 5, device="cpu"), N_ITER))
    hists = {id(s.history) for s in state.shards}
    assert len(hists) == 2
    state, ys = tdm.run_scan(step, state, N_ITER)
    for s in state.shards:
        assert torch.equal(s.history, ref_state.history)
    chains = tdm.sample(model, de, N_ITER, key=5, mesh=mesh, **kw)
    np.testing.assert_array_equal(chains.data, ref.data)


@pytest.mark.parametrize("allow_fused", [True, False],
                         ids=["kernels", "unfused"])
def test_sharded_mcz_resume_is_one_run(allow_fused):
    """N/2 + N/2 iterations under a mesh of 3 shards, through the
    returned (gathered) state, history included, and ``state=`` (split
    again), equal N unsharded."""
    model, de = _small()
    kw = {"key": 5, "device": "cpu", "return_state": True,
          "allow_fused": allow_fused}
    ref, ref_state = tdm.sample(model, de, N_ITER, **kw)
    a, mid = tdm.sample(model, de, N_ITER // 2, mesh=_mesh(3), **kw)
    b, end = tdm.sample(model, de, N_ITER // 2, mesh=_mesh(3), state=mid,
                        **kw)
    np.testing.assert_array_equal(np.concatenate([a.data, b.data]),
                                  ref.data)
    _same_state(end, ref_state)


@pytest.mark.parametrize("D", (2, 3))
def test_sharded_mcz_optimize_equals_unsharded(D):
    """DE-MCz optimization (the unfused step: K3 runs MH only) over a
    mesh equals the unsharded optimization."""
    model, de = tgauss.make_mle(data=DATA, Np=4, n_groups=8, burnin=BURNIN,
                                alpha=0.5, sample="resample", n_initial=10)
    ref = tdm.optimize(model, de, N_ITER, key=7, device="cpu")
    pop = tdm.optimize(model, de, N_ITER, key=7, device="cpu",
                       mesh=_mesh(D))
    np.testing.assert_array_equal(pop.theta, ref.theta)
    np.testing.assert_array_equal(pop.weight, ref.weight)


def test_sharded_mcz_follows_the_plan(monkeypatch):
    """The plain calls of a 4-shard DE-MCz run: K3 once per iteration and
    shard, K2 once per open gate on the whole population."""
    from demcmc_tpu_torch.ops import migration as tmig
    model, de = _mcz_mig()
    calls = {"k3": [], "k2": []}
    k3, k2 = tres.resample_step_plain, tmig.migrate_plain

    def rec_k3(cfg, model, spec, theta, *a, **kw):
        calls["k3"].append(theta.shape[0])
        return k3(cfg, model, spec, theta, *a, **kw)

    def rec_k2(theta, *a, **kw):
        calls["k2"].append(theta.shape[0])
        return k2(theta, *a, **kw)
    monkeypatch.setattr(tres, "resample_step_plain", rec_k3)
    monkeypatch.setattr(tmig, "migrate_plain", rec_k2)
    spec = tdm.make_spec(model, de)
    step = tdm.build_step(model, de, spec, mesh=_mesh(4))
    state = step.split(tdm.sampler._grow_history(
        tdm.init_state(model, de, spec, 5, device="cpu"), N_ITER))
    opened = sum(w.migrate for w in step.plan(state, N_ITER))
    tdm.run_scan(step, state, N_ITER)
    assert calls["k3"] == [de.n_chains // 4] * (4 * N_ITER)
    assert calls["k2"] == [de.n_chains] * opened


# ------------------------------------------------------------------ (c)


def test_sharded_resample_history_config_agrees_with_jax(eight_devices):
    """``tests/test_sharding.py::test_sharded_resample_history``'s
    configuration (mvnormal d = 4 on 30 observations from ``PRNGKey(1)``,
    8 groups × 3, n_initial 40, burn-in 200, 800 iterations) in the port,
    through the unfused step (no K3 density at d = 4): on 8 shards, finite
    and bit for bit the unsharded run, state and history, over the first
    240 iterations (past the burn-in; 8 one-group shards of the unfused
    step cost about 40 ms an iteration on the CPU, so the full 800 would
    take half a minute); the unsharded 800-iteration run's means against
    the JAX package's 8-device run on the same data.  600 kept draws of
    24 chains: μᵢ's posterior sd is about 1/√31 = 0.18 and σ's about
    0.07, and the two runs' means differ by about 0.015 and 0.006 at one
    Monte Carlo standard error (the chains' autocorrelation included), so
    0.08 and 0.04 are five of them."""
    jmodel, jde = jmvn.make(d=4, n_obs=30, key=1, burnin=200, n_groups=1,
                            Np=8)
    jde = jde.replace(n_groups=8, Np=3, n_initial=40)
    jc = dm.sample(jmodel, jde, 800, key=2, mesh=jchain_mesh(8))
    data = np.asarray(jmodel.data, np.float32)
    model, de = tmvn.make(data=data, burnin=200, n_groups=8, Np=3,
                          n_initial=40)
    assert model.cuda_density is None
    kw = {"key": 2, "device": "cpu", "return_state": True}
    tc, ts = tdm.sample(model, de, 240, mesh=_mesh(8), **kw)
    ref, rs = tdm.sample(model, de, 240, **kw)
    assert np.isfinite(tc.data).all() and tc.data.shape == (40, 5, 24)
    np.testing.assert_array_equal(tc.data, ref.data)
    _same_state(ts, rs)
    full = tdm.sample(model, de, 800, key=2, device="cpu")
    assert full.data.shape == np.asarray(jc.data).shape == (600, 5, 24)
    for i in range(1, 5):
        name = f"mu[{i}]"
        assert abs(jc.mean(name) - full.mean(name)) < 0.08, name
    assert abs(jc.mean("sigma") - full.mean("sigma")) < 0.04
