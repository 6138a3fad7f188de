"""``sample(mesh=)`` and ``optimize(mesh=)`` in the port
(``demcmc_tpu_torch.parallel``, ``sampler.ShardedStep``) on the CPU,
where a mesh of ``["cpu"] * D`` runs D shards in one process and the
wrappers run their plain versions.

(a) A shard's words are the columns of the population's draw: Philox
    words of chains ``chain0 ..`` and the unfused step's pool rows of
    groups ``g0 ..``.
(b) K1's plain version on a shard (``de_step(..., chain0=)`` on the
    shard's ``local_config``) equals the shard's slice of the whole
    population's step, bits-in and on Philox words, across burn-in; every
    shard writes the population's gate.
(c) Sharded runs equal the unsharded run bit for bit, for 1, 2, 4 and 8
    shards: the kernels' step (the Gaussian with α = 0.5, thin 1 and 5,
    snooker, two constant blocks, the ABC binomial's noise panel), the
    unfused step (the Gaussian, ``abc_kde``'s fixed panel) and
    ``optimize``; a resume under a mesh equals one run; the plain calls
    follow the plan.
(d) The port's 8-shard Gaussian agrees with the JAX package's
    ``sample(..., mesh=chain_mesh(8))`` statistically.
(e) What a mesh refuses.
(f) Every kernel launches with its tensors' card made current, so the
    shards of a mesh over several cards launch on their own cards.
"""

import functools
import pathlib
import types

import numpy as np
import pytest
import torch

import demcmc_tpu as dm
from demcmc_tpu.models import gaussian as jgauss
from demcmc_tpu.parallel import chain_mesh as jchain_mesh

import demcmc_tpu_torch as tdm
from demcmc_tpu_torch import parallel as tpar
from demcmc_tpu_torch import rng as trng
from demcmc_tpu_torch import sampler
from demcmc_tpu_torch.models import abc_kde as tkde
from demcmc_tpu_torch.models import binomial as tbinom
from demcmc_tpu_torch.models import gaussian as tgauss
from demcmc_tpu_torch.models import rastrigin as trast
from demcmc_tpu_torch.ops import _build as tbuild
from demcmc_tpu_torch.ops import fused_step as tfused
from demcmc_tpu_torch.ops import migration as tmig

DATA = np.asarray(np.random.default_rng(3).normal(0.3, 1.2, 50), np.float32)
SHARDS = (1, 2, 4, 8)
G, NP = 8, 4
N_ITER, BURNIN = 30, 15


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _mesh(D):
    return tdm.chain_mesh(devices=["cpu"] * D)


def _gauss(**kw):
    kw = {"Np": NP, "n_groups": G, "burnin": BURNIN, "alpha": 0.5,
          "discard_burnin": False, **kw}
    return tgauss.make(data=DATA, **kw)


# (model, de) makers and sample() options of the bitwise cases
CASES = {
    "gauss": (_gauss, {}),
    "gauss-thin5": (_gauss, {"thin": 5}),
    "snooker": (functools.partial(_gauss, theta_snooker=0.5), {}),
    "blocks": (functools.partial(_gauss, blocks=[[True, False],
                                                 [False, True]],
                                 blocking_on=True), {}),
    "abc": (lambda: tbinom.make(N=10, k=6, abc=True, fresh_noise=True,
                                n_sim=64, Np=NP,
                                n_groups=G, burnin=BURNIN, alpha=0.5,
                                discard_burnin=False), {}),
    "unfused": (_gauss, {"allow_fused": False}),
    "kde": (lambda: tkde.make(n_obs=20, n_sim=64, Np=NP, n_groups=G,
                              burnin=BURNIN, alpha=0.5,
                              discard_burnin=False),
            {"allow_fused": False}),
}


@functools.lru_cache(maxsize=None)
def _unsharded(case):
    make, kw = CASES[case]
    model, de = make()
    chains, state = tdm.sample(model, de, N_ITER, key=5, device="cpu",
                               return_state=True, **kw)
    return chains, state


def _same_state(a, b):
    assert torch.equal(a.theta, b.theta)
    assert torch.equal(a.weight, b.weight)
    assert torch.equal(a.fire, b.fire)
    assert a.iteration == b.iteration and a.key == b.key


# ------------------------------------------------------------------ (a)


def test_shard_words_are_columns_of_the_population_draw():
    full = trng.words_block(9, 17, 3, 11, 40, ns=trng.STEP_NS)
    for c0, n in ((0, 40), (8, 12), (36, 4)):
        part = trng.words_block(9, 17, 3, 11, n, ns=trng.STEP_NS, chain0=c0)
        assert torch.equal(part, full[:, :, c0:c0 + n])
        assert torch.equal(trng.words(9, 17, 11, n, chain0=c0, row0=2),
                           trng.words(9, 17, 11 + 2, 40)[2:, c0:c0 + n])


def test_shard_pool_holds_its_groups_rows():
    """A shard's unfused step draws its groups' rows of the population's
    pool, and the scalar side channel of the population."""
    model, de = _gauss()
    spec = tdm.make_spec(model, de)
    full = tdm.UnfusedStep(model, de, spec, "cpu")
    for g0, n in tfused.shard_groups(G, 3):
        part = tdm.UnfusedStep(model, de, spec, "cpu", groups=(g0, n))
        assert part.pool_words == full.pool_words
        for it in (1, 70):
            assert torch.equal(part.draws(4, it).bits,
                               full.draws(4, it).bits[g0:g0 + n])
            assert part.scalar_words(4, it) == full.scalar_words(4, it)


def test_shard_groups_are_contiguous_and_even():
    assert tfused.shard_groups(8, 3) == [(0, 3), (3, 3), (6, 2)]
    assert tfused.shard_groups(4, 4) == [(0, 1), (1, 1), (2, 1), (3, 1)]
    sizes = [len(t) for t in torch.tensor_split(torch.arange(11), 4)]
    assert [n for _, n in tfused.shard_groups(11, 4)] == sizes


# ------------------------------------------------------------------ (b)


@pytest.mark.parametrize("words", ["bits", "philox"])
def test_plain_k1_on_a_shard_is_a_slice_of_the_population_step(words):
    """Eight iterations crossing burn-in 4, from a state whose gate is
    set: each shard of the 8 × 4 population, stepped alone with its
    ``chain0``, equals its slice of the whole population's step, and
    every shard writes the population's gate."""
    model, de = _gauss(burnin=4, theta_snooker=0.25)
    spec = tdm.make_spec(model, de)
    cfg = tfused.StepConfig.make(model, de, spec)
    full = tdm.init_state(model, de, spec, 2, device="cpu")
    full.fire.fill_(1)
    groups = tfused.shard_groups(G, 3)
    shards = [(tfused.local_config(cfg, n), g0 * NP,
               full.theta[g0 * NP:(g0 + n) * NP].clone(),
               full.weight[g0 * NP:(g0 + n) * NP].clone(),
               full.fire.clone()) for g0, n in groups]
    gen = np.random.default_rng(0)
    fires = set()
    for it in range(1, 9):
        bits = None
        if words == "bits":
            bits = torch.from_numpy(gen.integers(
                0, 2 ** 32, (cfg.rows.n_words, G * NP),
                dtype=np.uint64).astype(np.uint32))
        tfused.de_step(cfg, model, spec, full.theta, full.weight, full.fire,
                       it, seed=6, bits=bits)
        for scfg, c0, th, w, fire in shards:
            tfused.de_step(scfg, model, spec, th, w, fire, it, seed=6,
                           bits=bits, chain0=c0)
            assert torch.equal(th, full.theta[c0:c0 + th.shape[0]])
            assert torch.equal(w, full.weight[c0:c0 + th.shape[0]])
            assert torch.equal(fire, full.fire)
        fires.add(int(full.fire[0]))
    assert fires == {0, 1}


def test_shard_words_must_hold_the_population():
    model, de = _gauss()
    spec = tdm.make_spec(model, de)
    cfg = tfused.local_config(tfused.StepConfig.make(model, de, spec), 2)
    s = tdm.init_state(model, de, spec, 2, device="cpu")
    bits = torch.zeros((cfg.rows.n_words, 2 * NP), dtype=torch.uint32)
    with pytest.raises(ValueError, match="population"):
        tfused.de_step(cfg, model, spec, s.theta[:8].clone(),
                       s.weight[:8].clone(), s.fire.clone(), 1, bits=bits,
                       chain0=8)


# ------------------------------------------------------------------ (c)


@pytest.mark.parametrize("D", SHARDS)
@pytest.mark.parametrize("case", list(CASES))
def test_sharded_sample_equals_unsharded(case, D):
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
        assert isinstance(step, tdm.ShardedStep)
        assert step.fused is (case not in ("unfused", "kde"))


OPT_CASES = {
    "max": lambda: tgauss.make_mle(data=DATA, Np=NP, n_groups=G,
                                   burnin=BURNIN, alpha=0.5),
    "min": lambda: trast.make(n_dim=2, Np=NP, n_groups=G, dtype=np.float32,
                              burnin=BURNIN, alpha=0.5),
    "min-float64": lambda: trast.make(n_dim=2, Np=NP, n_groups=G,
                                      burnin=BURNIN, alpha=0.5),
}


@pytest.mark.parametrize("D", SHARDS)
@pytest.mark.parametrize("case", list(OPT_CASES))
def test_sharded_optimize_equals_unsharded(case, D):
    """K1's greedy max and min per shard, and float64 through the unfused
    step per shard."""
    model, de = OPT_CASES[case]()
    ref = tdm.optimize(model, de, 2 * N_ITER, key=7, device="cpu")
    pop = tdm.optimize(model, de, 2 * N_ITER, key=7, device="cpu",
                       mesh=_mesh(D))
    np.testing.assert_array_equal(pop.theta, ref.theta)
    np.testing.assert_array_equal(pop.weight, ref.weight)
    assert pop.theta.dtype == (np.float64 if "float64" in case
                               else np.float32)


@pytest.mark.parametrize("allow_fused", [True, False],
                         ids=["kernels", "unfused"])
def test_mesh_of_distinct_devices_equals_unsharded(allow_fused):
    """A mesh whose devices differ, called without ``device=`` as a mesh
    of several cards is: here ``cpu`` and ``cpu:0``, two ``torch.device``s
    of the one CPU.  ``sample()`` and ``optimize()`` equal their unsharded
    runs."""
    mesh = tdm.chain_mesh(devices=["cpu", "cpu:0", "cpu", "cpu:0"])
    model, de = _gauss()
    ref = tdm.sample(model, de, N_ITER, key=5, device="cpu",
                     allow_fused=allow_fused)
    chains = tdm.sample(model, de, N_ITER, key=5, mesh=mesh,
                        allow_fused=allow_fused)
    np.testing.assert_array_equal(chains.data, ref.data)
    np.testing.assert_array_equal(chains.lp, ref.lp)
    model, de = OPT_CASES["max" if allow_fused else "min-float64"]()
    ref = tdm.optimize(model, de, N_ITER, key=7, device="cpu")
    pop = tdm.optimize(model, de, N_ITER, key=7, mesh=mesh)
    np.testing.assert_array_equal(pop.theta, ref.theta)
    np.testing.assert_array_equal(pop.weight, ref.weight)


@pytest.mark.parametrize("allow_fused", [True, False],
                         ids=["kernels", "unfused"])
def test_sharded_resume_is_one_run(allow_fused):
    """N/2 + N/2 iterations under a mesh of 3 shards (groups 3, 3, 2),
    through the returned (gathered) state and ``state=`` (split again),
    equal N unsharded."""
    model, de = _gauss()
    kw = {"key": 5, "device": "cpu", "return_state": True,
          "allow_fused": allow_fused}
    ref, ref_state = tdm.sample(model, de, N_ITER, **kw)
    a, mid = tdm.sample(model, de, N_ITER // 2, mesh=_mesh(3), **kw)
    assert mid.theta.shape == (G * NP, 2)
    b, end = tdm.sample(model, de, N_ITER // 2, mesh=_mesh(3), state=mid,
                        **kw)
    np.testing.assert_array_equal(np.concatenate([a.data, b.data]),
                                  ref.data)
    _same_state(end, ref_state)


def test_sharded_run_follows_the_plan(monkeypatch):
    """The plain calls of a 4-shard run: K1 once per window and shard,
    K2 once per open gate on the whole population."""
    model, de = _gauss()
    calls = {"de_step": [], "migrate": []}
    k1, k2 = tfused.de_step_plain, tmig.migrate_plain

    def rec_k1(cfg, model, spec, theta, *a, **kw):
        calls["de_step"].append(theta.shape[0])
        return k1(cfg, model, spec, theta, *a, **kw)

    def rec_k2(theta, *a, **kw):
        calls["migrate"].append(theta.shape[0])
        return k2(theta, *a, **kw)
    monkeypatch.setattr(tfused, "de_step_plain", rec_k1)
    monkeypatch.setattr(tmig, "migrate_plain", rec_k2)
    spec = tdm.make_spec(model, de)
    step = tdm.build_step(model, de, spec, mesh=_mesh(4))
    state = step.split(tdm.init_state(model, de, spec, 5, device="cpu"))
    windows = step.plan(state, N_ITER)
    opened = sum(w.migrate for w in windows)
    tdm.run_scan(step, state, N_ITER)
    assert opened >= 3
    assert calls["de_step"] == [2 * NP] * (4 * len(windows))
    assert calls["migrate"] == [G * NP] * opened


# ------------------------------------------------------------------ (d)


def test_sharded_gaussian_agrees_with_jax_mesh_run(eight_devices):
    """The configuration of ``tests/test_sharding.py::
    test_sharded_statistically_equals_unsharded`` (30 observations, here
    from numpy seed 5, G = 8 × Np = 8), shortened to 450 iterations with
    a burn-in of 150: 300 draws of 64 chains, about 1,700 effective draws
    of μ and 1,000 of σ (posterior sds 0.16 and 0.12), so each run's
    means carry a Monte Carlo error of about 0.004 and the difference of
    the two about 0.006, a ninth of that test's tolerance of 0.05 on the
    means; sd(μ)'s difference about 0.004 against 0.03."""
    data = np.random.default_rng(5).standard_normal(30)
    jmodel, jde = jgauss.make(data=data, burnin=150, n_groups=8, Np=8)
    jc = dm.sample(jmodel, jde, 450, key=4, mesh=jchain_mesh(8))
    model, de = tgauss.make(data=data, burnin=150, n_groups=8, Np=8)
    tc = tdm.sample(model, de, 450, key=4, device="cpu", mesh=_mesh(8))
    assert tc.data.shape == jc.data.shape == (300, 2, 64)
    assert abs(jc.mean("mu") - tc.mean("mu")) < 0.05
    assert abs(jc.mean("sigma") - tc.mean("sigma")) < 0.05
    assert abs(jc.std("mu") - tc.std("mu")) < 0.03


# ------------------------------------------------------------------ (e)


def test_mesh_refusals(tmp_path):
    """What a mesh still refuses: ``shard_data`` on a mesh with no ``data``
    axis and on a size that does not divide over it (the JAX messages),
    a data axis under a process group (a one-process gloo group here;
    ROADMAP.md A10 rest 6), too many shards, a non-mesh, and a
    ``device=`` other than the mesh's."""
    model, de = _gauss()
    with pytest.raises(ValueError, match="mesh has no axis 'data'"):
        tpar.shard_data(DATA, _mesh(2))
    with pytest.raises(ValueError, match="not divisible by the 4-way 'data' "
                       "mesh axis"):
        tpar.shard_data(DATA[:50], tpar.data_mesh(1, 4,
                                                  devices=["cpu"] * 4))
    torch.distributed.init_process_group(
        "gloo", init_method="file://" + str(tmp_path / "rdv"),
        world_size=1, rank=0)
    try:
        with pytest.raises(NotImplementedError, match="process group.*"
                           "ROADMAP.md A10 rest 6"):
            tpar.shard_data(DATA, tpar.data_mesh(1, 2, devices=["cpu"] * 2))
    finally:
        torch.distributed.destroy_process_group()
    with pytest.raises(ValueError, match="every shard needs a group"):
        tdm.sample(model, de, 10, device="cpu", mesh=_mesh(G + 1))
    with pytest.raises(TypeError, match="chain mesh"):
        tdm.optimize(*tgauss.make_mle(data=DATA, Np=NP, n_groups=G), 10,
                     device="cpu", mesh=[torch.device("cpu")] * 2)
    with pytest.raises(ValueError, match="device="):
        tdm.sample(model, de, 10, device="cuda", mesh=_mesh(2))


def test_chain_mesh_without_cuda_raises():
    """``chain_mesh()`` spans the visible GPUs: with none, and no
    ``devices``, it raises; it never builds a CPU mesh by itself."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tpar.chain_mesh()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tpar.chain_mesh(devices=["cuda:0"] * 2)
    mesh = tpar.chain_mesh(3, devices=["cpu"] * 4)
    assert mesh.devices.size == 3 and mesh.shape == {"chains": 3}
    assert mesh.axis_names == ("chains",)
    assert all(d == torch.device("cpu") for d in mesh.devices)


def test_one_device_mesh_is_the_plain_path():
    model, de = _gauss()
    spec = tdm.make_spec(model, de)
    step = tdm.build_step(model, de, spec, mesh=_mesh(1))
    assert type(step) is sampler.Step and step.device.type == "cpu"
    mcz = de.replace(sample="resample", n_initial=8)
    chains = tdm.sample(model, mcz, 6, device="cpu", mesh=_mesh(1))
    assert chains.data.shape[0] == 6


# ------------------------------------------------------------------ (f)


@pytest.fixture
def fake_cards(monkeypatch):
    """CUDA faked on the CPU: ``torch.cuda.device`` sets a current card
    (0 at the start), each card's current stream is ``100 + index``, and
    every library entry records the current card and the stream it was
    passed; returns the records."""
    current, calls = [0], []

    class device:
        def __init__(self, d):
            self.idx = torch.device(d).index

        def __enter__(self):
            self.prev, current[0] = current[0], self.idx

        def __exit__(self, *exc):
            current[0] = self.prev

    class Lib:
        def __getattr__(self, name):
            def entry(*args):
                calls.append((name, current[0], args[-1]))
                return 0
            return entry

    monkeypatch.setattr(torch.cuda, "device", device)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda d: (
        types.SimpleNamespace(cuda_stream=100 + torch.device(d).index)))
    monkeypatch.setattr(tbuild, "library", lambda name: Lib())
    yield calls
    assert current == [0]


class _OnCard1:
    """A stand-in for a float32 CUDA tensor on cuda:1."""

    def __init__(self, *shape):
        self.shape, self.device = shape, torch.device("cuda", 1)

    def data_ptr(self):
        return 0


def test_launches_make_the_tensors_card_current(fake_cards, monkeypatch):
    """K1 and K2 on tensors of cuda:1 while cuda:0 is current launch with
    cuda:1 current, on cuda:1's stream (CUDA launches no kernel on a
    stream of another card than the current one)."""
    model, de = _gauss()
    cfg = tfused.StepConfig.make(model, de, tdm.make_spec(model, de))
    monkeypatch.setattr(tfused.StepConfig, "density_data",
                        lambda self, device: None)
    C = G * NP
    tfused.de_step(cfg, model, None, _OnCard1(C, 2), _OnCard1(C),
                   _OnCard1(1), 1, check=False, chain0=C)
    tmig.migrate(_OnCard1(C, 2), _OnCard1(C), _OnCard1(1), G, NP,
                 check=False)
    assert fake_cards == [(tfused._build.entry("de_step", cfg.density), 1,
                           101), ("migrate_f32", 1, 101)]


def test_only_the_launch_helper_reads_a_stream():
    """Every wrapper launches through ``_build.launch`` (which makes the
    tensors' card current): no other module of the port reads a current
    stream."""
    pkg = pathlib.Path(tdm.__file__).parent
    readers = sorted(str(p.relative_to(pkg)) for p in pkg.rglob("*.py")
                     if "current_stream" in p.read_text())
    assert readers == ["ops/_build.py"]
