"""What the port must not do: import JAX or the JAX package, fall back to
the CPU when CUDA is asked for and missing, or run a setting it does not
carry yet."""

import ast
import pathlib

import numpy as np
import pytest
import torch

import demcmc_tpu_torch as tdm
from demcmc_tpu_torch.models import gaussian as tgauss
from demcmc_tpu_torch.ops import fused_step as tfused
from demcmc_tpu_torch.ops import migration as tmig

PKG = pathlib.Path(tdm.__file__).resolve().parent
DATA = np.zeros(10, np.float32)


def _imported_roots(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_port_imports_neither_jax_nor_the_jax_package():
    files = sorted(PKG.rglob("*.py"))
    assert len(files) >= 15
    bad = {(str(f.relative_to(PKG)), root) for f in files
           for root in _imported_roots(f)
           if root in ("jax", "jaxlib", "demcmc_tpu")}
    assert not bad


@pytest.mark.parametrize("rel", ["sampler.py", "ops/kde.py", "utils/kde.py",
                                 "models/abc_kde.py", "models/lnr.py",
                                 "models/binomial.py",
                                 "models/hierarchical.py",
                                 "models/lotka_volterra.py",
                                 "utils/dists.py", "rng.py",
                                 "ops/proposals.py", "ops/accept.py"])
def test_unfused_step_modules_import_neither_jax_nor_the_jax_package(rel):
    """The unfused step's modules, one by one (the sweep above covers them
    too): each exists and imports only torch, numpy and the port."""
    roots = set(_imported_roots(PKG / rel))
    assert "torch" in roots or rel.startswith("models/")
    assert not roots & {"jax", "jaxlib", "demcmc_tpu"}


@pytest.mark.parametrize("rel", ["optimize.py", "particle.py",
                                 "models/rastrigin.py"])
def test_optimization_modules_import_neither_jax_nor_the_jax_package(rel):
    """The optimization slice's modules, one by one: each exists and
    imports no JAX; ``particle.py`` is the port's own numpy copy of the
    JAX package's."""
    roots = set(_imported_roots(PKG / rel))
    assert roots and not roots & {"jax", "jaxlib", "demcmc_tpu"}
    if rel == "particle.py":
        assert "numpy" in roots and "torch" not in roots


@pytest.mark.parametrize("rel", ["parallel/__init__.py", "parallel/mesh.py",
                                 "parallel/distributed.py"])
def test_mesh_modules_import_neither_jax_nor_the_jax_package(rel):
    """The mesh modules, one by one: each exists and imports no JAX and
    nothing of the JAX package (its ``parallel`` included); the mesh and
    process modules import torch."""
    roots = set(_imported_roots(PKG / rel))
    assert not roots & {"jax", "jaxlib", "demcmc_tpu"}
    if rel != "parallel/__init__.py":
        assert "torch" in roots


@pytest.mark.parametrize("rel", ["utils/checkpoint.py", "utils/monitor.py",
                                 "utils/pytree.py"])
def test_state_and_api_modules_import_neither_jax_nor_the_jax_package(rel):
    """The chunked run's modules, one by one: each exists and imports no
    JAX and nothing of the JAX package (the JAX monitor is numpy only, and
    the port keeps its own copy); the monitor and the pytree helpers are
    numpy only, the checkpoint module takes torch's tensors."""
    roots = set(_imported_roots(PKG / rel))
    assert roots and not roots & {"jax", "jaxlib", "demcmc_tpu"}
    assert "numpy" in roots
    assert ("torch" in roots) == (rel == "utils/checkpoint.py")


def test_exports_of_the_jax_package():
    """The JAX package's exports the port carries: the proposal slots,
    the checkpoint pair, ``as_union``, the module alias ``DEMCMC``, the
    replicated runs (ROADMAP.md A8) and ``parallel``'s ``distributed``,
    ``data_mesh`` and ``shard_data`` (A10 rest 2-3)."""
    from demcmc_tpu_torch.ops import proposals
    from demcmc_tpu_torch.utils import checkpoint, pytree
    for name, obj in (("snooker", proposals.snooker),
                      ("resample", proposals.resample),
                      ("sample_current", proposals.sample_current),
                      ("save_state", checkpoint.save_state),
                      ("load_state", checkpoint.load_state),
                      ("as_union", pytree.as_union)):
        assert name in tdm.__all__ and getattr(tdm, name) is obj
    assert tdm.DEMCMC is tdm and "DEMCMC" in tdm.__all__
    assert {"sample_replicated", "sample_replicated_packed",
            "optimize_replicated"} <= set(tdm.__all__)
    assert tdm.sample_replicated is tdm.sampler.sample_replicated
    assert {"distributed", "data_mesh", "shard_data",
            "chain_mesh"} <= set(tdm.parallel.__all__)
    from demcmc_tpu_torch.parallel import distributed
    assert tdm.parallel.distributed is distributed
    for name in ("initialize", "global_chain_mesh", "is_coordinator"):
        assert callable(getattr(distributed, name))
    assert tdm.sample_replicated_packed is \
        tdm.sampler.sample_replicated_packed
    assert tdm.as_union((1, [2, 3])) == [1, [2, 3]]
    spec = tdm.ParamSpec.from_example(["a", "b"], [np.zeros(()),
                                                   np.zeros((2, 2))], None)
    np.testing.assert_array_equal(
        pytree.ravel_params(spec, [1.5, [[1, 2], [3, 4]]]),
        [1.5, 1, 2, 3, 4])


def test_to_inference_data_dict_and_missing_arviz():
    """``Chains.to_inference_data`` hands arviz each parameter's draws
    ``[C, Ns]`` and the acceptance and lp; without arviz it raises
    ``ImportError``."""
    import importlib.util
    model, de = tgauss.make(data=DATA, Np=4, n_groups=2, burnin=2)
    chains = tdm.sample(model, de, 6, device="cpu")
    d = chains._inference_dict()
    assert set(d["posterior"]) == set(chains.names)
    np.testing.assert_array_equal(d["posterior"]["mu"], chains["mu"].T)
    np.testing.assert_array_equal(d["sample_stats"]["lp"], chains.lp.T)
    assert d["sample_stats"]["acceptance"].shape == (8, 4)
    if importlib.util.find_spec("arviz") is None:
        with pytest.raises(ImportError, match="arviz"):
            chains.to_inference_data()


@pytest.mark.parametrize("name", ["chip_smoke.py", "port_cells.py",
                                  "tools/k1_ab.py", "tools/sweep_phases.py",
                                  "tools/sample_ab.py", "tools/mesh_cards.py",
                                  "tools/rhat_ab.py", "tools/k2_phases.py",
                                  "tools/window_ab.py",
                                  "tools/run_scan_ab.py",
                                  "tools/unfused_graph_ab.py",
                                  "tools/dist_cards.py"])
def test_chip_scripts_import_neither_jax_nor_the_jax_package(name):
    roots = set(_imported_roots(PKG.parent / name))
    assert roots and not roots & {"jax", "jaxlib", "demcmc_tpu"}


def _no_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")


def test_default_device_without_cuda_raises():
    _no_card()
    model, de = tgauss.make(data=DATA)
    spec = tdm.make_spec(model, de)
    for call in (lambda: tdm.sample(model, de, 10),
                 lambda: tdm.init_state(model, de, spec, 0),
                 lambda: tdm.build_step(model, de, spec),
                 lambda: tdm.sample(model, de, 10, device="cuda"),
                 lambda: tdm.state_from_numpy(np.zeros((8, 2)), np.zeros(8),
                                              1, None, "flat")):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


def test_kernel_wrappers_never_fall_back():
    """The wrappers run the plain version for CPU tensors only; any other
    tensor goes to the kernel or raises, with no fallback."""
    model, de = tgauss.make(data=DATA, Np=4, n_groups=2, sweep="sync")
    spec = tdm.make_spec(model, de)
    cfg = tfused.StepConfig.make(model, de, spec)
    theta = torch.zeros((8, 2), device="meta")
    w = torch.zeros(8, device="meta")
    fire = torch.zeros(1, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="cpu or cuda"):
        tfused.de_step(cfg, model, spec, theta, w, fire, 1)
    with pytest.raises(ValueError, match="cpu or cuda"):
        tmig.migrate(theta, w, fire, 2, 4)
    with pytest.raises(ValueError, match="cpu or cuda"):
        tdm.sample(model, de, 10, device="meta")
    # the greedy entries of K1 (optimization) likewise
    from demcmc_tpu_torch.models import rastrigin
    from demcmc_tpu_torch.ops import _build
    for m, d in ((rastrigin.make(Np=4, n_groups=2, dtype=np.float32)),
                 (model, de.replace(update_particle="maximize",
                                    evaluate_fitness="fun"))):
        gcfg = tfused.StepConfig.make(m, d, tdm.make_spec(m, d))
        assert gcfg.mode in ("max", "min")
        assert _build.entry("de_step", m.cuda_density, gcfg.mode) == \
            f"de_step_{gcfg.mode}_{m.cuda_density.name}"
        with pytest.raises(ValueError, match="cpu or cuda"):
            tfused.de_step(gcfg, m, None, theta, w, fire, 1)
        with pytest.raises(ValueError, match="cpu or cuda"):
            tdm.optimize(m, d, 10, device="meta")
    with pytest.raises(ValueError, match="greedy"):
        _build.entry("resample_step", model.cuda_density, "max")
    with pytest.raises(ValueError, match="rastrigin"):
        _build.entry("de_step", rastrigin.density(), "mh")


# the cases keep the ids they had when migration, blocks, the optimization
# modes and float64 raised too, and when the custom slots raised naming
# their ROADMAP item
@pytest.mark.parametrize("kw,what", [
    ({"generate_proposal": "snooker"}, "snooker"),
    ({"sample": "custom"}, "custom"),
], ids=["kw0-snooker", "kw4-partner slots"])
def test_unported_settings_raise(kw, what):
    """A strategy slot named by a string that names no built-in raises,
    naming the string (a custom slot is a callable, which the port carries
    since the custom slots were ported; the snooker proposal is
    ``theta_snooker``, not a ``generate_proposal``)."""
    kw = {"Np": 6, **kw}
    with pytest.raises(ValueError, match=f"{what!r} names no built-in"):
        tdm.DE(bounds=tgauss.BOUNDS, **kw)


@pytest.mark.parametrize("kw", [
    {"sample": "resample", "n_initial": 10, "n_groups": 4},
    {"blocking_on": True},
    {"blocks": [[True, False], [False, True]], "blocking_on": True},
    {"update_particle": "maximize", "evaluate_fitness": "fun"},
    {"update_particle": "minimize", "evaluate_fitness": "fun"},
    {"dtype": np.float64},
], ids=["migration", "blocking_on", "blocks", "optimization-maximize",
        "optimization-minimize", "float64"])
def test_ported_settings_run(kw):
    """DE-MCz with migration as ``DE(Np=3, sample='resample',
    n_initial=...)`` gives it (the default four groups and α = 0.1), a
    constant ``blocking_on``, two blocks, the greedy accepts with the
    objective and float64, which raised before the port carried them:
    each builds a step, the kernels' (where the configuration has one)
    and the unfused one, and runs two iterations on the CPU."""
    model, _ = tgauss.make(data=DATA)
    de = tdm.DE(bounds=tgauss.BOUNDS, Np=3, burnin=1, **kw)
    assert de.alpha == 0.1 and de.n_groups == 4
    spec = tdm.make_spec(model, de)
    for allow_fused in (True, False):
        state = tdm.sampler._grow_history(
            tdm.init_state(model, de, spec, 3, device="cpu"), 2)
        step = tdm.build_step(model, de, spec, device="cpu",
                              allow_fused=allow_fused)
        for _ in range(2):
            state = step(state)
        assert state.iteration == de.n_initial + 3
        assert torch.isfinite(state.weight).all()
        assert state.theta.dtype == de.torch_dtype


def test_optimize_replicated_raises_naming_its_item():
    """``optimize_replicated`` (R runs as one batch, ROADMAP.md A8) is
    ported: it runs and returns one ``Population`` a replication, the
    Rastrigin on K1's greedy min as one replicated batch (the name is
    historical: before A8 it raised, naming its item); it still raises
    for what no optimization takes (the MH accept)."""
    from demcmc_tpu_torch.models import rastrigin
    model, de = rastrigin.make(n_groups=2, Np=4, dtype=np.float32)
    assert tdm.sampler.rep_supported([model], de, "cpu")
    pops = tdm.optimize_replicated(lambda data: model, de, 10,
                                   np.zeros((3, 1)), device="cpu")
    assert len(pops) == 3 and all(isinstance(p, tdm.Population)
                                  for p in pops)
    assert all(p.theta.shape == (8, 2) for p in pops)
    with pytest.raises(ValueError, match="update_particle"):
        tdm.optimize_replicated(lambda data: model, de.replace(
            update_particle="mh", evaluate_fitness="posterior"), 10,
            np.zeros((3, 1)), device="cpu")


@pytest.mark.parametrize("rel", ["sampler.py", "optimize.py", "model.py",
                                 "rng.py", "ops/fused_step.py",
                                 "ops/migration.py", "parallel/mesh.py",
                                 "utils/pytree.py"])
def test_replicated_modules_import_neither_jax_nor_the_jax_package(rel):
    """The replicated runs' modules, one by one: each exists and imports
    no JAX and nothing of the JAX package."""
    roots = set(_imported_roots(PKG / rel))
    assert roots and not roots & {"jax", "jaxlib", "demcmc_tpu"}


def test_replicated_wrappers_never_fall_back():
    """The replicated K1 and the segmented K2 run their plain versions for
    CPU tensors only: on another device they raise, and a replication
    larger than one K2 CTA raises, naming its ROADMAP item."""
    from demcmc_tpu_torch import sampler
    models = [tgauss.make_model(DATA + i) for i in range(2)]
    de = tdm.DE(bounds=tgauss.BOUNDS, Np=4, n_groups=2)
    spec = tdm.make_spec(models[0], de)
    step = sampler.RepStep(models, de, spec, "cpu", [1, 2])
    theta = torch.zeros((16, 2), device="meta")
    w = torch.zeros(16, device="meta")
    fire = torch.zeros(2, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="cpu or cuda"):
        tfused.de_step_rep(step.cfg, spec, theta, w, fire, 5)
    with pytest.raises(ValueError, match="cpu or cuda"):
        tmig.migrate_segments(theta, w, 2, 4, step.reps, 5, fire=fire)
    with pytest.raises(ValueError, match="A8 rest"):
        tmig.migrate_segments(torch.zeros((2 * 2048, 2), device="meta"),
                              torch.zeros(2 * 2048, device="meta"), 128, 16,
                              step.reps, 5, fire=fire)
    with pytest.raises(ValueError, match="de_step_rep"):
        tfused.de_step(step.cfg, models[0], spec, theta, w, fire, 5)


def test_resample_wrapper_never_falls_back():
    """K3's wrapper, like K1's, runs the plain version for CPU tensors only,
    and K1's refuses a resample configuration; the kernels' step refuses
    on a CUDA device a model without a K3 density (``build_step`` gives
    it the unfused step)."""
    from demcmc_tpu_torch.models import mvnormal as tmvn
    from demcmc_tpu_torch.ops import resample_step as tres
    model, de = tmvn.make(d=2, data=np.zeros((5, 2), np.float32),
                          n_initial=4)
    cfg = tfused.StepConfig.make(model, de, tdm.make_spec(model, de))
    theta = torch.zeros((3, 3), device="meta")
    w = torch.zeros(3, device="meta")
    fire = torch.zeros(1, dtype=torch.int32, device="meta")
    hist = torch.zeros((8, 3, 3), device="meta")
    with pytest.raises(ValueError, match="cpu or cuda"):
        tres.resample_step(cfg, model, None, theta, w, fire, hist, 5)
    with pytest.raises(ValueError, match="resample_step"):
        tfused.de_step(cfg, model, None, theta, w, fire, 5)
    assert model.cuda_density is None          # only d = 30 is compiled
    spec = tdm.make_spec(model, de)
    with pytest.raises(ValueError, match="CUDA density"):
        tdm.sampler.Step(model, de, spec, "cuda")
    assert isinstance(tdm.build_step(model, de, spec, "cpu"),
                      tdm.UnfusedStep)


def test_new_settings_are_accepted():
    """Snooker, the sequential sweep and DE-MCz resample construct (they
    raised before the port carried them); resample keeps the JAX
    package's Np >= 3 rule."""
    de = tdm.DE(bounds=tgauss.BOUNDS, Np=4, theta_snooker=0.1,
                sample="resample", n_initial=10, n_groups=1)
    assert de.sequential_sweep and de.uses_resample
    assert not tdm.DE(Np=6, sweep="sync").sequential_sweep
    with pytest.raises(ValueError):
        tdm.DE(Np=2, sample="resample", n_initial=10, n_groups=1)


def test_model_without_cuda_density_is_cpu_only():
    """A model without a CUDA density never reaches the DE-step kernels: it
    samples through the unfused step (on the CPU here, on the card by
    default), and the kernels' step refuses it on a CUDA device.  The name
    is historical: before the unfused step such a model ran on the CPU
    only; the kernels' step still refuses it."""
    model, de = tgauss.make(data=DATA)
    model.cuda_density = None
    spec = tdm.make_spec(model, de)
    assert isinstance(tdm.build_step(model, de, spec, device="cpu"),
                      tdm.UnfusedStep)
    assert tdm.sample(model, de.replace(burnin=2), 4, device="cpu")
    with pytest.raises(ValueError, match="CUDA density"):
        tdm.sampler.Step(model, de, spec, "cuda")


def test_step_choice_is_static():
    """``build_step`` picks from the model and the configuration alone: the
    kernels' step for a model with a K1 density, and for DE-MCz with a K3
    density, the unfused step otherwise (DE-MCz of an MVN whose width has
    no K3 density included) or with ``allow_fused=False``."""
    from demcmc_tpu_torch.models import mvnormal as tmvn
    model, de = tgauss.make(data=DATA)
    spec = tdm.make_spec(model, de)
    assert type(tdm.build_step(model, de, spec, "cpu")) is tdm.sampler.Step
    assert isinstance(tdm.build_step(model, de, spec, "cpu",
                                     allow_fused=False), tdm.UnfusedStep)
    m30, de30 = tmvn.make()
    current = de30.replace(sample="current", n_initial=0)
    assert isinstance(tdm.build_step(m30, current, tdm.make_spec(m30, de30),
                                     "cpu"), tdm.UnfusedStep)
    assert type(tdm.build_step(m30, de30, tdm.make_spec(m30, de30),
                               "cpu")) is tdm.sampler.Step
    m3, de3 = tmvn.make(d=2, data=np.zeros((5, 2), np.float32), n_initial=4)
    assert m3.cuda_density is None
    assert isinstance(tdm.build_step(m3, de3, tdm.make_spec(m3, de3),
                                     "cpu"), tdm.UnfusedStep)


@pytest.mark.parametrize("case,what", [("stochastic", "noise")])
def test_unfused_step_refuses_what_it_does_not_carry(case, what):
    """A stochastic model's density without its noise panel raises (it
    raised in the unfused step as a whole before the step carried the
    panels): the step scores every evaluation on its own panel, and runs
    two iterations on the CPU."""
    from demcmc_tpu_torch.models import binomial as tbin
    model, de = tbin.make(N=10, k=6, abc=True, fresh_noise=True, n_sim=50)
    spec = tdm.make_spec(model, de)
    step = tdm.build_step(model, de, spec, "cpu", allow_fused=False)
    assert isinstance(step, tdm.UnfusedStep)
    state = tdm.init_state(model, de, spec, 3, device="cpu")
    with pytest.raises(ValueError, match=what):
        step.fitness(state.theta.view(de.n_groups, de.Np, -1))
    for _ in range(2):
        state = step(state)
    assert torch.isfinite(state.weight).any()


def test_unfused_step_runs_resample():
    """The unfused step runs DE-MCz (it raised before it carried the
    history): an MVN without a K3 density samples on the CPU and writes
    each state into its history row."""
    from demcmc_tpu_torch.models import mvnormal as tmvn
    model, de = tmvn.make(d=2, data=np.zeros((5, 2), np.float32),
                          n_initial=4, burnin=1)
    spec = tdm.make_spec(model, de)
    step = tdm.build_step(model, de, spec, "cpu", allow_fused=False)
    assert isinstance(step, tdm.UnfusedStep)
    chains, end = tdm.sample(model, de, 3, device="cpu", return_state=True)
    assert end.history.shape == (7, 3, 3)
    assert torch.equal(end.history[6], end.theta)
    assert chains.data.shape == (2, 3, 3)
