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


@pytest.mark.parametrize("name", ["chip_smoke.py", "port_cells.py"])
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


@pytest.mark.parametrize("kw,what", [
    ({"generate_proposal": "snooker"}, "snooker"),
    ({"sample": "resample", "n_initial": 10, "n_groups": 4}, "migration"),
    ({"blocking_on": True}, "block"),
    ({"blocks": [[True, False]]}, "block"),
    ({"sample": "custom"}, "partner slots"),
    ({"update_particle": "maximize"}, "optimization"),
    ({"update_particle": "minimize"}, "optimization"),
    ({"dtype": np.float64}, "float64"),
])
def test_unported_settings_raise(kw, what):
    kw = {"Np": 6, **kw}
    with pytest.raises(NotImplementedError, match=what):
        tdm.DE(bounds=tgauss.BOUNDS, **kw)


def test_resample_wrapper_never_falls_back():
    """K3's wrapper, like K1's, runs the plain version for CPU tensors only,
    and K1's refuses a resample configuration."""
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
    with pytest.raises(ValueError, match="CUDA density"):
        tdm.sampler.Step(model, de, tdm.make_spec(model, de), "cuda")


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
    model, de = tgauss.make(data=DATA)
    model.cuda_density = None
    spec = tdm.make_spec(model, de)
    assert tdm.sample(model, de.replace(burnin=2), 4, device="cpu")
    with pytest.raises(ValueError, match="CUDA density"):
        tdm.sampler.Step(model, de, spec, "cuda")
