"""The data axis in the port (``parallel.data_mesh``, ``shard_data``), on
the CPU, where a ``chains × data`` mesh of ``["cpu"] * 8`` runs every
chain shard and data piece in one process.

(a) The twin of ``tests/test_sharding.py::test_data_sharding_psum``: a
    4 × 2 mesh, 64 observations split over the ``data`` axis, 4 groups ×
    6, 500 iterations: within 0.12 of the quadrature and of the JAX
    package's run on its own 4 × 2 mesh.
(b) Bit for bit: the data-mesh run equals the unsharded run of a model
    whose loglike sums the same pieces in the same order (the Gaussian on
    4 × 2 and a 1 × 2 mesh, LBA's 100 trials on 2 × 4, the 4-dim MVN's
    DE-MCz on 2 × 2); the sharded log-density is within 1e-5 relative of
    the full data's.
(c) The mesh and what ``shard_data`` refuses, with the JAX messages.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import demcmc_tpu as dm
from demcmc_tpu.models import gaussian as jgauss
from demcmc_tpu.parallel import data_mesh as jdata_mesh
from demcmc_tpu.parallel import shard_data as jshard_data

import demcmc_tpu_torch as tdm
from demcmc_tpu_torch import parallel as tpar
from demcmc_tpu_torch.model import DEModel
from demcmc_tpu_torch.models import gaussian as tgauss
from demcmc_tpu_torch.models import lba as tlba
from demcmc_tpu_torch.models import mvnormal as tmvn
from demcmc_tpu_torch.ops import accept as taccept

RAW = np.random.default_rng(0).normal(0.0, 1.0, size=(64,))


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cpu_mesh(n_c, n_d):
    return tpar.data_mesh(n_c, n_d, devices=["cpu"] * (n_c * n_d))


def _piecewise_twin(model, loglike, pieces, data):
    """``model`` with its data unsharded and a loglike that sums
    ``loglike(piece)`` over ``pieces`` in order: the data-mesh run's
    arithmetic on one device."""
    def summed(_, *params):
        total = None
        for p in pieces:
            part = loglike(p, *params)
            total = part if total is None else total + part
        return total
    return DEModel(loglike_batched=summed,
                   prior_loglike_batched=model.prior_loglike_batched,
                   sample_prior=model.sample_prior, names=model.names,
                   data=data)


# ------------------------------------------------------------------ (a)


def test_data_sharding_psum_twin_agrees_with_quadrature_and_jax(
        eight_devices):
    mesh = _cpu_mesh(4, 2)
    data = tpar.shard_data(RAW.astype(np.float32), mesh, axis=0)
    model, de = tgauss.make(data=data, burnin=100, n_groups=4, Np=6)
    chains = tdm.sample(model, de, 500, key=1, mesh=mesh)
    truth = tgauss.posterior_grid(RAW)
    jmesh = jdata_mesh(4, 2)
    jmodel, jde = jgauss.make(data=jshard_data(jnp.asarray(RAW), jmesh),
                              burnin=100, n_groups=4, Np=6)
    jc = dm.sample(jmodel, jde, 500, key=1, mesh=jmesh)
    for name in ("mu", "sigma"):
        assert abs(chains.mean(name) - truth[name]["mean"]) < 0.12
        assert abs(chains.mean(name) - jc.mean(name)) < 0.12


# ------------------------------------------------------------------ (b)


@pytest.mark.parametrize("shape", [(4, 2), (1, 2)])
def test_gaussian_data_mesh_is_its_piecewise_twin(shape):
    """Each chain shard's likelihood is the sum of its row's pieces'
    partials, in piece order, so the data-mesh run is the unsharded run
    of the piecewise-sum model bit for bit (a mesh of one chain row runs
    the plain path over its data devices)."""
    mesh = _cpu_mesh(*shape)
    raw = RAW.astype(np.float32)
    data = tpar.shard_data(raw, mesh)
    model, de = tgauss.make(data=data, burnin=20, n_groups=4, Np=6,
                            alpha=0.5)
    assert model.cuda_density is None
    assert model.data.pieces == [tgauss.suff_stats(p.numpy())
                                 for p in data.pieces]
    chains, state = tdm.sample(model, de, 60, key=1, mesh=mesh,
                               return_state=True)
    twin = _piecewise_twin(model, tgauss.loglike_batched, data.pieces, raw)
    ref, ref_state = tdm.sample(twin, de, 60, key=1, device="cpu",
                                return_state=True)
    np.testing.assert_array_equal(chains.data, ref.data)
    np.testing.assert_array_equal(chains.lp, ref.lp)
    assert torch.equal(state.theta, ref_state.theta)
    step = tdm.build_step(model, de, tdm.make_spec(model, de), mesh=mesh)
    assert isinstance(step, tdm.UnfusedStep if shape[0] == 1
                      else tdm.ShardedStep)


def test_sharded_log_density_is_the_full_datas():
    """The data-mesh model's log posterior (partials of the two pieces'
    sufficient statistics, summed) within 1e-5 relative of the full
    data's model at 64 parameter points."""
    mesh = _cpu_mesh(4, 2)
    raw = RAW.astype(np.float32)
    sharded = tgauss.make_model(tpar.shard_data(raw, mesh))
    full = tgauss.make_model(raw)
    de = tdm.DE(bounds=tgauss.BOUNDS, Np=6, n_groups=4)
    spec = tdm.make_spec(full, de)
    gen = np.random.default_rng(4)
    x = torch.tensor(np.stack([gen.normal(0.0, 0.5, 64),
                               gen.uniform(0.5, 2.0, 64)], 1),
                     dtype=torch.float32)
    a = taccept.compute_posterior(sharded, spec, de, x).numpy()
    b = taccept.compute_posterior(full, spec, de, x).numpy()
    np.testing.assert_allclose(a, b, rtol=1e-5)


def test_lba_data_mesh_is_its_piecewise_twin():
    """LBA's 100 trials over a 2 × 4 mesh (25 a piece): τ's bound from the
    smallest rt of every piece, and the run bit for bit its piecewise-sum
    twin's."""
    lmodel, lde = tlba.make(n_trials=100, Np=6, n_groups=4, burnin=10,
                            alpha=0.5)
    mesh = _cpu_mesh(2, 4)
    data = tpar.shard_data(lmodel.data, mesh)
    assert [len(p[1]) for p in data.pieces] == [25] * 4
    model = tlba.make_model(data)
    assert tlba.min_rt(data) == tlba.min_rt(lmodel.data)
    chains = tdm.sample(model, lde, 24, key=2, mesh=mesh)
    twin = _piecewise_twin(model, tlba.loglike_batched, data.pieces,
                           lmodel.data)
    ref = tdm.sample(twin, lde, 24, key=2, device="cpu")
    np.testing.assert_array_equal(chains.data, ref.data)
    np.testing.assert_array_equal(chains.lp, ref.lp)


def test_mvnormal_mcz_data_mesh_is_its_piecewise_twin():
    """DE-MCz with a data axis: the 4-dim MVN (40 observations, the
    JAX ``test_sharded_resample_history`` model's width) on a 2 × 2 mesh,
    each chain shard on its history replica and its row's two pieces,
    bit for bit its piecewise-sum twin's unsharded run."""
    raw = np.random.default_rng(6).standard_normal((40, 4)).astype(
        np.float32)
    mesh = _cpu_mesh(2, 2)
    data = tpar.shard_data(raw, mesh)
    model, de = tmvn.make(data=data, burnin=10, n_groups=4, Np=3,
                          n_initial=20, alpha=0.5)
    chains, state = tdm.sample(model, de, 30, key=3, mesh=mesh,
                               return_state=True)
    twin = _piecewise_twin(model, tmvn.loglike_batched, data.pieces, raw)
    ref, ref_state = tdm.sample(twin, de, 30, key=3, device="cpu",
                                return_state=True)
    np.testing.assert_array_equal(chains.data, ref.data)
    assert torch.equal(state.history, ref_state.history)


@pytest.mark.parametrize("kind", ["numpy", "torch"])
def test_pieces_are_tensors_on_their_devices_taken_once(kind, monkeypatch):
    """``shard_data`` of a numpy array or a torch tensor puts piece j of
    chain row i, a tensor of its own, on ``devices[i, j]``; the Gaussian
    takes its pieces' sufficient statistics once, when it is made (none
    while it runs), and LBA its pieces' float32 columns on their devices;
    both inputs give the same run bit for bit."""
    mesh = _cpu_mesh(2, 2)
    raw = RAW.astype(np.float32)
    data = tpar.shard_data(raw if kind == "numpy" else torch.from_numpy(raw),
                           mesh)
    for i in range(2):
        for j, p in enumerate(data.row(i).pieces):
            assert isinstance(p, torch.Tensor)
            assert p.device == mesh.devices[i, j]
            np.testing.assert_array_equal(p.numpy(), raw[32 * j:32 * j + 32])
    assert data.row(0).pieces[0].data_ptr() != data.row(1).pieces[0].data_ptr()
    calls = []
    real = tgauss.suff_stats
    monkeypatch.setattr(tgauss, "suff_stats",
                        lambda x: calls.append(1) or real(x))
    model, de = tgauss.make(data=data, burnin=10, n_groups=4, Np=6,
                            alpha=0.5)
    assert len(calls) == 4                    # 2 chain rows × 2 pieces
    chains = tdm.sample(model, de, 30, key=1, mesh=mesh)
    assert len(calls) == 4
    monkeypatch.setattr(tgauss, "suff_stats", real)
    ref_model, _ = tgauss.make(data=tpar.shard_data(raw, mesh), burnin=10,
                               n_groups=4, Np=6, alpha=0.5)
    ref = tdm.sample(ref_model, de, 30, key=1, mesh=mesh)
    np.testing.assert_array_equal(chains.data, ref.data)
    lmodel, _ = tlba.make(n_trials=100)
    choice, rt = lmodel.data
    lmesh = _cpu_mesh(2, 4)
    ldata = tpar.shard_data((choice, rt) if kind == "numpy" else
                            (torch.from_numpy(choice), torch.from_numpy(rt)),
                            lmesh)
    cols = tlba.make_model(ldata).data
    for i in range(2):
        for j, (c, r) in enumerate(cols.row(i).pieces):
            assert c.dtype == r.dtype == torch.float32
            assert c.device == r.device == lmesh.devices[i, j]
            np.testing.assert_array_equal(
                torch.stack([c, r], 1).numpy(),
                tlba.trials((choice, rt))[25 * j:25 * j + 25])


# ------------------------------------------------------------------ (c)


def test_data_mesh_and_shard_data_refusals():
    mesh = _cpu_mesh(4, 2)
    assert mesh.axis_names == ("chains", "data")
    assert mesh.shape == {"chains": 4, "data": 2}
    assert mesh.devices.shape == (4, 2)
    with pytest.raises(ValueError, match="needs 8 devices; 6 given"):
        tpar.data_mesh(4, 2, devices=["cpu"] * 6)
    with pytest.raises(ValueError, match="mesh has no axis 'data'"):
        tpar.shard_data(RAW, tdm.chain_mesh(devices=["cpu"] * 2))
    with pytest.raises(ValueError, match="data size 63 along axis 0 is not "
                       "divisible by the 2-way 'data' mesh axis"):
        tpar.shard_data(RAW[:63], mesh)
    data = tpar.shard_data(RAW, mesh)
    assert not hasattr(data, "__array__")
    with pytest.raises(ValueError, match="sharded over 4 chain rows"):
        model, de = tgauss.make(data=data, n_groups=4, Np=6)
        tdm.sample(model, de, 10, mesh=_cpu_mesh(2, 2))


def test_data_mesh_without_cuda_raises():
    """``data_mesh()`` spans the visible GPUs: with none and no
    ``devices`` it raises, as ``chain_mesh()`` does."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tpar.data_mesh(1, 2)
