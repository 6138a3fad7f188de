"""Checkpoint and resume in the port (``demcmc_tpu_torch.utils.checkpoint``),
the cases of ``tests/test_checkpoint.py`` on the port's state: the state is
the whole run, and the port's Philox words depend only on (key,
iteration, chain), so a run resumed from a snapshot is the uninterrupted
run bit for bit; K1's and K3's plain versions, the unfused step and a
2-shard CPU mesh."""

import contextlib
import io
import os

import numpy as np
import pytest
import torch

import demcmc_tpu_torch as tdm
from demcmc_tpu_torch import sampler as tsampler
from demcmc_tpu_torch.models import gaussian as tgauss
from demcmc_tpu_torch.models import mvnormal as tmvn
from demcmc_tpu_torch.utils import checkpoint as tckpt

DATA = np.random.default_rng(2).standard_normal(20).astype(np.float32)


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _equal(a, b):
    assert a.iteration == b.iteration and a.key == b.key
    for k in ("theta", "weight", "fire", "history"):
        x, y = getattr(a, k), getattr(b, k)
        assert (x is None) == (y is None), k
        if x is not None:
            assert x.dtype == y.dtype and torch.equal(x.cpu(), y.cpu()), k


def test_resume_bitwise_identical(tmp_path):
    """run_scan 100 iterations against 40, save, load, 60: the same
    trajectory and final state (K1's plain version, migration)."""
    model, de = tgauss.make(data=DATA, Np=4, n_groups=4, burnin=0,
                            alpha=0.5, discard_burnin=False)
    spec = tdm.make_spec(model, de)
    step = tdm.build_step(model, de, spec, device="cpu")
    full, ys_full = tsampler.run_scan(
        step, tdm.init_state(model, de, spec, 7, device="cpu"), 100)
    mid, ys_a = tsampler.run_scan(
        step, tdm.init_state(model, de, spec, 7, device="cpu"), 40)
    path = tmp_path / "ckpt.npz"
    tdm.save_state(path, mid)
    loaded = tdm.load_state(path)
    _equal(loaded, mid)
    end, ys_b = tsampler.run_scan(step, loaded, 60)
    _equal(end, full)
    for f in ("theta", "lp", "accept"):
        np.testing.assert_array_equal(
            getattr(ys_full, f), np.concatenate([getattr(ys_a, f),
                                                 getattr(ys_b, f)]))


def test_checkpoint_roundtrip_with_history(tmp_path):
    model, de = tmvn.make(d=3, n_obs=20, n_initial=8, burnin=5)
    spec = tdm.make_spec(model, de)
    state = tdm.init_state(model, de, spec, 3, device="cpu")
    path = tmp_path / "h.npz"
    tdm.save_state(path, state)
    loaded = tdm.load_state(path)
    _equal(loaded, state)
    assert loaded.history.shape == (8, 3, 4)


def test_checkpoint_roundtrip_with_fire(tmp_path):
    """The gate is saved under its name: an open gate and no history load
    back as such, not as one another (the JAX package's positional format
    confused them); extension-less paths round-trip."""
    st = tsampler.SamplerState(
        theta=torch.arange(16.0).view(8, 2), weight=torch.zeros(8), key=5,
        iteration=7, fire=torch.ones(1, dtype=torch.int32))
    path = tmp_path / "fire_ckpt"
    tdm.save_state(path, st)
    got = tdm.load_state(path)
    assert got.history is None and int(got.fire[0]) == 1
    _equal(got, st)


def test_sample_periodic_checkpoint_and_resume(tmp_path):
    path = str(tmp_path / "run.npz")
    model, de = tgauss.make(data=DATA, Np=4, n_groups=2, burnin=0,
                            discard_burnin=False)
    full = tdm.sample(model, de, 150, key=1, device="cpu")
    tdm.sample(model, de, 100, key=1, device="cpu", checkpoint_every=25,
               checkpoint_path=path)
    state = tdm.load_state(path)
    assert state.iteration == 101
    chains = tdm.sample(model, de, 50, key=1, state=state, device="cpu")
    assert len(chains) == 50
    np.testing.assert_array_equal(chains.data, full.data[100:])
    np.testing.assert_array_equal(chains.lp, full.lp[100:])


RESUME = {
    "k1": (dict(alpha=0.5), True),
    "k3": (dict(alpha=0.5, sample="resample", n_initial=12, Np=4,
                sweep="sync"), True),
    "unfused": (dict(alpha=0.5, blocks=[[True, False], [False, True]],
                     blocking_on=True), False),
}


@pytest.mark.parametrize("case", ["k1", "k3", "unfused", "mesh"])
def test_interrupted_run_resumes_bitwise(case, tmp_path):
    """A run of 200 iterations with ``checkpoint_every=70`` leaves its
    last snapshot 140 or more iterations in (its chunks are cut at the
    burn-in switch too, as the JAX loop's); resumed from it for the rest,
    it ends as the uninterrupted run, its draws the uninterrupted run's
    last ones and its saved gate (``fire``) carried across: K1's and K3's
    plain versions with migration, the unfused step with blocks, a
    2-shard mesh."""
    kw, fused = RESUME["k1" if case == "mesh" else case]
    kw = {"Np": 5, **kw}
    model, de = tgauss.make(data=DATA, n_groups=4, burnin=30,
                            discard_burnin=False, **kw)
    run = dict(device="cpu", allow_fused=fused)
    if case == "mesh":
        run = dict(mesh=tdm.chain_mesh(devices=["cpu"] * 2))
    full, end = tdm.sample(model, de, 200, key=4, return_state=True, **run)
    path = tmp_path / "run"
    tdm.sample(model, de, 200, key=4, checkpoint_every=70,
               checkpoint_path=path, **run)
    state = tdm.load_state(path)
    done = state.iteration - de.n_initial - 1
    assert 140 <= done < 200
    chains, got = tdm.sample(model, de, 200 - done, key=4, state=state,
                             return_state=True, **run)
    np.testing.assert_array_equal(chains.data, full.data[done:])
    np.testing.assert_array_equal(chains.acceptance,
                                  full.acceptance[done:])
    if de.uses_resample:       # the resumed history grows by this run's
        assert got.history.shape[0] == end.history.shape[0] + 200 - done
        got = got._replace(history=got.history[:end.history.shape[0]])
    _equal(got, end)


def test_resume_resample_grows_history():
    """Resuming DE-MCz extends the history for the new run's rows (without
    growth a write past the end would fail), and they are written."""
    model, de = tmvn.make(d=3, n_obs=20, n_initial=8, burnin=5,
                          discard_burnin=False)
    c1, s1 = tdm.sample(model, de, 40, key=3, return_state=True,
                        device="cpu")
    H1 = s1.history.shape[0]
    assert H1 == 8 + 40
    c2, s2 = tdm.sample(model, de, 30, key=3, state=s1, return_state=True,
                        device="cpu")
    assert s2.history.shape[0] == H1 + 30
    assert s2.iteration == 8 + 40 + 30 + 1
    assert torch.any(s2.history[-1] != 0)


def test_checkpoint_async_and_atomic(tmp_path, monkeypatch):
    """``async_=True`` returns a Future; the write is atomic (no temporary
    file left); a failed write surfaces from the Future and leaves the
    old snapshot whole."""
    st = tsampler.SamplerState(
        theta=torch.arange(24.0).view(12, 2), weight=torch.zeros(12), key=2,
        iteration=11, fire=torch.zeros(1, dtype=torch.int32))
    path = tmp_path / "async_ckpt"
    fut = tdm.save_state(path, st, async_=True)
    assert fut is not None
    times = fut.result(timeout=30)
    assert times["end"] >= times["start"]
    _equal(tdm.load_state(path), st)
    assert [p for p in tmp_path.iterdir() if ".tmp" in p.name] == []

    def broken(f, **arrays):
        f.write(b"partial")
        raise OSError("disk full")
    monkeypatch.setattr(tckpt.np, "savez", broken)
    newer = st._replace(iteration=12, theta=st.theta + 1)
    fut = tdm.save_state(path, newer, async_=True)
    with pytest.raises(OSError, match="disk full"):
        fut.result(timeout=30)
    monkeypatch.undo()
    _equal(tdm.load_state(path), st)
    assert [p for p in tmp_path.iterdir() if ".tmp" in p.name] == []


def test_snapshot_is_taken_before_the_state_moves_on(tmp_path):
    """The steps update the state's tensors in place: an asynchronous
    save copies them before it returns, so a later update does not reach
    the file."""
    st = tsampler.SamplerState(
        theta=torch.zeros(8, 2), weight=torch.zeros(8), key=1,
        iteration=3, fire=torch.zeros(1, dtype=torch.int32))
    fut = tdm.save_state(tmp_path / "s", st, async_=True)
    st.theta.add_(1.0)
    fut.result(timeout=30)
    assert torch.equal(tdm.load_state(tmp_path / "s").theta,
                       torch.zeros(8, 2))


def test_checkpoint_fires_when_chunk_does_not_divide_interval(tmp_path):
    """stop_rhat's chunks (6 iterations of 120) skip every multiple of
    the interval 35: the interval-elapsed rule still saves, late in the
    run (stop_rhat=0 is out of reach, so the run goes to its end)."""
    model, de = tgauss.make(data=DATA, n_groups=4, Np=4, burnin=20)
    path = str(tmp_path / "cadence")
    tdm.sample(model, de, 120, key=1, stop_rhat=0.0, checkpoint_every=35,
               checkpoint_path=path, device="cpu")
    st = tdm.load_state(path)
    assert st.iteration >= 100


def test_jax_written_file_is_refused(tmp_path):
    """A file the JAX package wrote (its key a [2] uint32 array; or its
    legacy positional format) is refused, naming ``state_from_numpy``."""
    import jax
    import jax.numpy as jnp
    from demcmc_tpu.sampler import SamplerState as JState
    from demcmc_tpu.utils.checkpoint import save_state as jsave

    st = JState(theta=jnp.ones((4, 3, 2)), weight=jnp.zeros((4, 3)),
                key=jax.random.PRNGKey(0),
                iteration=jnp.asarray(7, jnp.int32), history=None,
                fire=jnp.ones((1, 1), jnp.int32))
    path = tmp_path / "jax_ckpt"
    jsave(path, st)
    with pytest.raises(ValueError, match="state_from_numpy"):
        tdm.load_state(path)
    legacy = str(tmp_path / "legacy.npz")
    np.savez(legacy, n_leaves=4, leaf_0=np.ones((4, 3, 2)))
    with pytest.raises(ValueError, match="state_from_numpy"):
        tdm.load_state(legacy)
    assert os.path.exists(legacy)


def test_stop_and_progress_do_not_change_a_checkpoint(tmp_path):
    """The snapshot at a chunk's end is the state there whatever cut the
    chunks: with progress (chunks of 3) the file holds the same state as
    without (chunks of 30), both saved at iteration 60."""
    model, de = tgauss.make(data=DATA, n_groups=4, Np=4, burnin=0,
                            alpha=0.5)
    a, b = tmp_path / "a", tmp_path / "b"
    tdm.sample(model, de, 60, key=3, checkpoint_every=30,
               checkpoint_path=a, device="cpu")
    with contextlib.redirect_stdout(io.StringIO()):
        tdm.sample(model, de, 60, key=3, checkpoint_every=30,
                   checkpoint_path=b, progress=True, device="cpu")
    _equal(tdm.load_state(a), tdm.load_state(b))
