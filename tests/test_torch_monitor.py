"""The port's streaming ``ConvergenceMonitor`` (its own numpy copy of the
JAX package's) against the JAX one on the same chunks, bit for bit;
against the port's post-hoc split-R̂; and ``sample(monitor=True)`` and
``stop_rhat`` (statistical, level (c): the JAX run of the same
configuration stops early too, and both posterior means agree within
Monte Carlo error)."""

import numpy as np
import pytest
import torch

import demcmc_tpu as jdm
from demcmc_tpu.models import gaussian as jgauss
from demcmc_tpu.utils import monitor as jmon

import demcmc_tpu_torch as tdm
from demcmc_tpu_torch import diagnostics as tdiag
from demcmc_tpu_torch.models import gaussian as tgauss
from demcmc_tpu_torch.utils import monitor as tmon


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _ar1(seed, T, C, d, rho=0.7, trend=True):
    rng = np.random.default_rng(seed)
    x = np.empty((T, C, d))
    x[0] = rng.standard_normal((C, d))
    for t in range(1, T):
        x[t] = rho * x[t - 1] + np.sqrt(1 - rho * rho) * rng.standard_normal(
            (C, d))
    x += rng.normal(size=(1, C, 1)) * 0.2
    if trend:
        x[:, :, d - 1] += np.linspace(0.0, 3.0, T)[:, None]
    return x


def _feed(mon, x, step):
    for lo in range(0, x.shape[0], step):
        mon.update(x[lo:lo + step])
    return mon


@pytest.mark.parametrize("T,C,d,step", [(1200, 6, 3, 137), (7, 4, 2, 3),
                                        (3000, 8, 1, 500)])
def test_monitor_equals_the_jax_monitor(T, C, d, step):
    """R̂, ESS (streaming and rough) and the bucket store: the same bits
    from the same chunks (float32 chunks too, as the trajectory is)."""
    x = _ar1(T + C, T, C, d)
    for chunks in (x, x.astype(np.float32)):
        j = _feed(jmon.ConvergenceMonitor(), chunks, step)
        t = _feed(tmon.ConvergenceMonitor(), chunks, step)
        assert t.n == j.n
        for f in ("rhat", "ess_stream", "ess_rough"):
            a, b = getattr(t, f)(), getattr(j, f)()
            assert (a is None) == (b is None)
            if a is not None:
                np.testing.assert_array_equal(a, b)
        assert t.max_rhat() == j.max_rhat() or (t.max_rhat() is None
                                                and j.max_rhat() is None)


def test_merged_bucket_store_equals_the_jax_monitor():
    """Past 512 buckets the store merges pairwise; the merged counts, sums
    and sums of squares are the JAX monitor's bit for bit, and the split
    R̂ stays within 1e-2 of the post-hoc one."""
    rng = np.random.default_rng(3)
    T, C = 4 * tmon._MAX_BUCKETS + 37, 4
    x = rng.standard_normal((T, C, 1)).cumsum(axis=0) * 0.01
    j = _feed(jmon.ConvergenceMonitor(), x, 250)
    t = _feed(tmon.ConvergenceMonitor(), x, 250)
    assert t._bucket_size == j._bucket_size > 1
    assert t._bn == j._bn and len(t._bn) <= tmon._MAX_BUCKETS + 1
    for a, b in ((t._bs1, j._bs1), (t._bs2, j._bs2)):
        np.testing.assert_array_equal(np.stack(a), np.stack(b))
    np.testing.assert_allclose(t.rhat()[0], tdiag.split_rhat(x[:, :, 0]),
                               atol=1e-2)


def test_monitor_rhat_matches_split_rhat():
    """Within 1e-2 of the port's post-hoc ``split_rhat`` on AR(1) chains,
    a trend included (the split flags it)."""
    x = _ar1(0, 1200, 6, 3)
    got = _feed(tmon.ConvergenceMonitor(), x, 137).rhat()
    want = np.array([tdiag.split_rhat(x[:, :, k]) for k in range(3)])
    np.testing.assert_allclose(got, want, atol=1e-2)
    assert got[2] > 1.15


def test_monitor_takes_trajectory_chunks_only():
    with pytest.raises(ValueError, match=r"\[T, C, d\]"):
        tmon.ConvergenceMonitor().update(np.zeros((2, 3, 4, 5)))


def test_sample_monitor_end_to_end():
    """``sample(monitor=True)`` feeds the post-burn-in draws: the monitor
    counts them, and its R̂ agrees with the chains' split R̂."""
    model, de = tgauss.make(key=0, n_obs=30, n_groups=8, Np=6, burnin=400)
    chains = tdm.sample(model, de, 1600, key=3, monitor=True, device="cpu")
    mon = chains.monitor
    assert mon.n == 1200 == len(chains)
    r = mon.rhat()
    assert 0.99 < mon.max_rhat() < 1.05
    want = [tdiag.split_rhat(chains[n]) for n in chains.names]
    np.testing.assert_allclose(r, want, atol=1e-2)
    assert np.all(mon.ess_rough() > 50)


def test_stop_rhat_stops_early_as_the_jax_package():
    """``stop_rhat`` ends the run at a chunk boundary once the streaming
    R̂max reaches the target, never before 50 stored post-burn-in draws,
    and returns only the draws taken (``n_iter`` recomputed); the JAX run
    of the same configuration stops early too, and the posterior means of
    μ agree within Monte Carlo error (4 standard errors, from each run's
    bulk ESS); a target out of reach runs to the end."""
    jmodel, jde = jgauss.make(key=0, n_obs=30, n_groups=8, Np=6,
                              burnin=200)
    jc = jdm.sample(jmodel, jde, 20000, key=5, stop_rhat=1.05)
    model, de = tgauss.make(data=np.asarray(jmodel.data, np.float32),
                            n_groups=8, Np=6, burnin=200)
    tc = tdm.sample(model, de, 20000, key=5, stop_rhat=1.05, device="cpu")
    for c in (jc, tc):
        assert 50 <= len(c) < 19800 - 200
        assert c.monitor.max_rhat() <= 1.05
        assert c.monitor.n == len(c)
    # chunks of 1,000 iterations after the one that ends at the burn-in
    # switch (the JAX package on the CPU has no switch: 800, 1,800, ...)
    assert len(tc) % 1000 == 0 and len(jc) % 1000 == 800
    se = [c.std("mu") / np.sqrt(c.ess("mu")) for c in (jc, tc)]
    assert abs(jc.mean("mu") - tc.mean("mu")) < 4 * np.hypot(*se)
    full = tdm.sample(model, de, 600, key=5, stop_rhat=1e-9, device="cpu")
    assert len(full) == 600 - 200
