"""The host-side rules of K1 and K3 on the d = 2 densities with their draws
taken before the state (``csrc/sweep_hoist.cuh``): a K3 window over a
thread block cluster (``resample_step.window_chains`` and
``resample_super_k``), and the group limit of a density with lanes, read
from the one-thread kernel that takes its largest groups at one lane a
chain (``fused_step.block_chains``).  Each rule is held on the CPU against
one launch an iteration (``sampler.run_loop``)."""

import numpy as np
import pytest
import torch

import demcmc_tpu_torch as tdm
from demcmc_tpu_torch import sampler as tsampler
from demcmc_tpu_torch.models import binomial as tbinom
from demcmc_tpu_torch.models import discrete_binomial as tdisc
from demcmc_tpu_torch.models import gaussian as tgauss
from demcmc_tpu_torch.models import lba as tlba
from demcmc_tpu_torch.models import mvnormal as tmvn
from demcmc_tpu_torch.ops import _build
from demcmc_tpu_torch.ops import fused_step as tfused
from demcmc_tpu_torch.ops import resample_step as tres

DATA = np.asarray(np.random.default_rng(12).normal(0.2, 1.1, 50), np.float32)


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread per test, restored after it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _mcz(n_groups, Np, **kw):
    return tgauss.make(data=DATA, n_groups=n_groups, Np=Np, alpha=0.0,
                       sample="resample", n_initial=6, sweep="sync", **kw)


def _cfg(model, de):
    return tfused.StepConfig.make(model, de, tdm.make_spec(model, de))


@pytest.mark.parametrize("Np", [3, 4, 6, 16])
def test_cluster_window_holds_whole_groups(Np):
    """On the CPU a Gaussian K3 window holds CLUSTER_CTAS CTAs of whole
    groups within MAX_WINDOW_C chains each (the card reads the largest
    cluster of its kernel); the 30-dim MVN's window stays one CTA."""
    model, de = _mcz(4, Np)
    want = tres.CLUSTER_CTAS * (tres.MAX_WINDOW_C // Np) * Np
    assert tres.window_chains(_cfg(model, de), "cpu") == want
    assert want > tres.MAX_WINDOW_C
    G_edge = want // Np
    assert tres.resample_super_k(_cfg(model, de.replace(
        n_groups=G_edge))) == tres.RESAMPLE_SUPER_K
    assert tres.resample_super_k(_cfg(model, de.replace(
        n_groups=G_edge + 1))) == 1
    mvn, mde = tmvn.make(d=30, n_obs=20, key=1, n_groups=4, Np=Np,
                         n_initial=2)
    assert tres.window_chains(_cfg(mvn, mde), "cpu") == tres.MAX_WINDOW_C
    assert "gaussian" in _build.HOIST_DENSITIES
    assert "mvnormal30" not in _build.HOIST_DENSITIES


def _clone(state):
    return state._replace(**{k: getattr(state, k).clone()
                             for k in ("theta", "weight", "fire", "history")
                             if getattr(state, k) is not None})


def _same(a, b):
    (ca, sa), (cb, sb) = a, b
    np.testing.assert_array_equal(ca.data, cb.data)
    np.testing.assert_array_equal(ca.lp, cb.lp)
    np.testing.assert_array_equal(ca.acceptance, cb.acceptance)
    for k in ("theta", "weight", "fire", "history"):
        x, y = getattr(sa, k), getattr(sb, k)
        if x is not None:
            assert torch.equal(x.view(torch.int32) if x.is_floating_point()
                               else x, y.view(torch.int32)
                               if y.is_floating_point() else y), k


def _windows_and_loop(model, de, n_iter, key):
    spec = tdm.make_spec(model, de)
    got = tdm.sample(model, de, n_iter, key=key, device="cpu",
                     return_state=True)
    state = tsampler._grow_history(
        tdm.init_state(model, de, spec, key, device="cpu"), n_iter)
    step = tdm.build_step(model, de, spec, device="cpu")
    state, ys = tsampler.run_loop(step, state, n_iter, 1)
    return got, (tsampler.bundle_samples(model, de, spec, ys, n_iter, 1),
                 state), step


@pytest.mark.parametrize("alpha", [0.0, 0.2])
def test_cluster_window_above_one_cta_equals_the_loop(alpha, monkeypatch):
    """The Gaussian DE-MCz at C = 2,048 (512 × 4, above one CTA's 1,024)
    runs windows (K = 8 here) across the burn-in switch, with migration
    between them where α > 0, and equals one launch an iteration bit for
    bit, history included."""
    monkeypatch.setattr(tres, "RESAMPLE_SUPER_K", 8)
    model, de = _mcz(512, 4, burnin=10, theta_snooker=0.2,
                     discard_burnin=False)
    de = de.replace(alpha=alpha)
    got, loop, step = _windows_and_loop(model, de, 14, key=3)
    assert step.superstep_k == 8
    _same(got, loop)


@pytest.mark.parametrize("name", ["lba", "binomial_abc",
                                  "discrete_binomial"])
def test_lanes_group_limit_is_the_one_lane_kernels(name, monkeypatch):
    """A density with lanes takes its largest groups at one lane a chain,
    in the one-thread kernel, whose block holds the group limit: the
    kernels' step takes a group up to ``block_chains`` (on the CPU the
    static 1,024) and no larger."""
    if name == "lba":
        model, de = tlba.make(key=0, n_trials=20, Np=1024, n_groups=1)
    elif name == "binomial_abc":
        model, de = tbinom.make(N=10, k=6, abc=True, fresh_noise=True,
                                n_sim=64, Np=1024, n_groups=1)
    else:
        model, de = tdisc.make(key=0, n_obs=20, dtype=np.float32, Np=1024,
                               n_groups=1)
    assert model.cuda_density.name == name
    assert tfused.block_chains(False, model.cuda_density, False, False, 1,
                               "cpu") == tfused.MAX_BLOCK_CHAINS == 1024
    assert tsampler.fused_supported(model, de)
    assert not tsampler.fused_supported(model, de.replace(Np=1025))
    seen = []

    def stub(resample, density, seq, snooker, n_blocks, device):
        seen.append(density.name)
        return 512
    monkeypatch.setattr(tfused, "block_chains", stub)
    assert not tsampler.fused_supported(model, de)
    assert tsampler.fused_supported(model, de.replace(Np=512, n_groups=2))
    assert seen == [name, name]


def test_one_lane_groups_windows_equal_the_loop(monkeypatch):
    """The discrete binomial at 2 × 1,024 (one lane a chain on the card)
    through windows (K = 8) across burn-in equals one launch an
    iteration, bit for bit."""
    monkeypatch.setattr(tfused, "SUPER_K", 8)
    model, de = tdisc.make(key=0, n_obs=20, dtype=np.float32, Np=1024,
                           n_groups=2, burnin=6, discard_burnin=False)
    got, loop, step = _windows_and_loop(model, de, 12, key=5)
    assert step.superstep_k == 8
    _same(got, loop)
