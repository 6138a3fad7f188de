"""The port's sampling loop on the CPU (plain PyTorch versions of both
kernels): the posterior of the reference Gaussian configuration, thinning
and resuming, and the state converter from the JAX package's state."""

import numpy as np
import pytest
import torch

import demcmc_tpu as jdm
from demcmc_tpu.models import gaussian as jgauss

import demcmc_tpu_torch as tdm
from demcmc_tpu_torch.models import gaussian as tgauss
from demcmc_tpu_torch.ops import fused_step as tfused
from demcmc_tpu_torch.ops import migration as tmig

DATA = np.asarray(np.random.default_rng(0).standard_normal(50), np.float32)


def test_posterior_matches_grid():
    """Reference Gaussian configuration (Np=6 × 4 groups, 3,000
    iterations, burn-in 1,000; PARITY_RESULTS.md): posterior means and
    sds within 0.02 of the quadrature oracle, R̂ < 1.05.  No kernel is
    launched on the CPU."""
    launches = (tfused.de_step.launches, tmig.migrate.launches)
    model, de = tgauss.make(data=DATA)
    chains = tdm.sample(model, de, 3000, key=1, device="cpu")
    assert (tfused.de_step.launches, tmig.migrate.launches) == launches
    assert len(chains) == 2000 and chains.n_chains == 24
    truth = tgauss.posterior_grid(DATA)
    for name in ("mu", "sigma"):
        assert abs(chains.mean(name) - truth[name]["mean"]) < 0.02, name
        assert abs(chains.std(name) - truth[name]["std"]) < 0.02, name
    assert chains.rhat().max() < 1.05
    assert 0.05 < chains.acceptance.mean() < 0.9
    assert np.isfinite(chains.lp).all()


def test_thin_gives_the_sliced_draws():
    model, de = tgauss.make(data=DATA, burnin=40)
    full = tdm.sample(model, de, 120, key=3, device="cpu")
    thin = tdm.sample(model, de, 120, key=3, thin=4, device="cpu")
    np.testing.assert_array_equal(thin.data, full.data[3::4])
    np.testing.assert_array_equal(thin.lp, full.lp[3::4])
    np.testing.assert_array_equal(thin.acceptance, full.acceptance[3::4])
    with pytest.raises(ValueError):
        tdm.sample(model, de, 121, key=3, thin=4, device="cpu")


def test_resume_is_bitwise():
    """2N iterations in one run equal N iterations followed by N more from
    the returned state, bit for bit (the migration gate rides along in
    the state)."""
    model, de = tgauss.make(data=DATA, burnin=0, discard_burnin=False)
    whole, s_whole = tdm.sample(model, de, 200, key=5, return_state=True,
                                device="cpu")
    first, s_mid = tdm.sample(model, de, 100, key=5, return_state=True,
                              device="cpu")
    theta_mid = s_mid.theta.clone()
    second, s_end = tdm.sample(model, de, 100, key=5, state=s_mid,
                               return_state=True, device="cpu")
    assert torch.equal(s_mid.theta, theta_mid)          # input untouched
    np.testing.assert_array_equal(
        np.concatenate([first.data, second.data]), whole.data)
    np.testing.assert_array_equal(
        np.concatenate([first.lp, second.lp]), whole.lp)
    assert s_end.iteration == s_whole.iteration == 201
    assert torch.equal(s_end.theta, s_whole.theta)
    assert torch.equal(s_end.fire, s_whole.fire)


def test_state_from_numpy_round_trips_jax_state(monkeypatch):
    """A JAX ``init_state`` (flat layout) and its fused-layout form both
    convert to the same port state, and back to the JAX arrays."""
    monkeypatch.setenv("DEMCMC_FUSED", "interpret")
    jm, jde = jgauss.make(data=DATA, Np=8, n_groups=8)
    spec = jdm.make_spec(jm, jde)
    js = jdm.init_state(jm, jde, spec, 4)
    step = jdm.sampler.build_step(jm, jde, spec)
    assert getattr(step, "fused", False)
    fs = step.to_fused(js)
    flat = tdm.state_from_numpy(np.asarray(js.theta), np.asarray(js.weight),
                                np.asarray(js.iteration), None, "flat",
                                device="cpu")
    fused = tdm.state_from_numpy(np.asarray(fs.theta), np.asarray(fs.weight),
                                 np.asarray(fs.iteration), np.asarray(fs.fire),
                                 "fused", device="cpu")
    assert torch.equal(flat.theta, fused.theta)
    assert torch.equal(flat.weight, fused.weight)
    assert flat.iteration == fused.iteration == 1
    assert int(fused.fire[0]) == int(np.asarray(fs.fire).reshape(-1)[0])
    np.testing.assert_array_equal(
        fused.theta.numpy().reshape(8, 8, 2),
        np.asarray(js.theta, np.float32))
    np.testing.assert_array_equal(fused.weight.numpy().reshape(8, 8),
                                  np.asarray(js.weight, np.float32))
    # the port samples on from the JAX population
    model, de = tgauss.make(data=DATA, Np=8, n_groups=8, burnin=0,
                            discard_burnin=False)
    chains = tdm.sample(model, de, 5, state=fused, device="cpu")
    assert chains.data.shape == (5, 2, 64)
    with pytest.raises(ValueError):
        tdm.state_from_numpy(np.asarray(js.theta), np.asarray(js.weight), 1,
                             None, "packed", device="cpu")


@pytest.mark.parametrize("kw,exc", [({"mesh": object()}, TypeError),
                                    ({"checkpoint_every": 10}, None),
                                    ({"monitor": True}, None),
                                    ({"stop_rhat": 1.01}, None)],
                         ids=["kw0", "kw1", "kw2", "kw3"])
def test_later_slice_options_raise(kw, exc):
    """The options that raised before the port carried them
    (``checkpoint_every``, ``monitor``, ``stop_rhat``) now run and change
    no draw (``tests/test_torch_chunked.py`` holds them bit for bit over
    more configurations); ``mesh=`` is carried
    (``tests/test_torch_mesh.py``) and refuses what is not a chain
    mesh."""
    model, de = tgauss.make(data=DATA, burnin=4)
    if exc is not None:
        with pytest.raises(exc):
            tdm.sample(model, de, 10, device="cpu", **kw)
        return
    ref = tdm.sample(model, de, 60, device="cpu")
    got = tdm.sample(model, de, 60, device="cpu", **kw)
    np.testing.assert_array_equal(got.data, ref.data)
    np.testing.assert_array_equal(got.lp, ref.lp)
    assert hasattr(got, "monitor") == ("checkpoint_every" not in kw)


def test_init_state_and_first_gate():
    """``init_state`` draws the population from the init namespace and
    scores it with the posterior; the first gate is Bernoulli(α) from its
    own namespace, and never fires with one group."""
    model, de = tgauss.make(data=DATA, Np=6, n_groups=4)
    spec = tdm.make_spec(model, de)
    s = tdm.init_state(model, de, spec, 9, device="cpu")
    assert s.theta.shape == (24, 2) and s.theta.dtype == torch.float32
    assert (s.theta[:, 1] > 0).all()
    torch.testing.assert_close(
        s.weight, tdm.ops.accept.compute_posterior(model, spec, de, s.theta),
        rtol=0, atol=0)
    again = tdm.init_state(model, de, spec, 9, device="cpu")
    assert torch.equal(s.theta, again.theta)
    assert torch.equal(s.fire, tdm.sampler._first_gate(de, 9, 1, "cpu"))
    gates = [int(tdm.sampler._first_gate(de, k, 1, "cpu")[0])
             for k in range(200)]
    assert 5 <= sum(gates) <= 40                      # α = 0.1
    one = tdm.DE(Np=6, n_groups=1, bounds=tgauss.BOUNDS)
    assert one.alpha == 0.0
    assert int(tdm.init_state(model, one, spec, 9, device="cpu").fire[0]) == 0
    assert all(int(tdm.sampler._first_gate(one, k, 1, "cpu")[0]) == 0
               for k in range(50))


def test_cpu_step_words_equal_per_iteration_words():
    """On the CPU the step draws its words for many iterations at once; the
    run equals one taken with the words of each iteration drawn alone
    (the wrappers' own Philox draw), across block edges and a new key."""
    model, de = tgauss.make(data=DATA, Np=6, n_groups=4, burnin=30)
    spec = tdm.make_spec(model, de)
    step = tdm.build_step(model, de, spec, device="cpu")
    step.WORDS_PER_BLOCK = 10 * 24 * step.cfg.rows.n_words   # 10 per block
    for key, it0, n in ((3, 1, 25), (4, 7, 12)):
        s = tdm.init_state(model, de, spec, key, device="cpu",
                           start_iteration=it0)
        ref = s._replace(theta=s.theta.clone(), weight=s.weight.clone(),
                         fire=s.fire.clone())
        for _ in range(n):
            s = step(s)
            tmig.migrate(ref.theta, ref.weight, ref.fire, 4, 6,
                         seed=key, it=ref.iteration)
            tfused.de_step(step.cfg, model, spec, ref.theta, ref.weight,
                           ref.fire, ref.iteration, seed=key)
            ref = ref._replace(iteration=ref.iteration + 1)
            assert torch.equal(s.theta, ref.theta)
            assert torch.equal(s.weight, ref.weight)
            assert torch.equal(s.fire, ref.fire)
