"""The port's hierarchical model (``demcmc_tpu_torch.models.hierarchical``,
the reference's ``Hierarchical_Example.jl``: DE-MCz with snooker, two
groups with migration and two blocks) against the JAX package's: the
density and prior on the same data, one bits-in run of the full
configuration through the unfused step against the JAX XLA step (the
harness of ``test_torch_unfused_resample.py``), and a CPU ``sample()``.

The JAX model draws its data with ``jax.random``, the port's with numpy;
both take the same array here through ``data=``.  Tolerances: the log
posterior within 1e-5 + 1e-5·|lp| (XLA sums the S·n terms in another
order); the run as in ``test_torch_unfused_resample.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

import demcmc_tpu as jdm
from demcmc_tpu.models import hierarchical as jhier

import demcmc_tpu_torch as tdm
from demcmc_tpu_torch.models import hierarchical as thier
from demcmc_tpu_torch.ops import accept as taccept

from test_torch_unfused_resample import (K, _fed_pool, _jax_run,  # noqa
                                         margins, one_torch_thread)

S, N_DATA = 4, 10
DATA = thier.simulate(np.random.default_rng(11), S, N_DATA)


def _population(C, seed):
    """θ [C, 2 + S + 1] inside the support: μβ0, σβ0, β0[S], σ."""
    rng = np.random.default_rng(seed)
    return np.concatenate([rng.normal(1.0, 0.3, (C, 1)),
                           rng.uniform(0.5, 1.5, (C, 1)),
                           rng.normal(0.0, 0.8, (C, S)),
                           rng.uniform(0.3, 0.8, (C, 1))],
                          1).astype(np.float32)


def test_density_matches_jax():
    """The batched log posterior (priors, then the S·n likelihood terms) at
    n_subj = 4 against the JAX model's per-cell one, θ inside the support
    and with σβ0 < 0 and σ < 0 (−inf); the names, bounds and DE defaults
    are the JAX ``make``'s."""
    jm, jde = jhier.make(n_subj=S, n_data=N_DATA, data=jnp.asarray(DATA))
    model, de = thier.make(n_subj=S, n_data=N_DATA, data=DATA)
    spec, jspec = tdm.make_spec(model, de), jdm.make_spec(jm, jde)
    assert spec.names == jspec.names == thier.NAMES
    assert spec.dim == 2 + S + 1 and spec.shapes == jspec.shapes
    np.testing.assert_array_equal(spec.lo, jspec.lo)
    np.testing.assert_array_equal(spec.hi, jspec.hi)
    for f in ("Np", "n_groups", "theta_snooker", "n_initial", "burnin",
              "alpha", "uses_resample", "sequential_sweep"):
        assert getattr(de, f) == getattr(jde, f), f
    assert de.blocks == ((True, True, (False,) * S, True),
                         (False, False, (True,) * S, False))
    x = _population(64, 1)
    x[:3, 1] = -0.2
    x[3:5, -1] = -0.1
    want = np.asarray(jax.vmap(lambda q: jdm.compute_posterior(
        jm, jspec, jde, q))(jnp.asarray(x)))
    got = taccept.compute_posterior(model, spec, de,
                                     torch.tensor(x)).numpy()
    fin = np.isfinite(want)
    assert (~fin).sum() == 5
    np.testing.assert_array_equal(np.isfinite(got), fin)
    np.testing.assert_allclose(got[fin], want[fin], rtol=1e-5, atol=1e-5)


def test_full_configuration_matches_jax_xla_step(margins):
    """K = 4 iterations of the hierarchical configuration itself (DE-MCz,
    snooker 0.1, two groups, the two blocks swept every iteration, the
    sequential sweep; α raised to 0.5 so that four iterations open a
    gate) in the port's unfused step, fed the JAX pool and scalars,
    against the JAX XLA step: θ, w, accept flags and the history row each
    iteration writes; the port takes no kernel (no CUDA density)."""
    kw = dict(n_subj=S, n_data=N_DATA, burnin=30, alpha=0.5)
    jm, jde = jhier.make(data=jnp.asarray(DATA), **kw)
    model, de = thier.make(data=DATA, **kw)
    assert model.cuda_density is None
    C, n_init = de.n_chains, de.n_initial
    hist0 = np.stack([_population(C, s) for s in range(n_init)])
    theta0 = hist0[0]
    spec = tdm.make_spec(model, de)
    w0 = taccept.compute_posterior(model, spec, de,
                                   torch.tensor(theta0)).numpy()
    it0 = n_init + 1
    n_words, pools, scalars, outs, hists = _jax_run(jm, jde, theta0, w0,
                                                    hist0, 2, it0)
    step = tdm.build_step(model, de, spec, device="cpu")
    assert isinstance(step, tdm.UnfusedStep) and step.pool_words == n_words
    state = tdm.state_from_numpy(
        theta0, w0, it0, None, "flat", device="cpu",
        history=np.concatenate([hist0, np.zeros((K, C, spec.dim))]))
    step.draws = lambda key_, it: _fed_pool(pools[it - it0],
                                            scalars[it - it0])
    out = (torch.empty(C, spec.dim), torch.empty(C),
           torch.empty(C, dtype=torch.bool))
    for k in range(K):
        state = step(state, out)
        jt, ja, jw = outs[k]
        np.testing.assert_allclose(out[0].numpy(), jt, rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(out[1].numpy(), jw, rtol=1e-5, atol=1e-5)
        np.testing.assert_array_equal(out[2].numpy(), ja)
        np.testing.assert_allclose(state.history[it0 + k - 1].numpy(),
                                   hists[k][it0 + k - 1], rtol=1e-6,
                                   atol=1e-6)
    assert all((m.abs() > 1e-4).all() for m in margins), "near-tie"
    assert any(u <= np.float32(0.5) for u, _ in scalars)


def test_sample_on_cpu_runs_and_stores_history():
    """``sample()`` of the full-width model (20 subjects × 50 observations,
    d = 23, 6 chains) through the unfused step on the CPU, 300 iterations
    after a burn-in of 100: finite draws of the kept iterations, σ and σβ0
    positive, and the history holding every state of the run after its
    n_initial prior rows."""
    model, de = thier.make(burnin=100)
    assert de.n_chains == 6 and de.n_initial == 84
    chains, end = tdm.sample(model, de, 400, key=1, device="cpu",
                             return_state=True)
    assert chains.data.shape == (300, 23, 6)
    assert np.isfinite(chains.data).all() and np.isfinite(chains.lp).all()
    assert (chains["sigma"] > 0).all() and (chains["sigma_b0"] > 0).all()
    assert end.history.shape == (84 + 400, 6, 23)
    np.testing.assert_array_equal(end.history[184:].numpy(),
                                  np.moveaxis(chains.data, 1, 2))
    assert end.iteration == 485
