"""The port's plain DE step (the CPU version of CUDA kernel K1, with K2's
plain migration in front) on the LBA, pseudo-marginal ABC binomial and
discrete binomial densities, against the JAX whole-iteration Pallas kernel
in interpret mode, on the same random words (bits-in mode).

The JAX kernel's within-group gathers are replaced, in this process only,
by the JAX package's own linear-select gather, as in
``test_torch_fused_step.py`` (ROADMAP.md, C).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from demcmc_tpu.models import binomial as jbin
from demcmc_tpu.models import discrete_binomial as jdisc
from demcmc_tpu.models import lba as jlba
from demcmc_tpu.ops import fused_step as jfused
from demcmc_tpu.sampler import make_spec as jmake_spec

import demcmc_tpu_torch as tdm
from demcmc_tpu_torch.models import binomial as tbin
from demcmc_tpu_torch.models import discrete_binomial as tdisc
from demcmc_tpu_torch.models import lba as tlba
from demcmc_tpu_torch.ops import fused_step as tfused
from demcmc_tpu_torch.ops import migration as tmig

K, BURNIN = 3, 1
LBA_DATA = tlba.simulate(np.random.default_rng(5), 32, **tlba.TRUE)


@pytest.fixture()
def f32_jax():
    """JAX without x64 (the test harness turns it on): the JAX LBA model's
    folded prior constant would otherwise trace as a float64 op, which the
    fused kernel refuses."""
    with jax.enable_x64(False):
        yield


@pytest.fixture()
def member_gather(monkeypatch):
    """The JAX kernel with a within-group gather that returns the drawn
    member (see the module docstring)."""
    def one(x, idx, p, Np):
        return jfused._seg_gather(jfused._roll_dict(x, p, Np), idx, p, Np)

    def multi(x, idxs, p, Np):
        rolls = jfused._roll_dict(x, p, Np)
        return [jfused._seg_gather(rolls, i, p, Np) for i in idxs]

    monkeypatch.setattr(jfused, "_seg_gather_bin", one)
    monkeypatch.setattr(jfused, "_seg_gather_bin_multi", multi)


def _bits(key2, it, n_words, C):
    """The words the interpret-mode kernel_call feeds iteration ``it``."""
    key = jax.random.wrap_key_data(jnp.asarray(key2), impl="threefry2x32")
    b = np.asarray(jax.random.bits(jax.random.fold_in(key, it),
                                   (n_words, C), jnp.uint32))
    return torch.from_numpy(b.astype(np.int64)).to(torch.uint32)


def _lba(G, Np, rng):
    kw = dict(Np=Np, n_groups=G, burnin=BURNIN, sweep="sync")
    C = G * Np
    min_rt = float(LBA_DATA[1].min())
    theta = np.stack([np.abs(rng.normal(2.5, 0.6, C)),
                      np.abs(rng.normal(2.0, 0.6, C)),
                      rng.uniform(0.5, 1.0, C), rng.uniform(0.1, 0.3, C),
                      rng.uniform(0.05, 0.9 * min_rt, C)], 1)
    return (jlba.make(data=LBA_DATA, **kw), tlba.make(data=LBA_DATA, **kw),
            theta)


def _abc(G, Np, rng):
    kw = dict(N=10, k=6, abc=True, fresh_noise=True, n_sim=400, Np=Np,
              n_groups=G, burnin=BURNIN)
    return (jbin.make(**kw), tbin.make(**kw),
            rng.uniform(0.4, 0.8, (G * Np, 1)))


def _discrete(G, Np, rng):
    kw = dict(key=0, n_obs=50, dtype=np.float32, Np=Np, n_groups=G,
              burnin=BURNIN)
    C = G * Np
    theta = np.stack([rng.integers(10, 31, C), rng.uniform(0.2, 0.8, C)], 1)
    return jdisc.make(**kw), tdisc.make(**kw), theta


# (case, G, Np, seed, θ tolerance, w tolerance, near-tie margin); a θ
# tolerance t means |port − JAX| <= t + t·|JAX|, a w tolerance (r, a)
# means |port − JAX| <= a + r·|JAX|.  XLA's exp and log differ from
# torch's by an ulp.  The ABC density is integer hits and one log.  The
# discrete one sums 50·lgamma(N + 1) (up to ~5,000) against the
# unique-count terms down to w ~ −100: one ulp of those terms is ~5e-4,
# so its w tolerance is absolute, four such ulps.  LBA sums 32 trials of
# four exp and two logs each, in index order here and in one jnp.sum in
# XLA's order there.
CASES = [("lba", _lba, 8, 4, 0, 1e-5, (1e-5, 1e-5), 1e-3),
         ("abc", _abc, 16, 8, 1, 1e-6, (1e-6, 1e-6), 1e-4),
         ("discrete", _discrete, 16, 8, 2, 1e-6, (0.0, 2e-3), 1e-2)]


@pytest.mark.parametrize("name,case,G,Np,seed,tol,w_tol,tie", CASES,
                         ids=[c[0] for c in CASES])
def test_plain_step_matches_jax_kernel(f32_jax, member_gather, name, case,
                                       G, Np, seed, tol, w_tol, tie):
    """K = 3 iterations from it = 1 with fire = 1 and burn-in 1 (migration
    first, across the burn-in boundary): trajectory θ and w within the
    case's tolerance, accept flags and the exported gate exactly, away
    from near-ties (none occur at these seeds); the row layout has the
    JAX kernel's word count; integer dimensions stay integral."""
    rng = np.random.default_rng(seed)
    (jm, jde), (model, de), theta = case(G, Np, rng)
    theta = theta.astype(np.float32)
    C, d = theta.shape
    R, Cf = 8, C // 8
    spec = tdm.make_spec(model, de)
    cfg = tfused.StepConfig.make(model, de, spec)
    kern = jfused.build_fused_step(jm, jde, jmake_spec(jm, jde),
                                   interpret=True, K=K, mig_in_kernel=True)
    assert cfg.rows.n_words == kern.n_words
    noise = None
    if model.stochastic:
        noise = tdm.rng.to_uni(tdm.rng.words(9, 0, model.noise_words, C))
    w = tdm.ops.accept.compute_posterior(model, spec, torch.tensor(theta),
                                         noise).numpy()
    key2 = np.array([0x3456 + seed, 0xBEEF], np.uint32)
    jt, jw, jacc, jfire = (np.asarray(o) for o in jax.jit(kern)(
        jnp.asarray(theta.T.reshape(d, R, Cf)), jnp.asarray(w.reshape(R, Cf)),
        jnp.asarray(key2), jnp.int32(1), jnp.ones((1, 1), jnp.int32)))

    th, ww = torch.tensor(theta), torch.tensor(w)
    fire = torch.ones(1, dtype=torch.int32)
    n_acc = 0
    for k in range(K):
        words = _bits(key2, 1 + k, kern.n_words, C)
        tmig.migrate_plain(th, ww, fire, words, G, Np)
        margin = tfused.de_step_plain(cfg, model, spec, th, ww, fire, 1 + k,
                                      words)
        assert (margin.abs() > tie).all(), "near-tie at this seed"
        jth, jww = jt[k].reshape(d, C).T, jw[k].reshape(C)
        np.testing.assert_allclose(th.numpy(), jth, rtol=tol, atol=tol)
        fin = np.isfinite(jww)
        np.testing.assert_array_equal(np.isfinite(ww.numpy()), fin)
        np.testing.assert_allclose(ww.numpy()[fin], jww[fin],
                                   rtol=w_tol[0], atol=w_tol[1])
        np.testing.assert_array_equal((margin <= 0).numpy(),
                                      jacc[k].reshape(C))
        n_acc += int((margin <= 0).sum())
        for i in cfg.int_dims:
            assert torch.equal(th[:, i], torch.round(th[:, i]))
    assert int(fire[0]) == int(jfire.reshape(-1)[0])
    assert n_acc > 0
