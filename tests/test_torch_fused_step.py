"""The port's plain DE step (``demcmc_tpu_torch.ops.fused_step``, the CPU
version of CUDA kernel K1, with K2's plain migration in front) against the
JAX whole-iteration Pallas kernel run in interpret mode, on the same
random words (bits-in mode).

The JAX kernel reads its words from ``jax.random.bits(fold_in(key, it),
(n_words, C))`` exactly as its ``kernel_call`` makes them in interpret
mode; the port's plain step reads the same ``[n_words, C]`` rows.

The JAX kernel's within-group gathers (``_seg_gather_bin`` and
``_seg_gather_bin_multi``) do not return the member they are given: lane
c ends up with a value routed by other lanes' offsets (ROADMAP.md, C).
The port gathers the drawn member, so these tests replace those two
functions, in this process only, by the JAX package's own linear-select
gather (``_roll_dict`` + ``_seg_gather``), which does.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from demcmc_tpu.models import gaussian as jgauss
from demcmc_tpu.ops import fused_step as jfused
from demcmc_tpu.sampler import make_spec as jmake_spec

import demcmc_tpu_torch as tdm
from demcmc_tpu_torch.models import gaussian as tgauss
from demcmc_tpu_torch.ops import fused_step as tfused
from demcmc_tpu_torch.ops import migration as tmig

DATA = np.asarray(np.random.default_rng(3).normal(0.3, 1.2, 50), np.float32)
G, NP, K, BURNIN = 8, 8, 4, 2


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


def _population(seed, C):
    rng = np.random.default_rng(seed)
    mu = rng.normal(DATA.mean(), 0.3, C)
    sigma = np.abs(rng.normal(DATA.std(), 0.3, C)) + 0.05
    theta = np.stack([mu, sigma], 1).astype(np.float32)
    w = np.asarray(jgauss.prior_loglike_batched(theta[:, 0], theta[:, 1])
                   + jgauss.loglike_batched(DATA, theta[:, 0], theta[:, 1]),
                   np.float32)
    return theta, w


def _bits(key2, it, n_words, C):
    """The words the interpret-mode kernel_call feeds iteration ``it``."""
    key = jax.random.wrap_key_data(jnp.asarray(key2), impl="threefry2x32")
    b = np.asarray(jax.random.bits(jax.random.fold_in(key, it),
                                   (n_words, C), jnp.uint32))
    return torch.from_numpy(b.astype(np.int64)).to(torch.uint32)


@pytest.mark.parametrize("proposal,seed", [("random_gamma", 0),
                                           ("fixed_gamma", 1),
                                           ("variable_gamma", 2)])
def test_plain_step_matches_jax_kernel(member_gather, proposal, seed):
    """K=4 iterations from it=1 with fire=1 and burnin=2 (so the run
    migrates first and crosses the burn-in boundary): trajectory θ and w
    to rtol 1e-5 / atol 1e-6, accept flags and the exported migration
    gate exactly, away from near-ties (none occur at these seeds)."""
    C, d = G * NP, 2
    R, Cf = 8, C // 8
    jm, jde = jgauss.make(data=DATA, Np=NP, n_groups=G, burnin=BURNIN,
                          generate_proposal=proposal)
    kern = jfused.build_fused_step(jm, jde, jmake_spec(jm, jde),
                                   interpret=True, K=K, mig_in_kernel=True)
    theta, w = _population(seed, C)
    key2 = np.array([0x1234 + seed, 0xBEEF], np.uint32)
    it0 = 1
    jt, jw, jacc, jfire = (np.asarray(o) for o in jax.jit(kern)(
        jnp.asarray(theta.T.reshape(d, R, Cf)), jnp.asarray(w.reshape(R, Cf)),
        jnp.asarray(key2), jnp.int32(it0), jnp.ones((1, 1), jnp.int32)))

    model, de = tgauss.make(data=DATA, Np=NP, n_groups=G, burnin=BURNIN,
                            generate_proposal=proposal)
    spec = tdm.make_spec(model, de)
    cfg = tfused.StepConfig.make(model, de, spec)
    assert cfg.rows.n_words == kern.n_words
    th, ww = torch.tensor(theta), torch.tensor(w)
    fire = torch.ones(1, dtype=torch.int32)
    for k in range(K):
        words = _bits(key2, it0 + k, kern.n_words, C)
        tmig.migrate_plain(th, ww, fire, words, G, NP)
        margin = tfused.de_step_plain(cfg, model, spec, th, ww, fire,
                                      it0 + k, words)
        assert (margin.abs() > 1e-4).all(), "near-tie at this seed"
        np.testing.assert_allclose(th.numpy(), jt[k].reshape(d, C).T,
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(ww.numpy(), jw[k].reshape(C),
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_array_equal((margin <= 0).numpy(),
                                      jacc[k].reshape(C))
    assert int(fire[0]) == int(jfire.reshape(-1)[0])


@pytest.mark.parametrize("kw", [{}, {"generate_proposal": "fixed_gamma"},
                                {"alpha": 0.0, "beta": 0.0, "epsilon": 0.0},
                                {"kappa": 0.5}])
def test_draw_rows_match_kernel_word_count(kw):
    """The port's per-iteration row layout has exactly the JAX kernel's
    word count, at the bench width (G=256, Np=16)."""
    jm, jde = jgauss.make(data=DATA, Np=16, n_groups=256, **kw)
    kern = jfused.build_fused_step(jm, jde, jmake_spec(jm, jde),
                                   interpret=True, K=1, mig_in_kernel=True)
    model, de = tgauss.make(data=DATA, Np=16, n_groups=256, **kw)
    rows = tfused.draw_rows(de, 2)
    assert rows.n_words == kern.n_words
    if not kw:
        assert rows.n_words == 17


def test_wrapper_takes_plain_version_on_cpu():
    """On CPU tensors ``de_step`` (the K1 wrapper) runs the plain version:
    same result as calling it directly, no kernel launch counted."""
    model, de = tgauss.make(data=DATA, Np=NP, n_groups=G, burnin=BURNIN)
    spec = tdm.make_spec(model, de)
    cfg = tfused.StepConfig.make(model, de, spec)
    theta, w = _population(5, G * NP)
    words = tdm.rng.words(7, 3, cfg.rows.n_words, G * NP)
    a = [torch.tensor(theta), torch.tensor(w), torch.zeros(1, dtype=torch.int32)]
    b = [x.clone() for x in a]
    before = tfused.de_step.launches
    tfused.de_step(cfg, model, spec, *a, 3, seed=7)
    tfused.de_step_plain(cfg, model, spec, *b, 3, words)
    assert tfused.de_step.launches == before
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def test_kernel_arguments():
    """K1's ctypes argument arrays: the integer array is kept per seed and
    carries the window of the latest launch (its first iteration, K, the
    emission rule and the phase) and the population's chains (a bits-in
    buffer's width, the launch's own unless given); the float array is
    built once, in the layout ``csrc/de_step.cu`` reads."""
    model, de = tgauss.make(data=DATA, Np=NP, n_groups=G, burnin=BURNIN)
    cfg = tfused.StepConfig.make(model, de, tdm.make_spec(model, de))
    a = cfg.iargs(3, seed=(7 << 32) | 5)
    assert list(a[:7]) == [G, NP, 3, BURNIN, 1, 5, 7]
    r = cfg.rows
    assert list(a[7:15]) == [r.partners, r.gamma, r.eps, 0xFFFFFFFF,
                             r.gate, r.normal, r.accept, r.fire]
    assert list(a[15:]) == [1, 0, 1, r.n_words, 0, G * NP]
    assert cfg.iargs(4, seed=(7 << 32) | 5) is a and a[2] == 4
    assert cfg.iargs(9, (7 << 32) | 5, K=16, emit=(3, 4), post=True) is a
    assert a[2] == 9 and list(a[15:]) == [16, 3, 4, r.n_words, 1, G * NP]
    assert cfg.iargs(9, (7 << 32) | 5, n_all=4 * G * NP)[20] == 4 * G * NP
    b = cfg.iargs(4, seed=9)
    assert b is not a and list(b[5:7]) == [9, 0]
    assert cfg.fargs is cfg.fargs
    f = np.float32
    assert list(cfg.fargs[:7]) == [0.0, f(0.001), f(0.002), f(0.0), f(0.1),
                                   f(0.05), f(0.1)]
    assert len(cfg.fargs) == 7 + 4 + len(model.cuda_density.params)


def test_reference_gather_network_returns_other_members():
    """Why the ``member_gather`` fixture exists (ROADMAP.md, C): the JAX
    kernel's binary gather network, run as the kernel runs it, returns
    for most lanes a group member other than the one asked for, while the
    port's ``gather_members`` returns the member asked for."""
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import tpu as pltpu
    R, Cf, Np = 8, 128, 16
    rng = np.random.default_rng(11)
    idx = rng.integers(0, Np, (R, Cf)).astype(np.int32)
    x = np.arange(R * Cf, dtype=np.float32).reshape(R, Cf)

    def kern(x_ref, i_ref, o_ref):
        p = jax.lax.broadcasted_iota(jnp.int32, (R, Cf), 1) % Np
        o_ref[:] = jfused._seg_gather_bin(x_ref[:], i_ref[:], p, Np)

    got = np.asarray(pl.pallas_call(
        kern, out_shape=jax.ShapeDtypeStruct((R, Cf), jnp.float32),
        interpret=pltpu.InterpretParams())(x, idx))
    lane = np.arange(Cf)
    asked = x[np.arange(R)[:, None], (lane // Np * Np)[None, :] + idx]
    assert np.mean(got != asked) > 0.5
    port = tdm.ops.proposals.gather_members(
        torch.tensor(x).view(R * Cf // Np, Np, 1),
        torch.tensor(idx.astype(np.int64)).view(R * Cf // Np, Np))
    np.testing.assert_array_equal(port.view(R, Cf).numpy(), asked)
