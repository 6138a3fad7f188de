"""The port's plain DE step with the snooker branch and the sequential sweep
(``demcmc_tpu_torch.ops.fused_step``, the CPU version of CUDA kernel K1)
against the JAX whole-iteration Pallas kernel in interpret mode, on the
same random words (bits-in mode).

As in ``test_torch_fused_step.py``, the JAX kernel's within-group gathers
``_seg_gather_bin``/``_seg_gather_bin_multi`` are replaced, in this process
only, by the JAX package's own linear-select gather, which returns the
member drawn (ROADMAP.md, C).
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
from demcmc_tpu_torch.ops import proposals as tprop

DATA = np.asarray(np.random.default_rng(3).normal(0.3, 1.2, 50), np.float32)
K, BURNIN = 4, 2


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
    """θ [C, 2] near the posterior and its log posterior (the port's
    density, which equals JAX's to rtol 1e-6, test_torch_model.py)."""
    rng = np.random.default_rng(seed)
    mu = rng.normal(DATA.mean(), 0.3, C)
    sigma = np.abs(rng.normal(DATA.std(), 0.3, C)) + 0.05
    theta = np.stack([mu, sigma], 1).astype(np.float32)
    model, de = tgauss.make(data=DATA)
    w = tdm.ops.accept.compute_posterior(model, tdm.make_spec(model, de), de,
                                         torch.tensor(theta))
    return theta, w.numpy()


def _bits(key2, it, n_words, C):
    """The words the interpret-mode kernel_call feeds iteration ``it``."""
    key = jax.random.wrap_key_data(jnp.asarray(key2), impl="threefry2x32")
    b = np.asarray(jax.random.bits(jax.random.fold_in(key, it),
                                   (n_words, C), jnp.uint32))
    return torch.from_numpy(b.astype(np.int64)).to(torch.uint32)


@pytest.mark.parametrize("sweep,G,Np,seed", [("sync", 32, 16, 0),
                                             ("sequential", 8, 4, 1)])
def test_plain_snooker_step_matches_jax_kernel(member_gather, sweep, G, Np,
                                               seed):
    """θsnooker = 0.5, K = 4 iterations from it = 1 with fire = 1 and
    burn-in 2 (migration first, across the burn-in boundary): trajectory θ
    and w within 1e-5 (atol and rtol), accept flags and the exported gate
    exactly, away from near-ties (none occur at these seeds).  XLA's log
    and exp differ from torch's by an ulp, and a snooker projection onto a
    short θ − z amplifies that over the iterations: the largest difference
    seen is 5.3e-6.  Snooker draws land on the chain itself (degenerate)
    in about 1/Np of the chains and are rejected in both."""
    C, d = G * Np, 2
    R, Cf = 8, C // 8
    kw = dict(Np=Np, n_groups=G, burnin=BURNIN, theta_snooker=0.5,
              sweep=sweep)
    jm, jde = jgauss.make(data=DATA, **kw)
    kern = jfused.build_fused_step(jm, jde, jmake_spec(jm, jde),
                                   interpret=True, K=K, mig_in_kernel=True)
    theta, w = _population(seed, C)
    key2 = np.array([0x2345 + seed, 0xBEEF], np.uint32)
    jt, jw, jacc, jfire = (np.asarray(o) for o in jax.jit(kern)(
        jnp.asarray(theta.T.reshape(d, R, Cf)), jnp.asarray(w.reshape(R, Cf)),
        jnp.asarray(key2), jnp.int32(1), jnp.ones((1, 1), jnp.int32)))

    model, de = tgauss.make(data=DATA, **kw)
    spec = tdm.make_spec(model, de)
    cfg = tfused.StepConfig.make(model, de, spec)
    assert cfg.rows.n_words == kern.n_words
    assert cfg.rows.n_members == (Np if sweep == "sequential" else 1)
    th, ww = torch.tensor(theta), torch.tensor(w)
    fire = torch.ones(1, dtype=torch.int32)
    n_degen = 0
    for k in range(K):
        words = _bits(key2, 1 + k, kern.n_words, C)
        n_degen += _degenerate(cfg, words).sum()
        tmig.migrate_plain(th, ww, fire, words, G, Np)
        margin = tfused.de_step_plain(cfg, model, spec, th, ww, fire, 1 + k,
                                      words)
        assert (margin.abs() > 1e-4).all(), "near-tie at this seed"
        np.testing.assert_allclose(th.numpy(), jt[k].reshape(d, C).T,
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(ww.numpy(), jw[k].reshape(C),
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_array_equal((margin <= 0).numpy(),
                                      jacc[k].reshape(C))
    assert int(fire[0]) == int(jfire.reshape(-1)[0])
    assert n_degen > 0


def _degenerate(cfg, words):
    """Chains whose snooker draw is on and lands on the chain itself (in
    their own sub-sweep block), from the words."""
    G, Np, r = cfg.G, cfg.Np, cfg.rows
    slot = torch.arange(G * Np) % Np
    off = slot * r.stride if r.n_members > 1 else 0
    cols = torch.arange(G * Np)
    az = tdm.rng.randint(words[r.triple + off, cols], Np)
    on = tdm.rng.to_uni(words[r.snooker + 1 + off, cols]) \
        <= np.float32(cfg.theta_snooker)
    return (az == slot) & on


def test_degenerate_snooker_draw_rejects_without_nan():
    """Every chain draws itself as z with the snooker gate on and the β
    gate off: the proposal is θ, the correction −inf, every move is
    rejected and nothing turns NaN."""
    G, Np = 4, 6
    C = G * Np
    model, de = tgauss.make(data=DATA, Np=Np, n_groups=G, burnin=0,
                            theta_snooker=0.5, alpha=0.0)
    spec = tdm.make_spec(model, de)
    cfg = tfused.StepConfig.make(model, de, spec)
    r = cfg.rows
    words = tdm.rng.words(5, 3, r.n_words, C).to(torch.int64)
    slot = torch.arange(C) % Np
    words[r.triple] = slot                        # az = own slot
    words[r.snooker + 1] = 0                      # snooker gate on
    words[r.gate] = 0xFFFFFFFF                    # β gate off
    theta, w = (torch.tensor(x) for x in _population(4, C))
    th0, w0 = theta.clone(), w.clone()
    margin = tfused.de_step_plain(cfg, model, spec, theta, w,
                                  torch.zeros(1, dtype=torch.int32), 3,
                                  words.to(torch.uint32))
    assert torch.isposinf(margin).all()
    assert torch.equal(theta, th0) and torch.equal(w, w0)
    # the pieces: a degenerate draw proposes θ exactly and corrects −inf
    th = th0.view(G, Np, 2)
    prop, den0, degen = tprop.kernel_snooker(th, th, th.flip(1),
                                             th.roll(1, 1),
                                             torch.full((G, Np), 1.7))
    assert degen.all() and torch.isfinite(prop).all()
    adj = tprop.kernel_snooker_log_adj(th, th, den0, degen, 2)
    assert torch.isneginf(adj).all()


def test_snooker_pieces_match_the_reference_formulas():
    """Projection, proposal and correction against float64 numpy of the
    reference's formulas (``utilities.jl:239-246``, ``crossover.jl:
    239-273``) at d = 5, to float32 rounding (rtol 1e-5)."""
    rng = np.random.default_rng(9)
    t, z, m, n = (rng.normal(size=(7, 5)).astype(np.float32)
                  for _ in range(4))
    g = rng.uniform(1.2, 2.2, 7).astype(np.float32)
    prop, den0, degen = tprop.kernel_snooker(
        *(torch.tensor(x) for x in (t, z, m, n)), torch.tensor(g))
    T, Z, M, N = (x.astype(np.float64) for x in (t, z, m, n))
    pd = T - Z
    dd = (pd * pd).sum(1, keepdims=True)
    want = T + g[:, None] * ((M * pd).sum(1, keepdims=True) / dd * pd
                             - (N * pd).sum(1, keepdims=True) / dd * pd)
    np.testing.assert_allclose(prop.numpy(), want, rtol=1e-5, atol=1e-6)
    assert not degen.any()
    adj = tprop.kernel_snooker_log_adj(prop, torch.tensor(z), den0, degen, 5)
    a1 = np.sqrt(((want - Z) ** 2).sum(1))
    a2 = np.sqrt(dd[:, 0])
    np.testing.assert_allclose(adj.numpy(), 4 * (np.log(a1) - np.log(a2)),
                               rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("kw", [
    {"sweep": "sequential", "Np": 3, "kappa": 0.5},
    {"sample": "resample", "n_initial": 8, "n_groups": 1, "Np": 8,
     "alpha": 0.0, "theta_snooker": 0.1, "sweep": "sync"}])
def test_draw_rows_match_kernel_word_count(kw):
    """Row layouts beyond the bits-in tests' (the sequential sweep with κ
    rows and no snooker; the resample variant, which draws no partner or
    member-index rows) have exactly the JAX kernel's word count."""
    kw = {"Np": 16, "n_groups": 32, **kw}
    jm, jde = jgauss.make(data=DATA, **kw)
    kern = jfused.build_fused_step(jm, jde, jmake_spec(jm, jde),
                                   interpret=True, K=1, mig_in_kernel=True,
                                   hist_S=64)
    model, de = tgauss.make(data=DATA, **kw)
    rows = tfused.draw_rows(de, 2)
    assert rows.n_words == kern.n_words
    if de.uses_resample:
        assert rows.partners == rows.triple == -1 and rows.snooker >= 0
    else:
        assert rows.n_members == 3 and rows.gate < rows.partners
