"""The port's unfused step against the JAX package's XLA step
(``build_step(..., allow_fused=False)``) on the CPU, on the same random
words: the JAX pool of iteration ``it`` is ``jax.random.bits(fold_in(
step_key(key, it), 0), (G, pool_words))`` and its scalar side channel
``KeyDraws(fold_in(kit, 1))``'s first two draws (the migration gate and N);
both are fed to the port's :class:`~demcmc_tpu_torch.rng.Pool`.  The JAX
step runs with x64 off (the harness turns it on), where a randint takes
one word as in the port.

Tolerances: θ within 1e-6 + 1e-6·|θ| (a few float32 ulp of the operands:
XLA on the CPU contracts a·b + c into one fused multiply-add, which torch
does not, and its exp, log and cos differ from torch's by an ulp; the
snooker step's r₁ − r₂ cancels, so its error is an ulp of the operands,
not of θ); w within 1e-5 + 1e-5·|w|
(the JAX step scores each cell with the model's per-cell loglike, the
port's Gaussian with its batched sufficient-statistic form); the discrete
binomial's w within 2e-3 absolute (jax ``gammaln`` per observation against
the port's ``lgamma32`` over the folded counts, as in
``test_torch_zoo_kernel.py``); accept flags exactly, away from near-ties
(none at these seeds).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import demcmc_tpu as jdm
from demcmc_tpu import rng as jrng
from demcmc_tpu.models import discrete_binomial as jdisc
from demcmc_tpu.models import gaussian as jgauss
from demcmc_tpu.sampler import SamplerState as JState
from demcmc_tpu.sampler import build_step as jbuild_step
from demcmc_tpu.sampler import make_spec as jmake_spec

import demcmc_tpu_torch as tdm
from demcmc_tpu_torch import rng as trng
from demcmc_tpu_torch.models import discrete_binomial as tdisc
from demcmc_tpu_torch.models import gaussian as tgauss
from demcmc_tpu_torch.ops import accept as taccept

DATA = np.random.default_rng(0).standard_normal(50).astype(np.float32)
THETA_TOL = 1e-6


@pytest.fixture(autouse=True)
def one_torch_thread():
    """The port's CPU path runs many small torch operations, which thread
    pools only slow down (most where the test runner's other workers hold
    the cores); one intra-op thread per test, restored after it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _gauss(G, Np, **kw):
    """The JAX and port Gaussians; a ``generate_proposal`` named by string
    (as the port takes it) is the JAX package's function of that name."""
    kw = dict(Np=Np, n_groups=G, **kw)
    jkw = dict(kw)
    if "generate_proposal" in kw:
        jkw["generate_proposal"] = getattr(jdm, kw["generate_proposal"])
    return jgauss.make(data=DATA, **jkw), tgauss.make(data=DATA, **kw)


def _disc(G, Np, **kw):
    kw = dict(key=0, n_obs=50, dtype=np.float32, Np=Np, n_groups=G, **kw)
    return jdisc.make(**kw), tdisc.make(**kw)


def _theta0(name, C, rng):
    if name == "discrete":
        return np.stack([rng.integers(10, 31, C), rng.uniform(0.2, 0.8, C)],
                        1).astype(np.float32)
    return np.stack([rng.normal(0.1, 0.3, C), rng.uniform(0.6, 1.5, C)],
                    1).astype(np.float32)


def jax_run(jm, jde, theta0, w0, key, it0, K):
    """The JAX XLA step over K iterations from ``it0``: per iteration its
    pool words, its two scalar draws and its output (θ, accept, lp)."""
    G, Np, d = jde.n_groups, jde.Np, theta0.shape[-1]
    with jax.enable_x64(False):
        step = jbuild_step(jm, jde, jmake_spec(jm, jde), allow_fused=False)
        free = dict(zip(step.__code__.co_freevars,
                        (c.cell_contents for c in step.__closure__)))
        n_words = free["pool_words"]
        base = jax.random.PRNGKey(key)
        state = JState(theta=jnp.asarray(theta0.reshape(G, Np, d)),
                       weight=jnp.asarray(w0.reshape(G, Np)), key=base,
                       iteration=jnp.int32(it0), history=None)
        jstep = jax.jit(step)
        pools, scalars, outs = [], [], []
        for it in range(it0, it0 + K):
            kit = jrng.step_key(base, it)
            pools.append(np.asarray(jax.random.bits(
                jax.random.fold_in(kit, 0), (G, n_words), jnp.uint32)))
            sk = jax.random.fold_in(kit, 1)
            scalars.append(
                (float(jax.random.uniform(jax.random.fold_in(sk, 1), (),
                                          jnp.float32)),
                 int(jax.random.randint(jax.random.fold_in(sk, 2), (), 2,
                                        G + 1, jnp.int32))))
            state, out = jstep(state)
            outs.append(tuple(np.asarray(o) for o in out))
    return n_words, pools, scalars, outs


def fed_pool(bits, scalars):
    return trng.Pool(torch.from_numpy(bits.astype(np.int64)).to(
        torch.uint32), trng.Scalars(values=scalars))


@pytest.fixture()
def margins(monkeypatch):
    """Each MH decision's margin log max(u, tiny) − Δ, recorded."""
    got = []
    orig = taccept.mh_update

    def rec(draws, w_cur, w_prop, log_adj):
        if not isinstance(draws, trng.Pool):       # the pool's sizing run
            return orig(draws, w_cur, w_prop, log_adj)
        off = draws.offset
        acc = orig(draws, w_cur, w_prop, log_adj)
        u = trng._uniform24(draws.bits[:, off:draws.offset])
        lu = torch.log(torch.clamp_min(u.reshape(w_cur.shape), trng.TINY))
        got.append(lu - ((w_prop - w_cur) + log_adj))
        return acc

    monkeypatch.setattr(taccept, "mh_update", rec)
    return got


def _check(th, w, acc, out, w_tol, theta_tol=THETA_TOL):
    jt, ja, jw = out
    np.testing.assert_allclose(th, jt, rtol=theta_tol, atol=theta_tol)
    fin = np.isfinite(jw)
    np.testing.assert_array_equal(np.isfinite(w), fin)
    np.testing.assert_allclose(w[fin], jw[fin], rtol=w_tol[0],
                               atol=w_tol[1])
    np.testing.assert_array_equal(acc, ja)


# (case, model maker, G, Np, DE settings, base key, first iteration,
#  iterations, w tolerance (rtol, atol), near-tie margin)
CASES = [
    ("burn-in", _gauss, 8, 6, dict(burnin=2, alpha=0.0), 3, 1, 4,
     (1e-5, 1e-5), 1e-3),
    ("gate", _gauss, 8, 6, dict(burnin=2, alpha=0.1), 11, 1, 4,
     (1e-5, 1e-5), 1e-3),
    ("snooker", _gauss, 8, 6, dict(burnin=2, theta_snooker=0.5), 5, 1, 4,
     (1e-5, 1e-5), 1e-3),
    ("sequential", _gauss, 8, 4, dict(burnin=2), 7, 1, 4,
     (1e-5, 1e-5), 1e-3),
    ("fixed-gamma", _gauss, 8, 6,
     dict(burnin=2, generate_proposal="fixed_gamma"), 13, 1, 4,
     (1e-5, 1e-5), 1e-3),
    ("variable-gamma", _gauss, 8, 6,
     dict(burnin=2, generate_proposal="variable_gamma"), 17, 1, 4,
     (1e-5, 1e-5), 1e-3),
    ("recombination", _gauss, 8, 6, dict(burnin=2, kappa=0.5), 19, 1, 4,
     (1e-5, 1e-5), 1e-3),
    ("integer-snap", _disc, 8, 6, dict(burnin=2), 2, 1, 4,
     (0.0, 2e-3), 1e-2),
]


@pytest.mark.parametrize("name,maker,G,Np,kw,key,it0,K,w_tol,tie", CASES,
                         ids=[c[0] for c in CASES])
def test_unfused_step_matches_jax_xla_step(margins, name, maker, G, Np, kw,
                                           key, it0, K, w_tol, tie):
    """K iterations of the port's step core, fed the JAX pool and scalars,
    against the JAX XLA step: θ, w and the accept flags after each; the
    port's pool is as wide as the JAX one and used to its last column."""
    (jm, jde), (model, de) = maker(G, Np, **kw)
    C = G * Np
    theta0 = _theta0("discrete" if maker is _disc else name, C,
                     np.random.default_rng(key))
    spec = tdm.make_spec(model, de)
    w0 = taccept.compute_posterior(model, spec, de,
                                   torch.tensor(theta0)).numpy()
    n_words, pools, scalars, outs = jax_run(jm, jde, theta0, w0, key, it0, K)
    step = tdm.build_step(model, de, spec, device="cpu", allow_fused=False)
    assert isinstance(step, tdm.UnfusedStep)
    assert step.pool_words == n_words
    th = torch.tensor(theta0).view(G, Np, -1)
    w = torch.tensor(w0).view(G, Np)
    gates = []
    for k in range(K):
        draws = fed_pool(pools[k], scalars[k])
        th, w, acc = step.step_core(draws, th, w, it0 + k, step.fitness)
        assert draws.offset == n_words
        gates.append(scalars[k][0] <= np.float32(de.alpha))
        _check(th.reshape(C, -1).numpy(), w.reshape(C).numpy(),
               acc.reshape(C).numpy(), outs[k], w_tol)
        if spec.has_int:
            assert torch.equal(th[..., 0], torch.round(th[..., 0]))
    assert all((m.abs() > tie).all() for m in margins), "near-tie"
    assert it0 <= de.burnin < it0 + K - 1          # both sides of burn-in
    if name == "gate":
        assert set(gates) == {True, False}         # gate open and closed


def test_unfused_sample_matches_jax_trajectory(monkeypatch):
    """The slice as a whole: the port's ``sample(..., allow_fused=False)``
    from the JAX initial state, its step fed the JAX words, over 20
    iterations (burn-in 10, α = 0.1, θs = 0.1) against the JAX XLA step's
    trajectory: every stored θ within 1e-5 + 1e-5·|θ| (the single step's
    ulps, carried forward through 20 iterations of partner differences),
    lp and accept flags as in the single-step test."""
    G, Np, K, key = 8, 6, 20, 4
    kw = dict(burnin=10, alpha=0.1, theta_snooker=0.1, discard_burnin=False)
    (jm, jde), (model, de) = _gauss(G, Np, **kw)
    C = G * Np
    theta0 = _theta0("gauss", C, np.random.default_rng(key))
    spec = tdm.make_spec(model, de)
    w0 = taccept.compute_posterior(model, spec, de,
                                   torch.tensor(theta0)).numpy()
    n_words, pools, scalars, outs = jax_run(jm, jde, theta0, w0, key, 1, K)
    monkeypatch.setattr(tdm.UnfusedStep, "draws",
                        lambda self, key_, it: fed_pool(pools[it - 1],
                                                        scalars[it - 1]))
    state = tdm.state_from_numpy(theta0.reshape(G, Np, 2), w0, 1, None,
                                 "flat", device="cpu")
    chains, end = tdm.sample(model, de, K, state=state, device="cpu",
                             allow_fused=False, return_state=True)
    assert end.iteration == K + 1
    for k in range(K):
        _check(chains.data[k].T, chains.lp[k], chains.acceptance[k],
               outs[k], (1e-5, 1e-5), theta_tol=1e-5)
    assert any(u <= np.float32(0.1) for u, _ in scalars)


def test_pool_maps_match_jax_pool():
    """The port's Pool against the JAX ``Pool`` on the same words (x64
    off): uniform, shifted uniform, normal, gumbel and randint draws of
    group-shaped requests, in call order, within 2 float32 ulp of values
    of order 1 (a gumbel near 0 is the log of a value near 1); the
    columns taken match the JAX ``CountingDraws``."""
    G, W = 6, 64
    with jax.enable_x64(False):
        key = jax.random.PRNGKey(9)
        jp = jrng.Pool(key, G, W)
        bits = np.asarray(jp.bits)
        want = [jp.uniform((G, 3)), jp.uniform((G, 2, 1), 0.5, 1.0),
                jp.normal((G, 4, 2)), jp.gumbel((G, 5)),
                jp.randint((G, 4), 0, 5), jp.uniform((2, G), -1e-3, 1e-3)]
        want = [np.asarray(x) for x in want]
        jc = jrng.CountingDraws(G)
        jc.uniform((G, 3)); jc.normal((G, 4, 2)); jc.randint((G, 4), 0, 5)
    tp = fed_pool(bits, [])
    got = [tp.uniform((G, 3)), tp.uniform((G, 2, 1), 0.5, 1.0),
           tp.normal((G, 4, 2)), tp.gumbel((G, 5)),
           tp.randint((G, 4), 0, 5), tp.uniform((2, G), -1e-3, 1e-3)]
    assert tp.offset == jp.offset
    for a, b in zip(got, want):
        assert a.shape == b.shape
        np.testing.assert_allclose(a.numpy(), b, rtol=2.4e-7, atol=2.4e-7)
    tc = trng.CountingDraws(G)
    tc.uniform((G, 3)), tc.normal((G, 4, 2)), tc.randint((G, 4), 0, 5)
    assert tc.words == jc.words


@pytest.mark.parametrize("cell", ["gaussian", "hierarchical"])
def test_unfused_sample_same_bits_under_inference_mode(cell):
    """``chip_smoke.py`` runs its unfused cells under
    ``torch.inference_mode()``: the draws are the plain call's bits."""
    from demcmc_tpu_torch.models import hierarchical as thier
    if cell == "gaussian":
        model, de = tgauss.make(Np=6, n_groups=4, burnin=10)
    else:
        model, de = thier.make(n_subj=4, n_data=10, key=0, burnin=10)
    a = tdm.sample(model, de, 40, key=3, device="cpu", allow_fused=False)
    with torch.inference_mode():
        b = tdm.sample(model, de, 40, key=3, device="cpu",
                       allow_fused=False)
    for x, y in ((a.data, b.data), (a.acceptance, b.acceptance),
                 (a.lp, b.lp)):
        np.testing.assert_array_equal(x, y)
