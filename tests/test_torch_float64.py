"""float64 in the port's unfused step against the JAX XLA step with x64
on, on the CPU, on the same random words.

With x64 the JAX pool changes two rules (``demcmc_tpu/rng.py:133-180``):
a float64 uniform takes two words, ``(w_hi >> 6)·2⁻²⁶ + (w_lo >> 5)·
2⁻⁵³``, and every group randint takes two (a 64-bit draw); the port's
``Pool(..., x64=True)`` and ``CountingDraws(..., x64=True)`` model that
step for a float64 configuration.  The JAX pool of iteration ``it`` is
``jax.random.bits(fold_in(step_key(key, it), 0), (G, pool_words))`` and
its scalar side channel ``KeyDraws(fold_in(kit, 1))``'s first two draws
(the migration gate, a float32 uniform in either rule, and N); both are
fed to the port's pool.

Tolerances: θ within 1e-12 + 1e-12·|θ| (XLA on the CPU contracts a·b + c
into fused multiply-adds and torch does not: an ulp or two of the
operands); w within 1e-10 + 1e-12·|w| (the objectives' float64 sums in
XLA's order against torch's, and the Rastrigin's gradient, up to 74,
times θ's ulps); accept flags exactly, away from near-ties (a margin at
or below 1e-9; only the snooker's degenerate draws, which propose θ
itself and tie exactly, come near).  Pool draws: uniforms and randints
bit for bit, normals and Gumbels within 4 float64 ulp.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import demcmc_tpu as jdm
from demcmc_tpu import rng as jrng
from demcmc_tpu.models import rastrigin as jras
from demcmc_tpu.sampler import SamplerState as JState
from demcmc_tpu.sampler import build_step as jbuild_step
from demcmc_tpu.sampler import make_spec as jmake_spec

import demcmc_tpu_torch as tdm
from demcmc_tpu_torch import rng as trng
from demcmc_tpu_torch.models import rastrigin as tras
from demcmc_tpu_torch.ops import accept as taccept

MLE_DATA = np.random.default_rng(3).normal(2.0, 1.5, 100)
TIE = 1e-9


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread per test (many small torch operations)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jnorm_ll(data, mu, sigma):
    return jnp.sum(jax.scipy.stats.norm.logpdf(data, mu, sigma))


def _tnorm_ll(data, mu, sigma):
    """``jax.scipy.stats.norm.logpdf`` summed, in its operation order."""
    x = torch.as_tensor(data, dtype=mu.dtype)
    scale_sqrd = sigma * sigma
    quadratic = (x - mu) * (x - mu) / scale_sqrd
    return torch.sum((torch.log(2.0 * math.pi * scale_sqrd) + quadratic)
                     / -2.0)


def _jsq(data, x):
    d = x - 1.0
    return -0.5 * jnp.sum(d * d / 0.25)


def _tsq(data, x):
    d = x - 1.0
    return -0.5 * torch.sum(d * d / 0.25)


def _models(name, G, Np, **kw):
    """(JAX model, JAX de), (port model, port de), float64: the
    reference's Rastrigin (minimize), its Gaussian MLE (maximize,
    ``tests/test_optimization.py``) or a 2-d Gaussian posterior sampled
    by MH (prior N(0, 1), likelihood N(1, 0.5²), bounds ±5)."""
    if name == "min-rastrigin":
        return (jras.make(n_dim=2, Np=Np, n_groups=G, dtype=jnp.float64,
                          **kw),
                tras.make(n_dim=2, Np=Np, n_groups=G, dtype=np.float64,
                          **kw))
    if name == "max-mle":
        jm = jdm.DEModel(loglike=_jnorm_ll, names=("mu", "sigma"),
                         sample_prior=lambda key: [0.0, 1.0],
                         data=jnp.asarray(MLE_DATA))
        tm = tdm.DEModel(loglike=_tnorm_ll, names=("mu", "sigma"),
                         sample_prior=lambda u, n: [u(1)[0], u(1)[0] + 0.5],
                         data=MLE_DATA)
        kw = dict(bounds=((-np.inf, np.inf), (1e-6, np.inf)), Np=Np,
                  n_groups=G, update_particle="maximize",
                  evaluate_fitness="fun", **kw)
        return ((jm, jdm.DE(dtype=jnp.float64, **kw)),
                (tm, tdm.DE(dtype=np.float64, **kw)))
    jm = jdm.DEModel(loglike=_jsq, prior_loglike=lambda x: -0.5 * jnp.sum(
        x * x), sample_prior=lambda key: [jnp.zeros(2)], names=("x",))
    tm = tdm.DEModel(loglike=_tsq, prior_loglike=lambda x: -0.5 * torch.sum(
        x * x), sample_prior=lambda u, n: [u(2).T], names=("x",))
    kw = dict(bounds=((-5.0, 5.0),), Np=Np, n_groups=G, **kw)
    jkw = dict(kw)
    if "generate_proposal" in kw:
        jkw["generate_proposal"] = getattr(jdm, kw["generate_proposal"])
    return ((jm, jdm.DE(dtype=jnp.float64, **jkw)),
            (tm, tdm.DE(dtype=np.float64, **kw)))


def _population(name, C, seed):
    rng = np.random.default_rng(seed)
    if name == "max-mle":
        theta = np.stack([rng.normal(2.0, 0.4, C), rng.uniform(0.8, 2.5, C)],
                         1)
    else:
        theta = rng.uniform(-4.8, 4.8, (C, 2))
        theta[1] = [5.5, 0.0]               # out of bounds: ∓inf weight
    return theta


def jax_xla_run(jm, jde, theta0, w0, key, it0, n_iter):
    """The JAX XLA step with x64 on over ``n_iter`` iterations: per
    iteration its pool words, its two scalar draws and its output; and
    the final state."""
    G, Np, d = jde.n_groups, jde.Np, theta0.shape[-1]
    with jax.enable_x64(True):
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
        for it in range(it0, it0 + n_iter):
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
        final = (np.asarray(state.theta), np.asarray(state.weight))
    return n_words, pools, scalars, outs, final


def fed_pool(bits, scalars):
    return trng.Pool(torch.from_numpy(bits.astype(np.int64)).to(
        torch.uint32), trng.Scalars(values=scalars), x64=True)


def _close(got, want, rtol, atol, what):
    fin = np.isfinite(want)
    np.testing.assert_array_equal(np.isfinite(got), fin, err_msg=what)
    np.testing.assert_array_equal(got[~fin], want[~fin], err_msg=what)
    np.testing.assert_allclose(got[fin], want[fin], rtol=rtol, atol=atol,
                               err_msg=what)


def _margins(monkeypatch, got):
    """Record each accept decision's margin: ``log max(u, tiny) − Δ`` for
    MH (the uniform it drew), ``|w′ − w|`` for the greedy rules."""
    orig = taccept.make_update

    class Peek:
        def __init__(self, draws):
            self.draws, self.u = draws, None

        def uniform(self, *a, **k):
            self.u = self.draws.uniform(*a, **k)
            return self.u

    def recording(de):
        rule = orig(de)

        def rec(draws, w_cur, w_prop, log_adj):
            if not isinstance(draws, trng.Pool):   # the sizing run
                return rule(draws, w_cur, w_prop, log_adj)
            peek = Peek(draws)
            acc = rule(peek, w_cur, w_prop, log_adj)
            if peek.u is None:
                m = (w_prop - w_cur).abs()
            else:
                m = (torch.log(torch.clamp_min(peek.u, trng.tiny(w_cur.dtype)))
                     - ((w_prop - w_cur) + log_adj)).abs()
            got.append(torch.nan_to_num(m, nan=np.inf, posinf=np.inf))
            return acc
        return rec
    monkeypatch.setattr(taccept, "make_update", recording)


# (case, G, Np, DE settings, key)
CASES = [
    ("min-rastrigin", 4, 10, dict(burnin=2, theta_snooker=0.3), 0),
    ("max-mle", 4, 12, dict(burnin=2), 1),
    ("mh-snooker-kappa", 4, 6, dict(burnin=2, theta_snooker=0.5,
                                     kappa=0.5), 2),
    ("mh-fixed-gamma", 4, 6, dict(burnin=2,
                                   generate_proposal="fixed_gamma"), 3),
]


@pytest.mark.parametrize("name,G,Np,kw,key", CASES, ids=[c[0] for c in CASES])
def test_float64_unfused_step_matches_jax_xla_step(monkeypatch, name, G, Np,
                                                   kw, key):
    """K = 4 iterations of the port's float64 unfused step, fed the JAX
    x64 pool and scalars, against the JAX XLA step with x64 on: the pool
    the same width (two words per float64 uniform and per randint) and
    used to its last column; θ, w and the accept flags after each, in
    float64, across the burn-in boundary with the migration gate drawn."""
    (jm, jde), (model, de) = _models(name, G, Np, **kw)
    C = G * Np
    theta0 = _population(name, C, key)
    spec = tdm.make_spec(model, de)
    w0 = taccept.make_fitness(model, spec, de)(
        torch.tensor(theta0)).numpy()
    n_words, pools, scalars, outs, _ = jax_xla_run(jm, jde, theta0, w0, key,
                                                   1, 4)
    margins = []
    _margins(monkeypatch, margins)
    step = tdm.build_step(model, de, spec, device="cpu")
    assert isinstance(step, tdm.UnfusedStep) and step.x64
    assert step.pool_words == n_words
    th = torch.tensor(theta0).view(G, Np, -1)
    w = torch.tensor(w0).view(G, Np)
    for k in range(4):
        draws = fed_pool(pools[k], scalars[k])
        th, w, acc = step.step_core(draws, th, w, 1 + k, step.fitness)
        assert draws.offset == n_words and th.dtype == torch.float64
        jt, ja, jw = outs[k]
        clear = (margins[k] > TIE).reshape(C).numpy()
        _close(th.reshape(C, -1).numpy(), jt, 1e-12, 1e-12, "theta")
        _close(w.reshape(C).numpy(), jw, 1e-12, 1e-10, "w")
        np.testing.assert_array_equal(acc.reshape(C).numpy()[clear],
                                      ja[clear])
        assert (~clear).sum() <= C // 4
    assert not np.isfinite(w0).all() or name == "max-mle"


def test_float64_pool_matches_jax_x64_pool():
    """The port's float64 pool against the JAX ``Pool`` with x64 on, on
    the same words and in call order: float64 uniforms (two words each)
    and randints (two words each) bit for bit, normals and Gumbels within
    4 ulp, a float32 uniform and a uint32-span draw one word each; the
    columns each rule takes match the JAX ``CountingDraws`` word for
    word."""
    G, W = 6, 96
    f64 = jnp.float64
    with jax.enable_x64(True):
        jp = jrng.Pool(jax.random.PRNGKey(9), G, W)
        bits = np.asarray(jp.bits)
        want = [jp.uniform((G, 3), dtype=f64),
                jp.uniform((G, 2, 1), 0.5, 1.0, f64),
                jp.normal((G, 2, 2), f64), jp.gumbel((G, 3), f64),
                jp.randint((G, 4), 0, 5), jp.uniform((G, 2)),
                jp.randuint((G, 2), jnp.uint32(1000)),
                jp.uniform((2, G), -1e-3, 1e-3, f64)]
        want = [np.asarray(x) for x in want]
        jc = jrng.CountingDraws(G)
        counts = []
        for draw in (lambda: jc.uniform((G, 3), dtype=f64),
                     lambda: jc.normal((G, 2, 2), f64),
                     lambda: jc.gumbel((G, 3), f64),
                     lambda: jc.randint((G, 4), 0, 5),
                     lambda: jc.uniform((G, 2)),
                     lambda: jc.randuint((G, 2), 1000)):
            draw()
            counts.append(jc.words)
    tp = fed_pool(bits, [])
    t64 = torch.float64
    got = [tp.uniform((G, 3), dtype=t64),
           tp.uniform((G, 2, 1), 0.5, 1.0, t64), tp.normal((G, 2, 2), t64),
           tp.gumbel((G, 3), t64), tp.randint((G, 4), 0, 5),
           tp.uniform((G, 2)), tp.randuint((G, 2), 1000),
           tp.uniform((2, G), -1e-3, 1e-3, t64)]
    assert tp.offset == jp.offset
    for i, (a, b) in enumerate(zip(got, want)):
        assert a.shape == b.shape
        if i in (2, 3):
            np.testing.assert_allclose(a.numpy(), b, rtol=9e-16,
                                       atol=9e-16)
        else:
            np.testing.assert_array_equal(a.numpy(), b)
            assert a.dtype == (torch.float64 if b.dtype == np.float64
                               else a.dtype)
    tc = trng.CountingDraws(G, x64=True)
    mine = []
    for draw in (lambda: tc.uniform((G, 3), dtype=t64),
                 lambda: tc.normal((G, 2, 2), t64),
                 lambda: tc.gumbel((G, 3), t64),
                 lambda: tc.randint((G, 4), 0, 5),
                 lambda: tc.uniform((G, 2)),
                 lambda: tc.randuint((G, 2), 1000)):
        draw()
        mine.append(tc.words)
    assert mine == counts
    # the scalar side channel's float64 uniform takes two words, the rule's
    sc = trng.Scalars(words=[int(bits[0, 0]), int(bits[0, 1]), 5])
    hi, lo = (torch.tensor([int(x)]) for x in bits[0, :2])
    assert sc.uniform(dtype=t64) == float(trng._uniform53(hi, lo)[0])
    assert sc.i == 2 and sc.randint((), 2, 5) == 2 + 5 % 3
    # float32 configurations keep one word per uniform and per randint
    t32 = trng.CountingDraws(G)
    t32.uniform((G, 3)), t32.randint((G, 4), 0, 5)
    assert t32.words == 3 + 4


def test_float64_state_carries_over_and_optimizes_as_jax(monkeypatch):
    """The slice as a whole in float64: a JAX float64 state carries over
    through ``state_from_numpy`` as float64 (it was cast to float32), the
    port's ``run_scan(..., collect=False)`` runs 12 iterations of the
    unfused step on it, fed the JAX words, and returns no trajectory;
    the final population and its optimum (``Population``,
    ``get_optimal``) agree with the JAX XLA step's."""
    G, Np, key, n = 4, 10, 5, 12
    (jm, jde), (model, de) = _models("min-rastrigin", G, Np, burnin=6)
    C = G * Np
    theta0 = _population("min-rastrigin", C, key)
    spec = tdm.make_spec(model, de)
    w0 = taccept.make_fitness(model, spec, de)(torch.tensor(theta0)).numpy()
    _, pools, scalars, _, (jt, jw) = jax_xla_run(jm, jde, theta0, w0, key, 1,
                                                 n)
    assert jt.dtype == theta0.dtype == np.float64
    state = tdm.state_from_numpy(theta0.reshape(G, Np, 2), w0, 1, None,
                                 "flat", device="cpu")
    assert state.theta.dtype == state.weight.dtype == torch.float64
    assert np.array_equal(state.theta.numpy(), theta0)
    monkeypatch.setattr(tdm.UnfusedStep, "draws",
                        lambda self, key_, it: fed_pool(pools[it - 1],
                                                        scalars[it - 1]))
    step = tdm.build_step(model, de, spec, device="cpu")
    end, ys = tdm.run_scan(step, state, n, collect=False)
    assert ys is None and end.iteration == n + 1
    _close(end.theta.numpy(), jt.reshape(C, 2), 1e-12, 1e-12, "theta")
    _close(end.weight.numpy(), jw.reshape(C), 1e-12, 1e-10, "w")
    pop = tdm.Population(theta=end.theta.numpy(), weight=end.weight.numpy(),
                         spec=spec)
    best, val = tdm.get_optimal(de, model, pop)
    i = int(np.argmin(jw.reshape(C)))
    np.testing.assert_allclose(best["x"], jt.reshape(C, 2)[i], rtol=1e-12)
    assert val == pytest.approx(float(jw.reshape(C)[i]), abs=1e-10)
