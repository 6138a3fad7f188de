"""The optimization accepts of the port against the JAX package, on the
CPU, on the same random words: the plain version of K1 with the greedy
max/min accept (``ops/fused_step.py::sweep_plain``, ``cfg.mode``) against
the JAX whole-iteration Pallas kernel in interpret mode, and the unfused
step with ``maximize``/``minimize`` against the JAX XLA step (x64 off,
float32); then K2's plain exchange with the +inf weights of min mode
against the JAX XLA migration.

Kernel cases run at G = 32 × Np = 16, a layout ``fused_step.supported``
accepts, K = 4 iterations from it = 1 with the migration gate set and
burn-in 2 (so the run migrates first and crosses the burn-in boundary),
the population reaching out of bounds (the objective scores ∓inf there)
and, in min mode, a group holding +inf weights in burn-in (the kernel
clamps them in the γ₂ base select).  The JAX kernel's within-group
gathers are replaced by its own linear-select gather, as in
``test_torch_fused_step.py`` (ROADMAP.md, C).

Tolerances: θ within 1e-5 + 1e-5·|θ|, about 20 float32 ulp of the
operands (|θ| ≤ 5.5; XLA on the CPU contracts a·b + c into fused
multiply-adds, torch does not, and the snooker step's r₁ − r₂ cancels, so
its error is an ulp of the operands, not of θ; 5 ulp seen); w within
1e-5·|w| plus 1e-5 for the Gaussian (a few float32 ulp: XLA's log against
torch's) and 5e-4 for the Rastrigin (its gradient, up to 2|x| + 20π ≈ 74,
times θ's few-ulp differences; 2.5e-4 seen), equal infinities; accept
flags exactly, away from near-ties (|w′ − w| at or below the stated tie:
a greedy accept of w′ = w is a tie, which the snooker's degenerate draws,
proposing θ itself, make; at most 5% of the decisions here).  The unfused
step against the XLA step: θ within 1e-6 + 1e-6·|θ|, w as in
``test_torch_unfused_step.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import demcmc_tpu as jdm
from demcmc_tpu import rng as jrng
from demcmc_tpu.models import gaussian as jgauss
from demcmc_tpu.models import rastrigin as jras
from demcmc_tpu.ops import fused_step as jfused
from demcmc_tpu.ops import migration as jmig
from demcmc_tpu.sampler import SamplerState as JState
from demcmc_tpu.sampler import build_step as jbuild_step
from demcmc_tpu.sampler import make_spec as jmake_spec

import demcmc_tpu_torch as tdm
from demcmc_tpu_torch import rng as trng
from demcmc_tpu_torch.models import gaussian as tgauss
from demcmc_tpu_torch.models import rastrigin as tras
from demcmc_tpu_torch.ops import accept as taccept
from demcmc_tpu_torch.ops import fused_step as tfused
from demcmc_tpu_torch.ops import migration as tmig
from demcmc_tpu_torch.ops import proposals as tprop

DATA = np.asarray(np.random.default_rng(3).normal(0.3, 1.2, 50), np.float32)
G, NP, K, BURNIN = 32, 16, 4, 2


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread per test (many small torch operations)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _models(name, Np, n_groups, **kw):
    """(JAX model, JAX de), (port model, port de) of a greedy case:
    ``'min-rastrigin'`` (float32, minimize) or ``'max-gaussian'``
    (maximize, the bench Gaussian's objective)."""
    if name == "min-rastrigin":
        return (jras.make(n_dim=2, Np=Np, n_groups=n_groups,
                          dtype=jnp.float32, **kw),
                tras.make(n_dim=2, Np=Np, n_groups=n_groups,
                          dtype=np.float32, **kw))
    kw = dict(Np=Np, n_groups=n_groups, update_particle="maximize",
              evaluate_fitness="fun", **kw)
    return jgauss.make(data=DATA, **kw), tgauss.make(data=DATA, **kw)


def _population(name, C, seed):
    """θ reaching past the bounds, and (Rastrigin) group 3's first four
    chains out of bounds, so they hold +inf weights in min mode."""
    rng = np.random.default_rng(seed)
    if name == "min-rastrigin":
        theta = rng.uniform(-5.3, 5.3, (C, 2))
        theta[3 * NP:3 * NP + 4] = [5.5, -0.25]
    else:
        theta = np.stack([rng.normal(DATA.mean(), 0.3, C),
                          rng.normal(DATA.std(), 0.4, C)], 1)
    return theta.astype(np.float32)


def _bits(key2, it, n_words, C):
    """The words the interpret-mode kernel_call feeds iteration ``it``."""
    key = jax.random.wrap_key_data(jnp.asarray(key2), impl="threefry2x32")
    b = np.asarray(jax.random.bits(jax.random.fold_in(key, it),
                                   (n_words, C), jnp.uint32))
    return torch.from_numpy(b.astype(np.int64)).to(torch.uint32)


# (case, θ snooker, seed); the JAX kernels are built once per module
KERNEL_CASES = [("min-rastrigin", 0.5, 0), ("max-gaussian", 0.0, 1)]


@pytest.fixture(scope="module")
def jax_kernel_runs():
    """Per kernel case: the JAX kernel's K iterations (θ, w, accept
    flags, exported gate) from the case's population, its port twins
    and the inputs, with the JAX gathers patched as in the module
    docstring and x64 off (the harness turns it on)."""
    def one(x, idx, p, Np):
        return jfused._seg_gather(jfused._roll_dict(x, p, Np), idx, p, Np)

    def multi(x, idxs, p, Np):
        rolls = jfused._roll_dict(x, p, Np)
        return [jfused._seg_gather(rolls, i, p, Np) for i in idxs]

    runs = {}
    with pytest.MonkeyPatch.context() as mp, jax.enable_x64(False):
        mp.setattr(jfused, "_seg_gather_bin", one)
        mp.setattr(jfused, "_seg_gather_bin_multi", multi)
        mp.setenv("DEMCMC_FUSED", "interpret")     # supported() on the CPU
        for name, theta_sn, seed in KERNEL_CASES:
            (jm, jde), (model, de) = _models(name, NP, G, burnin=BURNIN,
                                             theta_snooker=theta_sn)
            C, d = G * NP, 2
            R, Cf = 8, C // 8
            jspec = jmake_spec(jm, jde)
            assert jfused.supported(jm, jde, jspec)
            kern = jfused.build_fused_step(jm, jde, jspec, interpret=True,
                                           K=K, mig_in_kernel=True)
            spec = tdm.make_spec(model, de)
            theta = _population(name, C, seed)
            w = taccept.evaluate_fun(model, spec, de,
                                     torch.tensor(theta)).numpy()
            key2 = np.array([0x5EED + seed, 0xC0DE], np.uint32)
            out = jax.jit(kern)(
                jnp.asarray(theta.T.reshape(d, R, Cf)),
                jnp.asarray(w.reshape(R, Cf)), jnp.asarray(key2),
                jnp.int32(1), jnp.ones((1, 1), jnp.int32))
            runs[name] = dict(model=model, de=de, spec=spec, theta=theta,
                              w=w, key2=key2, n_words=kern.n_words,
                              out=tuple(np.asarray(o) for o in out))
    return runs


def _close(got, want, rtol, atol, what):
    fin = np.isfinite(want)
    np.testing.assert_array_equal(np.isfinite(got), fin, err_msg=what)
    np.testing.assert_array_equal(got[~fin], want[~fin], err_msg=what)
    np.testing.assert_allclose(got[fin], want[fin], rtol=rtol, atol=atol,
                               err_msg=what)


@pytest.mark.parametrize("name,tie,w_atol", [("min-rastrigin", 1e-4, 5e-4),
                                             ("max-gaussian", 1e-3, 1e-5)])
def test_greedy_plain_step_matches_jax_kernel(jax_kernel_runs, name, tie,
                                              w_atol):
    """K1's plain version in the case's greedy mode (K2's plain exchange
    first, as the gate is set) against the JAX kernel, iteration by
    iteration: θ, w and accept flags as in the module docstring, the
    exported gate exactly; out-of-bounds proposals scored ∓inf occur."""
    r = jax_kernel_runs[name]
    model, de, spec = r["model"], r["de"], r["spec"]
    C, d = G * NP, 2
    jt, jw, jacc, jfire = r["out"]
    cfg = tfused.StepConfig.make(model, de, spec)
    assert cfg.mode == name[:3] and cfg.rows.n_words == r["n_words"]
    th, ww = torch.tensor(r["theta"]), torch.tensor(r["w"])
    fire = torch.ones(1, dtype=torch.int32)
    bad = np.inf if cfg.mode == "min" else -np.inf
    assert (r["w"] == bad).any()                  # ∓inf weights at the start
    n_bad = n_ties = 0
    for k in range(K):
        words = _bits(r["key2"], 1 + k, r["n_words"], C)
        tmig.migrate_plain(th, ww, fire, words, G, NP)
        out = (torch.empty(C, d), torch.empty(C),
               torch.empty(C, dtype=torch.bool))
        margin = tfused.de_step_plain(cfg, model, spec, th, ww, fire, 1 + k,
                                      words, out=out)
        clear = (margin.abs() > tie).numpy()
        n_ties += int((~clear).sum())
        _close(th.numpy(), jt[k].reshape(d, C).T, 1e-5, 1e-5, "theta")
        _close(ww.numpy(), jw[k].reshape(C), 1e-5, w_atol, "w")
        np.testing.assert_array_equal(out[2].numpy()[clear],
                                      jacc[k].reshape(C)[clear])
        np.testing.assert_array_equal((margin < 0).numpy(), out[2].numpy())
        n_bad += int(torch.isinf(margin).sum())   # ∓inf proposals, rejected
    assert int(fire[0]) == int(jfire.reshape(-1)[0])
    assert n_bad > 0
    # ties: a degenerate snooker draw proposes θ itself, so w′ = w up to the
    # ulp by which XLA's objective differs from torch's; θ agrees either way
    assert n_ties <= K * C // 20


def test_min_mode_clamp_changes_the_base_select():
    """Why the min mode clamps (``fused_step.py:2289-2293``): with +inf
    weights in a group the unclamped softmax CDF is inf from the first of
    them on, so the base select always lands on that one; the clamped CDF
    spreads the mass over every +inf member.  The JAX kernel clamps, the
    JAX XLA step does not, and each port path copies its twin."""
    w = torch.tensor([[1.0, 5.0, float("inf"), 2.0, float("inf"), 0.5]])
    u = torch.linspace(0.01, 0.99, 6)[None]
    assert (tprop.select_base(w, u) == 2).all()
    clamped = tprop.select_base(w, u, clamp=True)
    assert set(clamped.flatten().tolist()) == {2, 4}
    finite = w.nan_to_num(posinf=30.0)
    assert torch.equal(tprop.select_base(finite, u, clamp=True),
                       tprop.select_base(finite, u))


# ------------------------------------------ the unfused step, x64 off

def jax_xla_run(jm, jde, theta0, w0, key, it0, n_iter):
    """The JAX XLA step over ``n_iter`` iterations with x64 off: per
    iteration its pool words, its two scalar draws and its output."""
    G_, Np_, d = jde.n_groups, jde.Np, theta0.shape[-1]
    with jax.enable_x64(False):
        step = jbuild_step(jm, jde, jmake_spec(jm, jde), allow_fused=False)
        free = dict(zip(step.__code__.co_freevars,
                        (c.cell_contents for c in step.__closure__)))
        n_words = free["pool_words"]
        base = jax.random.PRNGKey(key)
        state = JState(theta=jnp.asarray(theta0.reshape(G_, Np_, d)),
                       weight=jnp.asarray(w0.reshape(G_, Np_)), key=base,
                       iteration=jnp.int32(it0), history=None)
        jstep = jax.jit(step)
        pools, scalars, outs = [], [], []
        for it in range(it0, it0 + n_iter):
            kit = jrng.step_key(base, it)
            pools.append(np.asarray(jax.random.bits(
                jax.random.fold_in(kit, 0), (G_, n_words), jnp.uint32)))
            sk = jax.random.fold_in(kit, 1)
            scalars.append(
                (float(jax.random.uniform(jax.random.fold_in(sk, 1), (),
                                          jnp.float32)),
                 int(jax.random.randint(jax.random.fold_in(sk, 2), (), 2,
                                        G_ + 1, jnp.int32))))
            state, out = jstep(state)
            outs.append(tuple(np.asarray(o) for o in out))
    return n_words, pools, scalars, outs


def fed_pool(bits, scalars, x64=False):
    return trng.Pool(torch.from_numpy(bits.astype(np.int64)).to(
        torch.uint32), trng.Scalars(values=scalars), x64)


UNFUSED_CASES = [
    ("max-gaussian", 8, 6, dict(burnin=2, alpha=0.1), 11, (1e-5, 1e-5),
     5e-3),
    ("min-rastrigin", 8, 6, dict(burnin=2, alpha=0.1, theta_snooker=0.5),
     5, (1e-5, 1e-5), 1e-3),
]


@pytest.mark.parametrize("name,G_,Np_,kw,key,w_tol,tie", UNFUSED_CASES,
                         ids=[c[0] for c in UNFUSED_CASES])
def test_greedy_unfused_step_matches_jax_xla_step(monkeypatch, name, G_,
                                                  Np_, kw, key, w_tol, tie):
    """K = 4 iterations of the port's unfused step with the greedy update
    (which draws nothing: the pool is the XLA step's width), fed the JAX
    pool and scalars, against the JAX XLA step: θ, w and the accept flags
    after each, the flags away from near-ties (|w′ − w| at or below the
    case's tie, a few times the per-cell against batched w differences; at
    most 10% of the decisions: with θs = 0.5 and Np = 6 about 8% are the
    snooker's degenerate draws, which propose θ itself).  In min mode a
    group starts with a +inf weight in burn-in (the XLA step does not
    clamp, so neither does the unfused step)."""
    (jm, jde), (model, de) = _models(name, Np_, G_, **kw)
    C = G_ * Np_
    theta0 = _population(name, C, key)[:C]
    if name == "min-rastrigin":
        theta0[Np_] = [5.5, 0.0]                   # group 1: a +inf weight
    spec = tdm.make_spec(model, de)
    w0 = taccept.evaluate_fun(model, spec, de, torch.tensor(theta0)).numpy()
    n_words, pools, scalars, outs = jax_xla_run(jm, jde, theta0, w0, key, 1,
                                                4)
    gaps = []
    orig = taccept.make_update

    def recording(de_):
        rule = orig(de_)

        def rec(draws, w_cur, w_prop, log_adj):
            if isinstance(draws, trng.Pool):      # not the sizing run
                gaps.append(torch.nan_to_num((w_prop - w_cur).abs(),
                                             nan=np.inf, posinf=np.inf))
            return rule(draws, w_cur, w_prop, log_adj)
        return rec
    monkeypatch.setattr(taccept, "make_update", recording)
    step = tdm.build_step(model, de, spec, device="cpu", allow_fused=False)
    assert isinstance(step, tdm.UnfusedStep) and step.pool_words == n_words
    th = torch.tensor(theta0).view(G_, Np_, -1)
    w = torch.tensor(w0).view(G_, Np_)
    n_ties = 0
    for k in range(4):
        draws = fed_pool(pools[k], scalars[k])
        th, w, acc = step.step_core(draws, th, w, 1 + k, step.fitness)
        assert draws.offset == n_words and len(gaps) == k + 1
        jt, ja, jw = outs[k]
        clear = (gaps[k] > tie).reshape(C).numpy()
        n_ties += int((~clear).sum())
        _close(th.reshape(C, -1).numpy(), jt, 1e-6, 1e-6, "theta")
        _close(w.reshape(C).numpy(), jw, w_tol[0], w_tol[1], "w")
        np.testing.assert_array_equal(acc.reshape(C).numpy()[clear],
                                      ja[clear])
    assert n_ties <= 4 * C // 10      # θs/Np of them degenerate snooker draws
    if name == "min-rastrigin":
        assert np.isinf(w0).any() and (w0 == np.inf).any()


def test_min_mode_migration_matches_jax_xla_migration():
    """K2's plain exchange with min mode's +inf weights (and -0.0, ties
    between rank keys) against the JAX XLA step's migration
    (``demcmc_tpu/ops/migration.py``: victim ``argmax(gum − w)``, so a
    +inf weight is never the victim unless its whole group is), fed the
    same rank keys, N and Gumbels: θ and w bit for bit."""
    G_, Np_, d = 16, 6, 2
    rng = np.random.default_rng(17)
    C = G_ * Np_
    theta = rng.standard_normal((C, d)).astype(np.float32)
    theta[rng.random((C, d)) < 0.05] = -0.0
    w = (rng.random(C) * 40).astype(np.float32)
    w[rng.random(C) < 0.2] = np.inf
    w[:Np_] = np.inf                                # a group of +inf
    words = torch.from_numpy(rng.integers(0, 2 ** 32, (3, C)).astype(
        np.int64)).to(torch.uint32)
    u_key, n_active, gum = tmig.draws(words, G_, Np_)

    class Fed:
        def randint(self, shape, lo, hi):
            return jnp.int32(int(n_active))

        def uniform(self, shape=(), lo=0.0, hi=1.0, dtype=jnp.float32):
            return jnp.asarray(u_key.numpy())

        def gumbel(self, shape=(), dtype=jnp.float32):
            return jnp.asarray(gum.numpy())

    with jax.enable_x64(False):
        jt, jw = jmig.migrate(Fed(), jnp.asarray(theta.reshape(G_, Np_, d)),
                              jnp.asarray(w.reshape(G_, Np_)), G_)
    th, ww = torch.tensor(theta), torch.tensor(w)
    tmig.migrate_plain(th, ww, torch.ones(1, dtype=torch.int32), words, G_,
                       Np_)
    np.testing.assert_array_equal(th.numpy().view(np.uint32),
                                  np.asarray(jt).reshape(C, d).view(
                                      np.uint32))
    np.testing.assert_array_equal(ww.numpy(), np.asarray(jw).reshape(C))
    assert int(n_active) >= 2 and (ww.numpy() != w).any()
