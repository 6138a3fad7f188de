"""The port's K-iteration windows (``demcmc_tpu_torch.ops.fused_step``,
``ops/resample_step.py``, ``sampler.plan_windows`` / ``run_scan``) on the
CPU, where the wrappers run their plain versions.

(a) Bits-in against the JAX kernel: ``build_fused_step(..., K=4,
    interpret=True, mig_in_kernel=True)`` with ``emit='last'``,
    ``('stride', 2)`` and ``phase='post'``, held against the port's
    planned windows (K2's plain exchange where a gate opens, then the
    K-window plain version) fed the same ``[K·n_words, C]`` words.  The
    JAX kernel's within-group gather is replaced, in this process, by the
    JAX package's own linear-select gather, as in
    ``test_torch_fused_step.py`` (ROADMAP.md, C).
(b) ``rng.gates`` against the gates the plain step writes.
(c) ``run_scan``'s windows against the one-launch-per-iteration loop
    (``run_loop``), bit for bit.
(d) The plain calls a run makes follow the plan.
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
from demcmc_tpu_torch import rng as trng
from demcmc_tpu_torch import sampler as tsampler
from demcmc_tpu_torch.models import gaussian as tgauss
from demcmc_tpu_torch.models import mvnormal as tmvn
from demcmc_tpu_torch.ops import fused_step as tfused
from demcmc_tpu_torch.ops import migration as tmig
from demcmc_tpu_torch.ops import resample_step as tres

DATA = np.asarray(np.random.default_rng(3).normal(0.3, 1.2, 50), np.float32)
G, NP, K, ALPHA = 32, 16, 4, 0.5

# emission variant: (JAX emit, JAX phase, first iteration, burnin, thin of
# the port's plan over the K iterations)
VARIANTS = {"last": ("last", "all", 1, 2, K),
            "stride2": (("stride", 2), "all", 1, 2, 2),
            "post": ("all", "post", 5, 2, 1)}


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


@pytest.fixture(scope="module")
def jax_runs():
    """Each variant's JAX kernel built and run once for the module, with
    the member-returning gather (see the module docstring)."""
    def one(x, idx, p, Np):
        return jfused._seg_gather(jfused._roll_dict(x, p, Np), idx, p, Np)

    def multi(x, idxs, p, Np):
        rolls = jfused._roll_dict(x, p, Np)
        return [jfused._seg_gather(rolls, i, p, Np) for i in idxs]

    C, d = G * NP, 2
    R, Cf = 8, C // 8
    runs = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jfused, "_seg_gather_bin", one)
        mp.setattr(jfused, "_seg_gather_bin_multi", multi)
        for seed, (name, (emit, phase, it0, burnin, _)) in enumerate(
                VARIANTS.items()):
            jm, jde = jgauss.make(data=DATA, Np=NP, n_groups=G,
                                  burnin=burnin, alpha=ALPHA)
            kern = jfused.build_fused_step(
                jm, jde, jmake_spec(jm, jde), interpret=True, K=K,
                mig_in_kernel=True, emit=emit, phase=phase)
            theta, w = _population(seed, C)
            key2 = np.array([0x5EED + seed, 0xBEEF], np.uint32)
            out = jax.jit(kern)(
                jnp.asarray(theta.T.reshape(d, R, Cf)),
                jnp.asarray(w.reshape(R, Cf)), jnp.asarray(key2),
                jnp.int32(it0), jnp.ones((1, 1), jnp.int32))
            runs[name] = (kern.n_words, theta, w, key2,
                          tuple(np.asarray(o) for o in out))
    return runs


def _port_windows(cfg, model, spec, theta, w, words, it0, thin, phase):
    """The sampler's windows over the K iterations from ``it0`` on the fed
    words: the gates read from the words, K2's plain exchange before a
    window whose first gate is open, the K-window plain version.  Returns
    the trajectory, the state, the margins and the windows."""
    C, n = cfg.G * cfg.Np, cfg.rows.n_words
    uf = trng.to_uni(words[cfg.rows.fire::n, 0])
    gates = (uf <= np.float32(cfg.alpha)).numpy()
    wins = tsampler.plan_windows(it0, K, True, gates, K, thin)
    th, ww = torch.tensor(theta), torch.tensor(w)
    fire = torch.ones(1, dtype=torch.int32)
    T = K // thin
    traj = (torch.empty(T, C, cfg.d), torch.empty(T, C),
            torch.empty(T, C, dtype=torch.bool))
    margins = []
    for win in wins:
        k0 = win.it0 - it0
        wk = words[k0 * n:(k0 + win.K) * n]
        if win.migrate:
            tmig.migrate_plain(th, ww, fire, wk, cfg.G, cfg.Np)
        out = tuple(x[win.t0:win.t0 + win.n_emit] for x in traj)
        m = tfused.de_step_plain(cfg, model, spec, th, ww, fire, win.it0, wk,
                                 out if win.n_emit else None, K=win.K,
                                 emit=win.emit, phase=phase)
        margins.append(m.reshape(-1, C))
    return traj, (th, ww, fire), torch.cat(margins), wins


@pytest.mark.parametrize("name", list(VARIANTS))
def test_window_plain_matches_jax_kernel(jax_runs, name):
    """K = 4 iterations from a fired gate: the JAX kernel's stored rows
    (``emit='last'``: the last; ``('stride', 2)``: iterations 2 and 4;
    ``phase='post'`` past burn-in: all four) against the port's windows on
    the same words; θ and w to rtol 1e-5 / atol 1e-6, accept flags and
    the exported gate exactly, away from near-ties (none at these seeds).
    At α = 0.5 gates open inside the K iterations, so the port cuts
    windows there and carries the thin offset across."""
    emit, phase, it0, burnin, thin = VARIANTS[name]
    n_words, theta, w, key2, (jt, jw, jacc, jfire) = jax_runs[name]
    model, de = tgauss.make(data=DATA, Np=NP, n_groups=G, burnin=burnin,
                            alpha=ALPHA)
    spec = tdm.make_spec(model, de)
    cfg = tfused.StepConfig.make(model, de, spec)
    assert cfg.rows.n_words == n_words
    C, d = G * NP, 2
    words = torch.cat([_bits(key2, it0 + k, n_words, C) for k in range(K)])
    traj, state, margins, wins = _port_windows(cfg, model, spec, theta, w,
                                               words, it0, thin, phase)
    assert (margins.abs() > 1e-4).all(), "near-tie at this seed"
    T = K // thin
    assert jt.shape[0] == T
    for t in range(T):
        np.testing.assert_allclose(traj[0][t].numpy(),
                                   jt[t].reshape(d, C).T, rtol=1e-5,
                                   atol=1e-6)
        np.testing.assert_allclose(traj[1][t].numpy(), jw[t].reshape(C),
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_array_equal(traj[2][t].numpy(), jacc[t].reshape(C))
    assert int(state[2][0]) == int(jfire.reshape(-1)[0])
    if phase == "post":
        # the post window is bitwise the all-phase window
        traj_a, state_a, _, _ = _port_windows(cfg, model, spec, theta, w,
                                              words, it0, thin, "all")
        for x, y in zip(traj + state, traj_a + state_a):
            assert torch.equal(x, y)


def test_emission_variants_cut_windows(jax_runs):
    """The comparisons above cross a migration inside the K iterations:
    at least one variant's plan has a window that starts with K2 after
    the first."""
    cut = 0
    for name, (emit, phase, it0, burnin, thin) in VARIANTS.items():
        n_words, theta, w, key2, _ = jax_runs[name]
        words = torch.cat([_bits(key2, it0 + k, n_words, G * NP)
                           for k in range(K)])
        uf = trng.to_uni(words[n_words - 1::n_words, 0])
        wins = tsampler.plan_windows(it0, K, True,
                                     (uf <= np.float32(ALPHA)).numpy(), K,
                                     thin)
        cut += sum(win.migrate for win in wins[1:])
    assert cut >= 1


def test_window_raises_on_an_open_gate_inside():
    """A window whose iteration before the last opens the gate is a planning
    fault: the plain version raises; ``phase='post'`` in burn-in raises."""
    model, de = tgauss.make(data=DATA, Np=6, n_groups=4, alpha=1.0,
                            burnin=3)
    spec = tdm.make_spec(model, de)
    cfg = tfused.StepConfig.make(model, de, spec)
    s = tdm.init_state(model, de, spec, 1, device="cpu")
    with pytest.raises(RuntimeError, match="gate"):
        tfused.de_step(cfg, model, spec, s.theta, s.weight, s.fire, 5,
                       seed=1, K=2)
    with pytest.raises(ValueError, match="post"):
        tfused.de_step(cfg, model, spec, s.theta, s.weight, s.fire, 3,
                       seed=1, phase="post")


# ------------------------------------------------------------ (b) the gates


@pytest.mark.parametrize("alpha", [0.1, 0.5])
def test_host_gates_equal_the_steps_gates(alpha):
    """``rng.gates`` is, iteration by iteration, the gate the plain step
    writes into ``fire`` (the host's plan sees what the kernels draw)."""
    model, de = tgauss.make(data=DATA, Np=6, n_groups=4, alpha=alpha)
    spec = tdm.make_spec(model, de)
    step = tdm.build_step(model, de, spec, device="cpu")
    s = tdm.init_state(model, de, spec, 11, device="cpu",
                       start_iteration=7)
    n = 60
    want = trng.gates(11, 7, n, step.cfg.rows.fire, alpha)
    got = []
    for _ in range(n):
        s = step(s)
        got.append(bool(s.fire[0]))
    np.testing.assert_array_equal(np.array(got), want)
    assert 0 < want.sum() < n
    assert not trng.gates(11, 7, n, step.cfg.rows.fire, 0.0).any()


# ---------------------------------------------- (c) windows against the loop


def _clone(state):
    return state._replace(**{k: getattr(state, k).clone() for k in
                             ("theta", "weight", "fire", "history")
                             if getattr(state, k) is not None})


def _loop_reference(model, de, n_iter, key, thin, state=None):
    """What ``sample`` returns, run one iteration per step (``run_loop``)."""
    spec = tdm.make_spec(model, de)
    if state is None:
        state = tdm.init_state(model, de, spec, key, device="cpu")
    state = tsampler._grow_history(_clone(state), n_iter)
    step = tdm.build_step(model, de, spec, device="cpu")
    state, ys = tsampler.run_loop(step, state, n_iter, thin)
    return tsampler.bundle_samples(model, de, spec, ys, n_iter, thin), state


def _assert_same(a, b):
    (ca, sa), (cb, sb) = a, b
    np.testing.assert_array_equal(ca.data, cb.data)
    np.testing.assert_array_equal(ca.lp, cb.lp)
    np.testing.assert_array_equal(ca.acceptance, cb.acceptance)
    assert sa.iteration == sb.iteration
    for k in ("theta", "weight", "fire", "history"):
        if getattr(sa, k) is not None:
            x, y = getattr(sa, k), getattr(sb, k)
            assert torch.equal(x.view(torch.int32) if x.is_floating_point()
                               else x, y.view(torch.int32)
                               if y.is_floating_point() else y), k


@pytest.mark.parametrize("burnin", [17, 100])
@pytest.mark.parametrize("thin", [1, 5])
@pytest.mark.parametrize("alpha", [0.0, 0.1, 1.0])
def test_windows_equal_the_per_iteration_loop(alpha, thin, burnin,
                                             monkeypatch):
    """``sample`` through planned windows (K = 8, cut at open gates, at
    the burn-in switch to the post variant when it falls inside the run)
    gives the per-iteration loop's draws, weights, accept flags and final
    state, bit for bit."""
    monkeypatch.setattr(tfused, "SUPER_K", 8)
    model, de = tgauss.make(data=DATA, Np=6, n_groups=4, alpha=alpha,
                            burnin=burnin, discard_burnin=False)
    got = tdm.sample(model, de, 40, key=4, thin=thin, device="cpu",
                     return_state=True)
    _assert_same(got, _loop_reference(model, de, 40, 4, thin))


def test_resume_from_mid_window_and_short_run(monkeypatch):
    """A run resumed at iteration 24 (mid-window, past burn-in, so the
    whole run takes the post variant) with thin 5, and a run of 6 < K
    iterations, equal the per-iteration loop."""
    monkeypatch.setattr(tfused, "SUPER_K", 8)
    model, de = tgauss.make(data=DATA, Np=6, n_groups=4, alpha=0.3,
                            burnin=17, discard_burnin=False)
    _, mid = tdm.sample(model, de, 23, key=6, device="cpu",
                        return_state=True)
    assert mid.iteration == 24
    got = tdm.sample(model, de, 30, key=6, thin=5, state=mid, device="cpu",
                     return_state=True)
    _assert_same(got, _loop_reference(model, de, 30, 6, 5, state=mid))
    got = tdm.sample(model, de, 6, key=7, device="cpu", return_state=True)
    _assert_same(got, _loop_reference(model, de, 6, 7, 1))


def test_sequential_sweep_windows(monkeypatch):
    """The sequential sweep with snooker (Np = 4) through windows of at
    most 8."""
    monkeypatch.setattr(tfused, "SUPER_K", 8)
    model, de = tgauss.make(data=DATA, Np=4, n_groups=6, alpha=0.3,
                            theta_snooker=0.3, burnin=9,
                            discard_burnin=False)
    assert de.sequential_sweep
    got = tdm.sample(model, de, 36, key=8, thin=3, device="cpu",
                     return_state=True)
    _assert_same(got, _loop_reference(model, de, 36, 8, 3))


@pytest.mark.parametrize("which", ["C3", "C512"])
def test_resample_windows(which, monkeypatch):
    """K3 windows (K = 8 here, every iteration reading the history rows the
    window itself wrote) at C = 3 (a 3-dim MVN, sequential, snooker) and
    C = 512 (G = 128 × Np = 4, synchronous), across the burn-in switch,
    equal the per-iteration loop, history included."""
    monkeypatch.setattr(tres, "RESAMPLE_SUPER_K", 8)
    if which == "C3":
        data = np.random.default_rng(5).standard_normal((40, 3))
        model, de = tmvn.make(d=3, data=data, n_initial=16, burnin=20,
                              discard_burnin=False)
        n_iter = 30
    else:
        model, de = tgauss.make(data=DATA, n_groups=128, Np=4, alpha=0.0,
                                sample="resample", n_initial=10, burnin=14,
                                theta_snooker=0.1, sweep="sync",
                                discard_burnin=False)
        n_iter = 12
    got = tdm.sample(model, de, n_iter, key=9, device="cpu",
                     return_state=True)
    _assert_same(got, _loop_reference(model, de, n_iter, 9, 1))


@pytest.mark.parametrize("which", ["mvn30", "gaussian"])
def test_resample_windows_keep_one_iteration_above_one_cta(which):
    """Above the chains a K3 window holds K3 takes one iteration per launch,
    from the configuration; a window of two raises.  A window runs in one
    CTA (on the CPU, 1,024 chains; on the card, what the configuration's
    kernel can launch in one block), or on the Gaussian in one cluster of
    CTAs of whole groups (on the CPU, 8 of 1,024 chains)."""
    if which == "mvn30":
        model, de = tmvn.make(d=30, n_obs=20, key=1, n_groups=300, Np=4,
                              n_initial=2)
        most, n_groups = tres.MAX_WINDOW_C, 256
    else:
        model, de = tgauss.make(data=DATA, n_groups=2049, Np=4, alpha=0.0,
                                sample="resample", n_initial=2,
                                sweep="sync")
        most, n_groups = tres.CLUSTER_CTAS * tres.MAX_WINDOW_C, 2048
    spec = tdm.make_spec(model, de)
    step = tdm.build_step(model, de, spec, device="cpu")
    assert tres.window_chains(step.cfg, "cpu") == most
    assert de.n_chains > most >= 1024
    assert step.superstep_k == 1
    assert tres.resample_super_k(step.cfg) == 1
    small = tdm.build_step(model, de.replace(n_groups=n_groups),
                           tdm.make_spec(model, de.replace(
                               n_groups=n_groups)), device="cpu")
    assert small.superstep_k == tres.RESAMPLE_SUPER_K
    s = tsampler._grow_history(tdm.init_state(model, de, spec, 1,
                                              device="cpu"), 4)
    with pytest.raises(ValueError, match="one CTA"):
        tres.resample_step(step.cfg, model, spec, s.theta, s.weight, s.fire,
                           s.history, s.iteration, K=2)


def test_superstep_thin_step_and_post_step(monkeypatch):
    """The JAX step's names: ``get_superstep()`` runs ``superstep_k``
    iterations storing each, ``get_thin_step(thin)`` runs ``thin`` storing
    the last, both as the loop's; ``get_post_burnin()`` is the post
    variant's one-iteration step, equal to the step's past burn-in, None
    without a γ₂ base select to drop."""
    monkeypatch.setattr(tfused, "SUPER_K", 8)
    model, de = tgauss.make(data=DATA, Np=6, n_groups=4, alpha=0.5,
                            burnin=5)
    spec = tdm.make_spec(model, de)
    step = tdm.build_step(model, de, spec, device="cpu")
    assert step.superstep_k == 8
    s0 = tdm.init_state(model, de, spec, 3, device="cpu")
    C = de.n_chains

    def rows(T):
        return (torch.empty(T, C, 2), torch.empty(T, C),
                torch.empty(T, C, dtype=torch.bool))

    got, ref = rows(8), rows(8)
    a = step.get_superstep()(_clone(s0), got)
    b = _clone(s0)
    for t in range(8):
        b = step(b, tuple(x[t] for x in ref))
    got1, ref1 = rows(1), rows(1)
    a = step.get_thin_step(3)(a, got1)
    for t in range(3):
        b = step(b, tuple(x[0] for x in ref1) if t == 2 else None)
    for x, y in zip(got + got1 + (a.theta, a.fire),
                    ref + ref1 + (b.theta, b.fire)):
        assert torch.equal(x, y)
    assert a.iteration == b.iteration == 12
    # past burn-in (5) the post step's iteration is the step's, bit for bit
    a, b = step.get_post_burnin()(a), step(b)
    for x, y in zip((a.theta, a.weight, a.fire), (b.theta, b.weight, b.fire)):
        assert torch.equal(x, y)
    assert a.iteration == b.iteration == 13
    for kw in ({"generate_proposal": "fixed_gamma"}, {"burnin": 0}):
        m2, de2 = tgauss.make(data=DATA, Np=6, n_groups=4, **kw)
        assert tdm.build_step(m2, de2, tdm.make_spec(m2, de2),
                              device="cpu").get_post_burnin() is None


# -------------------------------------------------------- (d) launch counts


def _expected_calls(key, it0, n_iter, fire0, row, alpha, k_max):
    """K1 and K2 calls of a planned run, counted from the gates alone."""
    g = trng.gates(key, it0, n_iter, row, alpha)
    k1 = k2 = 0
    length = 0
    for i in range(n_iter):
        opens = bool(fire0) if i == 0 else bool(g[i - 1])
        if i == 0 or opens or length == k_max:
            k1 += 1
            length = 0
        k2 += opens
        length += 1
    return k1, k2


@pytest.mark.parametrize("alpha", [0.0, 0.1, 0.6])
def test_plain_calls_follow_the_plan(alpha, monkeypatch):
    """On CPU tensors the windows' plain calls are the plan's launches (K
    at most 8 here): one K-window plain call per window and one exchange
    per open gate; the per-iteration loop makes one of each per
    iteration."""
    monkeypatch.setattr(tfused, "SUPER_K", 8)
    calls = {"k1": 0, "k2": 0}
    plain_k1, plain_k2 = tfused.de_step_plain, tmig.migrate_plain

    def k1(*a, **kw):
        calls["k1"] += 1
        return plain_k1(*a, **kw)

    def k2(*a, **kw):
        calls["k2"] += 1
        return plain_k2(*a, **kw)

    monkeypatch.setattr(tfused, "de_step_plain", k1)
    monkeypatch.setattr(tmig, "migrate_plain", k2)
    model, de = tgauss.make(data=DATA, Np=6, n_groups=4, alpha=alpha,
                            burnin=0)
    spec = tdm.make_spec(model, de)
    step = tdm.build_step(model, de, spec, device="cpu")
    s = tdm.init_state(model, de, spec, 12, device="cpu")
    want = _expected_calls(12, s.iteration, 90, int(s.fire[0]),
                           step.cfg.rows.fire, alpha, tfused.super_k())
    tsampler.run_scan(step, _clone(s), 90)
    assert (calls["k1"], calls["k2"]) == want
    assert want[0] < 90 and (want[1] > 0) == (alpha > 0.0)
    calls.update(k1=0, k2=0)
    tsampler.run_loop(step, _clone(s), 90)
    assert (calls["k1"], calls["k2"]) == (90, 90 if alpha > 0.0 else 0)


def test_plan_emission_and_cuts():
    """The plan: windows cut at open gates, at k_max and at the switch;
    stored rows by the run's thin rule across windows."""
    gates = np.zeros(30, bool)
    gates[[4, 11]] = True                  # iterations 6 and 13 migrate
    wins = tsampler.plan_windows(1, 30, False, gates, 8, thin=3, switch=20)
    assert [(w.it0, w.K) for w in wins] == [(1, 5), (6, 7), (13, 8),
                                            (21, 8), (29, 2)]
    assert [w.migrate for w in wins] == [False, True, True, False, False]
    assert [w.post for w in wins] == [False, False, False, True, True]
    stored = [w.it0 + w.emit[0] + j * w.emit[1]
              for w in wins for j in range(w.n_emit)]
    assert stored == list(range(3, 31, 3))
    assert [w.t0 for w in wins if w.n_emit] == [0, 1, 4, 6, 9]
