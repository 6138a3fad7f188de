"""DE-MCz with migration between groups in the port: the plain K3 with its
migration gate and K2 between iterations (``demcmc_tpu_torch.ops.
resample_step``, ``ops.migration``) against the JAX resample kernel with
in-kernel migration (``build_fused_step(..., mig_in_kernel=True)``) in
interpret mode, on the same words and history indices; the sampler's
K3 windows against one launch per iteration; the host's gates against the
ones K3 writes.

The JAX kernel runs the resample layout padded to whole lanes ([d, 8,
128] for C ≤ 128): it draws its per-lane words over all 1,024 lanes, and
its pad groups rank last and never join the exchange.  The port is fed
the real chains' words (the first C columns); the pad lanes keep their
own, arbitrary, words.  As in ``test_torch_resample.py``, the JAX kernel's
within-group gather (the γ₂ base select) is replaced in this process by
the JAX package's linear-select gather (ROADMAP.md, C), and the history
indices are JAX's, fed to the port (indices-in).

Tolerance: θ and w within 1e-6 + 1e-6·|x| (XLA on the CPU contracts a·b +
c into a fused multiply-add, which torch does not), accept flags exactly,
away from near-ties (|log u − Δ| > 1e-4; none at these seeds); the
history rows written and the exported gate as θ and exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import demcmc_tpu as jdm
from demcmc_tpu import rng as jrng
from demcmc_tpu.models import mvnormal as jmvn
from demcmc_tpu.ops import fused_step as jfused
from demcmc_tpu.ops import proposals as jprop

import demcmc_tpu_torch as tdm
from demcmc_tpu_torch.models import gaussian as tgauss
from demcmc_tpu_torch.models import mvnormal as tmvn
from demcmc_tpu_torch.ops import fused_step as tfused
from demcmc_tpu_torch.ops import migration as tmig
from demcmc_tpu_torch.ops import resample_step as tres

D_MU, N_INIT, NP, K, TOL = 3, 16, 3, 6, 1e-6
DATA = np.asarray(np.random.default_rng(5).standard_normal((40, D_MU)),
                  np.float32)
# (groups, α, θsnooker, key words of the JAX kernel)
CASES = [(2, 1.0, 0.0, (0x51, 0xC0DE)), (2, 0.1, 0.0, (0x55, 0xC0DE)),
         (4, 1.0, 0.0, (0x53, 0xC0DE)), (4, 0.1, 0.5, (0x55, 0xC0DE))]
IDS = [f"G{c[0]}-alpha{c[1]}" + ("-snooker" if c[2] else "") for c in CASES]


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _member_gather(mp):
    def one(x, idx, p, Np):
        return jfused._seg_gather(jfused._roll_dict(x, p, Np), idx, p, Np)

    def multi(x, idxs, p, Np):
        rolls = jfused._roll_dict(x, p, Np)
        return [jfused._seg_gather(rolls, i, p, Np) for i in idxs]

    mp.setattr(jfused, "_seg_gather_bin", one)
    mp.setattr(jfused, "_seg_gather_bin_multi", multi)


def _pack(hist, S):
    """``[H, C, d]`` history to the narrow resample layout's slabs ``[S,
    d, 128]``: row t of chain c at slab t // B, lane (t % B)·C + c, B =
    128 // C (``demcmc_tpu/sampler.py`` ``pack_history``)."""
    H, C, d = hist.shape
    B = 128 // C
    out = np.zeros((S, d, 128), np.float32)
    for t in range(H):
        out[t // B, :, (t % B) * C:(t % B + 1) * C] = hist[t].T
    return out


def _seeds(G, kw):
    """History seeds ``[N_INIT, C, d]`` near the posterior and row 0's
    log posterior."""
    C = G * NP
    rng = np.random.default_rng(G)
    mu = rng.normal(DATA.mean(0), 0.3, (N_INIT, C, D_MU))
    sigma = np.abs(rng.normal(1.0, 0.2, (N_INIT, C, 1))) + 0.05
    hist = np.concatenate([mu, sigma], -1).astype(np.float32)
    model, de = tmvn.make(d=D_MU, data=DATA, n_initial=N_INIT, **kw)
    w = tdm.ops.accept.compute_posterior(model, tdm.make_spec(model, de), de,
                                         torch.tensor(hist[0]))
    return hist, w.numpy()


_RUNS = {}


def _jax_run(G, alpha, theta_sn, key2):
    """The JAX resample kernel with in-kernel migration, K iterations from
    n_initial + 1 with the gate open at the start: per iteration θ, w and
    accept of the real chains, the history and the exported gate (built
    once per case in this process)."""
    case = (G, alpha, theta_sn, key2)
    if case not in _RUNS:
        kw = dict(burnin=N_INIT + 3, theta_snooker=theta_sn, n_groups=G,
                  alpha=alpha)
        jm, jde = jmvn.make(d=D_MU, data=DATA, n_initial=N_INIT, **kw)
        spec = jdm.make_spec(jm, jde)
        C, D = G * NP, spec.dim
        hist0, w0 = _seeds(G, kw)
        S = jfused.RESAMPLE_S_GRAN
        th = np.zeros((D, 8 * 128), np.float32)
        th[:, :C] = hist0[0].T
        w = np.full(8 * 128, -np.inf, np.float32)
        w[:C] = w0
        with pytest.MonkeyPatch.context() as mp:
            _member_gather(mp)
            kern = jfused.build_fused_step(jm, jde, spec, interpret=True,
                                           K=K, hist_S=S, mig_in_kernel=True)
            out = jax.jit(kern)(
                jnp.asarray(th.reshape(D, 8, 128)),
                jnp.asarray(w.reshape(8, 128)), jnp.asarray(
                    np.array(key2, np.uint32)), jnp.int32(N_INIT + 1),
                jnp.ones((1, 1), jnp.int32), jnp.asarray(_pack(hist0, S)))
        jt, jw, jacc, jfire, jhist = (np.asarray(o) for o in out)
        hist = jhist[:, :, :(128 // C) * C].reshape(S, D, 128 // C, C)
        hist = hist.transpose(0, 2, 3, 1).reshape(-1, C, D)
        _RUNS[case] = dict(kw=kw, n_words=kern.n_words, hist0=hist0, w0=w0,
                           theta=jt[:, :, 0, :C].transpose(0, 2, 1),
                           w=jw[:, 0, :C], acc=jacc[:, 0, :C],
                           fire=int(jfire.reshape(-1)[0]),
                           hist=hist[:N_INIT + K])
    return _RUNS[case]


def _jax_indices(key2, it, n_sets, C, snooker):
    """JAX's history indices for iteration ``it`` as ``_resample_idx``
    (``fused_step.py:2637-2686``) draws them, flat row·C + chain,
    ``[n_sets · n_slots, C]``."""
    key = jax.random.wrap_key_data(jnp.asarray(key2), impl="threefry2x32")
    kd = jrng.KeyDraws(jax.random.fold_in(
        jax.random.fold_in(key, jrng.RESAMPLE), it))
    count = jnp.maximum(jnp.int32(it) - 1, 1)
    rows, chains = jprop.resample_flat_indices(kd, 2, count, C, (n_sets, C))
    if snooker:
        r2, c2 = jprop.resample_flat_indices(kd, 3, count, C, (n_sets, C))
        rows, chains = jnp.concatenate([rows, r2]), jnp.concatenate(
            [chains, c2])
    flat = np.asarray(rows, np.int64) * C + np.asarray(chains, np.int64)
    return torch.from_numpy(np.ascontiguousarray(
        flat.transpose(1, 0, 2).reshape(-1, C)))


def _jax_words(key2, it, n_words, C):
    """The words the interpret-mode kernel_call feeds iteration ``it``, real
    lanes only."""
    key = jax.random.wrap_key_data(jnp.asarray(np.array(key2, np.uint32)),
                                   impl="threefry2x32")
    b = np.asarray(jax.random.bits(jax.random.fold_in(key, it),
                                   (n_words, 8 * 128), jnp.uint32))[:, :C]
    return torch.from_numpy(b.astype(np.int64)).to(torch.uint32)


@pytest.mark.parametrize("G,alpha,theta_sn,key2", CASES, ids=IDS)
def test_plain_k3_with_gate_and_k2_match_jax_kernel(G, alpha, theta_sn,
                                                    key2):
    """K = 6 iterations from n_initial + 1 across burn-in, the gate open at
    the start: K2's plain version where the gate K3 wrote (or the first)
    is open, then K3's, bits-in and indices-in.  θ, w, accept flags and
    the history rows after each iteration, and the gate the last one
    writes, equal the JAX kernel's; at α = 0.1 a gate opens inside the
    run besides the first, and one stays shut."""
    run = _jax_run(G, alpha, theta_sn, key2)
    C = G * NP
    model, de = tmvn.make(d=D_MU, data=DATA, n_initial=N_INIT, **run["kw"])
    assert de.sequential_sweep and de.n_groups == G
    spec = tdm.make_spec(model, de)
    cfg = tfused.StepConfig.make(model, de, spec)
    assert cfg.rows.mig == 0 and cfg.alpha == np.float32(alpha)
    assert cfg.rows.n_words == run["n_words"]
    th = torch.tensor(run["hist0"][0])
    w = torch.tensor(run["w0"])
    hist = torch.zeros((N_INIT + K, C, spec.dim))
    hist[:N_INIT] = torch.tensor(run["hist0"])
    fire = torch.ones(1, dtype=torch.int32)
    opened = []
    for k in range(K):
        it = N_INIT + 1 + k
        words = _jax_words(key2, it, cfg.rows.n_words, C)
        idx = _jax_indices(np.array(key2, np.uint32), it, cfg.n_sets, C,
                           theta_sn > 0)
        opened.append(bool(fire[0]))
        tmig.migrate_plain(th, w, fire, words, G, NP)
        margin = tres.resample_step_plain(cfg, model, spec, th, w, fire,
                                          hist, it, words, idx)
        assert (margin.abs() > 1e-4).all(), "near-tie at this seed"
        np.testing.assert_allclose(th.numpy(), run["theta"][k], rtol=TOL,
                                   atol=TOL)
        np.testing.assert_allclose(w.numpy(), run["w"][k], rtol=TOL,
                                   atol=TOL)
        np.testing.assert_array_equal((margin <= 0).numpy(), run["acc"][k])
    np.testing.assert_allclose(hist.numpy(), run["hist"], rtol=TOL, atol=TOL)
    assert int(fire[0]) == run["fire"]
    if alpha < 1.0:
        assert any(opened[1:]) and not all(opened)
    else:
        assert all(opened)


@pytest.mark.parametrize("G,alpha", [(2, 1.0), (2, 0.1), (4, 1.0),
                                     (4, 0.1)])
def test_windows_equal_loop_with_migration(G, alpha):
    """The kernels' step on a DE-MCz Gaussian with migration: ``run_scan``
    (K3 windows cut where a gate opens, K2 between them) stores the same
    draws, bit for bit, as ``run_loop`` (K2 gated on the written flag,
    then K3, every iteration), and ends in the same state, history and
    gate included; the plan opens a window at each open gate."""
    model, de = tgauss.make(data=DATA[:, 0], Np=NP, n_groups=G, alpha=alpha,
                            sample="resample", n_initial=6, burnin=10,
                            theta_snooker=0.2)
    spec = tdm.make_spec(model, de)
    step = tdm.build_step(model, de, spec, device="cpu")
    assert type(step) is tdm.sampler.Step and step.cfg.resample
    n = 40
    ends, outs = [], []
    for run in (tdm.run_scan, tdm.sampler.run_loop):
        s = tdm.sampler._grow_history(
            tdm.init_state(model, de, spec, 5, device="cpu"), n)
        plan = step.plan(s, n)
        s, ys = run(step, s, n)
        ends.append(s)
        outs.append(ys)
    assert sum(w.migrate for w in plan) >= (n if alpha == 1.0 else 2)
    for a, b in zip(outs[0], outs[1]):
        np.testing.assert_array_equal(a, b)
    for name in ("theta", "weight", "fire", "history"):
        assert torch.equal(getattr(ends[0], name), getattr(ends[1], name))


def test_gates_equal_the_ones_k3_writes():
    """``rng.gates`` (the host's plan) equals, iteration by iteration, the
    gate the plain K3 writes from its Philox words, at α = 0.1 (some open)
    and α = 1 (all open)."""
    for alpha in (0.1, 1.0):
        model, de = tgauss.make(data=DATA[:, 0], Np=NP, n_groups=4,
                                alpha=alpha, sample="resample",
                                n_initial=4, burnin=5)
        spec = tdm.make_spec(model, de)
        cfg = tfused.StepConfig.make(model, de, spec)
        n = 30
        s = tdm.sampler._grow_history(
            tdm.init_state(model, de, spec, 9, device="cpu"), n)
        written = []
        for k in range(n):
            tres.resample_step(cfg, model, spec, s.theta, s.weight, s.fire,
                               s.history, s.iteration + k, seed=9)
            written.append(bool(s.fire[0]))
        want = tdm.rng.gates(9, s.iteration, n, cfg.rows.fire, alpha)
        np.testing.assert_array_equal(written, want)
        assert want.any() and (alpha == 1.0) == want.all()
