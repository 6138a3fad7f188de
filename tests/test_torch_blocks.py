"""Constant blocks in the port: the plain versions of K1 and K3
(``demcmc_tpu_torch.ops.fused_step.sweep_plain`` through ``de_step_plain``
and ``resample_step.resample_step_plain``) with two blocks swept every
iteration, against the JAX whole-iteration kernel's block sweeps
(``build_fused_step`` with constant-True ``blocking_on``) in interpret
mode, on the same words (bits-in) and, for K3, the same history indices
(indices-in); ``flatten_block`` against JAX's; the constant-False form
against no blocks.

As in ``test_torch_fused_step.py``, the JAX kernel's within-group gathers
are replaced in this process by the JAX package's linear-select gather,
which returns the member drawn (ROADMAP.md, C).

Tolerance: θ and w within 1e-6 + 1e-6·|x| (XLA on the CPU contracts a·b +
c into a fused multiply-add, which torch does not); with snooker 1e-5 +
1e-5·|x|, as ``test_torch_snooker.py`` holds the unblocked snooker (the
projection's r₁ − r₂ cancels, so an ulp of the operands is more than an
ulp of θ, and the sequential sweep carries it to later members); accept
flags exactly, away from near-ties (|log u − Δ| > 1e-4; none at these
seeds).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import demcmc_tpu as jdm
from demcmc_tpu import rng as jrng
from demcmc_tpu.models import gaussian as jgauss
from demcmc_tpu.models import mvnormal as jmvn
from demcmc_tpu.ops import fused_step as jfused
from demcmc_tpu.ops import proposals as jprop
from demcmc_tpu.sampler import flatten_block as jflatten_block

import demcmc_tpu_torch as tdm
from demcmc_tpu_torch.models import gaussian as tgauss
from demcmc_tpu_torch.models import mvnormal as tmvn
from demcmc_tpu_torch.ops import fused_step as tfused
from demcmc_tpu_torch.ops import migration as tmig
from demcmc_tpu_torch.ops import resample_step as tres

DATA = np.asarray(np.random.default_rng(3).normal(0.3, 1.2, 50), np.float32)
MVN_DATA = np.asarray(np.random.default_rng(5).standard_normal((40, 3)),
                      np.float32)
BLOCKS = [[True, False], [False, True]]
K, N_INIT = 4, 16


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


def _bits(key2, it, n_words, lanes, C):
    """The words the interpret-mode kernel_call feeds iteration ``it``
    (``lanes`` of them a row), the first ``C`` lanes."""
    key = jax.random.wrap_key_data(jnp.asarray(key2), impl="threefry2x32")
    b = np.asarray(jax.random.bits(jax.random.fold_in(key, it),
                                   (n_words, lanes), jnp.uint32))[:, :C]
    return torch.from_numpy(b.astype(np.int64)).to(torch.uint32)


def _check(th, w, margin, jt, jw, jacc, tol):
    assert (margin.abs() > 1e-4).all(), "near-tie at this seed"
    np.testing.assert_allclose(th, jt, rtol=tol, atol=tol)
    np.testing.assert_allclose(w, jw, rtol=tol, atol=tol)
    np.testing.assert_array_equal((margin <= 0).numpy(), jacc)


@pytest.mark.parametrize("Np,theta_sn,seed", [(8, 0.0, 0), (4, 0.5, 1)],
                         ids=["sync", "sequential-snooker"])
def test_blocked_plain_k1_matches_jax_kernel(Np, theta_sn, seed):
    """The Gaussian at G = 8 with the blocks (μ), (σ): K = 4 iterations from
    it = 1 across burn-in 2 with the migration gate open at the start (K2's
    plain version first, then K1's over both blocks), against the JAX
    kernel's trajectory, accept flags and exported gate; the word layout
    (the block sweeps' rows between the migration and gate rows) is the
    JAX kernel's."""
    G = 8
    C, d = G * Np, 2
    R, Cf = 8, C // 8
    kw = dict(data=DATA, Np=Np, n_groups=G, burnin=2, blocks=BLOCKS,
              blocking_on=True, theta_snooker=theta_sn)
    jm, jde = jgauss.make(**kw)
    rng = np.random.default_rng(seed)
    theta = np.stack([rng.normal(DATA.mean(), 0.3, C),
                      np.abs(rng.normal(DATA.std(), 0.3, C)) + 0.05],
                     1).astype(np.float32)
    w = np.asarray(jgauss.prior_loglike_batched(theta[:, 0], theta[:, 1])
                   + jgauss.loglike_batched(DATA, theta[:, 0], theta[:, 1]),
                   np.float32)
    key2 = np.array([0x1234 + seed, 0xBEEF], np.uint32)
    with pytest.MonkeyPatch.context() as mp:
        _member_gather(mp)
        kern = jfused.build_fused_step(jm, jde, jdm.make_spec(jm, jde),
                                       interpret=True, K=K,
                                       mig_in_kernel=True)
        out = jax.jit(kern)(
            jnp.asarray(theta.T.reshape(d, R, Cf)),
            jnp.asarray(w.reshape(R, Cf)), jnp.asarray(key2), jnp.int32(1),
            jnp.ones((1, 1), jnp.int32))
    jt, jw, jacc, jfire = (np.asarray(o) for o in out)

    model, de = tgauss.make(**kw)
    spec = tdm.make_spec(model, de)
    cfg = tfused.StepConfig.make(model, de, spec)
    r = cfg.rows
    assert cfg.blocks == ((True, False), (False, True))
    assert r.n_words == kern.n_words and r.n_blocks == 2
    assert r.fire == r.mig + 3 + 2 * r.blk_stride
    th, ww = torch.tensor(theta), torch.tensor(w)
    fire = torch.ones(1, dtype=torch.int32)
    tol = 1e-5 if theta_sn else 1e-6
    for k in range(K):
        words = _bits(key2, 1 + k, kern.n_words, C, C)
        tmig.migrate_plain(th, ww, fire, words, G, Np)
        margin = tfused.de_step_plain(cfg, model, spec, th, ww, fire, 1 + k,
                                      words)
        _check(th.numpy(), ww.numpy(), margin, jt[k].reshape(d, C).T,
               jw[k].reshape(C), jacc[k].reshape(C), tol)
    assert int(fire[0]) == int(jfire.reshape(-1)[0])


def _jax_indices(key2, it, n_sets, C, snooker):
    """JAX's history indices for iteration ``it`` (``_resample_idx``,
    ``fused_step.py:2637-2686``), flat row·C + chain, ``[n_sets · n_slots,
    C]``, slot sets block-major."""
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


@pytest.mark.parametrize("Np,sweep,theta_sn", [(3, "sequential", 0.5),
                                               (8, "sync", 0.0)],
                         ids=["sequential-snooker", "sync"])
def test_blocked_plain_k3_matches_jax_kernel(Np, sweep, theta_sn):
    """The MVN (d = 3, one group) with the blocks (μ), (σ): K = 4 DE-MCz
    iterations from n_initial + 1 across burn-in, each block sweep on its
    own history slot sets, against the JAX resample kernel: θ, w, accept
    flags after each iteration and the history rows written (once per
    iteration, after the last block)."""
    kw = dict(burnin=N_INIT + 2, theta_snooker=theta_sn, Np=Np, sweep=sweep,
              blocks=BLOCKS, blocking_on=True, n_initial=N_INIT)
    jm, jde = jmvn.make(d=3, data=MVN_DATA, **kw)
    spec = jdm.make_spec(jm, jde)
    C, D = Np, spec.dim
    rng = np.random.default_rng(Np)
    hist0 = np.concatenate(
        [rng.normal(MVN_DATA.mean(0), 0.3, (N_INIT, C, 3)),
         np.abs(rng.normal(1.0, 0.2, (N_INIT, C, 1))) + 0.05],
        -1).astype(np.float32)
    model, de = tmvn.make(d=3, data=MVN_DATA, **kw)
    tspec = tdm.make_spec(model, de)
    w0 = tdm.ops.accept.compute_posterior(model, tspec, de,
                                          torch.tensor(hist0[0])).numpy()
    S, B = jfused.RESAMPLE_S_GRAN, 128 // C
    packed = np.zeros((S, D, 128), np.float32)
    for t in range(N_INIT):
        packed[t // B, :, (t % B) * C:(t % B + 1) * C] = hist0[t].T
    th0 = np.zeros((D, 8 * 128), np.float32)
    th0[:, :C] = hist0[0].T
    wp = np.full(8 * 128, -np.inf, np.float32)
    wp[:C] = w0
    key2 = np.array([0x5151, 0xC0DE + Np], np.uint32)
    it0 = N_INIT + 1
    with pytest.MonkeyPatch.context() as mp:
        _member_gather(mp)
        kern = jfused.build_fused_step(jm, jde, spec, interpret=True, K=K,
                                       hist_S=S)
        out = jax.jit(kern)(
            jnp.asarray(th0.reshape(D, 8, 128)),
            jnp.asarray(wp.reshape(8, 128)), jnp.asarray(key2),
            jnp.int32(it0), jnp.zeros((1, 1), jnp.int32),
            jnp.asarray(packed))
    jt, jw, jacc, _, jhist = (np.asarray(o) for o in out)
    jhist = jhist[:, :, :B * C].reshape(S, D, B, C).transpose(0, 2, 3, 1)
    jhist = jhist.reshape(-1, C, D)[:N_INIT + K]

    cfg = tfused.StepConfig.make(model, de, tspec)
    assert cfg.rows.n_words == kern.n_words
    assert cfg.n_sets == 2 * cfg.rows.n_members
    assert tres.index_rows(cfg) == 2 * cfg.rows.n_members * cfg.n_slots
    th, ww = torch.tensor(hist0[0]), torch.tensor(w0)
    hist = torch.zeros((N_INIT + K, C, D))
    hist[:N_INIT] = torch.tensor(hist0)
    fire = torch.zeros(1, dtype=torch.int32)
    tol = 1e-5 if theta_sn else 1e-6
    for k in range(K):
        it = it0 + k
        words = _bits(key2, it, kern.n_words, 8 * 128, C)
        idx = _jax_indices(key2, it, cfg.n_sets, C, theta_sn > 0)
        margin = tres.resample_step_plain(cfg, model, tspec, th, ww, fire,
                                          hist, it, words, idx)
        _check(th.numpy(), ww.numpy(), margin, jt[k][:, 0, :C].T,
               jw[k][0, :C], jacc[k][0, :C], tol)
    np.testing.assert_allclose(hist.numpy(), jhist, rtol=tol, atol=tol)


@pytest.mark.parametrize("block", [
    [True, [False, True, False], [[True, False], [False, True]]],
    [False, True, np.zeros((2, 2), bool)],
    np.array([True, False, True], dtype=object),
], ids=["nested", "scalars", "object-array"])
def test_flatten_block_matches_jax(block):
    """A block of per-parameter masks (a scalar covering its parameter, a
    nested list, an array) flattens to JAX's ``[d]`` mask."""
    example = [0.0, np.zeros(3), np.zeros((2, 2))]
    spec = tdm.ParamSpec.from_example(("a", "v", "m"), example, None)
    jspec = jdm.ParamSpec.from_example(("a", "v", "m"), example, None)
    got = tdm.sampler.flatten_block(spec, block)
    np.testing.assert_array_equal(got, jflatten_block(jspec, block))
    assert got.dtype == bool and got.shape == (8,)


def test_flatten_block_shape_mismatch_raises():
    """An array element of the wrong size raises, as in JAX."""
    spec = tdm.ParamSpec.from_example(("v",), [np.zeros(4)], None)
    with pytest.raises(ValueError, match="does not match"):
        tdm.sampler.flatten_block(spec, [np.array([True, False])])
    np.testing.assert_array_equal(tdm.sampler.flatten_block(spec, [True]),
                                  [True] * 4)


def test_constant_false_blocks_equal_no_blocks():
    """``blocking_on=False`` never applies the blocks: the kernels' step
    has the word layout and draws of the configuration without blocks, and
    so has the unfused step; ``blocking_on=True`` with the blocks changes
    the layout (two block sweeps)."""
    kw = dict(data=DATA, Np=4, n_groups=4, burnin=3, alpha=0.5)
    base_model, base = tgauss.make(**kw)
    model, off = tgauss.make(blocks=BLOCKS, blocking_on=False, **kw)
    _, on = tgauss.make(blocks=BLOCKS, blocking_on=True, **kw)
    spec = tdm.make_spec(model, off)
    for allow_fused in (True, False):
        runs = [tdm.sample(m, de, 8, key=4, device="cpu", return_state=True,
                           allow_fused=allow_fused)
                for m, de in ((base_model, base), (model, off))]
        np.testing.assert_array_equal(runs[0][0].data, runs[1][0].data)
        assert torch.equal(runs[0][1].theta, runs[1][1].theta)
    r_off = tfused.StepConfig.make(model, off, spec).rows
    r_on = tfused.StepConfig.make(model, on, spec).rows
    assert r_off == tfused.StepConfig.make(base_model, base, spec).rows
    assert r_off.n_blocks == 1 and r_on.n_blocks == 2
    assert r_on.n_words == r_off.n_words + r_off.blk_stride
    step = tdm.build_step(model, off, spec, "cpu", allow_fused=False)
    assert step.pool_words == tdm.build_step(base_model, base, spec, "cpu",
                                             allow_fused=False).pool_words


def _port_de(jde):
    """The port's ``DE`` of a JAX ``DE`` with blocks: the same numbers, the
    strategy slots by name, the masks as nested lists of numpy bools and
    the constant ``blocking_on`` as its bool."""
    from demcmc_tpu.config import _always_blocking_on, _default_blocking_on
    names = ("Np", "n_groups", "burnin", "discard_burnin", "alpha", "beta",
             "epsilon", "sigma", "kappa", "theta_snooker", "bounds",
             "n_initial", "sweep")
    kw = {k: getattr(jde, k) for k in names}
    kw["generate_proposal"] = jde.generate_proposal.__name__
    kw["sample"] = "resample" if jde.uses_resample else None
    kw["blocking_on"] = {_always_blocking_on: True,
                         _default_blocking_on: False}[jde.blocking_on]
    kw["blocks"] = [[np.asarray(e, bool) for e in blk] for blk in jde.blocks]
    return tdm.DE(**kw)


def test_state_from_numpy_reads_jax_blocked_resample_state():
    """A JAX DE-MCz run with two blocks (the XLA step's flat state, history
    included) carries over to the port: ``state_from_numpy`` reads it,
    the JAX ``DE`` converts to the port's with the same blocks and word
    layout, and the port samples on from it, keeping the JAX history
    rows."""
    kw = dict(n_initial=N_INIT, burnin=2, blocks=BLOCKS, blocking_on=True,
              n_groups=2, alpha=0.1)
    jm, jde = jmvn.make(d=3, data=MVN_DATA, **kw)
    _, jst = jdm.sample(jm, jde, 6, key=3, return_state=True)
    model, de = tmvn.make(d=3, data=MVN_DATA, **kw)
    conv = _port_de(jde)
    assert conv.blocks == de.blocks and conv.blocking_on is de.blocking_on
    spec = tdm.make_spec(model, conv)
    assert (tfused.StepConfig.make(model, conv, spec).rows
            == tfused.StepConfig.make(model, de, spec).rows)
    st = tdm.state_from_numpy(jst.theta, jst.weight, jst.iteration, None,
                              "flat", device="cpu", history=jst.history)
    H = N_INIT + 6
    assert st.iteration == H + 1 and st.history.shape == (H, 6, 4)
    np.testing.assert_array_equal(st.history.numpy(),
                                  np.asarray(jst.history, np.float32))
    chains, end = tdm.sample(model, conv, 4, state=st, device="cpu",
                             return_state=True)
    assert end.iteration == H + 5 and chains.data.shape == (4 - 2, 4, 6)
    assert torch.equal(end.history[:H], st.history)
    assert torch.equal(end.history[-1], end.theta)


def test_blocking_config_forms():
    """``DE`` takes a bool ``blocking_on`` as one of the two constant forms
    (the JAX ``config.py:112-119``), keeps a callable, freezes ``blocks``
    to nested tuples of bools (hashable) and refuses an empty list."""
    from demcmc_tpu_torch.config import (_always_blocking_on,
                                         _blocking_const,
                                         _default_blocking_on)
    de = tdm.DE(Np=4, blocking_on=True,
                blocks=[[True, np.array([False, True])], [False, [1, 0]]])
    assert de.blocking_on is _always_blocking_on and _blocking_const(de)
    assert de.blocks == ((True, (False, True)), (False, (True, False)))
    hash(de.blocks)
    assert tdm.DE(Np=4).blocking_on is _default_blocking_on
    assert _blocking_const(tdm.DE(Np=4, blocking_on=False)) is False
    assert _blocking_const(tdm.DE(Np=4, blocking_on=lambda d: True)) is None
    with pytest.raises(ValueError, match="non-empty"):
        tdm.DE(Np=4, blocks=[])
    with pytest.raises(TypeError, match="blocking_on"):
        tdm.DE(Np=4, blocking_on="yes")
