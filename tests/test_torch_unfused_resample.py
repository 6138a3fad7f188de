"""The port's unfused step with DE-MCz, migration between DE-MCz groups and
blocks against the JAX package's XLA step (``build_step(...,
allow_fused=False)``) on the CPU, on the same random words, as
``test_torch_unfused_step.py`` holds ``sample_current``: the JAX pool of
iteration ``it`` (``jax.random.bits(fold_in(step_key(key, it), 0), (G,
pool_words))``) and its scalar side channel's first two draws (the
migration gate and N) are fed to the port's ``Pool``, and one iteration
at a time the port's ``UnfusedStep`` (history row ``it − 1`` written
after the sweeps) against the JAX step's output and history.

A callable ``blocking_on`` is a ``lax.cond`` in the JAX step, which traces
the blocked branch and then the plain one: its pool holds both branches'
columns, and the port's step takes the same ones.

Tolerances as in ``test_torch_unfused_step.py``: θ within 1e-6 +
1e-6·|θ| (XLA on the CPU contracts a·b + c into one fused multiply-add,
which torch does not), w within 1e-5 + 1e-5·|w| (the JAX step scores each
cell with the model's per-cell form, the port with the batched one), the
history row as θ, accept flags exactly, away from near-ties (none at
these seeds).
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
from demcmc_tpu.sampler import SamplerState as JState
from demcmc_tpu.sampler import build_step as jbuild_step

import demcmc_tpu_torch as tdm
from demcmc_tpu_torch import rng as trng
from demcmc_tpu_torch.models import gaussian as tgauss
from demcmc_tpu_torch.models import hierarchical as thier
from demcmc_tpu_torch.models import lba as tlba
from demcmc_tpu_torch.models import mvnormal as tmvn
from demcmc_tpu_torch.ops import accept as taccept
from demcmc_tpu_torch.ops import fused_step as tfused

MVN_DATA = np.asarray(np.random.default_rng(5).standard_normal((40, 3)),
                      np.float32)
GAUSS_DATA = np.random.default_rng(0).standard_normal(50).astype(np.float32)
N_INIT, K = 12, 4
BLOCKS_MVN = [[True, False], [False, True]]


def _switch(de):
    """Blocks from the third iteration of the run on (a function of the
    iteration: a ``lax.cond`` in the JAX step)."""
    return de.iter >= N_INIT + 3


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


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


def _models(name, G, Np, kw):
    kw = dict(Np=Np, n_groups=G, **kw)
    if name == "gauss":
        return (jgauss.make(data=GAUSS_DATA, **kw),
                tgauss.make(data=GAUSS_DATA, **kw))
    kw = dict(sample="resample", n_initial=N_INIT, **kw)
    return (jmvn.make(d=3, data=MVN_DATA, **kw),
            tmvn.make(d=3, data=MVN_DATA, **kw))


def _start(name, C, seed):
    """θ [C, d] near the posterior and, for DE-MCz, the history seeds
    ``[N_INIT, C, d]`` whose row 0 it is."""
    rng = np.random.default_rng(seed)
    if name == "gauss":
        return np.stack([rng.normal(0.1, 0.3, C), rng.uniform(0.6, 1.5, C)],
                        1).astype(np.float32), None
    hist = np.concatenate(
        [rng.normal(MVN_DATA.mean(0), 0.3, (N_INIT, C, 3)),
         np.abs(rng.normal(1.0, 0.2, (N_INIT, C, 1))) + 0.05],
        -1).astype(np.float32)
    return hist[0], hist


def _jax_run(jm, jde, theta0, w0, hist0, key, it0):
    """The JAX XLA step over K iterations from ``it0``: per iteration its
    pool words, its two scalar draws, its output (θ, accept, lp) and the
    history after it."""
    G, Np, d = jde.n_groups, jde.Np, theta0.shape[-1]
    with jax.enable_x64(False):
        step = jbuild_step(jm, jde, jdm.make_spec(jm, jde),
                           allow_fused=False)
        free = dict(zip(step.__code__.co_freevars,
                        (c.cell_contents for c in step.__closure__)))
        n_words = free["pool_words"]
        base = jax.random.PRNGKey(key)
        hist = None
        if hist0 is not None:
            hist = jnp.asarray(np.concatenate(
                [hist0, np.zeros((K,) + hist0.shape[1:], np.float32)]))
        state = JState(theta=jnp.asarray(theta0.reshape(G, Np, d)),
                       weight=jnp.asarray(w0.reshape(G, Np)), key=base,
                       iteration=jnp.int32(it0), history=hist)
        jstep = jax.jit(step)
        pools, scalars, outs, hists = [], [], [], []
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
            hists.append(None if state.history is None
                         else np.asarray(state.history))
    return n_words, pools, scalars, outs, hists


def _fed_pool(bits, scalars):
    return trng.Pool(torch.from_numpy(bits.astype(np.int64)).to(
        torch.uint32), trng.Scalars(values=scalars))


# (case, model, G, Np, DE settings, key)
CASES = [
    ("resample", "mvn", 1, 4, dict(burnin=N_INIT + 2, theta_snooker=0.3), 3),
    ("resample-migration", "mvn", 3, 3,
     dict(burnin=N_INIT + 2, alpha=0.5), 6),
    ("resample-blocks", "mvn", 2, 3,
     dict(burnin=N_INIT + 2, alpha=0.0, theta_snooker=0.2,
          blocks=BLOCKS_MVN, blocking_on=True), 5),
    ("resample-callable-blocking", "mvn", 2, 3,
     dict(burnin=N_INIT + 2, alpha=0.0, blocks=BLOCKS_MVN,
          blocking_on=_switch), 7),
    ("blocks", "gauss", 8, 6,
     dict(burnin=2, blocks=[[True, False], [False, True]],
          blocking_on=True), 9),
]


@pytest.mark.parametrize("name,model_name,G,Np,kw,key", CASES,
                         ids=[c[0] for c in CASES])
def test_unfused_step_matches_jax_xla_step(margins, name, model_name, G,
                                           Np, kw, key):
    """K = 4 iterations of the port's unfused step, fed the JAX pool and
    scalars, against the JAX XLA step: θ, w and the accept flags after each
    and, for DE-MCz, the history row the iteration writes; the port's pool
    is as wide as the JAX one and used to its last column."""
    (jm, jde), (model, de) = _models(model_name, G, Np, kw)
    C = G * Np
    theta0, hist0 = _start(model_name, C, key)
    spec = tdm.make_spec(model, de)
    w0 = taccept.compute_posterior(model, spec, de,
                                   torch.tensor(theta0)).numpy()
    it0 = N_INIT + 1 if hist0 is not None else 1
    n_words, pools, scalars, outs, hists = _jax_run(jm, jde, theta0, w0,
                                                    hist0, key, it0)
    step = tdm.build_step(model, de, spec, device="cpu", allow_fused=False)
    assert isinstance(step, tdm.UnfusedStep)
    assert step.pool_words == n_words
    state = tdm.state_from_numpy(theta0, w0, it0, None, "flat",
                                 device="cpu", history=None if hist0 is None
                                 else np.concatenate(
                                     [hist0, np.zeros((K, C, spec.dim))]))
    step.draws = lambda key_, it: _fed_pool(pools[it - it0],
                                            scalars[it - it0])
    out = (torch.empty(C, spec.dim), torch.empty(C), torch.empty(
        C, dtype=torch.bool))
    gates = []
    for k in range(K):
        state = step(state, out)
        gates.append(scalars[k][0] <= np.float32(de.alpha))
        jt, ja, jw = outs[k]
        np.testing.assert_allclose(out[0].numpy(), jt, rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(out[1].numpy(), jw, rtol=1e-5, atol=1e-5)
        np.testing.assert_array_equal(out[2].numpy(), ja)
        if hist0 is not None:
            row = it0 + k - 1
            np.testing.assert_allclose(state.history[row].numpy(),
                                       hists[k][row], rtol=1e-6, atol=1e-6)
            assert torch.equal(state.history[row], state.theta)
            assert not state.history[row + 1:].any()
    assert all((m.abs() > 1e-4).all() for m in margins), "near-tie"
    if name == "resample-migration":
        assert set(gates) == {True, False}         # gate open and closed
    if "blocking" in name:
        flags = [bool(_switch(tdm.sampler._DEView(de, it0 + k)))
                 for k in range(K)]
        assert set(flags) == {True, False}          # both branches ran


@pytest.mark.parametrize("which", ["mvn-d5", "lba", "hierarchical"])
def test_models_without_k3_density_run_demcmc_unfused(which):
    """DE-MCz of a model without a K3 density (an MVN of width 5, LBA, the
    hierarchical model) takes the unfused step, chosen from the model and
    the configuration alone, and samples on the CPU; the kernels' step
    refuses such a model on a CUDA device."""
    if which == "mvn-d5":
        model, de = tmvn.make(d=5, n_obs=20, burnin=5)
    elif which == "lba":
        model, de = tlba.make(n_trials=20, sample="resample", n_initial=10,
                              Np=4, n_groups=2, burnin=5)
        assert model.cuda_density.name == "lba"
    else:
        model, de = thier.make(n_subj=3, n_data=5, burnin=5)
    assert de.uses_resample
    spec = tdm.make_spec(model, de)
    assert not tdm.sampler.fused_supported(model, de)
    assert isinstance(tdm.build_step(model, de, spec, "cpu"),
                      tdm.UnfusedStep)
    with pytest.raises(ValueError, match="CUDA density|built for"):
        tdm.sampler.Step(model, de, spec, "cuda")
    chains, end = tdm.sample(model, de, 12, key=2, device="cpu",
                             return_state=True)
    assert chains.data.shape == (7, spec.dim, de.n_chains)
    assert np.isfinite(chains.lp).all()
    assert torch.equal(end.history[-1], end.theta)


def test_group_past_block_chains_takes_unfused_step(monkeypatch):
    """The kernels' step takes a configuration only where a group fits one
    block of its kernel: on the CPU the launch's static 1,024 chains; with
    the rule stubbed to 8 chains, a group of 16 takes the unfused step and
    one of 8 the kernels', for K1 and for K3."""
    model, de = tgauss.make(data=GAUSS_DATA, Np=16, n_groups=2)
    assert tdm.sampler.fused_supported(model, de)
    assert not tdm.sampler.fused_supported(model, de.replace(Np=1025,
                                                             n_groups=1))
    seen = []

    def stub(resample, density, seq, snooker, n_blocks, device):
        seen.append((resample, density.name, seq, snooker, n_blocks))
        return 8
    monkeypatch.setattr(tfused, "block_chains", stub)
    for kw in ({}, {"sample": "resample", "n_initial": 4},
               {"blocks": [[True, False], [False, True]],
                "blocking_on": True}):
        big = de.replace(**kw)
        spec = tdm.make_spec(model, big)
        assert isinstance(tdm.build_step(model, big, spec, "cpu"),
                          tdm.UnfusedStep)
        small = big.replace(Np=8)
        assert type(tdm.build_step(model, small, spec,
                                   "cpu")) is tdm.sampler.Step
    assert seen[0][1] == "gaussian"
    assert {s[0] for s in seen} == {True, False}
    assert {s[4] for s in seen} == {1, 2}
