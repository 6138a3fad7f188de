"""The port's chunked run (``sampler.run_scan``, ``chunk_schedule``)
against the JAX package's ``run_scan`` chunk loop, and against the
port's own one-chunk run and ``run_loop`` on the CPU: the chunk schedule
equals the JAX loop's, a chunked ``sample()`` is bit for bit the run
without chunks (so no option changes a draw), and only the rows a run
keeps are stored."""

import io
import re
import contextlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import demcmc_tpu as jdm
from demcmc_tpu.models import gaussian as jgauss
from demcmc_tpu.sampler import StepOutput as JOut
from demcmc_tpu.sampler import run_scan as jrun_scan

import demcmc_tpu_torch as tdm
from demcmc_tpu_torch import sampler as tsampler
from demcmc_tpu_torch.models import gaussian as tgauss

DATA = np.random.default_rng(4).standard_normal(20).astype(np.float32)


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class _Chunks:
    """A monitor that records the stored rows of each chunk."""

    def __init__(self):
        self.sizes = []

    def update(self, x):
        self.sizes.append(int(np.asarray(x).shape[0]))

    def max_rhat(self):
        return None


def _jstep(s, _=None):
    return s + 1.0, JOut(theta=s * jnp.ones((1, 1)),
                         accept=jnp.zeros((1,), bool), lp=s * jnp.ones(1))


def _jax_chunks(n_iter, thin, every, progress, stop, switch):
    mon = _Chunks()
    phase2 = None if switch is None else (_jstep, switch)
    with contextlib.redirect_stdout(io.StringIO()):
        jrun_scan(_jstep, jnp.zeros(()), n_iter, progress=progress,
                  checkpoint_every=every, thin=thin, monitor=mon,
                  stop_check=(lambda: False) if stop else None,
                  phase2=phase2)
    return [m for m in mon.sizes]


def _port_chunks(n_iter, thin, every, progress, stop):
    """The port's run_scan on a small Gaussian (the kernels' step on the
    CPU, no phase-2 switch), the rows of each chunk as its monitor sees
    them."""
    model, de = tgauss.make(data=DATA, Np=4, n_groups=2, burnin=0,
                            alpha=0.3)
    spec = tdm.make_spec(model, de)
    step = tdm.build_step(model, de, spec, device="cpu")
    state = tdm.init_state(model, de, spec, 3, device="cpu")
    mon = _Chunks()
    with contextlib.redirect_stdout(io.StringIO()):
        tsampler.run_scan(step, state, n_iter, thin, progress=progress,
                          checkpoint_every=every, monitor=mon,
                          stop_check=(lambda: False) if stop else None)
    return mon.sizes


GRID = [  # n_iter, thin, checkpoint_every, progress, stop_rhat, switch
    (30, 1, 0, False, False, None), (30, 1, 7, False, False, None),
    (97, 1, 0, True, False, None), (97, 1, 25, True, False, None),
    (120, 3, 0, False, True, None), (120, 3, 35, False, False, None),
    (120, 3, 35, True, False, 9), (120, 3, 7, False, False, 10),
    (60, 1, 0, True, False, 13), (60, 1, 1000, False, True, 59),
    (90, 10, 25, False, False, 40), (64, 2, 3, True, True, None),
]


@pytest.mark.parametrize("n_iter,thin,every,progress,stop,switch", GRID)
def test_chunk_schedule_equals_the_jax_run_scan(n_iter, thin, every,
                                                progress, stop, switch):
    """``chunk_schedule`` is the JAX loop's chunking: the rows each chunk
    hands its monitor, for checkpoint intervals in iterations (rounded up
    to outer steps), 20 chunks with progress or stop_rhat, and the cut at
    a phase-2 switch on an outer step (the JAX package has no phase 2
    elsewhere; the port's windows take a switch off the outer grid inside
    a chunk)."""
    want = _jax_chunks(n_iter, thin, every, progress, stop,
                       switch if switch is None or switch % thin == 0
                       else None)
    got = tsampler.chunk_schedule(n_iter, thin, every, progress, stop,
                                  switch)
    assert got == want
    if switch is None:
        assert _port_chunks(n_iter, thin, every, progress, stop) == want


_LINE = re.compile(r"\[demcmc_tpu(?:_torch)?\] (\d+)/(\d+) iterations")


@pytest.mark.parametrize("n_iter,thin,monitor", [(60, 1, False),
                                                 (90, 3, True)])
def test_progress_lines_count_as_the_jax_package(n_iter, thin, monitor,
                                                 capsys):
    """``sample(progress=True)`` prints the JAX package's progress line
    under the prefix ``[demcmc_tpu_torch]``, at the same iteration counts
    (a configuration where neither package cuts at a switch: no
    burn-in), with R̂max when monitoring."""
    jmodel, jde = jgauss.make(key=0, n_obs=20, n_groups=2, Np=4, burnin=0)
    jdm.sample(jmodel, jde, n_iter, key=1, thin=thin, progress=True,
               monitor=monitor)
    jout = capsys.readouterr().out
    model, de = tgauss.make(data=np.asarray(jmodel.data, np.float32),
                            n_groups=2, Np=4, burnin=0)
    tdm.sample(model, de, n_iter, key=1, thin=thin, progress=True,
               monitor=monitor, device="cpu")
    tout = capsys.readouterr().out
    jc = [m.groups() for m in _LINE.finditer(jout)]
    tc = [m.groups() for m in _LINE.finditer(tout)]
    assert tc == jc
    assert len(tc) == len(tsampler.chunk_schedule(n_iter, thin, 0, True))
    assert tc[-1] == (str(n_iter), str(n_iter))
    assert "[demcmc_tpu_torch]" in tout
    assert ("R̂max" in tout) == monitor == ("R̂max" in jout)


def _same(a, b):
    for x, y in ((a.data, b.data), (a.lp, b.lp),
                 (a.acceptance, b.acceptance)):
        assert x.shape == y.shape and x.tobytes() == y.tobytes()


def _same_state(a, b):
    assert a.iteration == b.iteration
    for k in ("theta", "weight", "fire", "history"):
        x, y = getattr(a, k), getattr(b, k)
        assert (x is None) == (y is None), k
        if x is not None:
            assert torch.equal(x, y), k


def _loop(model, de, n_iter, key, thin, allow_fused=True):
    spec = tdm.make_spec(model, de)
    state = tsampler._grow_history(
        tdm.init_state(model, de, spec, key, device="cpu"), n_iter)
    step = tdm.build_step(model, de, spec, device="cpu",
                          allow_fused=allow_fused)
    state, ys = tsampler.run_loop(step, state, n_iter, thin)
    return tsampler.bundle_samples(model, de, spec, ys, n_iter, thin), state


def _edge_gates(model, de, n_iter, key, every):
    """Chunk edges (every ``every`` iterations) where a gate opens."""
    spec = tdm.make_spec(model, de)
    step = tdm.build_step(model, de, spec, device="cpu")
    state = tdm.init_state(model, de, spec, key, device="cpu")
    return [w.it0 - state.iteration for w in step.plan(state, n_iter)
            if w.migrate and (w.it0 - state.iteration) % every == 0
            and w.it0 > state.iteration]


CASES = {
    "thin1-discard": (dict(), 1, True),
    "thin3-discard": (dict(), 3, True),
    "thin1-keep": (dict(), 1, False),
    "thin3-keep": (dict(), 3, False),
    "switch-inside-a-chunk": (dict(), 4, False),   # burn-in 30, thin 4
    "k3": (dict(sample="resample", n_initial=12, Np=4, sweep="sync"), 1,
           True),
    "k3-thin3": (dict(sample="resample", n_initial=12, Np=4,
                      sweep="sync"), 3, False),
}


@pytest.mark.parametrize("case", list(CASES))
def test_chunked_sample_is_the_one_chunk_run(case):
    """``sample()`` with chunks (progress, a checkpoint interval of 1 and
    of 7 iterations, so every gate opens at a chunk's edge) is bit for bit
    ``sample()`` without them and the one-launch-per-iteration loop's kept
    rows, its final state too; K1's and K3's plain versions, with
    migration (α = 0.5)."""
    kw, thin, discard = CASES[case]
    kw = {"Np": 5, **kw}
    model, de = tgauss.make(data=DATA, n_groups=4, burnin=30, alpha=0.5,
                            discard_burnin=discard, **kw)
    n = 84
    assert _edge_gates(model, de, n, 2, 1)
    ref = tdm.sample(model, de, n, key=2, thin=thin, device="cpu",
                     return_state=True)
    loop = _loop(model, de, n, 2, thin)
    _same(ref[0], loop[0])
    _same_state(ref[1], loop[1])
    for opts in ({"progress": True}, {"checkpoint_every": 1},
                 {"checkpoint_every": 7, "monitor": True}):
        with contextlib.redirect_stdout(io.StringIO()):
            got = tdm.sample(model, de, n, key=2, thin=thin, device="cpu",
                             return_state=True, **opts)
        _same(got[0], ref[0])
        _same_state(got[1], ref[1])


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_chunked_unfused_step_with_blocks(dtype):
    """The unfused step (two blocks, a callable ``blocking_on``, float32
    and float64) keeps its one iteration at a time within each chunk: bit
    for bit the run without chunks and ``run_loop``."""
    model, de = tgauss.make(
        data=DATA, n_groups=3, Np=4, burnin=10, alpha=0.5, dtype=dtype,
        blocks=[[True, False], [False, True]],
        blocking_on=lambda d: d.iter % 3 == 0)
    ref = tdm.sample(model, de, 40, key=5, device="cpu", allow_fused=False,
                     return_state=True)
    _same(ref[0], _loop(model, de, 40, 5, 1, allow_fused=False)[0])
    with contextlib.redirect_stdout(io.StringIO()):
        got = tdm.sample(model, de, 40, key=5, device="cpu",
                         allow_fused=False, return_state=True,
                         progress=True, checkpoint_every=3)
    _same(got[0], ref[0])
    _same_state(got[1], ref[1])
    assert got[0].data.dtype == dtype


@pytest.mark.parametrize("allow_fused", [True, False])
def test_chunked_mesh_run_is_the_unsharded_run(allow_fused):
    """On a 2-shard CPU mesh, chunked (progress, a checkpoint interval
    that the chunks do not divide, the monitor) and not: bit for bit the
    unsharded run without chunks, the shards' chains side by side."""
    model, de = tgauss.make(data=DATA, n_groups=4, Np=4, burnin=20,
                            alpha=0.5)
    ref = tdm.sample(model, de, 60, key=7, device="cpu",
                     allow_fused=allow_fused, return_state=True)
    mesh = tdm.chain_mesh(devices=["cpu"] * 2)
    for opts in ({}, {"progress": True, "checkpoint_every": 7,
                      "monitor": True}):
        with contextlib.redirect_stdout(io.StringIO()):
            got = tdm.sample(model, de, 60, key=7, mesh=mesh,
                             allow_fused=allow_fused, return_state=True,
                             **opts)
        _same(got[0], ref[0])
        _same_state(got[1], ref[1])


@pytest.mark.parametrize("thin,discard", [(1, True), (3, True),
                                          (1, False)])
def test_only_the_kept_rows_are_stored(thin, discard, monkeypatch):
    """With ``discard_burnin`` the run stores no burn-in row: the
    trajectory holds ``n_iter/thin − burnin/thin`` rows (all of them
    without it), the burn-in windows store nothing, and ``state.fire`` is
    read once (one plan) however many chunks the run has."""
    made, plans = [], []
    rows_init, plan = tsampler._Rows.__init__, tsampler.Step.plan

    def rows(self, T, *a, **kw):
        made.append(T)
        rows_init(self, T, *a, **kw)

    def count_plan(self, *a, **kw):
        out = plan(self, *a, **kw)
        plans.append(out)
        return out
    monkeypatch.setattr(tsampler._Rows, "__init__", rows)
    monkeypatch.setattr(tsampler.Step, "plan", count_plan)
    model, de = tgauss.make(data=DATA, n_groups=4, Np=4, burnin=30,
                            alpha=0.3, discard_burnin=discard)
    with contextlib.redirect_stdout(io.StringIO()):
        chains = tdm.sample(model, de, 90, key=1, thin=thin, device="cpu",
                            progress=True)
    kept = 90 // thin - (30 // thin if discard else 0)
    assert made == [kept] and len(chains) == kept
    assert len(plans) == 1
    burn = [w for w in plans[0] if w.it0 + w.K - 1 <= 30]
    assert burn and all(w.n_emit == 0 for w in burn) == discard
    assert sum(w.n_emit for w in plans[0]) == kept


def test_optimize_progress(capsys):
    """``optimize(progress=True)`` prints the progress line and returns
    the population it returns without it."""
    from demcmc_tpu_torch.models import rastrigin
    model, de = rastrigin.make(Np=4, n_groups=2, burnin=5)
    a = tdm.optimize(model, de, 40, key=1, device="cpu")
    capsys.readouterr()
    b = tdm.optimize(model, de, 40, key=1, device="cpu", progress=True)
    out = capsys.readouterr().out
    np.testing.assert_array_equal(a.theta, b.theta)
    np.testing.assert_array_equal(a.weight, b.weight)
    counts = [int(m.group(1)) for m in _LINE.finditer(out)]
    assert counts == list(range(2, 41, 2))
