"""The unfused step's sweeps as a CUDA graph (``sampler._SweepGraph``):
its bookkeeping on the CPU.  A CPU step keeps every iteration eager; a
test turns the graph path on (``step._graphs = {}``), where the recorded
call reruns on the static inputs in place of a replay: the iteration's
words copied into the graph's buffer in the eager pool's layout, θ and w
copied in, DE-MCz's span read from the iteration as an int64 tensor, the
eager pool moved past the sweeps' columns.  Every run must equal the
eager run bit for bit.  The graph itself is held on the card by
``chip_smoke.py`` (``[main-hier]``, ``[main-unfused-gauss]``: graphed
against eager bit for bit) and ``tools/unfused_graph_ab.py``.
"""

import numpy as np
import pytest
import torch

import demcmc_tpu_torch as tdm
from demcmc_tpu_torch import rng, sampler
from demcmc_tpu_torch.models import (binomial, gaussian, hierarchical,
                                     lotka_volterra)
from demcmc_tpu_torch.ops import _build

DATA = np.random.default_rng(0).standard_normal(50).astype(np.float32)


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def graphed(monkeypatch):
    """Steps built in the test take the graph path on the CPU (where an
    eligible step would on the card); returns the steps made."""
    made = []
    init = sampler.UnfusedStep.__init__

    def force(self, *a, **k):
        init(self, *a, **k)
        if sampler.GRAPHS and not (self.custom or self.n_noise
                                   or self.g0 is not None):
            self._graphs = {}
        made.append(self)
    monkeypatch.setattr(sampler.UnfusedStep, "__init__", force)
    return made


CASES = {
    "hier": (lambda: hierarchical.make(n_subj=5, n_data=10, key=0,
                                       burnin=10), 30),
    "snooker": (lambda: gaussian.make(data=DATA, Np=8, n_groups=4, burnin=10,
                                      theta_snooker=0.2, alpha=0.3), 30),
    "blocks": (lambda: gaussian.make(data=DATA, Np=8, n_groups=4, burnin=10,
                                     blocks=((True, False), (False, True)),
                                     blocking_on=True), 30),
    "blocks-fn": (lambda: gaussian.make(
        data=DATA, Np=8, n_groups=4, burnin=10,
        blocks=((True, False), (False, True)),
        blocking_on=lambda de: de.iter % 3 == 0), 30),
    "mcz": (lambda: gaussian.make(data=DATA, Np=4, n_groups=4, burnin=30,
                                  sample="resample", n_initial=20,
                                  theta_snooker=0.1, alpha=0.3,
                                  sweep="sync"), 50),
    "mutation": (lambda: gaussian.make(data=DATA, Np=4, n_groups=4,
                                       burnin=10, beta=0.3, alpha=0.5), 30),
    "f64-mcz": (lambda: gaussian.make(data=DATA, Np=8, n_groups=4, burnin=30,
                                      dtype=np.float64, sample="resample",
                                      n_initial=20), 45),
    "abc-fixed": (lambda: binomial.make(abc=True, n_groups=4, Np=4,
                                        burnin=5, n_sim=100), 12),
    "lv": (lambda: lotka_volterra.make(Np=4, n_groups=2, burnin=3), 6),
}


def _draws(model, de, n_iter):
    with torch.inference_mode():
        ch = tdm.sample(model, de, n_iter, key=3, allow_fused=False,
                        device="cpu")
    return np.asarray(ch.data), np.asarray(ch.acceptance)


@pytest.mark.parametrize("name", list(CASES))
def test_graph_path_is_the_eager_run_bit_for_bit(name, graphed):
    make, n_iter = CASES[name]
    model, de = make()
    x, acc = _draws(model, de, n_iter)
    step = graphed[-1]
    assert step._graphs, "the run took no graph"
    assert all(isinstance(g, sampler._SweepGraph)
               for g in step._graphs.values())
    sampler.GRAPHS = False
    try:
        x0, acc0 = _draws(model, de, n_iter)
    finally:
        sampler.GRAPHS = True
    assert graphed[-1]._graphs is None
    assert x.tobytes() == x0.tobytes() and acc.tobytes() == acc0.tobytes()


def test_a_port_launch_in_the_density_keeps_the_step_eager(graphed):
    """A density that launches a kernel of the port (counted by its
    wrapper at each launch, which a replay would skip) leaves the step
    eager after its first iteration, with the eager run's draws."""
    model, de = gaussian.make(data=DATA, Np=8, n_groups=4, burnin=10)
    inner = model.loglike_batched

    def launching(*args):
        _build.launch.calls += 1
        return inner(*args)
    model.loglike_batched = launching
    x, acc = _draws(model, de, 20)
    assert graphed[-1]._graphs is None
    sampler.GRAPHS = False
    try:
        x0, acc0 = _draws(model, de, 20)
    finally:
        sampler.GRAPHS = True
    assert x.tobytes() == x0.tobytes() and acc.tobytes() == acc0.tobytes()


def test_cpu_custom_stochastic_and_shard_steps_stay_eager():
    """On the CPU every step is eager; a custom slot, a stochastic model
    and a shard of a chain mesh never take graphs."""
    model, de = gaussian.make(data=DATA, Np=8, n_groups=4, burnin=10)
    spec = tdm.make_spec(model, de)
    assert sampler.UnfusedStep(model, de, spec, "cpu")._graphs is None
    m2, de2 = binomial.make(abc=True, fresh_noise=True, n_groups=4, Np=4,
                            burnin=5, n_sim=100)
    step = sampler.UnfusedStep(m2, de2, tdm.make_spec(m2, de2), "cpu")
    assert step._graphs is None and step.n_noise


def test_rows_seen_as_a_tensor_draws_the_same_partners():
    """DE-MCz's span from the iteration as an int64 tensor (a captured
    pool) draws the host int's partner indices."""
    words = torch.randint(0, 2 ** 32, (4, 16), dtype=torch.int64).to(
        torch.uint32)
    for it in (1, 2, 37, 1 << 20):
        host = rng.Pool(words, rng.Scalars(()))
        dev = rng.Pool(words, rng.Scalars(()))
        dev.it_tensor = torch.tensor(it, dtype=torch.int64)
        a = host.randuint((4, 2), (host.rows_seen(it) * 512 - 1) & 0xFFFFFFFF)
        b = dev.randuint((4, 2), (dev.rows_seen(it) * 512 - 1) & 0xFFFFFFFF)
        assert torch.equal(a, b)
