"""``demcmc_tpu_torch.parallel.distributed`` (the JAX package's
``parallel.distributed`` over ``torch.distributed``) on the CPU.

(a) With no process group: ``initialize()`` is a no-op, ``is_coordinator()``
    is True and ``global_chain_mesh()`` is ``chain_mesh()`` (which raises
    without a card); the backend follows the layout; a rank without a
    card and no ``device="cpu"`` raises before it joins.
(b) Two gloo CPU processes (one spawn for the module): ``sample(mesh=
    global_chain_mesh())`` on the Gaussian with α = 0.5 (the kernels'
    step), the unfused Gaussian and the mcz-mig DE-MCz Gaussian, and
    ``optimize`` of the Gaussian MLE; every rank's result equals the
    single-process unsharded run bit for bit.
(c) What a run over several processes refuses: checkpoints, the monitor,
    a data axis and a replicated run (ROADMAP.md A10 rest 6).
"""

import os
import queue

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

import demcmc_tpu_torch as tdm
from demcmc_tpu_torch.parallel import distributed as tdist
from demcmc_tpu_torch.models import gaussian as tgauss

DATA = np.asarray(np.random.default_rng(3).normal(0.3, 1.2, 50), np.float32)
N_ITER, WORLD = 24, 2


def _cases():
    """name -> (model, de, sample()'s options); "opt" runs optimize."""
    kw = {"Np": 4, "n_groups": 8, "burnin": 12, "discard_burnin": False}
    mcz = {"n_groups": 128, "Np": 4, "n_initial": 50, "theta_snooker": 0.1,
           "alpha": 0.1, "sweep": "sync", "sample": "resample",
           "burnin": 12, "discard_burnin": False}
    return {
        "gauss": (*tgauss.make(data=DATA, alpha=0.5, **kw), {}),
        "unfused": (*tgauss.make(data=DATA, alpha=0.5, **kw),
                    {"allow_fused": False}),
        "mcz-mig": (*tgauss.make(data=DATA, **mcz), {}),
        "opt": (*tgauss.make_mle(data=DATA, alpha=0.5, Np=4, n_groups=8,
                                 burnin=12), {}),
    }


def _refusals(mesh, tmp):
    """The message of each refusal of a run over several processes."""
    model, de, _ = _cases()["gauss"]
    out = {}
    for name, call in (
            ("checkpoint", lambda: tdm.sample(
                model, de, 8, mesh=mesh, checkpoint_every=4,
                checkpoint_path=os.path.join(tmp, "ck"))),
            ("monitor", lambda: tdm.sample(model, de, 8, mesh=mesh,
                                           monitor=True)),
            ("data", lambda: tdm.parallel.shard_data(
                DATA, tdm.parallel.data_mesh(1, 2, devices=["cpu"] * 2))),
            ("replicated", lambda: tdm.sample_replicated(
                tgauss.make_model, de, 8, np.stack([DATA, DATA]),
                mesh=mesh))):
        try:
            call()
            out[name] = None
        except NotImplementedError as e:
            out[name] = str(e)
    return out


def _rank(rank, init, tmp, q):
    torch.set_num_threads(1)
    try:
        lay = tdist.initialize(init, WORLD, rank, device="cpu")
        mesh = tdist.global_chain_mesh()
        out = {"layout": (lay.backend, str(lay.device), lay.staged),
               "owners": mesh.owners, "coordinator": tdist.is_coordinator()}
        for name, (model, de, kw) in _cases().items():
            if name == "opt":
                pop = tdm.optimize(model, de, N_ITER, key=7, mesh=mesh)
                out[name] = (pop.theta, pop.weight)
                continue
            chains, state = tdm.sample(model, de, N_ITER, key=5, mesh=mesh,
                                       return_state=True, **kw)
            out[name] = (chains.data, chains.lp, chains.acceptance,
                         state.theta.numpy(),
                         None if state.history is None
                         else state.history.numpy())
        out["refusals"] = _refusals(mesh, tmp)
        q.put((rank, out))
    except Exception as e:              # the parent reports it
        q.put((rank, repr(e)))
        raise
    finally:
        if torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Each rank's results from one spawn of two gloo CPU processes
    joined through a file in a temporary directory."""
    tmp = str(tmp_path_factory.mktemp("dist"))
    init = "file://" + os.path.join(tmp, "rendezvous")
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    procs = [ctx.Process(target=_rank, args=(r, init, tmp, q))
             for r in range(WORLD)]
    for p in procs:
        p.start()
    got = {}
    try:
        for _ in procs:
            r, out = q.get(timeout=240)
            got[r] = out
    except queue.Empty:
        pass
    finally:
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
    for r in range(WORLD):
        assert isinstance(got.get(r), dict), f"rank {r}: {got.get(r)}"
    return got


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------------------ (a)


def test_initialize_is_a_noop_without_a_cluster(monkeypatch):
    for k in tdist.ENV + ("LOCAL_RANK", "LOCAL_WORLD_SIZE"):
        monkeypatch.delenv(k, raising=False)
    assert tdist.initialize() is None
    assert not tdist.is_active() and tdist.layout() is None
    assert tdist.is_coordinator() and tdist.rank() == 0
    assert tdist.world_size() == 1
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tdist.global_chain_mesh()


def test_backend_follows_the_layout(monkeypatch):
    """NCCL where each rank has a card, gloo through pinned memory where
    ranks share one, gloo for CPU ranks; a rank with no card raises
    unless given ``device="cpu"``."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert tdist._choose(None, None, 1, 1, 2) == tdist.Layout(
        "nccl", torch.device("cuda", 1), False)
    assert tdist._choose(None, None, 3, 3, 4) == tdist.Layout(
        "gloo", torch.device("cuda", 1), True)
    assert tdist._choose("cpu", None, 0, 0, 4) == tdist.Layout(
        "gloo", torch.device("cpu"), False)
    with pytest.raises(ValueError, match="CPU rank takes gloo"):
        tdist._choose("cpu", "nccl", 0, 0, 1)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(RuntimeError, match="rank 0 has no CUDA device"):
        tdist._choose(None, None, 0, 0, 1)


def test_initialize_without_a_card_raises_before_joining(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tdist.initialize("file://" + str(tmp_path / "rdv"), 1, 0)
    assert not tdist.is_active()


# ------------------------------------------------------------------ (b)


def test_ranks_own_their_shards(ranks):
    for r, out in ranks.items():
        assert out["layout"] == ("gloo", "cpu", False)
        assert out["owners"] == [0, 1]
        assert out["coordinator"] is (r == 0)


@pytest.mark.parametrize("case", ["gauss", "unfused", "mcz-mig", "opt"])
def test_every_rank_returns_the_unsharded_run(ranks, case):
    model, de, kw = _cases()[case]
    if case == "opt":
        ref = tdm.optimize(model, de, N_ITER, key=7, device="cpu")
        want = (ref.theta, ref.weight)
    else:
        chains, state = tdm.sample(model, de, N_ITER, key=5, device="cpu",
                                   return_state=True, **kw)
        want = (chains.data, chains.lp, chains.acceptance,
                state.theta.numpy(),
                None if state.history is None else state.history.numpy())
    for r, out in ranks.items():
        for got, ref in zip(out[case], want):
            if ref is None:
                assert got is None
            else:
                np.testing.assert_array_equal(got, ref, err_msg=f"rank {r}")


# ------------------------------------------------------------------ (c)


@pytest.mark.parametrize("what", ["checkpoint", "monitor", "data",
                                  "replicated"])
def test_a_run_over_processes_refuses(ranks, what):
    for r, out in ranks.items():
        msg = out["refusals"][what]
        assert msg is not None and "ROADMAP.md A10 rest 6" in msg, (r, msg)
