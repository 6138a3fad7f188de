"""Faults of the port's API against the JAX package, and R̂ with its
table of ndtri values: ``DE.uses_snooker``; a ``DE`` with array bounds
compared and hashed by content; ``sample(progress=)``; rank-normalized R̂,
bulk ESS and ``Chains.rhat()`` bit for bit the JAX package's scipy-based
functions on draws with ties and signed zeros."""

import numpy as np
import pytest
import torch

import demcmc_tpu as jdm
from demcmc_tpu import diagnostics as jdiag

import demcmc_tpu_torch as tdm
from demcmc_tpu_torch import diagnostics as tdiag
from demcmc_tpu_torch.models import gaussian as tgauss

torch.set_num_threads(1)


@pytest.mark.parametrize("theta_snooker", [0.0, 0.1, 1.0])
def test_de_uses_snooker_as_jax(theta_snooker):
    kw = dict(Np=6, theta_snooker=theta_snooker)
    assert tdm.DE(**kw).uses_snooker is jdm.DE(**kw).uses_snooker
    assert tdm.DE(**kw).uses_snooker is (theta_snooker > 0.0)


def test_de_with_array_bounds_compares_and_hashes_by_content():
    b = np.array([[0, 1], [0, 2]])
    d1 = tdm.DE(Np=6, bounds=b)
    d2 = tdm.DE(Np=6, bounds=b.copy())
    d3 = tdm.DE(Np=6, bounds=np.array([[0, 1], [0, 3]]))
    assert d1 == d2 and hash(d1) == hash(d2)
    assert d1 != d3 and not (d1 == d3)
    assert d1 != tdm.DE(Np=6, bounds=b, alpha=0.2)
    assert d1 != tdm.DE(Np=6, bounds=np.array([[0, 1, 0, 2]]))   # shape
    assert {d1: 1, d3: 3}[d2] == 1
    assert tdm.DE(Np=6, bounds=[(0, 1), (0, 2)]) == \
        tdm.DE(Np=6, bounds=((0, 1), (0, 2)))
    assert d1.replace(bounds=b.copy()) == d1
    assert (d1 == "DE") is False


def test_sample_takes_progress_false_and_raises_for_true(capsys):
    """``progress=False`` is accepted (fault F6), and ``progress=True``,
    which raised until the chunked run was ported, prints the progress
    line and gives the same draws."""
    model, de = tgauss.make(Np=6, n_groups=2, burnin=4)
    a = tdm.sample(model, de, 8, device="cpu", progress=False)
    b = tdm.sample(model, de, 8, device="cpu")
    np.testing.assert_array_equal(a.data, b.data)
    assert capsys.readouterr().out == ""
    c = tdm.sample(model, de, 8, device="cpu", progress=True)
    np.testing.assert_array_equal(a.data, c.data)
    out = capsys.readouterr().out
    assert "[demcmc_tpu_torch] 8/8 iterations" in out


def _tied_draws(seed, n=300, c=12):
    rng_ = np.random.default_rng(seed)
    x = rng_.standard_normal((n, c)).cumsum(axis=0) * 0.1 \
        + rng_.standard_normal((n, c))
    x[:, 2] = np.round(x[:, 2], 1)                   # runs of ties
    x[:, 5] = np.round(x[:, 5])                      # long runs of ties
    x[: n // 3, 7] = 0.0
    x[n // 3: n // 2, 7] = -0.0                      # ±0 tie with each other
    x[:, 9] = np.where(x[:, 9] > 0, x[:, 9], -0.0)
    return x


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("fn", ["rank_normalized_rhat", "ess_bulk"])
def test_rank_diagnostics_bitwise_jax_with_ties_and_signed_zeros(fn, seed):
    """Calls on their own tables, then on one shared dict of tables: each
    call after the first reuses (and grows) its size's table, sizes mixed."""
    x = _tied_draws(seed)
    want = [getattr(jdiag, fn)(v) for v in (x, x[:, 7], x[:, 9], x[:200])]
    tables = {}
    for kw in ({}, {"tables": tables}, {"tables": tables}):
        got = [getattr(tdiag, fn)(v, **kw)
               for v in (x, x[:, 7], x[:, 9], x[:200])]
        assert np.array_equal(np.array(got).view(np.int64),
                              np.array(want).view(np.int64))
    assert len(tables) == 3


@pytest.mark.parametrize("shape", [(1000, 8), (41, 3), (7, 5)])
def test_rank_normalize_equals_direct_ndtri_of_ranks(shape):
    """The table's scores are ``ndtri`` of the average ranks' quantiles, bit
    for bit, at every size (a fresh table, the same table again, and a
    call's own)."""
    x = np.round(np.random.default_rng(3).normal(size=shape), 1)
    x[0, 0], x[-1, -1] = -0.0, 0.0
    ranks = tdiag.rankdata_average(x)
    direct = tdiag.ndtri((ranks - 3.0 / 8.0) /
                         (x.size - 2.0 * 3.0 / 8.0 + 1.0)).reshape(shape)
    tables = {}
    for _ in range(2):
        np.testing.assert_array_equal(tdiag._rank_normalize(x, tables),
                                      direct)
    np.testing.assert_array_equal(tdiag._rank_normalize(x), direct)
    assert tdiag._rank_normalize(np.empty((0, 3))).shape == (0, 3)


def test_chains_rhat_and_ess_bitwise_jax():
    rng_ = np.random.default_rng(5)
    data = np.round(rng_.normal(size=(240, 3, 16)), 2)
    data[:30, 1, :4] = -0.0
    data[30:60, 1, :4] = 0.0
    names = ["a", "b", "c"]
    acc, lp = np.zeros((240, 16)), np.zeros((240, 16))
    tc = tdm.Chains(data, names, acc, lp)
    jc = jdm.Chains(data, names, acc, lp)
    for got, want in ((tc.rhat(), jc.rhat()), (tc.ess(), jc.ess()),
                      (tc.rhat("b"), jc.rhat("b"))):
        assert np.array_equal(np.asarray(got, np.float64).view(np.int64),
                              np.asarray(want, np.float64).view(np.int64))


def _float32_draws(seed, n=300, c=12):
    """float64 draws whose values are all float32, as a sampler's are:
    chains that repeat a draw (rejections), ±0, ±inf, subnormals and the
    float32 extremes."""
    g = np.random.default_rng(seed)
    x = np.repeat(g.standard_normal((n // 3, c)), 3, axis=0)
    x += g.standard_normal((n, 1)).cumsum(axis=0) * 0.1
    x = x.astype(np.float32)
    tiny, big = np.float32(1e-45), np.finfo(np.float32).max
    x[:20, 0], x[20:40, 0] = 0.0, -0.0
    x[:5, 1], x[5:10, 1], x[10:15, 1], x[15:20, 1] = tiny, -tiny, big, -big
    x[:3, 2], x[3:6, 2] = np.inf, -np.inf
    return x.astype(np.float64)


def _argsort_ranks(a):
    """Average ranks by one argsort of the values (the sort the order keys
    replace), scipy's ``rankdata(method="average")`` algorithm."""
    a = a.reshape(-1)
    sorter = np.argsort(a)
    arr = a[sorter]
    obs = np.r_[True, arr[1:] != arr[:-1]]
    dense = obs.cumsum()
    count = np.r_[np.nonzero(obs)[0], len(obs)]
    out = np.empty(a.size)
    out[sorter] = 0.5 * (count[dense] + count[dense - 1] + 1)
    return out


@pytest.mark.parametrize("case", ["float32", "nan", "float64"])
def test_float32_order_keys_rank_as_the_values(case):
    """Draws of float32 values sort by their order keys (−0.0 tied with
    +0.0); a NaN or a value that is no float32 takes the argsort."""
    x = _float32_draws(4)
    if case == "nan":
        x[[7, 100, 250], 3] = np.nan
    elif case == "float64":
        x[11, 4] += 1e-12
    assert (tdiag._f32_keys(x.reshape(-1)) is None) == (case != "float32")
    want = _argsort_ranks(x)
    np.testing.assert_array_equal(tdiag.rankdata_average(x), want)
    direct = tdiag.ndtri((want - 3.0 / 8.0) /
                         (x.size - 2.0 * 3.0 / 8.0 + 1.0)).reshape(x.shape)
    np.testing.assert_array_equal(tdiag._rank_normalize(x), direct)


@pytest.mark.parametrize("fn", ["rank_normalized_rhat", "ess_bulk"])
def test_rank_diagnostics_bitwise_jax_on_float32_draws(fn):
    x = _float32_draws(6)
    tables = {}
    for v in (x, x[:, 0], x[:, 1:3], x[:150]):
        got, want = getattr(tdiag, fn)(v, tables), getattr(jdiag, fn)(v)
        assert np.float64(got).view(np.int64) == np.float64(want).view(
            np.int64)


# ------------------------------------------------- F7: replicated width


@pytest.mark.parametrize("G, alpha, one_batch", [(256, 0.1, False),
                                                 (64, 0.1, True),
                                                 (256, 0.0, True)])
def test_replicated_batch_predicate_holds_k2s_width(G, alpha, one_batch):
    """Fault F7: a replication of more than ``ONE_CTA_MAX_CHAINS`` = 1,024
    chains that migrates (G·Np = 4,096, α = 0.1) takes no replicated K1
    batch, whose segmented K2 runs one CTA a replication; 1,024 chains,
    or no migration, still do.  The predicate is static, so the CPU
    evaluates it."""
    model, de = tgauss.make(Np=16, n_groups=G, alpha=alpha)
    assert tdm.sampler.rep_supported([model, model], de, "cpu") is one_batch


def _wide_reps():
    datasets = np.random.default_rng(2).normal(0.0, 1.0, (2, 50))
    _, de = tgauss.make(Np=16, n_groups=256, alpha=0.1, burnin=1,
                        discard_burnin=False)
    return datasets.astype(np.float32), de


def test_packed_run_wider_than_k2s_cta_raises_before_it_starts(
        monkeypatch):
    """Fault F7: the packed run of two bench-width replications raises its
    "use sample_replicated" ``ValueError`` before any state or step is
    made."""
    datasets, de = _wide_reps()

    def started(*a, **k):
        raise AssertionError("the packed run started")
    monkeypatch.setattr(tdm.sampler, "_run_replicated", started)
    with pytest.raises(ValueError, match="use sample_replicated"):
        tdm.sample_replicated_packed(tgauss.make_model, de, 2, datasets,
                                     device="cpu")


def test_replicated_wider_than_k2s_cta_run_in_turn(monkeypatch):
    """Fault F7: ``sample_replicated`` runs two bench-width replications
    (G = 256, Np = 16, α = 0.1) in turn, each bit for bit its solo
    ``sample()``, and builds no replicated step."""
    datasets, de = _wide_reps()

    def batched(*a, **k):
        raise AssertionError("a replicated batch was built")
    monkeypatch.setattr(tdm.sampler, "RepStep", batched)
    reps = tdm.sample_replicated(tgauss.make_model, de, 3, datasets,
                                 keys=[11, 12], device="cpu")
    for r, chains in enumerate(reps):
        solo = tdm.sample(tgauss.make_model(datasets[r]), de, 3, key=11 + r,
                          device="cpu")
        np.testing.assert_array_equal(chains.data, solo.data)
        np.testing.assert_array_equal(chains.lp, solo.lp)
