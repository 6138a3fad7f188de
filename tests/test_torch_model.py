"""The port's substrate against the JAX package: ParamSpec, the Gaussian
batched density and its pieces, the diagnostics, and the Philox words."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from demcmc_tpu import ParamSpec as JSpec
from demcmc_tpu import diagnostics as jdiag
from demcmc_tpu.models import gaussian as jgauss
from demcmc_tpu.utils import dists as jdists

import demcmc_tpu_torch as tdm
from demcmc_tpu_torch import diagnostics as tdiag
from demcmc_tpu_torch import rng
from demcmc_tpu_torch.models import gaussian as tgauss
from demcmc_tpu_torch.utils import dists as tdists

NAMES = ("a", "b", "m", "k")
EXAMPLE = [np.float64(0.5), np.zeros(3), np.zeros((2, 2)), np.int64(4)]


@pytest.mark.parametrize("bounds", [
    None, ((-1.0, 1.0), (0.0, np.inf), (-np.inf, np.inf), (0, 10))])
def test_paramspec_matches_jax(bounds):
    """The ``test_paramspec.py`` spec: sizes, offsets, masks, names,
    bounds, flatten/unflatten and the chains-last ``unflatten_cols``."""
    js = JSpec.from_example(NAMES, EXAMPLE, bounds)
    ts = tdm.ParamSpec.from_example(NAMES, EXAMPLE, bounds)
    assert (ts.sizes, ts.dim, ts.offsets, ts.shapes, ts.is_int) == \
        (js.sizes, js.dim, js.offsets, js.shapes, js.is_int)
    np.testing.assert_array_equal(ts.int_mask, js.int_mask)
    assert ts.flat_names() == js.flat_names()
    np.testing.assert_array_equal(ts.lo, js.lo)
    np.testing.assert_array_equal(ts.hi, js.hi)
    params = [0.5, np.arange(3.0), np.arange(4.0).reshape(2, 2), 7]
    np.testing.assert_array_equal(ts.flatten(params).numpy(),
                                  np.asarray(js.flatten(params), np.float32))
    flat = np.linspace(-2.0, 6.6, 9).astype(np.float32)
    for t, j in zip(ts.unflatten(torch.tensor(flat)),
                    js.unflatten(jnp.asarray(flat))):
        assert t.shape == j.shape
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    assert ts.unflatten(torch.tensor(flat))[3].dtype == torch.int32
    cols = np.random.default_rng(0).normal(size=(9, 3, 5)).astype(np.float32)
    for t, j in zip(ts.unflatten_cols(torch.tensor(cols)),
                    js.unflatten_cols(jnp.asarray(cols))):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))


def test_paramspec_mismatches_raise():
    with pytest.raises(ValueError):
        tdm.ParamSpec.from_example(NAMES, EXAMPLE, ((0, 1),))
    with pytest.raises(ValueError):
        tdm.ParamSpec.from_example(("a",), [1.0, 2.0], None)


def _thetas():
    """f32 (μ, σ) with out-of-support σ ≤ 0 and far-out values mixed in."""
    rng_ = np.random.default_rng(1)
    mu = rng_.normal(0.0, 2.0, 400)
    sigma = np.abs(rng_.normal(1.0, 1.0, 400))
    sigma[:10] = -np.abs(sigma[:10])
    sigma[10] = 0.0
    mu[11:15] = [1e3, -1e3, 1e-20, -0.0]
    return mu.astype(np.float32), sigma.astype(np.float32)


def test_gaussian_density_matches_jax():
    """Batched log posterior (prior + centered sufficient-statistic
    likelihood) in float32 against JAX's ``prior_loglike_batched +
    loglike_batched`` at rtol 1e-6; σ ≤ 0 gives -inf in both."""
    data = np.asarray(np.random.default_rng(2).normal(3.0, 2.0, 50),
                      np.float32)
    mu, sigma = _thetas()
    jmu, jsigma = jnp.asarray(mu), jnp.asarray(sigma)
    want = np.asarray(jgauss.prior_loglike_batched(jmu, jsigma)
                      + jgauss.loglike_batched(data, jmu, jsigma))
    model, de = tgauss.make(data=data)
    spec = tdm.make_spec(model, de)
    theta = torch.tensor(np.stack([mu, sigma], 1))
    got = model.log_posterior_cols(spec, theta.T).numpy()
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-6)
    post = tdm.ops.accept.compute_posterior(model, spec, de, theta).numpy()
    assert np.isneginf(post[sigma < 0]).all()
    ok = sigma > 0
    np.testing.assert_allclose(post[ok], want[ok], rtol=1e-6)


def test_dists_match_jax():
    mu, sigma = _thetas()
    x = torch.tensor(mu)
    np.testing.assert_allclose(
        tdists.normal_logpdf(x, 0.0, 1.0).numpy(),
        np.asarray(jdists.normal_logpdf(mu, 0.0, 1.0)), rtol=1e-6)
    np.testing.assert_allclose(
        tdists.normal_logpdf(x, 0.5, torch.tensor(np.abs(sigma) + 0.1))
        .numpy(),
        np.asarray(jdists.normal_logpdf(mu, 0.5, np.abs(sigma) + 0.1)),
        rtol=1e-6)
    np.testing.assert_allclose(
        tdists.halfcauchy_logpdf(torch.tensor(sigma)).numpy(),
        np.asarray(jdists.halfcauchy_logpdf(sigma)), rtol=1e-6)
    u = torch.linspace(0.0, 0.999, 101)
    hc = tdists.sample_halfcauchy(u)
    assert (hc >= 0).all() and torch.isfinite(hc).all()
    assert abs(float(torch.median(hc)) - 1.0) < 0.05    # median of |Cauchy|


def test_posterior_grid_matches_jax():
    data = np.random.default_rng(4).normal(1.0, 0.5, 30)
    t, j = tgauss.posterior_grid(data), jgauss.posterior_grid(data)
    for name in ("mu", "sigma"):
        for stat in ("mean", "std"):
            assert t[name][stat] == j[name][stat]


def _draws():
    rng_ = np.random.default_rng(6)
    x = rng_.standard_normal((400, 8)).cumsum(axis=0) * 0.1 \
        + rng_.standard_normal((400, 8))
    x[:, 3] = np.round(x[:, 3], 1)                   # ties in the ranks
    return x


@pytest.mark.parametrize("fn", ["split_rhat", "rank_normalized_rhat", "ess",
                                "ess_bulk", "ess_tail"])
def test_diagnostics_equal_jax(fn):
    x = _draws()
    assert getattr(tdiag, fn)(x) == getattr(jdiag, fn)(x)
    assert getattr(tdiag, fn)(x[:, 0]) == getattr(jdiag, fn)(x[:, 0])


def test_summary_stats_equal_jax():
    x = _draws()
    assert tdiag.summary_stats(x) == jdiag.summary_stats(x)


def test_ndtri_and_ranks_match_scipy():
    from scipy.special import ndtri
    from scipy.stats import rankdata
    p = np.concatenate([np.linspace(0.0, 1.0, 2001),
                        np.random.default_rng(7).random(5000),
                        [1e-300, 1e-30, 1 - 1e-12]])
    np.testing.assert_array_equal(tdiag.ndtri(p), ndtri(p))
    x = np.round(np.random.default_rng(8).normal(size=3000), 1)
    np.testing.assert_array_equal(tdiag.rankdata_average(x),
                                  rankdata(x, method="average"))


# Random123's known-answer vectors for Philox4x32-10 (kat_vectors):
# (counter, key) -> output
KAT = [
    ((0, 0, 0, 0), (0, 0),
     (0x6627e8d5, 0xe169c58d, 0xbc57ac4c, 0x9b00dbd8)),
    ((0xffffffff,) * 4, (0xffffffff,) * 2,
     (0x408f276d, 0x41c83b0e, 0xa20bc7c6, 0x6d5451fd)),
    ((0x243f6a88, 0x85a308d3, 0x13198a2e, 0x03707344),
     (0xa4093822, 0x299f31d0),
     (0xd16cfe09, 0x94fdcceb, 0x5001e420, 0x24126ea1)),
]


@pytest.mark.parametrize("ctr,key,want", KAT)
def test_philox_known_answers(ctr, key, want):
    out = rng.philox4x32([torch.tensor([c], dtype=torch.int64) for c in ctr],
                         key)
    assert tuple(int(o[0]) for o in out) == want


PRODUCTS = {
    "torch": lambda ctr, key: rng._rounds(
        [torch.tensor([c], dtype=torch.int64) for c in ctr], key,
        rng._mulhilo),
    "numpy": lambda ctr, key: rng._rounds(
        [np.array([c], dtype=np.uint64) for c in ctr], key,
        rng._mulhilo_u64, np.uint64),
    "int": lambda ctr, key: rng._rounds(ctr, key, rng._mulhilo_int),
}


@pytest.mark.parametrize("form", list(PRODUCTS))
@pytest.mark.parametrize("ctr,key,want", KAT)
def test_philox_product_forms_known_answers(ctr, key, want, form):
    """Each product form of the Philox rounds (torch's split, numpy's
    uint64, Python ints) gives Random123's known answers."""
    out = PRODUCTS[form](ctr, key)
    assert tuple(int(np.asarray(o).reshape(-1)[0]) for o in out) == want


@pytest.mark.parametrize("ns", [rng.STEP_NS, rng.EVAL_NS])
def test_cpu_words_are_the_torch_rounds_across_the_wrap(ns):
    """On the CPU the rounds run in numpy: the words equal torch's form
    of the rounds (the card's) at the same counters, across the 32-bit
    iteration wrap, at rows and chains far from 0."""
    seed, it0 = 0xFEDCBA9876543210, 0xFFFFFFFE
    row0, chain0 = 4097, 2 ** 32 - 40
    got = rng.words_block(seed, it0, 4, 9, 33, ns=ns, row0=row0,
                          chain0=chain0)
    rows = torch.arange(row0, row0 + 9)
    it = torch.arange(it0, it0 + 4) & 0xFFFFFFFF
    shape = (4, 9, 33)
    ctr = (torch.arange(chain0, chain0 + 33).expand(shape),
           (rows >> 2)[None, :, None].expand(shape),
           it[:, None, None].expand(shape),
           torch.full(shape, ns, dtype=torch.int64))
    lanes = torch.stack(rng._rounds(ctr, rng.seed_key(seed), rng._mulhilo))
    want = torch.gather(lanes, 0, (rows & 3)[None, None, :, None].expand(
        (1,) + shape))[0]
    assert torch.equal(got.to(torch.int64), want)


def test_key_fold_is_a_philox_block():
    """``Key.fold_in``'s two words are lanes 0 and 1 of the Philox block
    at (data lo, data hi, iteration, FOLD_NS) under the parent's words."""
    key = rng.Key(0x0123456789ABCDEF, 2 ** 32 + 5, 4)
    data = (7 << 32) | 99
    child = key.fold_in(data)
    lanes = rng.philox4x32([torch.tensor([c], dtype=torch.int64)
                            for c in (99, 7, 5, rng.FOLD_NS)], key.words)
    assert child.words == (int(lanes[0][0]), int(lanes[1][0]))


def test_words_are_philox_lanes():
    """Word (seed, it, row, chain) is lane row & 3 of the Philox block at
    counter (chain, row >> 2, it, namespace), key (seed lo, seed hi)."""
    seed = (0xABCDEF01 << 32) | 0x12345678
    w = rng.words(seed, 77, 9, 5, ns=rng.INIT_NS)
    assert w.dtype == torch.uint32 and w.shape == (9, 5)
    for row in (0, 3, 4, 8):
        for chain in (0, 4):
            ctr = [torch.tensor([v], dtype=torch.int64)
                   for v in (chain, row >> 2, 77, rng.INIT_NS)]
            lanes = rng.philox4x32(ctr, (0x12345678, 0xABCDEF01))
            assert int(w[row, chain]) == int(lanes[row & 3][0])
    rows = rng.words(seed, 77, 4, 5, ns=rng.INIT_NS, row0=5)
    assert torch.equal(rows, w[5:9])
    with pytest.raises(ValueError):
        rng.seed_key(-1)


def test_words_block_stacks_the_iterations():
    """``words_block`` draws several iterations at once: the same words as
    one ``words`` call per iteration, across the 32-bit iteration wrap."""
    seed = 0x0123456789ABCDEF
    for it0 in (5, 0xFFFFFFFE):
        block = rng.words_block(seed, it0, 4, 7, 9, row0=2)
        assert block.dtype == torch.uint32 and block.shape == (4, 7, 9)
        for k in range(4):
            assert torch.equal(block[k], rng.words(seed, it0 + k, 7, 9,
                                                   row0=2))
    assert torch.equal(rng.words(seed, 1 << 32, 3, 4),
                       rng.words(seed, 0, 3, 4))


def test_bit_maps():
    b = torch.tensor([0, 0x1FF, 0x200, 0xFFFFFFFF, 0x80000000],
                     dtype=torch.int64).to(torch.uint32)
    u = rng.to_uni(b)
    assert u.dtype == torch.float32
    assert u.tolist() == [0.0, 0.0, 2.0 ** -23, 1.0 - 2.0 ** -23, 0.5]
    assert rng.randint(b, 7).tolist() == [0, 0x1FF % 7, 0x200 % 7,
                                          0xFFFFFFFF % 7, 0x80000000 % 7]
