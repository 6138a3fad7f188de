"""The KDE pieces of the port (``utils/kde.py``, and ``ops/kde.py``, the
wrapper of CUDA kernel K4 and its plain version) against the JAX package
on the CPU: ``demcmc_tpu.utils.kde`` and the Pallas kernel
``kde_logpdf_pallas`` in interpret mode, with x64 off (the harness turns
it on, and the JAX bandwidth would then come out in float64).

Tolerances: the bandwidth within 1e-6 relative (XLA's and torch's sums
for the sd); densities within 2e-5 relative and absolute, the JAX
kernel test's own tolerance (``tests/test_abc_kde.py:47``: sums of
thousands of kernel terms in other orders).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from demcmc_tpu.ops.pallas_kde import kde_logpdf_pallas
from demcmc_tpu.utils import kde as jkde

from demcmc_tpu_torch.ops import kde as tkde_ops
from demcmc_tpu_torch.utils import kde as tkde

RNG = np.random.default_rng(0)
X = RNG.standard_normal(37).astype(np.float32)           # unaligned
SIMS = (RNG.normal(0.0, 0.3, (4, 1)) + RNG.uniform(0.6, 1.4, (4, 1))
        * RNG.standard_normal(1537)).astype(np.float32)
TOL = 2e-5


@pytest.fixture(autouse=True)
def one_torch_thread():
    """The port's CPU path runs many small torch operations, which thread
    pools only slow down (most where the test runner's other workers hold
    the cores); one intra-op thread per test, restored after it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax(fn, *args, **kw):
    with jax.enable_x64(False):
        return np.asarray(fn(*(jnp.asarray(a) for a in args), **kw))


@pytest.mark.parametrize("n", [100, 1537, 10_000])
def test_silverman_bandwidth_matches_jax(n):
    """Batched over chains, each row against ``jnp.std`` (population sd)
    and ``jnp.quantile``'s linear interpolation; a constant row takes
    the 1e-6 floor."""
    s = np.random.default_rng(n).standard_normal((3, n)).astype(np.float32)
    s[2] = 0.25
    got = tkde.silverman_bandwidth(torch.tensor(s)).numpy()
    want = np.array([_jax(jkde.silverman_bandwidth, row) for row in s])
    np.testing.assert_allclose(got, want, rtol=1e-6)
    srt = torch.sort(torch.tensor(s[0])).values
    for q in (0.25, 0.75):
        assert float(tkde._quantile(srt, q)) == float(
            _jax(jnp.quantile, s[0], q))


def test_epanechnikov_pdf_and_logpdf_match_jax():
    h = tkde.silverman_bandwidth(torch.tensor(SIMS))
    pdf = tkde.epanechnikov_pdf(torch.tensor(X), torch.tensor(SIMS)).numpy()
    lp = tkde.epanechnikov_logpdf(torch.tensor(X), torch.tensor(SIMS),
                                  h).numpy()
    for c in range(len(SIMS)):
        np.testing.assert_allclose(pdf[c], _jax(jkde.epanechnikov_pdf, X,
                                                SIMS[c]), rtol=TOL, atol=TOL)
        np.testing.assert_allclose(lp[c], _jax(jkde.epanechnikov_logpdf, X,
                                               SIMS[c]), rtol=TOL, atol=TOL)


def test_floor_applied():
    """A point outside every kernel's support takes log(1e-10), as the
    JAX function and kernel do."""
    x = torch.tensor([100.0, 0.0])
    sims = torch.zeros((2, 100))
    h = torch.full((2,), 0.5)
    want = float(np.log(np.float32(1e-10)))
    for fn in (tkde_ops.kde_logpdf_plain, tkde_ops.kde_logpdf):
        out = fn(x, sims, h).numpy()
        assert out[:, 0] == pytest.approx([want] * 2)
        assert np.isfinite(out[:, 1]).all() and (out[:, 1] > want).all()
    assert float(_jax(jkde.epanechnikov_logpdf, np.array([100.0]),
                      np.zeros(100))[0]) == pytest.approx(want)


def test_plain_k4_matches_pallas_kernel():
    """The plain version of K4 at the JAX test's unaligned shapes (E = 37,
    S = 1,537, ``test_abc_kde.py:41-47``) batched over 4 chains, against
    ``kde_logpdf_pallas`` in interpret mode chain by chain, with the same
    bandwidths."""
    h = tkde.silverman_bandwidth(torch.tensor(SIMS))
    got = tkde_ops.kde_logpdf_plain(torch.tensor(X), torch.tensor(SIMS),
                                    h).numpy()
    assert got.shape == (4, 37)
    for c in range(4):
        want = _jax(kde_logpdf_pallas, X, SIMS[c], np.float32(h[c]))
        np.testing.assert_allclose(got[c], want, rtol=TOL, atol=TOL)


def test_kde_wrapper_takes_plain_version_on_cpu(monkeypatch):
    """On CPU tensors ``kde_logpdf`` is the plain version and counts no
    launch; the plain version's chunks of chains change nothing."""
    x, s = torch.tensor(X), torch.tensor(SIMS)
    h = tkde.silverman_bandwidth(s)
    before = tkde_ops.kde_logpdf.launches
    whole = tkde_ops.kde_logpdf(x, s, h)
    assert tkde_ops.kde_logpdf.launches == before
    monkeypatch.setattr(tkde_ops, "PLAIN_CHUNK", 37 * 1537)   # one chain
    assert torch.equal(tkde_ops.kde_logpdf(x, s, h), whole)


def test_kde_vmap_folds_the_batch_into_one_call(monkeypatch):
    """Under ``torch.func.vmap`` (a custom fitness slot runs per cell) the
    operator's vmap rule folds the batch into the chains: one call of the
    plain version on the CPU (one K4 launch on the card) for the whole
    batch, bit for bit the unbatched call, nested vmaps too; a batch of
    evaluation points takes one call per member."""
    calls = []
    plain = tkde_ops.kde_logpdf_plain

    def counted(x, sims, h, floor):
        calls.append(tuple(sims.shape))
        return plain(x, sims, h, floor)

    monkeypatch.setattr(tkde_ops, "kde_logpdf_plain", counted)
    x, s = torch.tensor(X), torch.tensor(SIMS)
    h = tkde.silverman_bandwidth(s)
    whole = tkde_ops.kde_logpdf(x, s, h)
    calls.clear()

    def cell(sims, hh):
        return tkde_ops.kde_logpdf(x, sims[None], hh[None])[0]

    assert torch.equal(torch.func.vmap(cell)(s, h), whole)
    assert calls == [(4, 1537)]
    calls.clear()
    nested = torch.func.vmap(torch.func.vmap(cell))(s.reshape(2, 2, -1),
                                                    h.reshape(2, 2))
    assert torch.equal(nested.reshape(4, -1), whole)
    assert calls == [(4, 1537)]
    calls.clear()
    xs = torch.stack([x, x.flip(0), x + 0.5, x - 0.5])
    got = torch.func.vmap(lambda xx, sims, hh: tkde_ops.kde_logpdf(
        xx, sims[None], hh[None])[0])(xs, s, h)
    for c in range(4):
        assert torch.equal(got[c], plain(xs[c], s[c:c + 1], h[c:c + 1],
                                         1e-10)[0])
    assert calls == [(1, 1537)] * 4


@pytest.mark.parametrize("n_sim,tile", [(1537, 1664), (100, 128),
                                        (10_000, 2048), (2048, 2048)])
def test_sim_tile_is_the_pallas_rule(n_sim, tile):
    assert tkde_ops.sim_tile(n_sim) == tile


def test_kde_wrapper_refuses_a_device_it_does_not_run_on():
    """Tensors on neither the CPU nor a CUDA device raise before any
    build or launch."""
    meta = dict(device="meta")
    with pytest.raises(ValueError, match="cpu or cuda"):
        tkde_ops.kde_logpdf(torch.zeros(3, **meta),
                            torch.zeros((2, 5), **meta),
                            torch.zeros(2, **meta))
