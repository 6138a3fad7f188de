"""K2's spread form restated on the CPU: ranks by counting on 23-bit keys,
the victims' total order and the scatter, held to the port's plain
exchange (``migration.migrate_plain``, sort-based ranks) and to the JAX
package's numpy oracle of the reference exchange
(``tests/test_fused_step.py::_np_migration_oracle``), bit for bit.

``csrc/migration.cu`` keys group g by word >> 9 of its leader's row-0 word
(``to_uni`` is exact and rising in it) and ranks it by #{h < g : key_h
<= key_g} + #{h > g : key_h < key_g}, the sort's (uniform, g) order; it
finds each group's victim as the maximum of a total order that a
lane-split scan and a shuffle reduction both reach (a NaN score at q = 0
first, then the larger score, then the smaller q, a later NaN last),
stages the victims' rows with ``+ 0.0``, and writes every group's victim
slot from the staged row of ``perm[(rank - 1) mod N]`` (rank < N) or its
own.  What binds the CUDA code to this restatement is ``chip_smoke.py``'s
``phase_k2``: both forms of K2 bit for bit the plain version at every
shape it checks.
"""

import numpy as np
import pytest
import torch

from test_fused_step import _np_migration_oracle

from demcmc_tpu_torch import rng
from demcmc_tpu_torch.ops import migration as tmig

torch.set_num_threads(1)


def _keys(seed, G, ties):
    """Leader words [G] with tied top 23 bits: none, in pairs, or all."""
    g = np.random.default_rng(seed)
    words = g.integers(0, 2 ** 32, G, dtype=np.uint64)
    low = g.integers(0, 0x200, G).astype(np.uint64)
    if ties == "pairs":
        words[1::2] = (words[0:-1:2][: G // 2] & ~np.uint64(0x1FF)) \
            | low[1::2]
    elif ties == "all":
        words = (words[0] & ~np.uint64(0x1FF)) | low
    return words


def _uni(words):
    return rng.to_uni(torch.from_numpy(words.astype(np.int64)).to(
        torch.uint32))


def _count_ranks(key):
    """The rank kernel's count, on keys [G] of any ordered type: an h
    before g counts when its key is at most g's, an h after g when it is
    below (rank(g) = #{h : key_h < key_g, or key_h = key_g and h < g})."""
    G = key.shape[0]
    h = np.arange(G)
    before = (h[None, :] < h[:, None]) & (key[None, :] <= key[:, None])
    after = (h[None, :] > h[:, None]) & (key[None, :] < key[:, None])
    return (before | after).sum(1)


@pytest.mark.parametrize("G", [2, 3, 8, 255, 1000])
@pytest.mark.parametrize("ties", ["none", "pairs", "all"])
def test_counting_rank_equals_the_sort_and_the_oracle(G, ties):
    words = _keys(G, G, ties)
    u = _uni(words)
    rank = _count_ranks(words >> np.uint64(9))
    want_rank, want_perm = tmig._rank_and_perm(u)
    assert np.array_equal(rank, want_rank.numpy())
    perm = np.empty(G, int)
    perm[rank] = np.arange(G)
    assert np.array_equal(perm, want_perm.numpy())
    order = np.lexsort((np.arange(G), u.numpy()))   # the oracle's ranks
    assert np.array_equal(perm, order)
    assert np.array_equal(np.sort(rank), np.arange(G))


@pytest.mark.parametrize("ties", ["none", "pairs", "all"])
def test_rank_keys_of_23_bits_order_as_the_uniforms(ties):
    G = 513
    words = _keys(7, G, ties)
    assert np.array_equal(_count_ranks(words >> np.uint64(9)),
                          _count_ranks(_uni(words).numpy()))


def _victim(s):
    """The kernel's victim of one group's scores: lanes of L = 4 scan their
    q = l, l + 4, ... and a butterfly over the lanes reduces, both by the
    order of ``victim_before``."""
    def before(a, b):                      # a, b: (class, score, q)
        if b[2] < 0:
            return a[2] >= 0
        if a[2] < 0:
            return False
        if a[0] != b[0]:
            return a[0] > b[0]
        if a[1] > b[1]:
            return True
        if b[1] > a[1]:
            return False
        return a[2] < b[2]
    L = 4
    best = [(0, 0.0, -1)] * L
    for q, x in enumerate(s):
        k = (2 if q == 0 else 0) if np.isnan(x) else 1
        if before((k, x, q), best[q % L]):
            best[q % L] = (k, x, q)
    o = L // 2
    while o:
        best = [best[l ^ o] if before(best[l ^ o], best[l]) else best[l]
                for l in range(L)]
        o //= 2
    assert len({b[2] for b in best}) == 1
    return best[0][2]


def _spread(theta, w, words, G, Np):
    """K2's spread form in torch: returns new (θ, w)."""
    C, d = theta.shape
    u = torch.clamp_min(rng.to_uni(words[2]), rng.TINY)
    s = ((-torch.log(-torch.log(u))).view(G, Np) - w.view(G, Np)).numpy()
    vid = np.array([_victim(s[g]) for g in range(G)])
    lead = words[0, ::Np].to(torch.int64).numpy()
    rank = _count_ranks(lead >> 9)
    perm = np.empty(G, int)
    perm[rank] = np.arange(G)
    n = int(rng.randint(words[1, 0], G - 1)) + 2
    th, ww = theta.view(G, Np, d), w.view(G, Np)
    gi = torch.arange(G)
    vals = torch.cat([th[gi, vid] + 0.0, (ww[gi, vid] + 0.0)[:, None]], 1)
    src = [perm[(r + n - 1) % n] if r < n else g for g, r in enumerate(rank)]
    new_t, new_w = th.clone(), ww.clone()
    new_t[gi, vid] = vals[src, :d]
    new_w[gi, vid] = vals[src, d]
    return new_t.view(C, d), new_w.view(C)


def _case(seed, G, Np, ties, d=2):
    g = np.random.default_rng(seed)
    C = G * Np
    theta = (g.standard_normal((C, d)) * 1e3).astype(np.float32)
    theta[g.random((C, d)) < 0.05] = -0.0
    theta[:Np] = -0.0
    w = g.standard_normal(C).astype(np.float32)
    w[g.random(C) < 0.1] = -np.inf
    w[g.random(C) < 0.05] = np.inf
    w[g.random(C) < 0.05] = -0.0
    w[Np: 2 * Np] = -np.inf                  # a group of tied +inf scores
    words = g.integers(0, 2 ** 32, (3, C), dtype=np.uint64)
    words[0, ::Np] = _keys(seed, G, ties)
    return (torch.tensor(theta), torch.tensor(w),
            torch.from_numpy(words.astype(np.int64)).to(torch.uint32))


def _bits(t):
    return t.contiguous().view(torch.int32)


@pytest.mark.parametrize("G,Np", [(8, 4), (64, 12), (256, 16), (512, 3)])
@pytest.mark.parametrize("ties", ["pairs", "all"])
def test_spread_form_restated_equals_the_plain_exchange(G, Np, ties):
    theta, w, words = _case(G * Np, G, Np, ties)
    tp, wp = theta.clone(), w.clone()
    tmig.migrate_plain(tp, wp, torch.ones(1, dtype=torch.int32), words, G,
                       Np)
    ts, ws = _spread(theta, w, words, G, Np)
    assert torch.equal(_bits(ts), _bits(tp)) and torch.equal(_bits(ws),
                                                             _bits(wp))
    assert not torch.equal(_bits(tp), _bits(theta))
    u_key, n_active, gum = tmig.draws(words, G, Np)
    nt, nw = _np_migration_oracle(theta.view(G, Np, 2).numpy(),
                                  w.view(G, Np).numpy(), u_key.numpy(),
                                  int(n_active), gum.numpy())
    np.testing.assert_array_equal(ts.view(G, Np, 2).numpy(), nt)
    np.testing.assert_array_equal(ws.view(G, Np).numpy(), nw)


def test_victim_order_is_the_sequential_scan_with_nans():
    """The order keeps the scan's victim: a NaN score at q = 0 stays, a
    later NaN never replaces, ties keep the first index."""
    def scan(s):
        best, bs = 0, 0.0
        for q, x in enumerate(s):
            if q == 0 or x > bs:
                best, bs = q, x
        return best
    g = np.random.default_rng(3)
    for _ in range(300):
        n = int(g.integers(1, 40))
        s = np.round(g.standard_normal(n), 1)
        s[g.random(n) < 0.2] = np.nan
        s[g.random(n) < 0.1] = np.inf
        assert _victim(s) == scan(s)
