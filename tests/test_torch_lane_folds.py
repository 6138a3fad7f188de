"""The lane schedules of three CUDA kernels, restated in torch and held to
the plain versions bit for bit.

K1 on LBA (``csrc/densities/lba.cuh``) splits the trials over L lanes of
a warp per chain: in round r lane l evaluates trial r·L + l (a dummy
trial past the last), then every lane takes the round's 32 broadcasts
(lane l mod L) and adds the terms of lanes l < L and trials below
n_trials, the very first term alone.  K3 on the 30-dim MVN
(``csrc/sweep_dims.cuh``, ``densities/mvnormal.cuh``) splits the
dimensions: lane l holds dimension l + j·L in slot j, and
``DimLanes::fold`` has each lane store its slots at their dimensions in
a scratch row, then every lane reads the row back four at a time and
adds in index order.  Both are index order, so the float adds are the
serial loops' and the results the plain versions' bits; this file
restates the two schedules (which value sits in which lane, round or
scratch place, which are added) and holds them to the plain versions: LBA's
density for L ∈ {1, 2, 4, 8, 16, 32} on 100 and 37 trials, with trials
at rt ≤ τ; the MVN density and the snooker's dots and correction
(``ops/proposals.py``) at d = 31 for L ∈ {1, 8, 32}.  It also holds both
densities to the JAX models (``demcmc_tpu/models/lba.py``,
``mvnormal.py``) at the tolerances the port's other tests use: rtol 1e-5
for LBA (XLA sums the trials in its own order), 1e-6 for the MVN.

K1 on the discrete binomial (``csrc/densities/discrete_binomial.cuh``)
splits the unique counts over L lanes: in round r lane l forms
t_u = c_u·lgamma32(N − k_u + 1) for u = r·L + l (a (0, 0) pad past the
last), and every lane subtracts the round's first m terms in index order,
m the counts left; at L = 1 one lane walks them in turn.  Held to the
plain density for L ∈ {1, 2, 4, 8, 16} on 1 to 40 unique counts, and to
the JAX model's ``loglike_batched`` at ``test_torch_zoo.py``'s tolerance
(rtol 1e-6, atol 2e-3: XLA's lgamma against ``lgamma32``).

What binds the CUDA loops themselves to these schedules is
``chip_smoke.py``: ``phase_k1_zoo`` holds K1 on LBA bit for bit against
its plain version at every L the launch rule picks (Np = 16, 64 and a
group of the kernel's block limit; 100 and 37 trials), and
``phase_k3``/``phase_k3_super`` hold K3 on the MVN at C = 3 (32 lanes)
and at populations of 8 and 16 lanes, windows included.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import demcmc_tpu_torch as tdm
from demcmc_tpu.models import discrete_binomial as jdisc
from demcmc_tpu.models import lba as jlba
from demcmc_tpu.models import mvnormal as jmvn
from demcmc_tpu_torch.models import discrete_binomial as tdisc
from demcmc_tpu_torch.models import lba as tlba
from demcmc_tpu_torch.models import mvnormal as tmvn
from demcmc_tpu_torch.ops import proposals as tprop
from demcmc_tpu_torch.utils import dists

torch.set_num_threads(1)

WARP = 32
LBA_LANES = (1, 2, 4, 8, 16, 32)
DISC_LANES = (1, 2, 4, 8, 16)      # the kernel takes 8 at most; 16 held too
DISC_UNIQUE = (1, 7, 16, 17, 33, 40)
MVN_LANES = (1, 8, 32)
D_MVN = 30


def trial_fold(terms, L):
    """K1's fold of LBA's ``terms`` (a list of ``cnt`` tensors) over L
    lanes: term i sits in lane i mod L of round i // L; each round takes
    broadcasts of lanes l mod L for l < 32 and adds those with l < L and
    an index below ``cnt``, the first term alone."""
    cnt = len(terms)
    rounds = -(-cnt // L)
    lanes = [[terms[j * L + l] if j * L + l < cnt else None
              for l in range(L)] for j in range(rounds)]
    acc = None
    for j in range(rounds):
        for l in range(WARP):
            x = lanes[j][l % L]
            if j == 0 and l == 0:
                acc = x
            elif l < L and j * L + l < cnt:
                acc = acc + x
    return acc


def dims_fold(terms, L):
    """K3's fold (``DimLanes::fold``) of the MVN's per-dimension ``terms``
    over L lanes: lane l's slot j holds dimension l + j·L; each lane
    stores its slots at their dimensions in a scratch row padded to whole
    float4s, and the row is read back four at a time, the first term
    alone, then acc + term in index order."""
    cnt = len(terms)
    slots = -(-cnt // L)
    lanes = [[terms[l + j * L] if l + j * L < cnt else None
              for j in range(slots)] for l in range(L)]
    row = [None] * (-(-cnt // 4) * 4)
    for l in range(L):
        for j in range(slots):
            if l + j * L < cnt:
                row[l + j * L] = lanes[l][j]
    acc = None
    for q in range(len(row) // 4):
        for e in range(4):
            i = 4 * q + e
            if i == 0:
                acc = row[0]
            elif i < cnt:
                acc = acc + row[i]
    return acc


def bits(t):
    return t.contiguous().view(torch.int32)


# ----------------------------------------------------------------- LBA


def _lba_data(n_trials):
    return tlba.simulate(np.random.default_rng(n_trials), n_trials,
                         **tlba.TRUE)


def _lba_points(data, C=48, seed=0):
    """``[5, C]`` parameter columns: prior-like draws, τ at min_rt (the
    fastest trial invalid, the prior finite) and beyond it (more trials
    at rt ≤ τ, the prior −inf)."""
    g = np.random.default_rng(seed)
    min_rt = float(np.min(data[1]))
    nu = np.abs(g.normal(2.5, 0.8, (2, C)))
    A = g.uniform(0.3, 1.2, C)
    k = g.uniform(0.05, 0.4, C)
    tau = g.uniform(0.0, min_rt, C)
    tau[:4] = min_rt
    tau[4:8] = np.quantile(data[1], [0.1, 0.3, 0.6, 0.9])
    x = np.concatenate([nu, A[None], k[None], tau[None]]).astype(np.float32)
    return torch.from_numpy(x)


def lba_lanes(model, data, x, L):
    """K1's LBA density over L lanes: the prior in every lane, the
    trials in rounds of L (a dummy (0, 1) trial past the last), the
    round's terms folded by :func:`trial_fold`."""
    choice, rt = data
    n = len(rt)
    pad = -n % L
    padded = (np.concatenate([choice, np.zeros(pad, np.int32)]),
              np.concatenate([rt, np.ones(pad, np.float32)]))
    nu, A, k, tau = x[0:2], x[2], x[3], x[4]
    terms = tlba.trial_terms(padded, nu, A, k, tau)      # [n + pad, C]
    prior = model.prior_loglike_batched(nu, A, k, tau)
    return prior + trial_fold(list(terms[:n]), L)


@pytest.mark.parametrize("n_trials", [100, 37])
@pytest.mark.parametrize("L", LBA_LANES)
def test_lba_lane_rounds_equal_the_plain_density(L, n_trials):
    data = _lba_data(n_trials)
    model, de = tlba.make(data=data)
    spec = tdm.make_spec(model, de)
    x = _lba_points(data, seed=L)
    plain = model.log_posterior_cols(spec, x)
    lanes = lba_lanes(model, model.data, x, L)
    assert torch.equal(bits(lanes), bits(plain))
    # trials at rt ≤ τ: the −inf term sits in the fold
    assert bool(torch.isneginf(plain[:8]).all())


@pytest.mark.parametrize("n_trials", [100, 37])
def test_lba_lane_rounds_match_jax(n_trials):
    data = _lba_data(n_trials)
    model, _ = tlba.make(data=data)
    x = _lba_points(data, seed=7)
    got = lba_lanes(model, model.data, x, WARP).numpy()
    with jax.enable_x64(False):
        jm, _ = jlba.make(data=data)
        args = [jnp.asarray(v) for v in (x[0:2].numpy(), x[2].numpy(),
                                          x[3].numpy(), x[4].numpy())]
        want = np.asarray(jm.prior_loglike_batched(*args)
                          + jm.loglike_batched(jm.data, *args))
    fin = np.isfinite(want)
    np.testing.assert_array_equal(np.isneginf(got), np.isneginf(want))
    np.testing.assert_allclose(got[fin], want[fin], rtol=1e-5)


# ----------------------------------------------------------------- MVN


def _mvn(C=40, seed=3):
    data = np.random.default_rng(seed).standard_normal(
        (100, D_MVN)).astype(np.float32)
    model, de = tmvn.make(d=D_MVN, data=data)
    g = np.random.default_rng(seed + 1)
    x = g.normal(0.0, 0.3, (D_MVN + 1, C)).astype(np.float32)
    x[D_MVN] = np.abs(g.normal(1.0, 0.3, C))
    x[D_MVN, :3] = [-0.5, 0.0, -0.0]
    return model, de, data, torch.from_numpy(x)


def mvn_lanes(model, x, L):
    """K3's MVN density over L lanes: each dimension's two terms in its
    lane, both sums folded by :func:`dims_fold`, σ broadcast from its
    lane, the rest as the serial kernel."""
    p = model.cuda_density.params
    n, nd, ss, c0, log_2pi, log_pi, log2 = (dists.f32(v) for v in p[:7])
    xbar = p[7:]
    K = x.shape[0] - 1
    normal = dims_fold([(log_2pi + x[i] * x[i]) / -2.0 for i in range(K)], L)
    q = dims_fold([(x[i] - xbar[i]) * (x[i] - xbar[i]) for i in range(K)], L)
    s = x[K]
    half = log2 + -(log_pi + torch.log1p(s * s))
    half = torch.where(s >= 0.0, half, torch.full_like(half, -math.inf))
    ll = (c0 - nd * torch.log(s)) - (0.5 * (ss + n * q)) / (s * s)
    return (normal + half) + ll


@pytest.mark.parametrize("L", MVN_LANES)
def test_mvn_lane_folds_equal_the_plain_density(L):
    model, de, _, x = _mvn(seed=L)
    spec = tdm.make_spec(model, de)
    plain = model.log_posterior_cols(spec, x)
    assert torch.equal(bits(mvn_lanes(model, x, L)), bits(plain))


def test_mvn_lane_folds_match_jax():
    model, _, data, x = _mvn(seed=11)
    got = mvn_lanes(model, x, WARP).numpy()
    jm, _ = jmvn.make(d=D_MVN, data=data)
    mu, sigma = x[:D_MVN].numpy(), x[D_MVN].numpy()
    want = np.asarray(jm.prior_loglike_batched(mu, sigma)
                      + jm.loglike_batched(data, mu, sigma))
    ok = sigma > 0
    np.testing.assert_allclose(got[ok], want[ok], rtol=1e-6)
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want))


@pytest.mark.parametrize("L", MVN_LANES)
def test_snooker_lane_folds_equal_the_plain_proposal(L):
    """The snooker's |θ − z|², its two projections' numerators (folded
    together) and the correction's |θ′ − z|², each over L lanes, give
    the plain proposal and correction bit for bit; z == θ on some chains
    (the degenerate draw: the unit direction, folded again)."""
    d, C = D_MVN + 1, 40
    g = np.random.default_rng(20 + L)
    th, pz, pm, pn = (torch.from_numpy(g.normal(0.0, 1.0, (C, d)).astype(
        np.float32)) for _ in range(4))
    pz[:5] = th[:5]
    gam = torch.from_numpy(g.uniform(1.2, 2.2, C).astype(np.float32))
    want, den0_w, degen_w = tprop.kernel_snooker(th, pz, pm, pn, gam)
    adj_w = tprop.kernel_snooker_log_adj(want, pz, den0_w, degen_w, d)

    def fold3(sp):
        cols = lambda a: [a[:, i] for i in range(d)]     # noqa: E731
        return [dims_fold(cols(a * sp), L) for a in (sp, pm, pn)]

    sp = th - pz
    den0, n1, n2 = fold3(sp)
    degen = den0 <= np.finfo(np.float32).tiny
    unit = torch.where(degen[:, None], torch.ones_like(sp), sp)
    dens2, m1, m2 = fold3(unit)
    q1 = torch.where(degen, m1, n1) / torch.where(degen, dens2, den0)
    q2 = torch.where(degen, m2, n2) / torch.where(degen, dens2, den0)
    prop = th + gam[:, None] * (q1[:, None] * unit - q2[:, None] * unit)
    assert torch.equal(bits(prop), bits(want))
    assert torch.equal(bits(den0), bits(den0_w))
    a1 = torch.where(degen[:, None], th, prop) - pz
    a1sq = dims_fold([a1[:, i] * a1[:, i] for i in range(d)], L)
    adj = dists.f32(0.5 * (d - 1)) * (torch.log(a1sq) - torch.log(den0))
    adj = torch.where(degen, torch.full_like(adj, -math.inf), adj)
    assert torch.equal(bits(adj), bits(adj_w))
    assert int(degen.sum()) == 5


# ------------------------------------------------------ discrete binomial


def _disc(n_unique, seed=0):
    """The discrete model on 50 observations with ``n_unique`` unique
    counts (0 .. n_unique − 1, each at least once) and ``[2, C]`` columns:
    N over the support (−inf below the largest count) and p in (0, 1)."""
    g = np.random.default_rng(seed + n_unique)
    data = np.concatenate([np.arange(n_unique), g.integers(
        0, n_unique, 50 - n_unique)])
    model, de = tdisc.make(data=data, dtype=np.float32)
    N = np.arange(0, 41, dtype=np.float32).repeat(2)
    p = g.uniform(0.05, 0.95, N.size).astype(np.float32)
    return model, de, data, torch.from_numpy(np.stack([N, p]))


def disc_lanes(model, x, L):
    """K1's discrete density over L lanes (:func:`disc_rounds` folds the
    terms), its head and the −inf of N < max k as the serial kernel."""
    p = model.cuda_density.params
    n, cst, sk, kmax = (dists.f32(v) for v in p[:4])
    log_prior = dists.f32(p[5])
    tab = torch.from_numpy(model.cuda_density.data)
    N, pr = x[0], x[1]
    lp = (n * dists.lgamma32(N + 1.0) + cst + sk * torch.log(pr)
          + (n * N - sk) * torch.log1p(-pr))
    U = tab.shape[0]
    pad = -U % L
    k = torch.cat([tab[:, 0], torch.zeros(pad)])
    c = torch.cat([tab[:, 1], torch.zeros(pad)])
    terms = [c[u] * dists.lgamma32(N - k[u] + 1.0) for u in range(U + pad)]
    lp = disc_rounds(lp, terms, U, L)
    return log_prior + torch.where(N >= kmax, lp,
                                   torch.full_like(lp, -math.inf))


def disc_rounds(lp, terms, cnt, L):
    """Round r: lane l holds term r·L + l; every lane subtracts the
    round's first min(L, cnt − r·L) broadcasts in lane order (L = 1: the
    terms in turn)."""
    for r0 in range(0, cnt, L):
        lanes = terms[r0:r0 + L]
        for l in range(min(L, cnt - r0)):
            lp = lp - lanes[l]
    return lp


@pytest.mark.parametrize("n_unique", DISC_UNIQUE)
@pytest.mark.parametrize("L", DISC_LANES)
def test_discrete_lane_rounds_equal_the_plain_density(L, n_unique):
    model, de, _, x = _disc(n_unique)
    spec = tdm.make_spec(model, de)
    plain = model.log_posterior_cols(spec, x)
    lanes = disc_lanes(model, x, L)
    assert torch.equal(bits(lanes), bits(plain))
    assert bool(torch.isneginf(plain[: 2 * (n_unique - 1)]).all())
    assert bool(torch.isfinite(plain[2 * max(n_unique - 1, 0):]).all())


@pytest.mark.parametrize("n_unique", DISC_UNIQUE)
def test_discrete_lane_rounds_match_jax(n_unique):
    model, _, data, x = _disc(n_unique, seed=5)
    got = disc_lanes(model, x, 8).numpy()
    N, p = x[0].numpy().astype(np.int32), x[1].numpy()
    with jax.enable_x64(False):
        jm, _ = jdisc.make(data=data, dtype=np.float32)
        want = np.asarray(jm.prior_loglike_batched(jnp.asarray(N),
                                                   jnp.asarray(p))
                          + jm.loglike_batched(jm.data, jnp.asarray(N),
                                               jnp.asarray(p)))
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=1e-6, atol=2e-3)
