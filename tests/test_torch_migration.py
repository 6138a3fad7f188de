"""The port's plain migration (``demcmc_tpu_torch.ops.migration``, the CPU
version of CUDA kernel K2) against the JAX package's bitonic migration
kernel (``build_migration_kernel(..., variant="sorted")``) in interpret
mode, bit for bit.

Both get the same random values: the port derives them from a word block
(``migration.draws``) and the JAX kernel is fed those values — the
leader chains' rank uniforms, the active-group count and the Gumbels.
"""

import jax
import numpy as np
import pytest
import torch

from demcmc_tpu.ops import fused_step as jfused

from demcmc_tpu_torch.ops import migration as tmig


def _case(seed, G, Np, d=2):
    """θ with -0.0 entries, weights with ±inf, and a word block whose
    leader words tie in pairs (same top 23 bits, so equal uniforms)."""
    rng = np.random.default_rng(seed)
    C = G * Np
    theta = (rng.standard_normal((C, d)) * 1e3
             + rng.random((C, d)) * 1e-4).astype(np.float32)
    theta[rng.random((C, d)) < 0.05] = -0.0
    w = rng.standard_normal(C).astype(np.float32)
    w[rng.random(C) < 0.1] = -np.inf
    w[rng.random(C) < 0.05] = np.inf
    words = rng.integers(0, 2 ** 32, (3, C), dtype=np.uint64)
    leaders = np.arange(0, C, Np)
    twins = leaders[1::2]
    words[0, twins] = (words[0, twins - Np] & ~np.uint64(0x1FF)) \
        | rng.integers(0, 0x200, twins.size).astype(np.uint64)
    return (torch.tensor(theta), torch.tensor(w),
            torch.from_numpy(words.astype(np.int64)).to(torch.uint32))


def _jax_migrate(theta, w, u_key, n_active, gum, G, Np):
    C, d = theta.shape
    R, Cf = 8, C // 8
    u_row = np.full(C, 777.0, np.float32)        # only leader lanes read
    u_row[::Np] = u_key.numpy()
    kern = jfused.build_migration_kernel(G, Np, d, interpret=True,
                                         variant="sorted")
    nt, nw = jax.jit(kern)(
        np.ascontiguousarray(theta.numpy().T.reshape(d, R, Cf)),
        w.numpy().reshape(R, Cf), u_row.reshape(R, Cf),
        np.float32(int(n_active)).reshape(1, 1),
        gum.numpy().astype(np.float32).reshape(R, Cf))
    return np.asarray(nt).reshape(d, C).T, np.asarray(nw).reshape(C)


def _bits(x):
    return np.ascontiguousarray(x).view(np.uint32)


@pytest.mark.parametrize("G,Np", [(8, 4), (32, 16)])
def test_plain_migration_bitwise_equals_jax(G, Np):
    """Each G in {8, 32} and each Np in {4, 16} once: every (G, Np) is
    its own interpret-mode compile, seconds each on the CPU."""
    theta, w, words = _case(G * 131 + Np, G, Np)
    u_key, n_active, gum = tmig.draws(words, G, Np)
    assert (u_key[1::2] == u_key[:-1:2]).all()          # tied ranks
    want_t, want_w = _jax_migrate(theta, w, u_key, n_active, gum, G, Np)
    fire = torch.ones(1, dtype=torch.int32)
    tmig.migrate(theta, w, fire, G, Np, bits=words)
    np.testing.assert_array_equal(_bits(theta.numpy()), _bits(want_t))
    np.testing.assert_array_equal(_bits(w.numpy()), _bits(want_w))


def test_unfired_migration_is_identity():
    theta, w, words = _case(0, 8, 4)
    t0, w0 = theta.clone(), w.clone()
    tmig.migrate(theta, w, torch.zeros(1, dtype=torch.int32), 8, 4,
                 bits=words)
    assert torch.equal(theta, t0) and torch.equal(w, w0)


def test_migration_permutes_the_population():
    """A fired exchange moves whole (θ, w) rows: the multiset of rows is
    unchanged up to -0.0 becoming +0.0."""
    G, Np = 32, 16
    theta, w, words = _case(3, G, Np)
    rows0 = np.concatenate([theta.numpy() + 0.0, w.numpy()[:, None]], 1)
    tmig.migrate(theta, w, torch.ones(1, dtype=torch.int32), G, Np,
                 bits=words)
    rows1 = np.concatenate([theta.numpy(), w.numpy()[:, None]], 1)
    assert not np.array_equal(rows0, rows1)
    np.testing.assert_array_equal(rows0[np.lexsort(rows0.T)],
                                  rows1[np.lexsort(rows1.T)])
