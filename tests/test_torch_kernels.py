"""The port's two update kernels against the JAX package's Pallas kernels.

On the CPU the wrappers run their plain versions (``gram_reduce_ref``,
``kalman_downdate_ref``); those are held here against the Pallas kernels in
TPU interpret mode, on the same numpy inputs, exactly as
``tests/test_pallas_kernels.py`` runs them. f32, rtol 2e-5 / atol 2e-4: the
Pallas kernel sums 128-row tiles in another order than the plain product.

The CUDA kernels themselves run only on a card: ``tests/test_torch_cuda.py``
holds them against these plain versions there.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ov_plane_tpu.ops import pallas_kernels as pk
from ov_plane_tpu_torch.ops import kernels

TOL = dict(rtol=2e-5, atol=2e-4)
# (B, M, D): the unaligned shapes of the Pallas tests, then the slice's own
# (gram: M = 40 features x (3*12 - 3) rows, D = 93; downdate: M = D = 93).
GRAM_SHAPES = [(5, 300, 70), (2, 1320, 93)]
DOWNDATE_SHAPES = [(4, 300, 70), (2, 93, 93)]


def _pallas(fn, *args):
    from jax.experimental.pallas import tpu as pltpu

    with pltpu.force_tpu_interpret_mode():
        return jax.vmap(lambda *a: fn(*a, tile_m=128))(*(jnp.asarray(a) for a in args))


@pytest.mark.parametrize("shape", GRAM_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_gram_reduce_plain_matches_pallas(shape):
    rng = np.random.default_rng(17)
    B, M, D = shape
    H = rng.normal(size=(B, M, D)).astype(np.float32)
    r = rng.normal(size=(B, M)).astype(np.float32)
    H[:, M // 3:M // 2] = 0.0  # masked rows contribute nothing
    r[:, M // 3:M // 2] = 0.0
    lam_j, eta_j = _pallas(pk.gram_reduce_pallas, H, r)
    lam, eta = kernels.gram_reduce(torch.from_numpy(H), torch.from_numpy(r))
    np.testing.assert_allclose(lam.numpy(), np.asarray(lam_j), **TOL)
    np.testing.assert_allclose(eta.numpy(), np.asarray(eta_j), **TOL)
    assert torch.equal(lam, lam.transpose(-1, -2))


@pytest.mark.parametrize("shape", DOWNDATE_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_kalman_downdate_plain_matches_pallas(shape):
    rng = np.random.default_rng(18)
    B, M, D = shape
    A = rng.normal(size=(B, D, D))
    cov = (A @ A.transpose(0, 2, 1) + D * np.eye(D)).astype(np.float32)
    W = rng.normal(size=(B, M, D)).astype(np.float32)
    u = rng.normal(size=(B, M)).astype(np.float32)
    nc_j, dx_j = _pallas(pk.kalman_downdate_pallas, cov, W, u)
    nc, dx = kernels.kalman_downdate(torch.from_numpy(cov), torch.from_numpy(W), torch.from_numpy(u))
    np.testing.assert_allclose(nc.numpy(), np.asarray(nc_j), **TOL)
    np.testing.assert_allclose(dx.numpy(), np.asarray(dx_j), **TOL)
    assert torch.equal(nc, nc.transpose(-1, -2))


def test_cpu_tensors_take_the_plain_version_without_counting():
    kernels.reset_launch_counts()
    H = torch.randn(3, 50, 20, dtype=torch.float64)
    r = torch.randn(3, 50, dtype=torch.float64)
    lam, eta = kernels.gram_reduce(H, r)
    lam_r, eta_r = kernels.gram_reduce_ref(H, r)
    assert torch.equal(lam, lam_r) and torch.equal(eta, eta_r)
    cov = lam + torch.eye(20, dtype=torch.float64)
    nc, dx = kernels.kalman_downdate(cov, H, r)
    torch.testing.assert_close(nc, cov - H.mT @ H, rtol=1e-12, atol=1e-12)
    torch.testing.assert_close(dx, (H.mT @ r[..., None])[..., 0], rtol=1e-12, atol=1e-12)
    # The counts are of kernel launches only.
    assert kernels.gram_reduce.launches == 0 and kernels.kalman_downdate.launches == 0


def test_wrappers_reject_bad_shapes():
    H = torch.randn(2, 10, 4)
    with pytest.raises(ValueError):
        kernels.gram_reduce(H, torch.randn(2, 9))
    with pytest.raises(ValueError):
        kernels.kalman_downdate(torch.randn(2, 5, 5), H, torch.randn(2, 10))
