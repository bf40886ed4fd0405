"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: without a card they skip. The file imports no JAX, so it runs
on a machine that has only PyTorch and the CUDA toolkit; the repository's
conftest imports JAX, so run it there without it:

    python -m pytest tests/test_torch_cuda.py -q --noconftest -p no:cacheprovider

f32 agrees to 1e-5 of the largest value (the row sums run in another order
than the plain product), f64 to 1e-12; Λ and P′ must be bitwise symmetric.
"""

import pytest
import torch

from ov_plane_tpu_torch.ops import kernels


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
def test_cuda_kernels_match_plain(dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels are built with nvcc for sm_90a")
    g = torch.Generator(device="cuda").manual_seed(0)
    tol = 1e-5 if dtype == torch.float32 else 1e-12
    for B, M, D in ((5, 300, 70), (64, 1320, 93), (64, 93, 93)):
        H = torch.randn(B, M, D, generator=g, device="cuda", dtype=dtype)
        r = torch.randn(B, M, generator=g, device="cuda", dtype=dtype)
        before = kernels.gram_reduce.launches
        lam, eta = kernels.gram_reduce(H, r)
        assert kernels.gram_reduce.launches == before + 1
        lam_r, eta_r = kernels.gram_reduce_ref(H, r)
        torch.cuda.synchronize()
        assert (lam - lam_r).abs().max() <= tol * lam_r.abs().max()
        assert (eta - eta_r).abs().max() <= tol * eta_r.abs().max()
        assert torch.equal(lam, lam.mT)
        cov = lam_r / M + torch.eye(D, device="cuda", dtype=dtype)
        nc, dx = kernels.kalman_downdate(cov, H, r)
        nc_r, dx_r = kernels.kalman_downdate_ref(cov, H, r)
        torch.cuda.synchronize()
        assert (nc - nc_r).abs().max() <= tol * nc_r.abs().max()
        assert (dx - dx_r).abs().max() <= tol * dx_r.abs().max()
        assert torch.equal(nc, nc.mT)
