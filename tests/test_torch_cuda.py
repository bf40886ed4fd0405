"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: without a card they skip. The file imports no JAX, so it runs
on a machine that has only PyTorch and the CUDA toolkit; the repository's
conftest imports JAX, so run it there without it:

    python -m pytest tests/test_torch_cuda.py -q --noconftest -p no:cacheprovider

The sweep is chip_smoke.py's: every D of SWEEP_D with every M of SWEEP_M
(tile, chunk and split edges, empty inputs, the filters' shapes), B cycling
over 1, 5, 64; a band
of zero (masked) rows, and H at storage offset 1 (4 bytes off 16-byte
alignment in f32) in every other entry. f32 agrees to 1e-5 of the largest
value (the row sums run in another order than the plain product), f64 to
1e-12; Λ and P′ must be bitwise symmetric, and two calls bitwise equal.
"""

import pytest
import torch

from ov_plane_tpu_torch.ops import kernels

SWEEP_D = (1, 31, 32, 63, 93, 95, 96, 114, 147, 195, 300)
SWEEP_M = (0, 1, 3, 33, 93, 94, 114, 115, 147, 148, 300, 792, 1320, 4096)
SWEEP_B = (1, 5, 64)
SWEEP = [(SWEEP_B[(i + j) % 3], M, D) for i, D in enumerate(SWEEP_D) for j, M in enumerate(SWEEP_M)]
# The filters' own shapes first: the point path's (D = 93), the plane path's
# (D = 114), the vision path's merge downdates (M = 3), the MS-PL path's
# (D = 147: the SLAM update, the plane updates, the SLAM init's 33 rows), the
# anchored MS-PT run's at 4 streams and the tabletop run's at 16.
SWEEP = [(64, 1320, 93), (64, 93, 93), (64, 1320, 114), (64, 114, 114), (64, 115, 114), (64, 3, 114),
         (64, 1320, 147), (64, 147, 147), (64, 148, 147), (64, 33, 147),
         (4, 1320, 147), (4, 147, 147), (4, 33, 147), (16, 114, 114), (16, 115, 114), (16, 3, 114)] + SWEEP


def _inputs(B, M, D, dtype, g, offset):
    n = B * M * D
    flat = torch.randn(n + 1, generator=g, device="cuda", dtype=dtype)
    H = (flat[1:] if offset else flat[:n]).view(B, M, D)
    r = torch.randn(B, M, generator=g, device="cuda", dtype=dtype)
    if M >= 3:
        H[:, M // 3:M // 2] = 0.0
        r[:, M // 3:M // 2] = 0.0
    return H, r


def _close(a, ref, tol):
    return a.numel() == 0 or (a - ref).abs().max() <= tol * ref.abs().max()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
def test_cuda_kernels_match_plain(dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels are built with nvcc for sm_90a")
    g = torch.Generator(device="cuda").manual_seed(0)
    tol = 1e-5 if dtype == torch.float32 else 1e-12
    for n, (B, M, D) in enumerate(SWEEP):
        H, r = _inputs(B, M, D, dtype, g, offset=n % 2 == 1)
        before = kernels.gram_reduce.launches
        lam, eta = kernels.gram_reduce(H, r)
        assert kernels.gram_reduce.launches == before + 1
        lam2, eta2 = kernels.gram_reduce(H, r)
        lam_r, eta_r = kernels.gram_reduce_ref(H, r)
        torch.cuda.synchronize()
        assert _close(lam, lam_r, tol) and _close(eta, eta_r, tol), (B, M, D)
        assert torch.equal(lam, lam.mT) and torch.equal(lam, lam2) and torch.equal(eta, eta2), (B, M, D)
        cov = lam_r / max(M, 1) + torch.eye(D, device="cuda", dtype=dtype)
        nc, dx = kernels.kalman_downdate(cov, H, r)
        nc2, dx2 = kernels.kalman_downdate(cov, H, r)
        nc_r, dx_r = kernels.kalman_downdate_ref(cov, H, r)
        torch.cuda.synchronize()
        assert _close(nc, nc_r, tol) and _close(dx, dx_r, tol), (B, M, D)
        assert torch.equal(nc, nc.mT) and torch.equal(nc, nc2) and torch.equal(dx, dx2), (B, M, D)
