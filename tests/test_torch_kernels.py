"""The port's two update kernels against the JAX package's Pallas kernels.

On the CPU the wrappers run their plain versions (``gram_reduce_ref``,
``kalman_downdate_ref``); those are held here against the Pallas kernels in
TPU interpret mode, on the same numpy inputs, exactly as
``tests/test_pallas_kernels.py`` runs them. f32, rtol 2e-5 / atol 2e-4: the
Pallas kernel sums 128-row tiles in another order than the plain product.

The CUDA kernels themselves run only on a card: ``tests/test_torch_cuda.py``
holds them against these plain versions there. Their launch plans
(``kernels.launch_plan`` for the gram, ``kernels.stream_plan`` for the
downdate, pure Python) are checked here at the shapes of that sweep: every
row and every upper tile is covered exactly once.
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


# The card sweep of tests/test_torch_cuda.py and chip_smoke.py, plus the main
# path's shapes.
SWEEP_D = (1, 31, 32, 63, 93, 95, 96, 195, 300)
SWEEP_M = (0, 1, 3, 93, 94, 300, 1320, 4096)
SWEEP_B = (1, 5, 64)
SWEEP = [(SWEEP_B[(i + j) % 3], M, D) for i, D in enumerate(SWEEP_D) for j, M in enumerate(SWEEP_M)]
SWEEP += [(64, 1320, 93), (64, 93, 93), (65535, 94, 93), (7, 5, 12)]


def _upper_tile(t, ntc):
    """(ti, tj), ti ≤ tj, of upper tile t, numbered row by row as the kernels do."""
    ti = 0
    while t >= ntc - ti:
        t -= ntc - ti
        ti += 1
    return ti, ti + t


def _stream_parts(b, M, rows_per_block):
    """The blocks holding stream b's rows; block i writes the stream's partial
    as part i − first block, and gram_out_kernel sums this many parts."""
    return range(b * M // rows_per_block, ((b + 1) * M - 1) // rows_per_block + 1) if M else range(0)


def _tile_cover(plan, ntc, tiles):
    """How often each (ti, tj) is computed: group g takes tiles g·tiles + w."""
    cover = np.zeros((ntc, ntc), dtype=int)
    for g in range(plan.groups):
        for w in range(tiles):
            t = g * tiles + w
            if t < ntc * (ntc + 1) // 2:
                cover[_upper_tile(t, ntc)] += 1
    return cover


@pytest.mark.parametrize("itemsize", [4, 8], ids=["f32", "f64"])
def test_launch_plan_covers_every_row_and_upper_tile_once(itemsize):
    for B, M, D in SWEEP:
        for n_sm in (132, 114):
            plan = kernels.launch_plan(B, M, D, itemsize, n_sm)
            ntc = (D + kernels.TILE) // kernels.TILE
            ld = kernels.TILE * ntc
            raw = -(-plan.chunk_rows * D * itemsize // 128) * 128
            staging = plan.stages * raw + 2 * plan.chunk_rows * ld * itemsize
            assert plan.smem_bytes <= 227 * 1024 and 1 <= plan.groups <= 65535
            assert 1 <= plan.warps <= kernels.MAX_WARPS
            assert plan.blocks * plan.groups <= kernels.BLOCKS_PER_SM * n_sm
            # Rows: block i takes [i·rows_per_block, …), none of them empty.
            rows = np.zeros(B * M, dtype=int)
            for i in range(plan.blocks):
                lo, hi = i * plan.rows_per_block, min((i + 1) * plan.rows_per_block, B * M)
                assert hi > lo
                rows[lo:hi] += 1
            assert (rows == 1).all(), (B, M, D, plan)
            # Partials: the blocks holding stream b's rows, as parts 0, 1, …
            for b in {0, B // 2, B - 1}:
                parts = _stream_parts(b, M, plan.rows_per_block)
                owners = sorted({r // plan.rows_per_block for r in range(b * M, (b + 1) * M)})
                assert list(parts) == owners and len(parts) <= plan.max_parts
            assert plan.workspace == B * plan.max_parts * ntc * (ntc + 1) // 2 * kernels.TILE ** 2
            if plan.blocks:
                assert plan.smem_bytes == kernels.BAR_BYTES + staging
            # Upper tiles: each computed by exactly one warp of one group.
            cover = _tile_cover(plan, ntc, plan.warps)
            assert (cover[np.triu_indices(ntc)] == 1).all() and not np.tril(cover, -1).any()
    # The main path's gram fills the card in one wave with one tile group (H read once).
    plan = kernels.launch_plan(64, 1320, 93, 4)
    assert plan.groups == 1 and kernels.BLOCKS_PER_SM * 132 - 6 <= plan.blocks <= kernels.BLOCKS_PER_SM * 132


@pytest.mark.parametrize("itemsize", [4, 8], ids=["f32", "f64"])
def test_stream_plan_covers_every_upper_tile_once(itemsize):
    for B, M, D in SWEEP:
        for n_sm in (132, 114):
            plan = kernels.stream_plan(B, M, D, itemsize, n_sm)
            ntc = (D + kernels.TILE) // kernels.TILE
            n_upper = ntc * (ntc + 1) // 2
            assert 1 <= plan.tiles <= kernels.MAX_WARPS and 1 <= plan.groups <= n_upper
            assert plan.threads % (32 * plan.tiles) == 0 and plan.threads <= 32 * kernels.STREAM_WARPS
            assert plan.smem_bytes <= kernels.MAX_SMEM
            # Enough blocks for every SM where the tiles allow it.
            assert B * plan.groups >= n_sm or plan.groups == n_upper, (B, M, D, plan)
            # Upper tiles: each computed by exactly one warp of one group.
            cover = _tile_cover(plan, ntc, plan.tiles)
            assert (cover[np.triu_indices(ntc)] == 1).all() and not np.tril(cover, -1).any()
            # Staging: a stream in one chunk (one bulk copy) when it fits, and
            # room for the epilogue's padded tile per warp.
            ld = kernels.TILE * ntc
            whole = kernels._staging_bytes(max(M, 1), M, D, ld, itemsize, 1)
            if whole <= kernels.MAX_SMEM:
                assert plan.chunk_rows == max(M, 1) and plan.stages == 1
            else:
                assert plan.chunk_rows < M and 1 <= plan.stages <= kernels.STAGES
            assert plan.smem_bytes >= kernels._staging_bytes(plan.chunk_rows, M, D, ld, itemsize, plan.stages)
            assert plan.smem_bytes >= kernels.BAR_BYTES + plan.threads * 33 * itemsize
    # The main path's downdate: one bulk copy of a stream's W, 6 tiles over
    # 3 groups of 2 (192 blocks), 4 row slices per tile.
    plan = kernels.stream_plan(64, 93, 93, 4)
    assert (plan.groups, plan.tiles, plan.threads, plan.chunk_rows, plan.stages) == (3, 2, 256, 93, 1)


@pytest.mark.parametrize("D", SWEEP_D)
def test_span_element_row_by_float_reciprocal(D):
    """The kernel finds the row of element e of a chunk's span as
    ⌊(e + 0.5)·fl(1/D)⌋ in f32 (round to nearest at each step); exact for
    every element of every chunk the plans can stage (one block's shared
    memory of f32 at most)."""
    inv_d = np.float32(1.0) / np.float32(D)
    e = np.arange(max(kernels.MAX_SMEM // 4, kernels.TILE * D))
    k = np.floor((e.astype(np.float32) + np.float32(0.5)) * inv_d).astype(np.int64)
    np.testing.assert_array_equal(k, e // D)


def test_build_key_follows_every_included_header(tmp_path, monkeypatch):
    """The library's name hashes the source and every csrc/ header it
    includes, through other headers too, so an edited header is rebuilt."""
    (tmp_path / "k.cu").write_text('#include "a.cuh"\n#include <cuda_runtime.h>\n')
    (tmp_path / "a.cuh").write_text('#pragma once\n#include "sub/b.cuh"\n')
    (tmp_path / "sub").mkdir()
    (tmp_path / "sub" / "b.cuh").write_text("#pragma once\nconstexpr int kB = 1;\n")
    monkeypatch.setattr(kernels, "CSRC", tmp_path)
    monkeypatch.setitem(kernels.SOURCES, "k", "k.cu")
    assert sorted(f.name for f in kernels.source_files("k")) == ["a.cuh", "b.cuh", "k.cu"]
    before = kernels._lib_path("k")
    (tmp_path / "sub" / "b.cuh").write_text("#pragma once\nconstexpr int kB = 2;\n")
    assert kernels._lib_path("k") != before
    # The port's own sources: both kernels share gram_tile.cuh.
    monkeypatch.undo()
    for name in ("gram_reduce", "kalman_downdate"):
        assert {f.name for f in kernels.source_files(name)} == {f"{name}.cu", "gram_tile.cuh"}
