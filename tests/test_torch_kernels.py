"""The port's two update kernels against the JAX package's Pallas kernels.

On the CPU the wrappers run their plain versions (``gram_reduce_ref``,
``kalman_downdate_ref``); those are held here against the Pallas kernels in
TPU interpret mode, on the same numpy inputs, exactly as
``tests/test_pallas_kernels.py`` runs them. f32, rtol 2e-5 / atol 2e-4: the
Pallas kernel sums 128-row tiles in another order than the plain product.

The CUDA kernels themselves run only on a card: ``tests/test_torch_cuda.py``
holds them against these plain versions there. Their launch plans (pure
Python: ``kernels.launch_plan`` and ``kernels.stream_plan`` for f32,
``kernels.gram_f64_plan`` and ``kernels.downdate_f64_plan`` for the f64
tensor-core kernels) are checked here at the shapes of that sweep and at the
f64 shapes the filter's paths launch: every row and every upper tile or MMA
fragment is covered exactly once, and shared memory and clusters stay within
the card's limits.
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
# The f64 launch shapes of chip_smoke.PATH_SHAPES: every path's gram, the
# one-stream downdates of the replay (D = 156; 204 with ArUco landmarks),
# run_persistent_map (114) and viz_replay (141), the sharded point's
# (64, 93, 93); and one lone stream whose last row slice is short and
# staged in several chunks.
F64_GRAM_SHAPES = [(64, 1320, 93), (64, 1320, 114), (64, 1320, 147), (4, 1320, 147), (20, 1320, 114),
                   (20, 1320, 147), (16, 1320, 129), (16, 1320, 114), (8, 1320, 102), (64, 660, 93),
                   (2, 1320, 114), (4, 1320, 114)]
F64_DOWNDATE_SHAPES = [(1, M, D) for D in (156, 204, 141) for M in (D, D + 1, 33, 3)]
F64_DOWNDATE_SHAPES += [(1, 114, 114), (1, 115, 114), (64, 93, 93), (1, 999, 141)]


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


def _fragment_cover(D, items):
    """How often each 16×8 fragment (fi, fj) of the augmented Gram is
    computed by the warp items ``items``."""
    g = kernels.f64_geometry(D)
    cover = np.zeros((g.nfi, g.nfj), dtype=int)
    for w in items:
        for fi, fj in kernels.f64_item_fragments(D, w):
            cover[fi, fj] += 1
    return cover


def _check_fragment_cover(D, cover):
    """Every fragment that reaches the upper triangle exactly once, no other;
    so every (i, j), i ≤ j ≤ D, of the augmented Gram lies in a computed
    fragment, and each computed fragment lies in an upper 32×32 tile of the
    f32 path's workspace layout."""
    g = kernels.f64_geometry(D)
    fi, fj = np.meshgrid(np.arange(g.nfi), np.arange(g.nfj), indexing="ij")
    upper = 8 * fj + 7 >= 16 * fi
    assert (cover[upper] == 1).all() and not cover[~upper].any(), D
    i, j = np.triu_indices(D + 1)
    assert (cover[i // 16, j // 8] == 1).all()
    assert (fj[upper] // 4 >= fi[upper] // 2).all() and (fj[upper] // 4 < (D + 32) // 32).all()


def _check_gram_f64_plan(B, M, D, n_sm):
    plan = kernels.gram_f64_plan(B, M, D, n_sm)
    g = kernels.f64_geometry(D)
    ntc = (D + kernels.TILE) // kernels.TILE
    assert plan.smem_bytes <= kernels.MAX_SMEM and 1 <= plan.groups <= 65535
    assert plan.items_per_group <= plan.warps <= kernels.F64_MAX_WARPS and plan.warps >= kernels.F64_MIN_WARPS
    assert plan.chunk_rows % kernels.F64_K == 0 and 0 < plan.chunk_rows <= 64 * plan.warps
    assert plan.blocks * plan.groups <= max(n_sm, plan.groups)
    rows = np.zeros(B * M, dtype=int)
    for i in range(plan.blocks):
        lo, hi = i * plan.rows_per_block, min((i + 1) * plan.rows_per_block, B * M)
        assert hi > lo
        rows[lo:hi] += 1
    assert (rows == 1).all(), (B, M, D, plan)
    for b in {0, B // 2, B - 1}:
        parts = _stream_parts(b, M, plan.rows_per_block)
        owners = sorted({r // plan.rows_per_block for r in range(b * M, (b + 1) * M)})
        assert list(parts) == owners and len(parts) <= plan.max_parts
    assert plan.workspace == B * plan.max_parts * ntc * (ntc + 1) // 2 * kernels.TILE ** 2
    if plan.blocks:
        assert plan.smem_bytes == kernels._f64_staging_bytes(plan.chunk_rows, D, g.ldy, plan.stages, 2)
    # Upper fragments: group g's warp w computes item g·items_per_group + w.
    items = [gr * plan.items_per_group + w for gr in range(plan.groups) for w in range(plan.items_per_group)]
    assert max(items) >= g.items - 1
    _check_fragment_cover(D, _fragment_cover(D, [w for w in items if w < g.items]))


@pytest.mark.parametrize("itemsize", [4, 8], ids=["f32", "f64"])
def test_launch_plan_covers_every_row_and_upper_tile_once(itemsize):
    """f32: ``launch_plan`` (32×32 warp tiles); f64: ``gram_f64_plan``
    (16×8 MMA fragments in warp items), at the sweep's shapes and the
    paths' f64 gram shapes."""
    if itemsize == 8:
        for B, M, D in SWEEP + F64_GRAM_SHAPES:
            for n_sm in (132, 114):
                _check_gram_f64_plan(B, M, D, n_sm)
        # The main path's gram: one group (H read once), a block on every SM.
        plan = kernels.gram_f64_plan(64, 1320, 114)
        assert (plan.groups, plan.warps, plan.blocks) == (1, 8, 132)
        return
    for B, M, D in SWEEP:
        for n_sm in (132, 114):
            plan = kernels.launch_plan(B, M, D, n_sm)
            ntc = (D + kernels.TILE) // kernels.TILE
            ld = kernels.TILE * ntc
            raw = -(-plan.chunk_rows * D * 4 // 128) * 128
            staging = plan.stages * raw + 2 * plan.chunk_rows * ld * 4
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
    plan = kernels.launch_plan(64, 1320, 93)
    assert plan.groups == 1 and kernels.BLOCKS_PER_SM * 132 - 6 <= plan.blocks <= kernels.BLOCKS_PER_SM * 132


def _check_downdate_f64_plan(B, M, D, n_sm):
    plan = kernels.downdate_f64_plan(B, M, D, n_sm)
    g = kernels.f64_geometry(D)
    assert plan.smem_bytes <= kernels.MAX_SMEM
    assert 1 <= plan.slices <= kernels.F64_CLUSTER and 1 <= plan.ranks <= min(plan.slices, kernels.F64_RANKS, 16)
    assert plan.slices % plan.ranks == 0 and (plan.ranks > 1) == (M > kernels.F64_SHORT and plan.slices > 1)
    # Once slices are used, one block per SM, or two of at most 4 warps (a
    # thread takes 255 registers; an SM sub-partition holds two such warps).
    assert plan.slices == 1 or B * plan.groups * plan.slices <= (n_sm if plan.warps > 4 else 2 * n_sm)
    assert B <= 65535 and 1 <= plan.items_per_group <= plan.warps <= kernels.F64_MAX_WARPS
    # One block per SM where the items allow it; slices only where most SMs would idle.
    assert B * plan.groups <= n_sm or plan.groups == -(-g.items // kernels.F64_MAX_WARPS), (B, M, D, plan)
    assert B * plan.groups >= n_sm // 2 or plan.groups == g.items or plan.items_per_group == 1
    # Rows: every row of a stream in exactly one slice, every 8-row step of
    # a slice taken by exactly one of an item's warps.
    rows = np.zeros(M, dtype=int)
    for s in range(plan.ranks):
        rows[min(s * plan.slice_rows, M):min((s + 1) * plan.slice_rows, M)] += 1
    assert (rows == 1).all(), (B, M, D, plan)
    # The shares of the sums: every element stored by exactly one block of the group.
    E = plan.items_per_group * kernels.F64_FRAGS * 128
    shares = np.zeros(E, dtype=int)
    for s in range(plan.slices):
        shares[s * E // plan.slices:(s + 1) * E // plan.slices] += 1
    assert (shares == 1).all()
    parts = plan.warps // plan.items_per_group
    share = -(-plan.items_per_group * kernels.F64_FRAGS * 128 // plan.slices)
    assert plan.warps == parts * plan.items_per_group
    assert parts <= max(1, -(-plan.slice_rows // kernels.F64_K), -(-share // (32 * plan.warps // parts * kernels.F64_PRE)))
    assert share <= 32 * plan.warps * kernels.F64_PRE or plan.warps > kernels.F64_MAX_WARPS - plan.items_per_group
    steps = np.zeros(-(-plan.slice_rows // kernels.F64_K), dtype=int)
    for piece in range(parts):
        steps[piece::parts] += 1
    assert (steps == 1).all()  # a warp past the last step adds zeros
    # Shared memory: the group's fragment table, each warp's fragment sums.
    assert plan.items_per_group * kernels.F64_FRAGS * 4 <= kernels.F64_TAB
    assert plan.smem_bytes == kernels.F64_TAB + plan.warps * kernels.F64_FRAGS * 128 * 8
    items = [gr * plan.items_per_group + w for gr in range(plan.groups) for w in range(plan.items_per_group)]
    _check_fragment_cover(D, _fragment_cover(D, [w for w in items if w < g.items]))
    return plan


@pytest.mark.parametrize("itemsize", [4, 8], ids=["f32", "f64"])
def test_stream_plan_covers_every_upper_tile_once(itemsize):
    """f32: ``stream_plan``; f64: ``downdate_f64_plan`` (row slices over a
    cluster), at the sweep's shapes and the paths' f64 downdate shapes."""
    if itemsize == 8:
        for B, M, D in SWEEP + F64_DOWNDATE_SHAPES:
            for n_sm in (132, 114):
                _check_downdate_f64_plan(B, M, D, n_sm)
        return
    for B, M, D in SWEEP:
        for n_sm in (132, 114):
            plan = kernels.stream_plan(B, M, D, n_sm)
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
            whole = kernels._staging_bytes(max(M, 1), M, D, ld, 1)
            if whole <= kernels.MAX_SMEM:
                assert plan.chunk_rows == max(M, 1) and plan.stages == 1
            else:
                assert plan.chunk_rows < M and 1 <= plan.stages <= kernels.STAGES
            assert plan.smem_bytes >= kernels._staging_bytes(plan.chunk_rows, M, D, ld, plan.stages)
            assert plan.smem_bytes >= kernels.BAR_BYTES + plan.threads * 33 * 4
    # The main path's downdate: one bulk copy of a stream's W, 6 tiles over
    # 3 groups of 2 (192 blocks), 4 row slices per tile.
    plan = kernels.stream_plan(64, 93, 93)
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
    # The port's own sources: both kernels share gram_dmma.cuh (f64), which
    # includes gram_tile.cuh (f32).
    monkeypatch.undo()
    for name in ("gram_reduce", "kalman_downdate"):
        assert {f.name for f in kernels.source_files(name)} == {f"{name}.cu", "gram_dmma.cuh", "gram_tile.cuh"}


def test_imu_kernel_is_built_like_the_others(tmp_path, monkeypatch):
    """The IMU window kernel sits in the build table beside the grams: one
    source with no csrc/ header, a library named by its hash (an edit of the
    .cu renames it), and a launcher of the 14 pointers, B, W, the variant
    and the stream."""
    import ctypes
    from types import SimpleNamespace

    assert kernels.SOURCES["imu_propagate"] == "imu_propagate.cu"
    assert [f.name for f in kernels.source_files("imu_propagate")] == ["imu_propagate.cu"]
    src = (kernels.CSRC / "imu_propagate.cu").read_text()
    (tmp_path / "imu_propagate.cu").write_text(src)
    monkeypatch.setattr(kernels, "CSRC", tmp_path)
    before = kernels._lib_path("imu_propagate")
    assert before.name.startswith("libovp_imu_propagate_") and before.parent == kernels.BUILD_DIR
    (tmp_path / "imu_propagate.cu").write_text(src.replace("kChunk = 64", "kChunk = 32"))
    assert kernels._lib_path("imu_propagate") != before
    fns = {f"ovp_imu_propagate_{t}": SimpleNamespace() for t in ("f32", "f64")}
    kernels._declare(SimpleNamespace(**fns), "imu_propagate")
    for fn in fns.values():
        assert fn.argtypes == [ctypes.c_void_p] * 14 + [ctypes.c_int] * 3 + [ctypes.c_void_p]


def test_propagate_mean_cov_dispatch_by_device():
    """A CPU tensor takes the plain loop (no launch, the same bits); a tensor
    on any other device goes to the kernel, which raises where it cannot take
    it: no fallback."""
    from ov_plane_tpu_torch.state import propagator as prop

    B, W = 2, 5
    g = torch.Generator().manual_seed(0)
    imu = torch.zeros(B, 16, dtype=torch.float64)
    imu[:, 3] = 1.0
    t = 1.0 + 0.0025 * torch.arange(W, dtype=torch.float64).expand(B, W)
    args = (imu, imu.clone(), t, torch.randn(B, W, 3, generator=g, dtype=torch.float64),
            torch.randn(B, W, 3, generator=g, dtype=torch.float64), t[:, 0] + 1e-3, t[:, -1] - 1e-3,
            torch.full((4,), 1e-6, dtype=torch.float64), torch.tensor([0.0, 0.0, 9.81], dtype=torch.float64))
    before = kernels.imu_propagate.launches
    got = prop.propagate_mean_cov(*args, prop.PropagatorOptions())
    for a, b in zip(got, prop.propagate_mean_cov_ref(*args, prop.PropagatorOptions())):
        assert torch.equal(a, b)
    assert kernels.imu_propagate.launches == before
    with pytest.raises(ValueError, match="CUDA device"):
        prop.propagate_mean_cov(*(a.to("meta") for a in args), prop.PropagatorOptions())
    assert kernels.imu_propagate.launches == before


@pytest.mark.parametrize("D", sorted(set(SWEEP_D) | {102, 114, 129, 141, 147, 156, 204, 255, 256, 511}))
def test_f64_items_cover_every_upper_fragment_once(D):
    """The warp items of the f64 kernels (``gram_dmma.cuh`` ``item``,
    mirrored by ``kernels.f64_item_fragments``): every fragment that reaches
    the upper triangle of the augmented Gram in exactly one item; an item is
    at most F64_FRAGS fragments of at most two bands; the items of a band
    pair are equal but for the last."""
    g = kernels.f64_geometry(D)
    frags = [kernels.f64_item_fragments(D, w) for w in range(g.items)]
    _check_fragment_cover(D, _fragment_cover(D, range(g.items)))
    for f in frags:
        assert 1 <= len(f) <= kernels.F64_FRAGS and len({fi for fi, _ in f}) <= 2
    for p in range(g.npairs):
        sizes = [len(f) for f in frags[p * g.wpp:(p + 1) * g.wpp]]
        assert sizes[:-1] == [kernels.F64_FRAGS] * (g.wpp - 1) and sum(sizes) == g.lp
    # The staged tile's row-pair stride: 16-byte rows, and eight lanes of a
    # quarter warp (g in 0..1, t in 0..3) on eight distinct 16-byte banks.
    assert g.ldy % 2 == 0 and g.ldy >= 2 * 16 * g.nfi and g.ldy % 16 == 4
    banks = {((t * g.ldy + 2 * c) // 2) % 8 for t in range(4) for c in range(2)}
    assert len(banks) == 8


@pytest.mark.parametrize("shape", [(1, 156, 156), (1, 205, 204), (1, 141, 141), (1, 114, 114), (1, 3, 204)],
                         ids=lambda s: "x".join(map(str, s)))
def test_downdate_f64_plan_splits_a_lone_stream_over_a_cluster(shape):
    """One stream (the replays and scripts): one warp item per tile group,
    its sums stored by 2 to 8 blocks per group, the whole launch within one
    wave of the card at one block per SM; the rows of a long stream cut into
    slices over a cluster of up to 4 of those blocks, a short one (M = 3)
    taken whole by each."""
    B, M, D = shape
    plan = _check_downdate_f64_plan(B, M, D, 132)
    assert plan.items_per_group == 1 and plan.groups == kernels.f64_geometry(D).items
    assert 2 <= plan.slices <= 8 and plan.groups * plan.slices <= (132 if plan.warps > 4 else 264)
    assert plan.ranks == (min(plan.slices, kernels.F64_RANKS) if M > 64 else 1)


def test_launchers_take_every_plan_field():
    """The ctypes signature of each launcher (``kernels._declare``) holds the
    five pointers, B, M, D, the plan's launch fields as the wrapper passes
    them, and the stream."""
    import ctypes
    from types import SimpleNamespace

    fns = {f"ovp_{n}_{t}": SimpleNamespace() for n in kernels.SOURCES for t in ("f32", "f64")}
    for name in kernels.SOURCES:
        kernels._declare(SimpleNamespace(**fns), name)
    plans = {("gram_reduce", "f32"): kernels._plan_args(kernels.launch_plan(2, 50, 20)),
             ("gram_reduce", "f64"): kernels._plan_args(kernels.gram_f64_plan(2, 50, 20)),
             ("kalman_downdate", "f32"): tuple(kernels.stream_plan(2, 50, 20)),
             ("kalman_downdate", "f64"): tuple(kernels.downdate_f64_plan(2, 50, 20))}
    for (name, t), plan in plans.items():
        types = fns[f"ovp_{name}_{t}"].argtypes
        assert types[:5] == [ctypes.c_void_p] * 5 and types[-1] is ctypes.c_void_p
        assert len(types) == 5 + 3 + len(plan) + 1, (name, t)
