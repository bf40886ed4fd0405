"""The port's vision frontend against the JAX package, module by module.

The same numpy inputs go to the JAX function (per stream) and to the port
(all streams at once, on the CPU). Where the JAX function follows its
inputs' type the comparison runs in float64; the bf16 KLT sampler and the
renderer's float32 output are compared at their own type's tolerance.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ov_plane_tpu.frontend import fast as j_fast
from ov_plane_tpu.frontend import imageproc as j_ip
from ov_plane_tpu.frontend import klt as j_klt
from ov_plane_tpu.frontend import ransac as j_ransac
from ov_plane_tpu.frontend import fused as j_fused
from ov_plane_tpu.frontend.synthetic import render_frame_textured as j_render
from ov_plane_tpu.ops.quat import quat_2_rot as j_quat_2_rot
from ov_plane_tpu_torch.frontend import fast as t_fast
from ov_plane_tpu_torch.frontend import fused as t_fused
from ov_plane_tpu_torch.frontend import imageproc as t_ip
from ov_plane_tpu_torch.frontend import klt as t_klt
from ov_plane_tpu_torch.frontend import ransac as t_ransac
from ov_plane_tpu_torch.frontend.synthetic import render_frame_textured as t_render
from ov_plane_tpu_torch.sim import simulator as tsim

torch.set_num_threads(1)
f64 = torch.float64


@pytest.fixture(scope="module")
def scene():
    with np.load(tsim.VISION_SCENE_PATH) as z:
        return {k: z[k] for k in z.files}


def _render_jax(scene, i, wh, zeta, **kw):
    R = np.asarray(j_quat_2_rot(jnp.asarray(scene["gt_q"][i])))
    return j_render(scene["plane_corners"], scene["plane_normal"], scene["plane_d"], None, R, scene["gt_p"][i],
                    np.eye(3), np.zeros(3), np.asarray(zeta, np.float64), wh, blobs=False, **kw)


@pytest.fixture(scope="module")
def frames(scene):
    """Two consecutive 320×240 frames of the vision scene from the JAX
    renderer, with pixel noise, on the 8-bit lattice: [2, 240, 320] f64."""
    rng = np.random.default_rng(3)
    out = []
    for i in (60, 61):
        img = _render_jax(scene, i, (320, 240), [150.0, 150.0, 160.0, 120.0, 0.0, 0.0, 0.0, 0.0])
        img = np.clip(img + rng.normal(0.0, 0.01, img.shape), 0.0, 1.0)
        out.append(np.rint(img * 255.0) / 255.0)
    return np.stack(out)


@pytest.mark.parametrize("layers", [{}, dict(texture_cell=0.1, speckle_cells=((0.05, 0.12, 0.30), 0.12))],
                         ids=["default", "tuple_layers"])
def test_render_frame_textured_matches_jax(scene, layers):
    """The default layers, and the tabletop scene's: a (cell, r_lo, r_hi)
    layer beside a scalar one."""
    zeta = [75.0, 75.0, 80.0, 60.0, 0.0, 0.0, 0.0, 0.0]
    for i in (1, 45):
        ref = _render_jax(scene, i, (160, 120), zeta, **layers)
        R = j_quat_2_rot(jnp.asarray(scene["gt_q"][i]))
        got = t_render(torch.as_tensor(scene["plane_corners"]), scene["plane_normal"], scene["plane_d"],
                       np.asarray(R), scene["gt_p"][i], np.eye(3), np.zeros(3), zeta, (160, 120), **layers)
        assert got.dtype == torch.float32 and got.shape == (120, 160)
        d = np.abs(got.numpy().astype(np.float64) - ref)
        print(f"frame {i}: max|d| {d.max():.3e}, {(d > 0).sum()} of {d.size} pixels differ")
        assert d.max() <= 1e-6


@pytest.mark.parametrize("method", [j_ip.NONE, j_ip.HISTOGRAM, j_ip.CLAHE])
def test_preprocess(frames, method):
    """NONE and HISTOGRAM within 1e-12. JAX's CLAHE computes in float32
    whatever the image's type (float32 tables, weakly typed weights), and
    XLA's CPU code fuses some of its products into FMAs: within 2 float32
    ulps of 1 (2^-22)."""
    got = t_ip.preprocess(torch.as_tensor(frames), method)
    tol = 2.0**-22 if method == j_ip.CLAHE else 1e-12
    for b in range(2):
        ref = np.asarray(j_ip.preprocess(jnp.asarray(frames[b]), method))
        assert got[b].dtype == {j_ip.NONE: f64, j_ip.HISTOGRAM: torch.float32, j_ip.CLAHE: f64}[method]
        np.testing.assert_allclose(got[b].numpy(), ref, rtol=0, atol=tol)


def test_pyramid_and_prepare(frames):
    t_pyr = t_klt.build_pyramid(torch.as_tensor(frames), 5)
    t_prep = t_klt.prepare_pyramid(t_pyr, 7)
    for b in range(2):
        j_pyr = j_klt.build_pyramid(jnp.asarray(frames[b]), 5)
        j_prep = j_klt.prepare_pyramid(tuple(j_pyr), 7)
        for lvl in range(5):
            np.testing.assert_allclose(t_pyr[lvl][b].numpy(), np.asarray(j_pyr[lvl]), rtol=0, atol=1e-12)
            np.testing.assert_allclose(t_prep.padded[lvl][b].numpy(), np.asarray(j_prep.padded[lvl]), rtol=0,
                                       atol=1e-12)
            for g in range(2):
                np.testing.assert_allclose(t_prep.grads[lvl][g][b].numpy(), np.asarray(j_prep.grads[lvl][g]),
                                           rtol=0, atol=1e-12)


def test_fast_score_map(frames):
    opts = j_fast.FastOptions(threshold=15.0 / 255.0)
    got = t_fast.fast_score_map(torch.as_tensor(frames), t_fast.FastOptions(threshold=15.0 / 255.0))
    for b in range(2):
        ref = np.asarray(j_fast.fast_score_map(jnp.asarray(frames[b]), opts))
        assert (ref > 0).sum() > 50
        np.testing.assert_array_equal(got[b].numpy() > 0, ref > 0)
        np.testing.assert_allclose(got[b].numpy(), ref, rtol=0, atol=1e-12)
    # In f32 the score is summed in ring order, bit for bit as the JAX package sums it.
    got32 = t_fast.fast_score_map(torch.as_tensor(frames, dtype=torch.float32), t_fast.FastOptions(15.0 / 255.0))
    for b in range(2):
        ref32 = np.asarray(j_fast.fast_score_map(jnp.asarray(frames[b], jnp.float32), opts))
        np.testing.assert_array_equal(got32[b].numpy(), ref32)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_detect_grid(frames, dtype):
    rng = np.random.default_rng(4)
    occ_uv = np.stack([rng.uniform(-2, 322, (2, 64)), rng.uniform(-2, 242, (2, 64))], axis=-1)
    occ_mask = rng.random((2, 64)) < 0.5
    imgs = frames.astype(dtype)
    opts = dict(threshold=15.0 / 255.0, grid_x=20, grid_y=20, max_features=55)
    uv, ok = t_fast.detect_grid(torch.as_tensor(imgs), torch.as_tensor(occ_uv.astype(dtype)),
                                torch.as_tensor(occ_mask), t_fast.FastOptions(**opts), 240, 320)
    for b in range(2):
        j_uv, j_ok = j_fast.detect_grid(jnp.asarray(imgs[b]), jnp.asarray(occ_uv[b].astype(dtype)),
                                        jnp.asarray(occ_mask[b]), j_fast.FastOptions(**opts), 240, 320)
        np.testing.assert_array_equal(ok[b].numpy(), np.asarray(j_ok))
        np.testing.assert_array_equal(uv[b].numpy(), np.asarray(j_uv))
        assert 10 < int(j_ok.sum()) <= 55


def _ransac_inputs(rng, B=3, N=64):
    """Correspondences of a rotation + translation with outliers and masked slots."""
    uvn1 = rng.uniform(-0.6, 0.6, (B, N, 2))
    R = np.stack([np.asarray(j_quat_2_rot(jnp.asarray(q / np.linalg.norm(q))))
                  for q in np.concatenate([rng.normal(0, 0.02, (B, 3)), np.ones((B, 1))], axis=1)])
    t = rng.normal(0, 0.05, (B, 3))
    depth = rng.uniform(1.0, 4.0, (B, N))
    p = np.concatenate([uvn1, np.ones((B, N, 1))], axis=-1) * depth[..., None]
    p2 = np.einsum("bij,bnj->bni", R, p) + t[:, None, :]
    uvn2 = p2[..., :2] / p2[..., 2:3] + rng.normal(0, 2e-4, (B, N, 2))
    out = rng.random((B, N)) < 0.2
    uvn2 = np.where(out[..., None], uvn2 + rng.uniform(-0.05, 0.05, (B, N, 2)), uvn2)
    mask = rng.random((B, N)) < 0.8
    mask[2, 3:] = False                     # a stream with too few valid pairs
    return uvn1, uvn2, mask, R


def test_gyro_ransac():
    rng = np.random.default_rng(5)
    uvn1, uvn2, mask, R = _ransac_inputs(rng)
    opts = t_ransac.RansacOptions()
    inl, best_t, n_in = t_ransac.gyro_ransac(torch.as_tensor(uvn1), torch.as_tensor(uvn2), torch.as_tensor(mask),
                                             torch.as_tensor(R), opts)
    assert n_in.dtype == torch.int64
    compared = 0
    for b in range(3):
        j_inl, j_t, j_n = j_ransac.gyro_ransac(jnp.asarray(uvn1[b]), jnp.asarray(uvn2[b]), jnp.asarray(mask[b]),
                                               jnp.asarray(R[b]), j_ransac.RansacOptions())
        np.testing.assert_array_equal(inl[b].numpy(), np.asarray(j_inl))
        assert int(n_in[b]) == int(j_n)
        if np.linalg.norm(np.asarray(j_t)) > 0.5:
            np.testing.assert_allclose(best_t[b].numpy(), np.asarray(j_t), rtol=0, atol=1e-12)
            compared += 1
        else:
            # A hypothesis that pairs a track with itself explains every
            # match and wins: its cross product is exactly 0 here and a
            # rounding residue of XLA's fused multiply-adds there (|t| ≤ 1e-4).
            assert float(torch.linalg.vector_norm(best_t[b])) < 1e-4 and np.linalg.norm(np.asarray(j_t)) < 1e-4
    assert compared >= 1
    assert not inl[0].all() and inl[0].any()


def test_gyro_ransac_int64_hashes():
    """The hypothesis hashes need int64: 63·2654435761 overflows int32."""
    n_valid = torch.tensor([[37]])
    h = torch.arange(64, dtype=torch.int64)[None]
    ours = ((h * 2654435761) % n_valid)[0].numpy()
    theirs = np.asarray((jnp.arange(64, dtype=jnp.int64) * 2654435761) % 37)
    np.testing.assert_array_equal(ours, theirs)
    assert (np.arange(64, dtype=np.int64) * 2654435761).max() > np.iinfo(np.int32).max


def test_integrate_gyro():
    rng = np.random.default_rng(6)
    B, W = 3, 64
    imu_t = np.full((B, W), np.inf)
    n = (40, 41, 64)
    for b in range(B):
        imu_t[b, :n[b]] = 2.0 + np.arange(n[b]) / 400.0
    imu_w = rng.normal(0, 0.5, (B, W, 3))
    t0 = np.array([2.001, 2.0, 2.003])
    t1 = np.array([2.09, 2.1, 2.12])
    bg = rng.normal(0, 0.01, (B, 3))
    got = t_ransac.integrate_gyro(*(torch.as_tensor(a) for a in (imu_t, imu_w, t0, t1, bg)))
    for b in range(B):
        ref = np.asarray(j_ransac.integrate_gyro(jnp.asarray(imu_t[b]), jnp.asarray(imu_w[b]), jnp.asarray(t0[b]),
                                                 jnp.asarray(t1[b]), jnp.asarray(bg[b])))
        np.testing.assert_allclose(got[b].numpy(), ref, rtol=0, atol=1e-12)


def _sym_psd(rng, shape):
    X = rng.normal(0, 1, shape + (3, 5))
    A = X @ np.swapaxes(X, -1, -2)
    A[0] = 2.5 * np.eye(3)               # the isotropic branch
    return A


def test_inv3_and_eigvals3():
    rng = np.random.default_rng(7)
    A = _sym_psd(rng, (16,))
    A[1] = np.diag([1.0, 1e-3, 1e-6])
    ridge = rng.uniform(0, 1e-3, 16)
    np.testing.assert_allclose(t_fused._inv3(torch.as_tensor(A), torch.as_tensor(ridge)).numpy(),
                               np.asarray(j_fused._inv3(jnp.asarray(A), jnp.asarray(ridge))), rtol=0, atol=1e-10)
    for ours, theirs in zip(t_fused._eigvals3_sym(torch.as_tensor(A)), j_fused._eigvals3_sym(jnp.asarray(A))):
        np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), rtol=0, atol=1e-10)


def test_solve_tracks():
    rng = np.random.default_rng(8)
    B, cap = 2, 16
    # Whole-track systems of rays from a few camera centres through points.
    pts = rng.uniform(-1, 1, (B, cap, 3)) + np.array([0.0, 0.0, 3.0])
    A = np.zeros((B, cap, 3, 3))
    bvec = np.zeros((B, cap, 3))
    c = np.zeros((B, cap))
    n = rng.integers(0, 8, (B, cap)).astype(np.int32)
    for b in range(B):
        for i in range(cap):
            for _ in range(n[b, i]):
                ctr = rng.normal(0, 0.3, 3)
                d = pts[b, i] - ctr + rng.normal(0, 0.01, 3)
                d /= np.linalg.norm(d)
                Ai = np.eye(3) - np.outer(d, d)
                A[b, i] += Ai
                bvec[b, i] += Ai @ ctr
                c[b, i] += ctr @ Ai @ ctr
    valid = rng.random((B, cap)) < 0.8
    R = np.stack([np.asarray(j_quat_2_rot(jnp.asarray([0.0, 0.0, 0.0, 1.0])))] * B)
    p = rng.normal(0, 0.1, (B, 3))
    vopts = t_fused.FusedVisionOptions(
        cam_model=0, h=240, w=320, cap=cap, num_target=55, klt=t_klt.KltOptions(), fast=t_fast.FastOptions(),
        ransac=t_ransac.RansacOptions(), histogram_method=0, feat_init_min_obs=4, min_dist=0.1, max_dist=60.0,
        max_cond=8000.0, max_ray_rms_rel=0.03, max_ray_rms_abs=0.1)
    fev = t_fused.FusedFrontendState(pyr=None, ids=None, uv=None, valid=torch.as_tensor(valid), next_id=None,
                                     tri_A=torch.as_tensor(A), tri_b=torch.as_tensor(bvec), tri_c=torch.as_tensor(c),
                                     tri_n=torch.as_tensor(n), has_prev=None)
    p3, ok = t_fused._solve_tracks(fev, vopts, torch.as_tensor(R), torch.as_tensor(p))
    j_vopts = j_fused.FusedVisionOptions(
        cam_model=0, h=240, w=320, cap=cap, num_target=55, klt=j_klt.KltOptions(), fast=j_fast.FastOptions(),
        ransac=j_ransac.RansacOptions(), histogram_method=0, feat_init_min_obs=4, min_dist=0.1, max_dist=60.0,
        max_cond=8000.0, max_ray_rms_rel=0.03, max_ray_rms_abs=0.1)
    for b in range(B):
        j_fev = j_fused.FusedFrontendState(pyr=None, ids=None, uv=None, valid=jnp.asarray(valid[b]), next_id=None,
                                           tri_A=jnp.asarray(A[b]), tri_b=jnp.asarray(bvec[b]),
                                           tri_c=jnp.asarray(c[b]), tri_n=jnp.asarray(n[b]), has_prev=None)
        j_p3, j_ok = j_fused._solve_tracks(j_fev, j_vopts, jnp.asarray(R[b]), jnp.asarray(p[b]))
        np.testing.assert_array_equal(ok[b].numpy(), np.asarray(j_ok))
        np.testing.assert_allclose(p3[b].numpy(), np.asarray(j_p3), rtol=0, atol=1e-10)
    assert ok.any() and not ok.all()


@pytest.mark.parametrize("sampler,dtype,fb", [("slice", "float64", False), ("mm", "float32", False),
                                              ("mm", "float32", True), ("mm_bf16", "float32", False)])
def test_klt_track(frames, sampler, dtype, fb):
    """``slice`` in f64: uv within 1e-9 px. The exact samplers in f32 (the
    JAX ``'mm'`` one-hot GEMMs against the port's gathers): uv within 1e-3 px.
    ``mm_bf16`` in f32, the bench's sampler: ``ok`` equal, and uv within
    1e-3 px on most features (at least 75 %) and within 0.1 px on all. Its
    weights are rounded to bf16, so a patch is piecewise constant in its
    centre, in steps of up to 2^-8 px: where an f32 rounding difference of
    the flow (the patch sums run in another order) crosses a step, the two
    LK iterates part by up to a few hundredths of a pixel (the patches
    themselves agree bit for bit, ``test_bf16_sampler_matches_jax``). The
    JAX tracker parts from itself the same way when its start points move
    by one ulp, which the test shows."""
    imgs = frames.astype(dtype)
    jo = j_klt.KltOptions(levels=5, window=7, iters=8, fb_check=fb, sampler=sampler)
    to = t_klt.KltOptions(levels=5, window=7, iters=8, fb_check=fb, sampler=sampler)
    rng = np.random.default_rng(9)
    # FAST corners of the first frame, a few points near the border, and masked slots.
    j_uv, j_new = j_fast.detect_grid(jnp.asarray(imgs[0], jnp.float32), jnp.zeros((1, 2)), jnp.zeros(1, bool),
                                     j_fast.FastOptions(threshold=15.0 / 255.0, max_features=48), 240, 320)
    pts = np.concatenate([np.asarray(j_uv, np.float64) + rng.uniform(-0.5, 0.5, (48, 2)),
                          [[2.0, 3.0], [318.5, 120.0], [160.0, 239.0], [-3.0, 50.0]],
                          rng.uniform([10, 10], [310, 230], (12, 2))]).astype(dtype)
    mask = np.ones(64, bool)
    mask[np.asarray(~j_new).nonzero()[0]] = False
    mask[60:] = False
    flow0 = rng.normal(0, 1.0, (64, 2)).astype(dtype)
    # The two streams track frame 0 -> 1 and frame 1 -> 0.
    t_prep = [t_klt.prepare_pyramid(t_klt.build_pyramid(torch.as_tensor(imgs[[k, 1 - k]]), 5), 7) for k in (0, 1)]
    p1, ok = t_klt.track(t_prep[0], t_prep[1], torch.as_tensor(np.stack([pts, pts])),
                         torch.as_tensor(np.stack([mask, mask])), to, torch.as_tensor(np.stack([flow0, flow0])))
    for b in range(2):
        j_prep0 = j_klt.prepare_pyramid(tuple(j_klt.build_pyramid(jnp.asarray(imgs[b]), 5)), 7)
        j_prep1 = j_klt.prepare_pyramid(tuple(j_klt.build_pyramid(jnp.asarray(imgs[1 - b]), 5)), 7)
        j_p1, j_ok = j_klt.track(j_prep0, j_prep1, jnp.asarray(pts), jnp.asarray(mask), jo, jnp.asarray(flow0))
        np.testing.assert_array_equal(ok[b].numpy(), np.asarray(j_ok))
        d = np.abs(p1[b].numpy().astype(np.float64) - np.asarray(j_p1, np.float64)).max(axis=-1)
        d_ok = d[np.asarray(j_ok)]
        print(f"{sampler} {dtype} stream {b}: {d_ok.size} tracked, max|d uv| {d.max():.3e} px, "
              f"{(d_ok > 1e-3).sum()} tracked beyond 1e-3 px")
        assert d_ok.size > 20
        if sampler == "mm_bf16":
            assert (d_ok <= 1e-3).mean() >= 0.75 and d.max() <= 0.1
            # The reference parts from itself as far: the JAX tracker from
            # start points one f32 ulp up (a flow rounding difference).
            j_p1u, j_oku = j_klt.track(j_prep0, j_prep1, jnp.asarray(np.nextafter(pts, np.float32(np.inf))),
                                       jnp.asarray(mask), jo, jnp.asarray(flow0))
            both = np.asarray(j_ok) & np.asarray(j_oku)
            d_self = np.abs(np.asarray(j_p1u) - np.asarray(j_p1)).max(axis=-1)[both]
            print(f"  JAX against itself from starts 1 ulp up: max|d uv| {d_self.max():.3e} px, "
                  f"{(d_self > 1e-3).sum()} of {both.sum()} tracked beyond 1e-3 px")
            assert (d_self > 1e-3).any()
        else:
            assert d.max() <= (1e-9 if dtype == "float64" else 1e-3)


def test_bf16_sampler_matches_jax():
    """The bf16 roundings of the JAX one-hot GEMM sampler, bit for bit."""
    rng = np.random.default_rng(10)
    img = (np.rint(rng.random((60, 80)) * 255) / 255).astype(np.float32)
    pad = np.asarray(j_klt._pad_edge(jnp.asarray(img), 7))
    c = np.stack([rng.uniform(-3, 83, 200), rng.uniform(-3, 63, 200)], -1).astype(np.float32)
    ref = np.asarray(j_klt._sample_batch(jnp.asarray(pad)[None], jnp.asarray(c), 7, jnp.bfloat16))[0]
    got = t_klt.sample_patches(torch.as_tensor(pad)[None, None], torch.as_tensor(c)[None], 7, "mm_bf16")[0, 0]
    np.testing.assert_array_equal(got.numpy(), ref)


def test_samplers_slice_and_mm_are_one_path(frames):
    prep = t_klt.prepare_pyramid(t_klt.build_pyramid(torch.as_tensor(frames, dtype=torch.float32), 2), 7)
    c = torch.tensor([[[50.3, 60.7], [100.0, 20.25]]] * 2, dtype=torch.float32)
    a = t_klt.sample_patches(prep.padded[0][:, None], c, 7, "slice")
    assert torch.equal(a, t_klt.sample_patches(prep.padded[0][:, None], c, 7, "mm"))
    with pytest.raises(NotImplementedError):
        t_klt.sample_patches(prep.padded[0][:, None], c, 7, "rowmm_bf16")


def _plane_frame(rng, n, drop_p=0.1):
    """One stream's frame for the host plane detector: a floor plane (z = 0)
    seen from 3 m above and clutter floating over it, with track churn; uv is
    the projection of p3 plus pixel noise."""
    ids = np.arange(1, n + 1)
    keep = rng.random(n) > drop_p
    ids = np.where(keep, ids, -1)
    on_floor = rng.random(n) < 0.75
    xy = np.stack([np.cos(ids * 2.39), np.sin(ids * 1.17)], 1) * (0.3 + 0.6 * (ids[:, None] % 7) / 7)
    p3 = np.c_[xy, np.zeros(n)]
    p3[~on_floor, 2] = 0.8 + 0.1 * (ids[~on_floor] % 5)
    p3 += rng.normal(0, 0.003, p3.shape)
    uv = 320 + 220 * (p3[:, :2] / (3.0 - p3[:, 2])[:, None]) * 3.0 + rng.normal(0, 0.5, (n, 2))
    valid = keep & (rng.random(n) > 0.05)
    return ids.astype(np.int64), uv, p3, valid, np.eye(3), np.array([0.0, 0.0, 3.0])


@pytest.mark.parametrize("B,degenerate", [(1, False), (4, False), (3, True)])
def test_plane_tracker_batch_matches_jax_per_stream(B, degenerate):
    """The port's cross-stream detector (the driver's at every B) against B
    of the JAX package's per-stream ``PlaneTracker``: the same feature →
    plane labels, merge records and normal histories on every frame. The
    degenerate case has a stream with fewer than 3 valid tracks and one that
    tracks nothing on every other frame."""
    from ov_plane_tpu.frontend.plane_track import PlaneTracker
    from ov_plane_tpu.utils.config import TrackPlaneOptions as JOpts
    from ov_plane_tpu_torch.frontend.plane_track_batch import PlaneTrackerBatch
    from ov_plane_tpu_torch.utils.config import TrackPlaneOptions

    n, n_frames = (16, 4) if degenerate else (48, 12)
    opts, jopts = TrackPlaneOptions(), JOpts()
    if not degenerate:
        for o in (opts, jopts):
            o.min_norms, o.max_norm_avg_var, o.max_norm_avg_max = 3, 30.0, 30.0
    bt = PlaneTrackerBatch(B, opts)
    trs = [PlaneTracker(jopts) for _ in range(B)]
    rngs = [np.random.default_rng(100 + s) for s in range(B)]
    for t in range(n_frames):
        frames = []
        for s in range(B):
            ids, uv, p3, valid, R, p_c = _plane_frame(rngs[s], n)
            if degenerate and s == 0:
                valid = valid & (np.arange(n) < 2)
            elif degenerate and s == 1 and t % 2 == 0:
                ids = np.full(n, -1, np.int64)
            frames.append((ids, uv, p3, valid, R, p_c))
        got = bt.update_batch(*(np.stack([f[k] for f in frames]) for k in range(6)))
        for s in range(B):
            f2p, p2o = trs[s].update(*frames[s])
            assert got[s][0] == f2p and got[s][1] == p2o, (t, s)
            tr = trs[s]
            for name in ("_ids", "_plane", "_hist_cnt", "_hist_ptr"):
                np.testing.assert_array_equal(getattr(bt, name)[s], getattr(tr, name), err_msg=f"{t} {s} {name}")
            np.testing.assert_allclose(bt._hist[s], tr._hist, rtol=0, atol=1e-12)
            assert int(bt.curr_plane_id[s]) == tr.curr_plane_id
    if not degenerate:
        # Planes were found, so the comparison covers the clustering and merges.
        assert sum(len(set(bt.feat_to_plane(s).values())) for s in range(B)) >= max(1, B - 1)
