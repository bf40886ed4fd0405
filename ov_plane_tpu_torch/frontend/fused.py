"""The fused vision step: the frontend and the filter of one camera frame of
B streams, and its host driver.

Counterpart of ``ov_plane_tpu/frontend/fused.py``. One frame, every stream
at once over a leading dimension B:

    preprocess + pyramid → gyro-integrated rotation → whole-track
    triangulation update → predicted-pose LK flow prior → KLT → gyro RANSAC
    → FAST top-up with slot allocation → whole-track solve and gates →
    plane labels by feature id → ``models.manager.step`` → one packed pull.

The frontend runs in float32 whatever the filter's type; the IMU windows,
the host's plane labels and merges and ``t_new`` reach the step through one
float32 payload, as in the JAX driver, so a float64 filter sees the same
rounded inputs there. The step makes no host synchronization:
per-stream decisions are ``torch.where`` selects, and ties are broken
towards the lower index as the JAX package breaks them.

:class:`FusedVisionDriver` runs the step over a device-resident frame and
the host Delaunay plane detector (``plane_track_batch``) over each frame's
pulled tracks; the labels it makes reach the step two frames later
(pipelined: frame k's pull is read while frame k+1 runs);
:meth:`FusedVisionDriver.step_stream` is its one-stream form.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch
from torch.profiler import record_function

from ov_plane_tpu_torch.frontend import fast as ffast
from ov_plane_tpu_torch.frontend import imageproc as ip
from ov_plane_tpu_torch.frontend import klt as fklt
from ov_plane_tpu_torch.frontend.plane_track_batch import PlaneTrackerBatch
from ov_plane_tpu_torch.frontend.ransac import RansacOptions, gyro_ransac, integrate_gyro
from ov_plane_tpu_torch.models import feature_bank as fb
from ov_plane_tpu_torch.models.manager import FrameData, VioEngine, step
from ov_plane_tpu_torch.ops import cams
from ov_plane_tpu_torch.ops.quat import quat_2_rot
from ov_plane_tpu_torch.state.vio_state import TensorTree


class FusedVisionOptions(NamedTuple):
    """Static knobs of the fused step."""

    cam_model: int
    h: int
    w: int
    cap: int                    # feature slot capacity (== max_obs_per_frame)
    num_target: int             # detection top-up target (num_pts + num_pts_plane)
    klt: fklt.KltOptions
    fast: ffast.FastOptions
    ransac: RansacOptions
    histogram_method: int
    merge_slots: int = 8
    # Whole-track triangulation gates (TrackPlane.cpp:668-680 + ray RMS).
    feat_init_min_obs: int = 4
    min_dist: float = 0.25
    max_dist: float = 40.0
    max_cond: float = 5000.0
    max_ray_rms_rel: float = 0.05
    max_ray_rms_abs: float = 0.05
    img_wire: str = "f32"       # image upload type: 'f32', 'u8' or 'f16'


@dataclass
class FusedFrontendState(TensorTree):
    """Device-resident tracker state of B streams."""

    pyr: fklt.PreparedPyramid      # previous frame's prepared pyramid ([B, ...] levels)
    ids: torch.Tensor              # [B, cap] int32 (-1 free)
    uv: torch.Tensor               # [B, cap, 2] f32 pixels
    valid: torch.Tensor            # [B, cap] bool
    next_id: torch.Tensor          # [B] int32
    tri_A: torch.Tensor            # [B, cap, 3, 3] whole-track systems
    tri_b: torch.Tensor            # [B, cap, 3]
    tri_c: torch.Tensor            # [B, cap]
    tri_n: torch.Tensor            # [B, cap] int32
    has_prev: torch.Tensor         # [B] bool

    @classmethod
    def create(cls, vopts: FusedVisionOptions, batch: int, device, first_id: int = 1) -> "FusedFrontendState":
        B, cap = batch, vopts.cap
        f32 = dict(dtype=torch.float32, device=device)
        zero_img = torch.zeros(B, vopts.h, vopts.w, **f32)
        return cls(
            pyr=fklt.prepare_pyramid(fklt.build_pyramid(zero_img, vopts.klt.levels), vopts.klt.window),
            ids=torch.full((B, cap), -1, dtype=torch.int32, device=device),
            uv=torch.zeros(B, cap, 2, **f32),
            valid=torch.zeros(B, cap, dtype=torch.bool, device=device),
            next_id=torch.full((B,), first_id, dtype=torch.int32, device=device),
            tri_A=torch.zeros(B, cap, 3, 3, **f32),
            tri_b=torch.zeros(B, cap, 3, **f32),
            tri_c=torch.zeros(B, cap, **f32),
            tri_n=torch.zeros(B, cap, dtype=torch.int32, device=device),
            has_prev=torch.zeros(B, dtype=torch.bool, device=device),
        )


def _inv3(A: torch.Tensor, ridge: torch.Tensor) -> torch.Tensor:
    """Closed-form 3×3 inverse of A + ridge·I (no LU)."""
    A = A + ridge[..., None, None] * torch.eye(3, dtype=A.dtype, device=A.device)
    c00 = A[..., 1, 1] * A[..., 2, 2] - A[..., 1, 2] * A[..., 2, 1]
    c01 = A[..., 1, 2] * A[..., 2, 0] - A[..., 1, 0] * A[..., 2, 2]
    c02 = A[..., 1, 0] * A[..., 2, 1] - A[..., 1, 1] * A[..., 2, 0]
    c10 = A[..., 0, 2] * A[..., 2, 1] - A[..., 0, 1] * A[..., 2, 2]
    c11 = A[..., 0, 0] * A[..., 2, 2] - A[..., 0, 2] * A[..., 2, 0]
    c12 = A[..., 0, 1] * A[..., 2, 0] - A[..., 0, 0] * A[..., 2, 1]
    c20 = A[..., 0, 1] * A[..., 1, 2] - A[..., 0, 2] * A[..., 1, 1]
    c21 = A[..., 0, 2] * A[..., 1, 0] - A[..., 0, 0] * A[..., 1, 2]
    c22 = A[..., 0, 0] * A[..., 1, 1] - A[..., 0, 1] * A[..., 1, 0]
    det = A[..., 0, 0] * c00 + A[..., 0, 1] * c01 + A[..., 0, 2] * c02
    det = torch.where(torch.abs(det) < 1e-18, torch.full_like(det, 1e-18), det)
    adj = torch.stack([torch.stack([c00, c10, c20], dim=-1),
                       torch.stack([c01, c11, c21], dim=-1),
                       torch.stack([c02, c12, c22], dim=-1)], dim=-2)
    return adj / det[..., None, None]


def _eigvals3_sym(A: torch.Tensor):
    """Closed-form eigenvalues of symmetric [..., 3, 3] (Smith's
    trigonometric method), descending."""
    q = (A[..., 0, 0] + A[..., 1, 1] + A[..., 2, 2]) / 3.0
    A01, A02, A12 = A[..., 0, 1], A[..., 0, 2], A[..., 1, 2]
    p1 = A01**2 + A02**2 + A12**2
    dq0, dq1, dq2 = A[..., 0, 0] - q, A[..., 1, 1] - q, A[..., 2, 2] - q
    p2 = dq0**2 + dq1**2 + dq2**2 + 2.0 * p1
    p = torch.sqrt(torch.clamp(p2 / 6.0, min=1e-30))
    Bm = (A - q[..., None, None] * torch.eye(3, dtype=A.dtype, device=A.device)) / p[..., None, None]
    detB = (Bm[..., 0, 0] * (Bm[..., 1, 1] * Bm[..., 2, 2] - Bm[..., 1, 2] * Bm[..., 2, 1])
            - Bm[..., 0, 1] * (Bm[..., 1, 0] * Bm[..., 2, 2] - Bm[..., 1, 2] * Bm[..., 2, 0])
            + Bm[..., 0, 2] * (Bm[..., 1, 0] * Bm[..., 2, 1] - Bm[..., 1, 1] * Bm[..., 2, 0]))
    phi = torch.arccos(torch.clamp(detB / 2.0, -1.0, 1.0)) / 3.0
    e1 = q + 2.0 * p * torch.cos(phi)
    e3 = q + 2.0 * p * torch.cos(phi + 2.0 * torch.pi / 3.0)
    e2 = 3.0 * q - e1 - e3
    iso = p2 < 1e-24            # A is (nearly) a multiple of the identity
    return torch.where(iso, q, e1), torch.where(iso, q, e2), torch.where(iso, q, e3)


def _matvec(R: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """R [B, 3, 3] @ v [B, 3]."""
    return (R @ v[..., None])[..., 0]


def _solve_tracks(fev: FusedFrontendState, vopts: FusedVisionOptions, R_GtoC, p_CinG):
    """Whole-track triangulation solve and gates (the device port of the
    pipeline's ``solve_track_triangulations``): (p3 [B, cap, 3], ok [B, cap])."""
    enough = fev.valid & (fev.tri_n >= vopts.feat_init_min_obs)
    trace = fev.tri_A[..., 0, 0] + fev.tri_A[..., 1, 1] + fev.tri_A[..., 2, 2]
    ridge = 1e-6 * (trace + 1.0) + torch.where(enough, 0.0, 1.0)
    p3 = (_inv3(fev.tri_A, ridge) @ fev.tri_b[..., None])[..., 0]
    e1, _, e3 = _eigvals3_sym(fev.tri_A)
    cond = e1 / torch.clamp(e3, min=1e-18)
    depth = ((p3 - p_CinG[:, None, :]) * R_GtoC[:, None, 2, :]).sum(dim=-1)
    quad = ((p3[..., :, None] * fev.tri_A * p3[..., None, :]).sum(dim=(-2, -1))
            - 2.0 * (p3 * fev.tri_b).sum(dim=-1) + fev.tri_c)
    ray_rms = torch.sqrt(torch.clamp(quad, min=0.0) / torch.clamp(fev.tri_n, min=1))
    rms_gate = torch.clamp(vopts.max_ray_rms_rel * torch.abs(depth), min=vopts.max_ray_rms_abs)
    ok = (enough & (cond <= vopts.max_cond) & (depth >= vopts.min_dist) & (depth <= vopts.max_dist)
          & (ray_rms <= rms_gate) & torch.isfinite(p3).all(dim=-1))
    return p3, ok


def fused_vision_step(eng: VioEngine, vopts: FusedVisionOptions, state, bank, fev: FusedFrontendState,
                      img, imu_t, imu_w, imu_a, t_new, label_ids, label_pid, merge_from, merge_into):
    """One camera frame of every stream. img [B, h, w] float in [0, 1];
    imu_* [B, W(, 3)] windows covering [state.t, t_new] (+inf padding);
    t_new [B]; label_ids/label_pid [B, cap]: feature id → plane id from the
    host detector; merge_from/merge_into [B, Q].

    Returns (state', bank', fev', out, pull) with pull [B, cap+3, 8] f32: per
    slot (id, u, v, valid, p3, ok3), the 8 counters, and the camera pose
    the triangulations were solved at (R_GtoC, p_CinG) with the dropped
    plane-group count in the first pad."""
    f32 = torch.float32
    sdt = state.imu.dtype
    dev = img.device
    B, cap = fev.ids.shape

    with record_function("frontend.preprocess"):
        img_j = ip.preprocess(img.to(f32), vopts.histogram_method)
        pyr = fklt.prepare_pyramid(fklt.build_pyramid(img_j, vopts.klt.levels), vopts.klt.window)

    with record_function("frontend.triangulate"):
        # Gyro-integrated inter-frame camera rotation.
        R_imu = integrate_gyro(imu_t.to(f32), imu_w.to(f32), state.t.to(f32), t_new.to(f32),
                               state.imu[:, 10:13].to(f32))
        R_ItoC = quat_2_rot(state.calib_cam[:, 0:4]).to(f32)
        p_IinC = state.calib_cam[:, 4:7].to(f32)
        R_cam = R_ItoC @ R_imu @ R_ItoC.transpose(-1, -2)

        # Previous camera pose: the newest clone is the previous image.
        clones_t = torch.where(torch.isfinite(state.clones_t), state.clones_t,
                               torch.full_like(state.clones_t, -float("inf")))
        newest = torch.argmax(clones_t, dim=1)
        have_clone = state.num_clones >= 1
        R_GtoI_pc = quat_2_rot(fb._take(state.clones_q, newest[:, None])[:, 0]).to(f32)
        p_I_pc = fb._take(state.clones_p, newest[:, None])[:, 0].to(f32)
        R_prevC = R_ItoC @ R_GtoI_pc
        p_prevC = p_I_pc - _matvec(R_GtoI_pc.transpose(-1, -2), _matvec(R_ItoC.transpose(-1, -2), p_IinC))

        zeta = state.cam_zeta.to(f32)[:, None, :]

        # Incremental whole-track triangulation (pre-track uv at the previous pose).
        uvn_prev = cams.undistort(fev.uv, zeta, vopts.cam_model)
        b_c = torch.cat([uvn_prev, torch.ones_like(uvn_prev[..., :1])], dim=-1)
        b_g = b_c @ R_prevC
        b_g = b_g / torch.clamp(torch.sqrt((b_g * b_g).sum(dim=-1, keepdim=True)), min=1e-18)
        Ai = torch.eye(3, dtype=f32, device=dev) - b_g[..., :, None] * b_g[..., None, :]
        acc = fev.valid & fev.has_prev[:, None] & have_clone[:, None]
        accf = acc.to(f32)
        fev = fev.replace(
            tri_A=fev.tri_A + accf[..., None, None] * Ai,
            tri_b=fev.tri_b + accf[..., None] * (Ai @ p_prevC[:, None, :, None])[..., 0],
            tri_c=fev.tri_c + accf * (p_prevC[:, None, :, None] * Ai * p_prevC[:, None, None, :]).sum(dim=(-2, -1)),
            tri_n=fev.tri_n + acc.to(torch.int32),
        )

    with record_function("frontend.klt"):
        # Predicted-pose LK flow prior.
        R_GtoI_pi = quat_2_rot(state.imu[:, 0:4]).to(f32)
        R_GtoC_pi = R_ItoC @ R_GtoI_pi
        R_GtoC_new = R_cam @ R_GtoC_pi
        p_I_prev = state.imu[:, 4:7].to(f32)
        v_IinG = state.imu[:, 7:10].to(f32)
        dtf = torch.clamp(t_new.to(f32) - state.t.to(f32), min=0.0)
        p_C_prev = p_I_prev - _matvec(R_GtoC_pi.transpose(-1, -2), p_IinC)
        p_C_new = (p_I_prev + v_IinG * dtf[:, None]) - _matvec(R_GtoC_new.transpose(-1, -2), p_IinC)

        has_tri = fev.valid & (fev.tri_n >= 2)
        trace = fev.tri_A[..., 0, 0] + fev.tri_A[..., 1, 1] + fev.tri_A[..., 2, 2]
        ridge = 1e-6 * (trace + 1.0) + torch.where(has_tri, 0.0, 1.0)
        p3r = (_inv3(fev.tri_A, ridge) @ fev.tri_b[..., None])[..., 0]
        z = ((p3r - p_C_prev[:, None, :]) * R_GtoC_pi[:, None, 2, :]).sum(dim=-1)
        good_d = has_tri & torch.isfinite(z) & (z > vopts.min_dist) & (z < vopts.max_dist)
        # Masked median depth for the young tracks.
        inf = torch.full_like(z, float("inf"))
        z_sorted = torch.sort(torch.where(good_d, z, inf), dim=-1).values
        n_good = good_d.sum(dim=-1)
        med_idx = torch.clamp(torch.div(n_good - 1, 2, rounding_mode="floor"), 0, cap - 1)
        med = z_sorted.gather(1, med_idx[:, None])[:, 0]
        med = torch.where(n_good > 0, med, inf[:, 0])
        depth = torch.where(good_d, z, med[:, None])
        finite_d = torch.isfinite(depth) & fev.valid
        pt_C_prev = b_c * torch.where(finite_d, depth, torch.ones_like(depth))[..., None]
        pt_G = pt_C_prev @ R_GtoC_pi + p_C_prev[:, None, :]
        pt_C_new = (pt_G - p_C_new[:, None, :]) @ R_GtoC_new.transpose(-1, -2)
        b_rot = b_c @ R_cam.transpose(-1, -2)
        dir_new = torch.where(finite_d[..., None], pt_C_new, b_rot)
        pred = cams.project(dir_new, zeta, vopts.cam_model)[0]
        flow = pred - fev.uv
        good = (dir_new[..., 2] > 0.1) & torch.isfinite(flow).all(dim=-1)
        init_flow = torch.where(good[..., None], flow, torch.zeros_like(flow))

        track_mask = fev.valid & fev.has_prev[:, None]
        p1, ok = fklt.track(fev.pyr, pyr, fev.uv, track_mask, vopts.klt, init_flow)

    with record_function("frontend.ransac"):
        uvn_cur = cams.undistort(p1, zeta, vopts.cam_model)
        inl = gyro_ransac(uvn_prev, uvn_cur, ok, R_cam, vopts.ransac)[0]
        ok = torch.where((ok.sum(dim=-1) >= 8)[:, None], ok & inl, ok)
        uv = torch.where(ok[..., None], p1, fev.uv)
        valid = ok
        ids = torch.where(valid, fev.ids, torch.full_like(fev.ids, -1))

    with record_function("frontend.fast"):
        # FAST top-up with in-step slot allocation: the r-th free slot takes
        # the r-th detection, up to the target count.
        n_needed = torch.clamp(vopts.num_target - valid.sum(dim=-1), 0, cap)
        new_uv, new_ok = ffast.detect_grid(img_j, uv, valid, vopts.fast, vopts.h, vopts.w)
        free = ~valid
        free_rank = torch.cumsum(free, dim=-1, dtype=torch.int32) - 1
        new_rank = torch.cumsum(new_ok, dim=-1, dtype=torch.int32) - 1
        alloc = (free[:, :, None] & new_ok[:, None, :] & (free_rank[:, :, None] == new_rank[:, None, :])
                 & (new_rank[:, None, :] < n_needed[:, None, None]))
        is_new_row = alloc.any(dim=-1)
        src = fb.first_true(alloc)
        uv = torch.where(is_new_row[..., None], fb._take(new_uv, src), uv)
        valid = valid | is_new_row
        ids = torch.where(is_new_row, fev.next_id[:, None] + free_rank, ids)
        n_new = is_new_row.sum(dim=-1).to(torch.int32)
        rs = is_new_row
        fev = fev.replace(
            tri_A=torch.where(rs[..., None, None], torch.zeros_like(fev.tri_A), fev.tri_A),
            tri_b=torch.where(rs[..., None], torch.zeros_like(fev.tri_b), fev.tri_b),
            tri_c=torch.where(rs, torch.zeros_like(fev.tri_c), fev.tri_c),
            tri_n=torch.where(rs, torch.zeros_like(fev.tri_n), fev.tri_n),
        )

    with record_function("frontend.triangulate"):
        p3, ok3 = _solve_tracks(fev, vopts, R_prevC, p_prevC)
        ok3 = ok3 & have_clone[:, None]
        p3 = torch.where(ok3[..., None], p3, torch.zeros_like(p3))

        # Plane labels from the host detector, by feature id.
        leq = ((ids[:, :, None] == label_ids[:, None, :]) & (label_ids >= 0)[:, None, :]
               & (ids >= 0)[:, :, None])
        pid = torch.where(leq.any(dim=-1), label_pid.gather(1, fb.first_true(leq)),
                          torch.full_like(ids, -1))

    frame = FrameData(
        imu_t=imu_t.to(sdt), imu_w=imu_w.to(sdt), imu_a=imu_a.to(sdt), t_new=t_new.to(sdt),
        obs_id=torch.where(valid, ids, torch.full_like(ids, -1)), obs_uv=uv.to(sdt), obs_plane=pid,
        merge_from=merge_from, merge_into=merge_into,
    )
    new_state, new_bank, out = step(eng, state, bank, frame)

    fev = fev.replace(pyr=pyr, ids=ids, uv=uv, valid=valid, next_id=fev.next_id + n_new,
                      has_prev=torch.ones_like(fev.has_prev))
    # One packed pull per frame: the track table, the counters, the pose.
    rows = torch.cat([ids[..., None].to(f32), uv, valid[..., None].to(f32), p3, ok3[..., None].to(f32)], dim=-1)
    counters = torch.stack([out.n_plane_init, out.n_plane_constraints, out.n_planes, out.n_msckf_used,
                            out.n_bank, track_mask.sum(dim=-1), ok.sum(dim=-1), new_ok.sum(dim=-1)],
                           dim=-1).to(f32)
    pose_rows = torch.cat([R_prevC.reshape(B, 9), p_prevC, out.n_plane_dropped.to(f32)[:, None],
                           torch.zeros(B, 3, dtype=f32, device=dev)], dim=-1).reshape(B, 2, 8)
    pull = torch.cat([rows, counters[:, None, :], pose_rows], dim=1)
    return new_state, new_bank, fev, out, pull


def _pack_image(vopts: FusedVisionOptions, img):
    """Image [B, h, w] (numpy or tensor, float in [0, 1]) -> the wire type
    ``vopts.img_wire``: 'u8' (bit-lossless for an 8-bit source), 'f16' or
    'f32'. A tensor stays on its device."""
    if isinstance(img, torch.Tensor):
        x = img.to(torch.float32)
        if vopts.img_wire == "u8":
            return torch.clamp(torch.round(x * 255.0), 0.0, 255.0).to(torch.uint8)
        return x.to(torch.float16) if vopts.img_wire == "f16" else x
    imgs = np.asarray(img, np.float32)
    if vopts.img_wire == "u8":
        return np.clip(np.rint(imgs * np.float32(255.0)), 0.0, 255.0).astype(np.uint8)
    if vopts.img_wire == "f16":
        return imgs.astype(np.float16)
    return imgs


def _pack_payload(vopts: FusedVisionOptions, W: int, B: int, imu_t, imu_w, imu_a, t_new,
                  label_ids, label_pid, merge_from, merge_into, out=None):
    """Non-image inputs -> one f32 payload [B, 7W + 2cap + 2Q + 1] (host side;
    into ``out`` when given). Feature ids stay exact in f32 below 2^24."""
    cap, Q = vopts.cap, vopts.merge_slots
    n_pay = 7 * W + 2 * cap + 2 * Q + 1
    bview = lambda a: np.asarray(a, np.float32).reshape(B, -1)  # noqa: E731
    pay = np.zeros((B, n_pay), np.float32) if out is None else out
    pay[:, :W] = bview(imu_t)
    pay[:, W:4 * W] = bview(imu_w)
    pay[:, 4 * W:7 * W] = bview(imu_a)
    o = 7 * W
    pay[:, o:o + cap] = bview(label_ids)
    pay[:, o + cap:o + 2 * cap] = bview(label_pid)
    pay[:, o + 2 * cap:o + 2 * cap + Q] = bview(merge_from)
    pay[:, o + 2 * cap + Q:o + 2 * cap + 2 * Q] = bview(merge_into)
    pay[:, o + 2 * cap + 2 * Q] = np.asarray(t_new, np.float32).reshape(B)
    return pay


def _unpack_inputs(vopts: FusedVisionOptions, W: int, img_wire: torch.Tensor, pay: torch.Tensor):
    """Device-side inverse of the packing: (img, imu_t, imu_w, imu_a, t_new,
    label_ids, label_pid, merge_from, merge_into), each with a leading B."""
    cap, Q = vopts.cap, vopts.merge_slots
    B = pay.shape[0]
    if img_wire.dtype == torch.uint8:
        img = img_wire.to(torch.float32) * (1.0 / 255.0)
    else:
        img = img_wire.to(torch.float32)
    o = 7 * W
    i32 = torch.int32
    return (img, pay[:, :W], pay[:, W:4 * W].reshape(B, W, 3), pay[:, 4 * W:7 * W].reshape(B, W, 3),
            pay[:, o + 2 * cap + 2 * Q],
            pay[:, o:o + cap].to(i32), pay[:, o + cap:o + 2 * cap].to(i32),
            pay[:, o + 2 * cap:o + 2 * cap + Q].to(i32), pay[:, o + 2 * cap + Q:o + 2 * cap + 2 * Q].to(i32))


def _unpack(packed: np.ndarray):
    """[B, cap+3, 8] packed pull -> (ids, uv, valid, p3, ok3, counters [B, 9],
    R_GtoC, p_CinG)."""
    rows, counters = packed[:, :-3], packed[:, -3]
    pose = packed[:, -2:].reshape(packed.shape[0], 16)
    R = pose[:, 0:9].reshape(-1, 3, 3).astype(np.float64)
    p = pose[:, 9:12].astype(np.float64)
    # Counter #8 (dropped plane groups) rides the pose-row padding.
    counters = np.concatenate([counters, pose[:, 12:13]], axis=1)
    ids = rows[..., 0].astype(np.int64)
    uv = rows[..., 1:3].astype(np.float64)
    valid = rows[..., 3] > 0.5
    p3 = rows[..., 4:7].astype(np.float64)
    ok3 = rows[..., 7] > 0.5
    return ids, uv, valid, p3, ok3, counters, R, p


class FusedVisionDriver:
    """Host driver of the fused step for B streams: keeps the labels and
    merges of the host Delaunay plane detector, uploads one f32 payload per
    frame and reads one packed pull per frame.

    The JAX driver's environment switches are constructor arguments here,
    with the same defaults: ``klt_fb`` (forward-backward KLT check),
    ``sampler`` and ``img_wire`` ('auto' resolves against the first image,
    ``wire_guard.py``) and ``plane_threads`` (a thread pool for the
    per-stream Delaunay calls; 0 or 1 = serial). The host detector is the
    cross-stream ``PlaneTrackerBatch`` at every B; the JAX driver's switch
    to one ``PlaneTracker`` per stream (the same result) has no
    counterpart."""

    def __init__(self, cfg, eng: VioEngine, batch: int, klt_fb: bool = False, sampler: str = "auto",
                 img_wire: str = "auto", plane_threads: int = 0):
        if batch < 1:
            raise ValueError("the driver steps a batch of at least one stream")
        cap = cfg.tpu.max_obs_per_frame
        self.vopts = FusedVisionOptions(
            cam_model=cams.RADTAN if cfg.cam_model == "radtan" else cams.EQUI,
            h=cfg.cam_wh[1], w=cfg.cam_wh[0], cap=cap,
            num_target=min(cfg.num_pts + cfg.num_pts_plane, cap),
            # The reference LK geometry (TrackPlane.h:231-232): 15×15 window,
            # 5 levels; 8 prior-seeded iterations; forward-only by default
            # (one calcOpticalFlowPyrLK call, outliers go to the RANSAC).
            klt=fklt.KltOptions(levels=5, window=7, iters=8, fb_check=klt_fb, sampler=sampler),
            fast=ffast.FastOptions(threshold=cfg.fast_threshold / 255.0, grid_x=cfg.grid_x, grid_y=cfg.grid_y,
                                   max_features=min(cfg.num_pts + cfg.num_pts_plane, cap)),
            ransac=RansacOptions(),
            histogram_method={"NONE": ip.NONE, "HISTOGRAM": ip.HISTOGRAM,
                              "CLAHE": ip.CLAHE}.get(cfg.histogram_method.upper(), ip.NONE),
            feat_init_min_obs=cfg.trackplane.feat_init_min_obs,
            min_dist=cfg.trackplane.min_dist, max_dist=cfg.trackplane.max_dist,
            max_cond=cfg.trackplane.max_cond_number,
            max_ray_rms_rel=cfg.trackplane.max_ray_rms_rel, max_ray_rms_abs=cfg.trackplane.max_ray_rms_abs,
            img_wire=img_wire,
        )
        self.eng = eng
        self.device = eng.device
        self.B = n = batch
        self._plane_pool = None
        if plane_threads > 1 and n > 1:
            import concurrent.futures

            self._plane_pool = concurrent.futures.ThreadPoolExecutor(max_workers=plane_threads)
        self.tracker = PlaneTrackerBatch(n, cfg.trackplane, capacity=max(128, 2 * cap), pool=self._plane_pool)
        Q = self.vopts.merge_slots
        self._label_ids = np.full((n, cap), -1, np.int32)
        self._label_pid = np.full((n, cap), -1, np.int32)
        self._merge_from = np.full((n, Q), -1, np.int32)
        self._merge_into = np.full((n, Q), -1, np.int32)
        self.last_counters = np.zeros((n, 9), np.float32)   # the 9 counters of the last pull read
        self.last_pull = None     # the packed [B, cap+3, 8] pull read last: the previous frame's
        self._guard_resolved = self.vopts.img_wire != "auto" and self.vopts.klt.sampler != "auto"
        self._guard_frame = 0
        self.wire_guard_info = None
        self._W = cfg.tpu.max_imu_per_frame
        # Two pinned host buffers each for the payload and the pull: a frame's
        # buffers are reused two frames later, after its pull was read.
        n_pay = 7 * self._W + 2 * cap + 2 * Q + 1
        pin = self.device.type == "cuda"
        self._pay_bufs = [torch.zeros(n, n_pay, dtype=torch.float32, pin_memory=pin) for _ in range(2)]
        self._pull_bufs = [torch.zeros(n, cap + 3, 8, dtype=torch.float32, pin_memory=pin) for _ in range(2)]
        self._frame = 0
        self._pending = None      # (pinned pull buffer, CUDA event or None) of the last dispatch
        self.n_pulls = 0          # pulls read: one per frame after the first

    # ------------------------------------------------------------------
    def _resolve_guard(self, img):
        """Resolve 'auto' wire/sampler against the first image, and recheck
        every 16th image staged under the u8 wire (a frame off the 8-bit
        lattice downgrades the wire to f32)."""
        from ov_plane_tpu_torch.frontend import wire_guard as wg

        def host(x):
            return x.detach().to("cpu").numpy() if isinstance(x, torch.Tensor) else x

        vo = self.vopts
        if not self._guard_resolved:
            wire, sampler, info = wg.resolve_wire_and_sampler(host(img), vo.img_wire, vo.klt.sampler)
            self.vopts = vo._replace(img_wire=wire, klt=vo.klt._replace(sampler=sampler))
            self.wire_guard_info = info
            self._guard_resolved = True
            if info["reason"] is not None:
                print(f"[fused] wire guard: wire={wire} sampler={sampler} ({info['reason']})")
            return
        self._guard_frame += 1
        if self.vopts.img_wire == "u8" and self._guard_frame % 16 == 0 and not wg.u8_representable(host(img)):
            print("[fused] wire guard: frame left the 8-bit lattice — downgrading wire u8 -> f32 "
                  "(this frame shipped quantized)")
            self.vopts = self.vopts._replace(img_wire="f32")
            self.wire_guard_info = dict(self.wire_guard_info or {}, wire="f32", downgraded=True)

    def stage_image(self, img) -> torch.Tensor:
        """Pack a frame of every stream ``img`` [B, h, w] (float in [0, 1],
        numpy or tensor) to the wire type and start its copy to the device;
        pass the returned tensor to :meth:`step_batch` in place of the image."""
        if not isinstance(img, (np.ndarray, torch.Tensor)):
            img = np.asarray(img)
        self._resolve_guard(img)
        wire = _pack_image(self.vopts, img)
        if isinstance(wire, np.ndarray):
            wire = torch.from_numpy(wire)
        if wire.device == self.device:
            return wire
        if self.device.type == "cuda":
            wire = wire.pin_memory()
        return wire.to(self.device, non_blocking=True)

    def init_frontend(self, first_id: int = 1) -> FusedFrontendState:
        return FusedFrontendState.create(self.vopts, self.B, self.device, first_id)

    # ------------------------------------------------------------------
    def _apply_plane_result(self, s: int, f2p, p2o):
        """Fold one stream's detector output (feature id → plane id, plane →
        merged old planes) into the label/merge arrays of the next step."""
        self._label_ids[s] = -1
        self._label_pid[s] = -1
        for k, (fid, pid) in enumerate(list(f2p.items())[: self._label_ids.shape[1]]):
            self._label_ids[s, k] = fid
            self._label_pid[s, k] = pid
        Q = self._merge_from.shape[1]
        self._merge_from[s] = -1
        self._merge_into[s] = -1
        k = 0
        for into, olds in p2o.items():
            for old in olds:
                if k < Q:
                    self._merge_from[s, k] = old
                    self._merge_into[s, k] = into
                    k += 1

    def _run_plane_detectors(self, ids, uv, valid, p3, ok3, R_GtoC, p_CinG):
        ids = np.where(valid, ids, -1)
        ok = ok3 & valid
        with record_function("host.plane_detect"):
            results = self.tracker.update_batch(ids, uv, p3, ok, R_GtoC, p_CinG)
            for s, (f2p, p2o) in enumerate(results):
                self._apply_plane_result(s, f2p, p2o)

    def _consume(self, pending):
        """Wait for a step's pull, unpack it and run the plane detectors on it."""
        buf, event = pending
        with record_function("pull"):
            if event is not None:
                event.synchronize()
            self.n_pulls += 1
            self.last_pull = buf.numpy().copy()
        ids, uv, valid, p3, ok3, self.last_counters, R_GtoC, p_CinG = _unpack(self.last_pull)
        self._run_plane_detectors(ids, uv, valid, p3, ok3, R_GtoC, p_CinG)

    # ------------------------------------------------------------------
    def step_batch(self, states, banks, fevs, imgs, imu_t, imu_w, imu_a, t_new):
        """B streams, one step. ``imgs`` is a staged frame (:meth:`stage_image`)
        or a host image [B, h, w]; imu_t [B, W], imu_w/imu_a [B, W, 3] and
        t_new [B] are host arrays. Pipelined: frame k's pull is read (and the
        host detector run on it) while frame k+1 runs, so its plane labels
        reach the step of frame k+2."""
        img_w = imgs if isinstance(imgs, torch.Tensor) and imgs.device == self.device else self.stage_image(imgs)
        slot = self._frame % 2
        self._frame += 1
        pay_host = self._pay_bufs[slot]
        _pack_payload(self.vopts, self._W, self.B, imu_t, imu_w, imu_a, t_new, self._label_ids,
                      self._label_pid, self._merge_from, self._merge_into, out=pay_host.numpy())
        pay = pay_host.to(self.device, non_blocking=True)
        (img, it, iw, ia, tn, li, lp, mf, mi) = _unpack_inputs(self.vopts, self._W, img_w, pay)
        states, banks, fevs, out, pull = fused_vision_step(self.eng, self.vopts, states, banks, fevs, img,
                                                           it, iw, ia, tn, li, lp, mf, mi)
        pull_host = self._pull_bufs[slot]
        event = None
        if self.device.type == "cuda":
            pull_host.copy_(pull, non_blocking=True)
            event = torch.cuda.Event()
            event.record()
        else:
            pull_host.copy_(pull)
        prev, self._pending = self._pending, (pull_host, event)
        if prev is not None:
            self._consume(prev)
        return states, banks, fevs, out

    def step_stream(self, state, bank, fev, img, imu_t, imu_w, imu_a, t_new, pipelined: bool = True):
        """One stream, one step: :meth:`step_batch` at B = 1 with host inputs
        that have no stream dimension (img [h, w], or [1, h, w] staged by
        :meth:`stage_image`; imu_t [W], imu_w / imu_a [W, 3], t_new a float).
        The state, bank and tracker state keep their stream dimension of one.

        ``pipelined`` (the default) reads frame k's pull while frame k+1
        runs, so plane labels reach the step two frames later; with
        ``pipelined=False`` the frame's own pull is read (and the detector
        run) before returning, so labels lag one frame, as the reference's
        TrackPlane detects on the previous image."""
        if self.B != 1:
            raise ValueError(f"step_stream steps one stream; this driver has {self.B} (use step_batch)")
        imgs = img if img.ndim == 3 else img[None]
        state, bank, fev, out = self.step_batch(state, bank, fev, imgs, np.asarray(imu_t)[None],
                                                np.asarray(imu_w)[None], np.asarray(imu_a)[None],
                                                np.asarray([t_new], np.float64))
        if not pipelined:
            self.flush_stream()
        return state, bank, fev, out

    def flush_stream(self):
        """Read the pull left pending by the last :meth:`step_batch` or
        :meth:`step_stream`, so the last frame's counters and plane
        detection are processed."""
        if self._pending is not None:
            prev, self._pending = self._pending, None
            self._consume(prev)

    def close(self):
        """Stop the detector's thread pool (``plane_threads > 1``)."""
        if self._plane_pool is not None:
            self._plane_pool.shutdown()
