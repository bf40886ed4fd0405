"""Monte-Carlo of the image-driven plane benefit (counterpart of
``scripts/run_mc_vision.py``).

The reference's MC protocol (``results/run_simulation.sh:73-99``: one world,
re-noised measurements per run) on the vision scenes: B noise seeds ×
{planes ON, OFF} × {dense, sparse} through the whole fused path
(``FusedVisionDriver.step_batch``: KLT/FAST/Delaunay/CP init/constraints),
reporting the mean ± std of the posyaw ATE and a paired-t 95% interval on
the ON − OFF difference.

Seeds re-noise the measurements: per-stream IMU noise and bias walks
(``simulator.apply_noise`` from one ``torch.Generator`` seeded with
``--seed0``) and per-frame, per-stream image noise ahead of the camera's
8-bit ADC (numpy ``default_rng(seed0 + 999)``), while the world and its
texture stay fixed. ON and OFF replay identical inputs, so each seed's
difference is a paired sample. The seeds run as one batch of B streams;
frames are rendered by ``frontend.synthetic.render_frame_textured`` on the
device. The filter runs in float32 on the card and float64 on the CPU
(``--dtype``).

Usage (one scene per invocation):
    python -m ov_plane_tpu_torch.scripts.run_mc_vision --scene tabletop --out mc_tabletop.json
    python -m ov_plane_tpu_torch.scripts.run_mc_vision --scene room --device cpu --seeds 2 --max-frames 20
"""

from __future__ import annotations

import argparse
import copy
import json
import sys
import time
from typing import NamedTuple

import numpy as np
import torch
from scipy.stats import t as t_dist

from ov_plane_tpu_torch.eval.metrics import ate_posyaw
from ov_plane_tpu_torch.frontend.fused import FusedVisionDriver
from ov_plane_tpu_torch.frontend.synthetic import render_frame_textured
from ov_plane_tpu_torch.models.feature_bank import FeatureBank
from ov_plane_tpu_torch.models.manager import VioEngine, init_state_with_gt
from ov_plane_tpu_torch.ops.quat import quat_2_rot
from ov_plane_tpu_torch.parallel.ingest import Prefetcher
from ov_plane_tpu_torch.sim import simulator
from ov_plane_tpu_torch.sim.trajectory import get_trajectory
from ov_plane_tpu_torch.utils.config import sim_config
from ov_plane_tpu_torch.utils.torchenv import resolve_device


def scene_config(scene: str, dense: bool):
    """The scene protocols of the JAX script, field for field: (cfg, render),
    render being the keyword arguments of the textured renderer plus
    ``blobs`` (draw the map's blobs over the texture)."""
    cfg = sim_config()
    cfg.state.max_slam_features = 0
    cfg.state.do_calib_camera_pose = False
    cfg.state.do_calib_camera_intrinsics = False
    cfg.state.do_calib_camera_timeoffset = False
    cfg.histogram_method = "NONE"
    cfg.cam_wh = [640, 480]
    cfg.cam_intrinsics = [300.0, 300.0, 320.0, 240.0, 0.0, 0.0, 0.0, 0.0]
    cfg.sim.freq_cam = 20.0
    # Renderer-noise whitening (synthetic KLT noise is about 2 px).
    cfg.msckf_options.sigma_pix = 2.0
    cfg.slam_options.sigma_pix = 2.0
    cfg.msckf_options.chi2_multipler = 5.0
    cfg.num_pts = 150 if dense else 40
    cfg.num_pts_plane = 0
    cfg.tpu.max_obs_per_frame = 160 if dense else 80
    cfg.tpu.max_features = 2 * cfg.tpu.max_obs_per_frame
    cfg.tpu.max_msckf_update = 40 if dense else 24
    cfg.tpu.use_info_compression = True
    cfg.tpu.max_planes = 4

    render = {"texture_cell": 0.22, "speckle_cells": (0.15,), "blobs": False}
    if scene == "tabletop":
        cfg.sim.traj_kind = "tabletop"
        cfg.sim.traj_duration = 25.0
        cfg.sim.min_feature_gen_distance = 1.0
        # The reference's stock plane gates.
        render = {"texture_cell": 0.1, "speckle_cells": ((0.05, 0.12, 0.30), 0.12), "blobs": False}
    elif scene == "room":
        cfg.sim.traj_kind = "room_scan"
        cfg.sim.traj_duration = 20.0
        cfg.sim.min_feature_gen_distance = 0.7
        _tuned_gates(cfg)
    elif scene == "corridor":
        cfg.sim.traj_kind = "corridor"
        cfg.sim.traj_duration = 30.0
        cfg.sim.min_feature_gen_distance = 1.0
        _tuned_gates(cfg)
    elif scene == "lowtex":
        # A low-texture room: one coarse value-noise octave (1 m cells) and
        # sparse high-contrast marks, so the trackable corners are few,
        # widely spaced and on the walls (weak point geometry).
        cfg.sim.traj_kind = "room_scan"
        cfg.sim.traj_duration = 20.0
        cfg.sim.min_feature_gen_distance = 1.2
        cfg.num_pts = 50 if dense else 25
        cfg.tpu.max_obs_per_frame = 96 if dense else 64
        cfg.tpu.max_features = 2 * cfg.tpu.max_obs_per_frame
        cfg.tpu.max_msckf_update = 32 if dense else 20
        _tuned_gates(cfg)
        render = {"texture_cell": 1.0, "speckle_cells": ((0.5, 0.08, 0.16), (0.15, 0.06, 0.12)), "blobs": False}
    else:
        raise SystemExit(f"unknown scene {scene!r}")
    return cfg, render


def _tuned_gates(cfg):
    """The tuned plane gates of run_euroc --sim-calib --use-planes (the
    global condition gate grows with the distance from the scene origin,
    PlaneFitting.cpp:59-66)."""
    cfg.state.plane_init_min_feat = 8
    cfg.trackplane.min_norms = 3
    cfg.trackplane.max_norm_avg_var = 30.0
    cfg.trackplane.max_norm_avg_max = 30.0
    cfg.state.plane_init_max_cond = 150.0
    cfg.state.plane_msckf_max_cond = 150.0


def render_frames(cfg, truth: simulator.SimTruth, render: dict, n: int, device="cuda") -> np.ndarray:
    """Frames 1..n of the scene [n, H, W] (float32 in [0, 1], on the host),
    rendered on ``device`` from the room planes around the trajectory."""
    dev = resolve_device(device)
    _, traj_pos, _ = get_trajectory(cfg.sim)
    planes = simulator.generate_planes(traj_pos, cfg.sim.min_feature_gen_distance)
    f64 = dict(dtype=torch.float64, device=dev)
    corners, normal, d = (torch.as_tensor(x, **f64) for x in (planes.corners, planes.normal, planes.d))
    R_ItoC = quat_2_rot(torch.as_tensor(cfg.cam_extrinsics[0:4], **f64))
    p_IinC = torch.as_tensor(cfg.cam_extrinsics[4:7], **f64)
    layers = {k: v for k, v in render.items() if k != "blobs"}
    feat_p = truth.feat_p.to(**f64) if render.get("blobs") else None
    gt_q, gt_p = truth.gt_q.to(**f64), truth.gt_p.to(**f64)
    frames = [render_frame_textured(corners, normal, d, quat_2_rot(gt_q[i]), gt_p[i], R_ItoC, p_IinC,
                                    cfg.cam_intrinsics, tuple(cfg.cam_wh), feat_p=feat_p, **layers)
              for i in range(1, n + 1)]
    return torch.stack(frames).cpu().numpy()


class VariantRun(NamedTuple):
    """One arm's batched run: per-seed (ATE pos m, ATE ori deg), the
    estimates p [n, B, 3] and q [n, B, 4], the frontend's track ids and
    valid flags after each frame [n, B, cap], the constraint updates the
    last pull counted (as the JAX script counts them), the wall seconds of
    the frame loop, and each frame's nine pulled counters [n, B, 9] (the
    driver's ``last_counters``: plane inits, constraint updates, planes in
    the state, ...)."""
    ates: list
    p: np.ndarray
    q: np.ndarray
    ids: np.ndarray
    valid: np.ndarray
    n_constraints: int
    wall_s: float
    counters: np.ndarray


def noisy_streams(cfg, truth: simulator.SimTruth, B: int, seed: int) -> simulator.SimData:
    """``B`` IMU noise draws of the scene from ``torch.Generator(device).manual_seed(seed)``."""
    gen = torch.Generator(device=truth.imu_t.device).manual_seed(seed)
    return simulator.apply_noise(truth, simulator.noise_params(cfg), B, gen)


def noisy_images(frames: np.ndarray, B: int, seed: int, img_noise: float = 0.01):
    """Each frame [H, W] as B streams [B, H, W] float32: per-frame iid
    per-stream image noise from ``default_rng(seed + 999)`` (the same stream
    for ON and OFF), then the camera's 8-bit ADC."""
    rng = np.random.default_rng(seed + 999)
    for frame in frames:
        x = frame[None]
        if img_noise > 0:
            x = x + rng.normal(0.0, img_noise, (B,) + frame.shape)
        x = np.clip(x, 0.0, 1.0)
        yield np.rint(x * np.float32(255.0)).astype(np.float32) * np.float32(1.0 / 255.0)


def run_variant(cfg0, truth: simulator.SimTruth, frames: np.ndarray, B: int, seed: int, use_planes: bool,
                dtype, label: str, img_noise: float = 0.01, device="cuda",
                sim: simulator.SimData | None = None) -> VariantRun:
    """One arm (planes ON or OFF) over the frames for B seeds as one batch.

    ``sim`` gives the noisy IMU streams (default: :func:`noisy_streams` of
    ``seed``). The image noise of every frame comes from
    ``default_rng(seed + 999)``, the same stream for ON and OFF."""
    dev = resolve_device(device)
    cfg = copy.deepcopy(cfg0)
    cfg.state.use_plane_constraint = use_planes
    cfg.state.use_plane_slam_feats = use_planes
    eng = VioEngine.from_config(cfg, device=dev)
    drv = FusedVisionDriver(cfg, eng, batch=B)
    fev = drv.init_frontend()
    if sim is None:
        sim = noisy_streams(cfg, truth, B, seed)
    state = init_state_with_gt(eng, cfg, t0=sim.cam_t_imu[0].expand(B), q0=sim.gt_q[0].expand(B, 4),
                               p0=sim.gt_p[0].expand(B, 3), v0=sim.gt_v[0].expand(B, 3),
                               bg0=sim.gt_bg_cam[:B, 0], ba0=sim.gt_ba_cam[:B, 0], dtype=dtype, device=dev)
    bank = FeatureBank.create(cfg.tpu.max_features, eng.layout.max_clones, B, dtype, dev)
    host = lambda x: x.detach().to(torch.float64).cpu().numpy()  # noqa: E731
    imu_t, imu_wb, imu_ab = host(sim.imu_t), host(sim.imu_w[:B]), host(sim.imu_a[:B])
    cam_t_imu, starts = host(sim.cam_t_imu), np.asarray(sim.imu_window_start)

    n = len(frames)
    W = cfg.tpu.max_imu_per_frame
    images = Prefetcher(noisy_images(frames, B, seed, img_noise), stage=drv.stage_image, depth=2)
    ps, qs, ids, valid, counters = [], [], [], [], []
    t0 = time.time()
    for i in range(1, n + 1):
        s0 = int(starts[i])
        it_w = np.full((B, W), np.inf)
        iw_w = np.zeros((B, W, 3))
        ia_w = np.zeros((B, W, 3))
        m = len(imu_t[s0:s0 + W])
        it_w[:, :m] = imu_t[s0:s0 + W][None]
        iw_w[:, :m] = imu_wb[:, s0:s0 + W]
        ia_w[:, :m] = imu_ab[:, s0:s0 + W]
        state, bank, fev, out = drv.step_batch(state, bank, fev, next(images), it_w, iw_w, ia_w,
                                               np.full(B, float(cam_t_imu[i])))
        ps.append(out.p)          # on the device; one pull at the end
        qs.append(out.q)
        ids.append(fev.ids)
        valid.append(fev.valid)
        if i > 1:                 # the pipelined pull read in step i is frame i - 1's
            counters.append(drv.last_counters.copy())
    drv.flush_stream()
    counters.append(drv.last_counters.copy())
    drv.close()
    images.close()
    p_all, q_all = host(torch.stack(ps)), host(torch.stack(qs))
    ids_all, valid_all = torch.stack(ids).cpu().numpy(), torch.stack(valid).cpu().numpy()
    wall = time.time() - t0
    n_constr = int(sum(c[1] for c in drv.last_counters)) if use_planes else 0
    print(f"[mc] {label}: {n} frames x {B} seeds in {wall:.0f}s ({n * B / wall:.1f} fps agg)", file=sys.stderr)

    gt_p, gt_q = (torch.as_tensor(host(x[1:n + 1])) for x in (sim.gt_p, sim.gt_q))
    ates = []
    for b in range(B):
        ap, ao, _, _ = ate_posyaw(torch.as_tensor(p_all[:, b]), torch.as_tensor(q_all[:, b]), gt_p, gt_q)
        ates.append((float(ap), float(ao)))
    return VariantRun(ates, p_all, q_all, ids_all, valid_all, n_constr, wall, np.stack(counters))


def paired_stats(on, off):
    """mean ± std per arm and the paired-t 95% interval of the difference
    (ON − OFF). Seeds with a non-finite ATE (a stream that diverged) are
    left out pairwise and counted."""
    on, off = np.asarray(on), np.asarray(off)
    finite = np.isfinite(on).all(axis=1) & np.isfinite(off).all(axis=1)
    out = {"n_seeds": int(len(on)),
           "n_diverged_on": int((~np.isfinite(on).all(axis=1)).sum()),
           "n_diverged_off": int((~np.isfinite(off).all(axis=1)).sum())}
    on, off = on[finite], off[finite]
    if len(on) == 0:
        return out
    d = on - off
    nb = len(d)
    for j, name in enumerate(["pos_m", "ori_deg"]):
        dj = d[:, j]
        sd = dj.std(ddof=1) if nb > 1 else 0.0
        se = sd / np.sqrt(nb) if nb > 1 else 0.0
        tc = float(t_dist.ppf(0.975, nb - 1)) if nb > 1 else 0.0
        out[name] = {
            "on_mean": float(on[:, j].mean()), "on_std": float(on[:, j].std(ddof=1)),
            "off_mean": float(off[:, j].mean()), "off_std": float(off[:, j].std(ddof=1)),
            "delta_mean": float(dj.mean()),
            "delta_ci95": [float(dj.mean() - tc * se), float(dj.mean() + tc * se)],
            "delta_pct": float(100.0 * dj.mean() / off[:, j].mean()),
        }
    return out


def main(argv=None, runs: dict | None = None) -> int:
    """The command line. ``runs``, when given, receives each arm's
    :class:`VariantRun` under (density, "ON" | "OFF")."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scene", required=True, choices=["tabletop", "room", "corridor", "lowtex"])
    ap.add_argument("--seeds", type=int, default=10)
    ap.add_argument("--seed0", type=int, default=17)
    ap.add_argument("--max-frames", type=int, default=0)
    ap.add_argument("--densities", default="dense,sparse")
    ap.add_argument("--img-noise", type=float, default=0.01,
                    help="per-frame per-stream iid image noise sigma ([0,1] scale) added before the 8-bit "
                         "ADC; 0 = clean renders (seeds then differ only in IMU noise)")
    ap.add_argument("--dtype", default="auto", choices=["auto", "f32", "f64"],
                    help="filter dtype (auto: f32 on the card, f64 on the CPU)")
    ap.add_argument("--out", default="")
    ap.add_argument("--no-plane-msckf", action="store_true",
                    help="ON arm: no out-of-state grouped plane-MSCKF updates (CP-state init + in-state rows only)")
    ap.add_argument("--adaptive-sigma", action="store_true",
                    help="ON arm: noise-adaptive constraint whitening (tpu.sigma_c_adaptive)")
    ap.add_argument("--sigma-c", type=float, default=0.0, help="override sigma_constraint")
    ap.add_argument("--const-init-multi", type=float, default=0.0)
    ap.add_argument("--msckf-min-feat", type=int, default=0, help="override plane_msckf_min_feat")
    ap.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    dt = {"auto": torch.float32 if dev.type == "cuda" else torch.float64,
          "f32": torch.float32, "f64": torch.float64}[args.dtype]
    print(f"[mc] device {dev}, filter dtype {dt}", file=sys.stderr)

    results = {"scene": args.scene, "seeds": args.seeds, "img_noise": args.img_noise, "dtype": args.dtype,
               "cells": {}}
    for dense in [d.strip() == "dense" for d in args.densities.split(",")]:
        cfg, render = scene_config(args.scene, dense)
        if args.no_plane_msckf:
            cfg.state.use_plane_constraint_msckf = False
        if args.adaptive_sigma:
            cfg.tpu.sigma_c_adaptive = True
        if args.sigma_c > 0:
            cfg.state.sigma_constraint = args.sigma_c
        if args.const_init_multi > 0:
            cfg.state.const_init_multi = args.const_init_multi
        if args.msckf_min_feat > 0:
            cfg.state.plane_msckf_min_feat = args.msckf_min_feat
        t0 = time.time()
        truth = simulator.build_sim(cfg, max_obs=cfg.tpu.max_obs_per_frame, device=dev)
        n = int(truth.cam_t_imu.shape[0]) - 1
        if args.max_frames:
            n = min(n, args.max_frames)
        frames = render_frames(cfg, truth, render, n, dev)
        dname = "dense" if dense else "sparse"
        print(f"[mc] {args.scene}/{dname}: {n} frames rendered in {time.time() - t0:.0f}s (untimed)",
              file=sys.stderr)

        arms = {}
        for use_planes in (True, False):
            arm = "ON" if use_planes else "OFF"
            arms[use_planes] = run_variant(cfg, truth, frames, args.seeds, args.seed0, use_planes, dt,
                                           f"{args.scene}/{dname}/{arm}", img_noise=args.img_noise, device=dev)
            if runs is not None:
                runs[(dname, arm)] = arms[use_planes]
        stats = paired_stats(arms[True].ates, arms[False].ates)
        results["cells"][dname] = {"ate_on": arms[True].ates, "ate_off": arms[False].ates, "stats": stats}
        if stats.get("n_diverged_on") or stats.get("n_diverged_off"):
            print(f"[mc] {args.scene}/{dname}: DIVERGED seeds — ON {stats['n_diverged_on']}/{stats['n_seeds']}, "
                  f"OFF {stats['n_diverged_off']}/{stats['n_seeds']} (stats over the converged pairs)")
        for name, s in stats.items():
            if not isinstance(s, dict):
                continue
            lo, hi = s["delta_ci95"]
            sig = "SIGNIFICANT" if lo * hi > 0 else "within noise"
            print(f"[mc] {args.scene}/{dname} {name}: ON {s['on_mean']:.4f}±{s['on_std']:.4f} vs OFF "
                  f"{s['off_mean']:.4f}±{s['off_std']:.4f}  Δ {s['delta_mean']:+.4f} ({s['delta_pct']:+.1f}%) "
                  f"CI95 [{lo:+.4f}, {hi:+.4f}] -> {sig}")

    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
        print(f"[mc] wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
