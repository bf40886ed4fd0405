"""Serial EuRoC/ASL dataset replay (counterpart of ``scripts/run_euroc.py``,
the reference's ``ros1_serial_msckf`` without ROS).

Reads the extracted EuRoC layout:

    <data>/mav0/imu0/data.csv                 t[ns], w(3), a(3)
    <data>/mav0/cam0/data.csv                 t[ns], filename
    <data>/mav0/cam0/data/<filename>.png
    <data>/mav0/state_groundtruth_estimate0/data.csv   (optional: GT init and ATE)

Flow (ros1_serial_msckf.cpp:46-287): initialize from the ground truth when
it is there, else statically from the IMU, else dynamically (a linear
solve over a 2 s window of tracked frames, MLE refinement, covariance
inflation); then replay every camera frame through the host pipeline
(``frontend.pipeline.VisionPipeline`` and ``models.manager.step``) or, with
``--fused``, through ``FusedVisionDriver.step_stream``, frames decoded
and copied to the card ahead on a ``parallel.ingest`` thread. Writes the TUM trajectory, the timing and plane
CSVs, optionally IMU-rate odometry, a checkpoint and the persistent map
cloud, and prints the posyaw ATE when the ground truth is there.

The same flags as the JAX script, plus ``--device`` (default ``cuda``;
``--device cpu`` runs on the CPU with the kernels' plain versions).
``--bag``, ``--loop-out`` and ``--viz-dir`` raise: their modules are not
ported yet. Timestamps are rebased to the whole second of the first IMU
sample (float32 state and wire keep their resolution); the files written
carry the dataset's times.

Usage:
    python -m ov_plane_tpu_torch.scripts.run_euroc --data /path/to/V1_01_easy --max-frames 500
"""

from __future__ import annotations

import argparse
import math
import os
import sys
import tempfile
import time

import numpy as np
import torch

from ov_plane_tpu_torch.eval import io as eio
from ov_plane_tpu_torch.eval import png
from ov_plane_tpu_torch.eval.metrics import ate_posyaw
from ov_plane_tpu_torch.frontend.pipeline import VisionPipeline
from ov_plane_tpu_torch.models.feature_bank import FeatureBank
from ov_plane_tpu_torch.models.initializer import InitOptions, static_initialize
from ov_plane_tpu_torch.models.manager import VioEngine, _imu_constants, init_state_with_gt, step
from ov_plane_tpu_torch.ops.quat import quat_2_rot, rot_2_quat
from ov_plane_tpu_torch.parallel.ingest import Prefetcher, device_prefetch
from ov_plane_tpu_torch.utils import printer
from ov_plane_tpu_torch.utils.config import load_yaml, sim_config
from ov_plane_tpu_torch.utils.torchenv import resolve_device

# Flags whose modules wait for a later slice: flag -> (module, ROADMAP item).
NOT_PORTED = {
    "bag": ("eval/rosbag.py", "queue 1, item 1"),
    "loop_out": ("eval/loopclosure.py", "queue 1, item 1"),
    "viz_dir": ("eval/trackviz.py", "queue 1, item 1"),
}


def euroc_v1_config():
    """EuRoC MAV cam0/imu0 calibration (the kalibr values of the reference's
    config/euroc_mav chain files)."""
    cfg = sim_config()
    cfg.cam_model = "radtan"
    cfg.cam_wh = [752, 480]
    cfg.cam_intrinsics = [458.654, 457.296, 367.215, 248.375,
                          -0.28340811, 0.07395907, 0.00019359, 1.76187114e-05]
    # T_cam_imu from the EuRoC calibration -> JPL q_ItoC + p_IinC.
    T_CtoI = np.array([
        [0.0148655429818, -0.999880929698, 0.00414029679422, -0.0216401454975],
        [0.999557249008, 0.0149672133247, 0.025715529948, -0.064676986768],
        [-0.0257744366974, 0.00375618835797, 0.999660727178, 0.00981073058949],
        [0.0, 0.0, 0.0, 1.0],
    ])
    R_ItoC = T_CtoI[:3, :3].T
    p_IinC = -R_ItoC @ T_CtoI[:3, 3]
    q = rot_2_quat(torch.as_tensor(R_ItoC, dtype=torch.float64)).numpy()
    cfg.cam_extrinsics = [*(float(v) for v in q), *(float(v) for v in p_IinC)]
    cfg.imu_noises.sigma_w = 1.6968e-04
    cfg.imu_noises.sigma_wb = 1.9393e-05
    cfg.imu_noises.sigma_a = 2.0e-3
    cfg.imu_noises.sigma_ab = 3.0e-3
    cfg.msckf_options.chi2_multipler = 5.0
    cfg.slam_options.chi2_multipler = 5.0
    cfg.state.max_slam_features = 15
    cfg.gravity_mag = 9.81
    return cfg


def _t64(x, dev) -> torch.Tensor:
    """A host array as an f64 tensor on ``dev``."""
    return torch.as_tensor(np.asarray(x, np.float64), dtype=torch.float64, device=dev)


def load_image(path) -> np.ndarray:
    """[H, W] float32 in [0, 1]: the PNG's 8-bit luma (PIL's ``convert("L")``)."""
    return png.read_gray(path).astype(np.float32) / np.float32(255.0)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--data", default="", help="sequence dir containing mav0/")
    ap.add_argument("--bag", default="", help="replay a ROS1 .bag (not ported yet)")
    ap.add_argument("--imu-topic", default="/imu0")
    ap.add_argument("--cam-topic", default="/cam0/image_raw")
    ap.add_argument("--gt", default="", help="ASL groundtruth csv outside the data folder")
    ap.add_argument("--config", default=None, help="estimator_config.yaml (reference format)")
    tmp = tempfile.gettempdir()
    ap.add_argument("--out", default=os.path.join(tmp, "ovp_euroc_traj.txt"))
    ap.add_argument("--timing", default=os.path.join(tmp, "ovp_euroc_timing.csv"))
    ap.add_argument("--plane-csv", default=os.path.join(tmp, "ovp_plane_track.csv"),
                    help="plane-tracking statistics CSV (the reference's second CSV)")
    ap.add_argument("--odom-out", default="",
                    help="also write IMU-rate odometry (fast_state_propagate between updates) to this TUM file")
    ap.add_argument("--ckpt", default="", help="checkpoint npz; with --ckpt-every N the state, bank and "
                                               "trajectory are saved every N frames")
    ap.add_argument("--ckpt-every", type=int, default=200)
    ap.add_argument("--resume", action="store_true", help="resume the replay from --ckpt")
    ap.add_argument("--loop-out", default="", help="loop-closure info packs (not ported yet)")
    ap.add_argument("--loop-every", type=int, default=10)
    ap.add_argument("--verbosity", default="", help="ALL/DEBUG/INFO/WARNING/ERROR/SILENT (default: the config's)")
    ap.add_argument("--max-frames", type=int, default=0)
    ap.add_argument("--use-planes", action="store_true")
    ap.add_argument("--max-slam", type=int, default=-1,
                    help="override state.max_slam_features (-1 keeps the config value)")
    ap.add_argument("--map-capacity", type=int, default=8192, help="persistent plane-map point capacity")
    ap.add_argument("--map-voxel", type=float, default=0.10, help="persistent-map downsample voxel (m)")
    ap.add_argument("--map-out", default="", help="write the final persistent-map cloud (npz: points, plane_id)")
    ap.add_argument("--downsample", type=int, default=1, help="process every Nth frame")
    ap.add_argument("--no-gt-init", action="store_true",
                    help="ignore the groundtruth for initialization (still used for ATE)")
    ap.add_argument("--viz-dir", default="", help="debug images (not ported yet)")
    ap.add_argument("--sim-calib", action="store_true",
                    help="the simulator's camera calibration (folders from make_synth_asl) and no histogram "
                         "preprocessing")
    ap.add_argument("--fast-threshold", type=float, default=0.0, help="override the FAST threshold (0-255)")
    ap.add_argument("--stock-plane-gates", action="store_true",
                    help="with --sim-calib --use-planes: keep the reference's default plane gates")
    ap.add_argument("--track-cap", type=int, default=0, help="override the tracker capacity (num_pts)")
    ap.add_argument("--f32", action="store_true", help="run the filter in float32")
    ap.add_argument("--fused", action="store_true",
                    help="replay through the fused vision step (frontend/fused.py) on the u8 wire")
    ap.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    return ap


def make_config(args):
    cfg = euroc_v1_config()
    if args.sim_calib:
        sc = sim_config()
        cfg.cam_model, cfg.cam_wh = sc.cam_model, sc.cam_wh
        cfg.cam_intrinsics, cfg.cam_extrinsics = sc.cam_intrinsics, sc.cam_extrinsics
        cfg.histogram_method = "NONE"
        # The tracker's capacity stays within the filter's observation slots.
        cfg.num_pts = 150
        cfg.num_pts_plane = 0
        cfg.tpu.max_obs_per_frame = 160
        # The synthetic renderer's frontend noise is about 2 px.
        cfg.msckf_options.sigma_pix = 2.0
        cfg.slam_options.sigma_pix = 2.0
        if args.use_planes and not args.stock_plane_gates:
            # The JAX script's synthetic-room plane gates.
            cfg.state.plane_init_min_feat = 8
            cfg.trackplane.min_norms = 3
            cfg.trackplane.max_norm_avg_var = 30.0
            cfg.trackplane.max_norm_avg_max = 30.0
            cfg.msckf_options.chi2_multipler = 5.0
            cfg.state.plane_init_max_cond = 150.0
            cfg.state.plane_msckf_max_cond = 150.0
    if args.config:
        cfg = load_yaml(args.config, base=cfg)
    if args.fast_threshold > 0:
        cfg.fast_threshold = args.fast_threshold
    if args.track_cap > 0:
        cfg.num_pts = args.track_cap
        cfg.tpu.max_obs_per_frame = max(2 * args.track_cap, 32)
    cfg.state.use_plane_constraint = args.use_planes
    cfg.state.use_plane_slam_feats = args.use_planes
    if args.max_slam >= 0:
        cfg.state.max_slam_features = args.max_slam
    cfg.state.do_calib_camera_pose = False
    cfg.state.do_calib_camera_intrinsics = False
    cfg.state.do_calib_camera_timeoffset = False
    return cfg


def _dynamic_init(cfg, eng, pipe, get_frame, cam_t, imu_t, imu_w, imu_a, dt, dev, t_base=0.0):
    """Dynamic initialization over a 2 s window of tracked frames (run_euroc.py:365-456).
    Returns (state, start_idx) or (None, None)."""
    from ov_plane_tpu_torch.models.dyn_init import DynInitOptions, dynamic_initialize, dynamic_mle_refine
    from ov_plane_tpu_torch.ops import cams

    print("[euroc] static init failed; trying dynamic init", file=sys.stderr)
    f64 = torch.float64

    def t64(x):
        return _t64(x, dev)

    def one(x):                     # one stream's row
        return _t64(x, dev)[None]

    zeta = t64(cfg.cam_intrinsics)
    R_ItoC = quat_2_rot(t64(cfg.cam_extrinsics[0:4]))
    p_IinC = t64(cfg.cam_extrinsics[4:7])
    win = {}
    for i, t in enumerate(cam_t):
        dummy = init_state_with_gt(eng, cfg, t0=[t], q0=one([0.0, 0, 0, 1]), p0=one(np.zeros(3)),
                                   v0=one(np.zeros(3)), bg0=one(np.zeros(3)), ba0=one(np.zeros(3)), device=dev)
        oid, ouv, _ = pipe.process_image(get_frame(i), dummy)
        win[i] = (t, oid, ouv)
        keys = sorted(win)
        while win and win[keys[0]][0] < t - 2.2:
            win.pop(keys[0])
            keys = sorted(win)
        if len(win) < 12 or (t - win[keys[0]][0]) < 1.8:
            continue
        sel = [keys[int(r)] for r in np.linspace(0, len(keys) - 1, 6)]
        tp = np.asarray([win[s][0] for s in sel])
        common = set(win[sel[0]][1][win[sel[0]][1] >= 0])
        for s in sel[1:]:
            common &= set(win[s][1][win[s][1] >= 0])
        common = sorted(common)[:16]
        if len(common) < 8:
            continue
        F = len(common)
        uv = np.zeros((6, F, 2))
        mk = np.zeros((6, F), bool)
        for a, s in enumerate(sel):
            _, oid, ouv = win[s]
            for fi, fid in enumerate(common):
                j = np.nonzero(oid == fid)[0]
                if len(j):
                    uv[a, fi] = ouv[j[0]]
                    mk[a, fi] = True
        # Undistorted in one call (the JAX script undistorts each observation alone).
        uvn = torch.where(t64(mk)[..., None] > 0, cams.undistort(t64(uv), zeta, eng.cam_model),
                          torch.zeros(6, F, 2, dtype=f64, device=dev))
        lo2 = np.searchsorted(imu_t, tp[0]) - 2
        hi2 = np.searchsorted(imu_t, tp[-1]) + 3
        di_opts = DynInitOptions(min_deg=5.0)
        di_args = (t64(imu_t[lo2:hi2]), t64(imu_w[lo2:hi2]), t64(imu_a[lo2:hi2]), t64(tp), uvn,
                   torch.as_tensor(mk, device=dev), R_ItoC, p_IinC)
        ok, q0_, v0_, g_err, pf_, fok_ = dynamic_initialize(*di_args, di_opts)
        ok = bool(ok)
        if not ok:
            print(f"[euroc] dyn-init attempt t={t + t_base:.2f}: F={F} g_err={float(g_err):.2f} -> rejected",
                  file=sys.stderr)
        bg0_ = ba0_ = torch.zeros(3, dtype=f64, device=dev)
        if ok and di_opts.mle_iters > 0:
            R_lin = quat_2_rot(q0_)
            ok_m, q_m, v_m, bg_m, ba_m, _, gerr_m, _ = dynamic_mle_refine(
                *di_args, R_lin @ v0_, R_lin @ t64([0.0, 0.0, di_opts.gravity_mag]),
                torch.einsum("ij,fj->fi", R_lin, pf_), fok_, di_opts)
            if bool(ok_m):
                q0_, v0_, bg0_, ba0_, g_err = q_m, v_m, bg_m, ba_m, gerr_m
                print(f"[euroc] dynamic MLE refined (|g| err {float(gerr_m):.3f}, "
                      f"bg {bg_m.cpu().numpy().round(4)}, ba {ba_m.cpu().numpy().round(3)})")
        if ok:
            state = init_state_with_gt(eng, cfg, t0=[t], q0=q0_[None], p0=one(np.zeros(3)), v0=v0_[None],
                                       bg0=bg0_[None], ba0=ba0_[None], dtype=dt, device=dev)
            # Dynamic init is not GT-grade: inflate the seed covariance
            # (the reference's init_dyn_inflation_*).
            infl = np.ones(15)
            infl[0:3] = di_opts.inflation_ori
            infl[6:9] = di_opts.inflation_vel
            infl[9:12] = di_opts.inflation_bg
            infl[12:15] = di_opts.inflation_ba
            s = torch.as_tensor(np.sqrt(infl), dtype=dt, device=dev)
            cov = state.cov.clone()
            cov[:, :15, :15] = cov[:, :15, :15] * s[:, None] * s[None, :]
            print(f"[euroc] dynamic init at t={t + t_base:.3f} (|g| err {float(g_err):.2f})")
            return state.replace(cov=cov), i + 1
    return None, None


def main(argv=None) -> dict:
    """Run the replay; returns a summary (init kind and frame, trajectory,
    per-frame counters, host reads, ATE, wall times, files written)."""
    ap = build_parser()
    args = ap.parse_args(argv)
    for flag, (module, item) in NOT_PORTED.items():
        if getattr(args, flag):
            raise NotImplementedError(f"--{flag.replace('_', '-')} needs {module}, which is not ported yet: it "
                                      f"comes with a later slice of ov_plane_tpu_torch (ROADMAP.md {item})")
    if not args.data:
        ap.error("--data is required")
    dev = resolve_device(args.device)
    cfg = make_config(args)
    printer.set_print_level(args.verbosity or cfg.verbosity)
    printer.print_config(cfg)
    dt = torch.float32 if args.f32 else torch.float64
    np_dt = np.float32 if args.f32 else np.float64

    mav0 = os.path.join(args.data, "mav0")
    imu = np.loadtxt(os.path.join(mav0, "imu0", "data.csv"), delimiter=",", comments="#")
    t_base = float(math.floor(imu[0, 0] * 1e-9))
    imu_t = imu[:, 0] * 1e-9 - t_base
    imu_w = imu[:, 1:4]
    imu_a = imu[:, 4:7]
    cam_csv = np.genfromtxt(os.path.join(mav0, "cam0", "data.csv"), delimiter=",", comments="#", dtype=str)
    cam_t = cam_csv[:, 0].astype(np.float64) * 1e-9 - t_base
    cam_files = [os.path.join(mav0, "cam0", "data", f.strip()) for f in cam_csv[:, 1]]

    def get_frame(i):
        return load_image(cam_files[i])

    gt_path = args.gt or os.path.join(mav0, "state_groundtruth_estimate0", "data.csv")
    have_gt = os.path.exists(gt_path)

    eng = VioEngine.from_config(cfg, device=dev)
    pipe = VisionPipeline(cfg, eng)
    fdrv = fev = None
    if args.fused:
        from ov_plane_tpu_torch.frontend.fused import FusedVisionDriver

        # PNG frames are 8-bit at the source: the u8 wire is lossless.
        fdrv = FusedVisionDriver(cfg, eng, 1, img_wire="u8")
        fev = fdrv.init_frontend()
    bank = FeatureBank.create(cfg.tpu.max_features, eng.layout.max_clones, 1, dt, dev)
    rec = eio.TimingRecorder()
    prec = eio.PlaneStatsRecorder()
    pmap = None
    if args.use_planes:
        from ov_plane_tpu_torch.frontend.map_blocks import PersistentPlaneMap

        pmap = PersistentPlaneMap(capacity=args.map_capacity, voxel=args.map_voxel,
                                  frame_batch=fdrv.vopts.cap if fdrv else pipe.fe.cap, device=dev)

    # ----- initialization ------------------------------------------------
    t_init = time.perf_counter()
    state, start_idx, init_kind = None, 0, None
    if have_gt and not args.no_gt_init:
        t_gt, p_gt, q_gt, v_gt, bg_gt, ba_gt = eio.read_euroc_gt(gt_path)
        t_gt = t_gt - t_base
        for i, t in enumerate(cam_t):      # the first camera frame with ground truth
            j = np.searchsorted(t_gt, t)
            if 0 < j < len(t_gt):
                q0, p0, v0, bg0, ba0 = (_t64(x[j], dev)[None] for x in (q_gt, p_gt, v_gt, bg_gt, ba_gt))
                state = init_state_with_gt(eng, cfg, t0=[t], q0=q0, p0=p0, v0=v0, bg0=bg0, ba0=ba0, dtype=dt,
                                           device=dev)
                start_idx, init_kind = i + 1, "gt"
                break
    if state is None:
        opts = InitOptions(window_time=1.0, imu_thresh=1.0, gravity_mag=cfg.gravity_mag)
        for i, t in enumerate(cam_t):
            lo = np.searchsorted(imu_t, t - 2.5)
            hi = np.searchsorted(imu_t, t)
            if hi - lo < 100:
                continue
            ok, _, imu16, _ = static_initialize(_t64(imu_t[lo:hi], dev), _t64(imu_w[lo:hi], dev),
                                                _t64(imu_a[lo:hi], dev), t, opts)
            if bool(ok):
                state = init_state_with_gt(eng, cfg, t0=[t], q0=imu16[None, 0:4], p0=imu16[None, 4:7],
                                           v0=imu16[None, 7:10], bg0=imu16[None, 10:13], ba0=imu16[None, 13:16],
                                           dtype=dt, device=dev)
                start_idx, init_kind = i + 1, "static"
                print(f"[euroc] static init at t={t + t_base:.3f}")
                break
    if state is None:
        state, start_idx = _dynamic_init(cfg, eng, pipe, get_frame, cam_t, imu_t, imu_w, imu_a, dt, dev, t_base)
        if state is not None:
            init_kind = "dynamic"
            pipe.fe.prev_pyr = None                  # the tracker starts anew for the filtered run
            bank = FeatureBank.create(cfg.tpu.max_features, eng.layout.max_clones, 1, dt, dev)
    if state is None:
        print("[euroc] initialization failed", file=sys.stderr)
        sys.exit(1)
    t_init = time.perf_counter() - t_init

    # ----- replay --------------------------------------------------------
    times, poss, quats, counters = [], [], [], []
    n_done = 0
    W = cfg.tpu.max_imu_per_frame
    if args.ckpt and args.resume:
        from ov_plane_tpu_torch.utils.checkpoint import load_npz

        state, bank = load_npz(args.ckpt, state, bank)
        meta = np.load(args.ckpt + ".meta.npz")
        start_idx = int(meta["next_frame"])
        times = list(meta["times"] - t_base)
        poss, quats = list(meta["poss"]), list(meta["quats"])
        if "timing_rows" in meta:
            rec.rows = [list(r) for r in meta["timing_rows"]]
        if "plane_rows" in meta:
            prec.rows = [list(r) for r in meta["plane_rows"]]
        pipe.fe.prev_pyr = None      # the tracker re-bootstraps
        # Reissued ids must not meet ids alive in the restored bank.
        pipe.fe.next_id = (int(meta["next_id"]) if "next_id" in meta
                           else int(bank.fid.max().item()) + 1_000_000)
        if fdrv is not None:
            fev = fdrv.init_frontend(first_id=pipe.fe.next_id)
        print(f"[euroc] resumed from {args.ckpt} at frame index {start_idx} ({len(times)} frames already recorded)")
    frame_idxs = range(start_idx, len(cam_t), args.downsample)
    if fdrv is not None:
        # The frame is packed to the u8 wire and its copy to the card started
        # on the prefetch thread, overlapping the previous step.
        frames_it = Prefetcher(frame_idxs, stage=lambda i: (i, fdrv.stage_image(get_frame(i)[None])), depth=2)
    else:
        # Read and decoded on the prefetch thread, copied to the card there
        # on a side stream.
        frames_it = device_prefetch(frame_idxs, dev, depth=2, stage=lambda i: (i, torch.from_numpy(get_frame(i))))
    odom_rows = []
    if args.odom_out:
        from ov_plane_tpu_torch.state.propagator import fast_state_propagate

        noises, gravity = _imu_constants(eng, dt, dev)
    # The state's time on the host, as the state holds it (set to t_new by each step).
    t_state = float(np_dt(state.t[0].item()))
    host_reads = 0
    t_loop = time.perf_counter()
    for i, img in frames_it:
        if args.max_frames and n_done >= args.max_frames:
            break
        t = float(cam_t[i])
        lo = max(np.searchsorted(imu_t, t_state) - 9, 0)
        seg = slice(lo, min(lo + W, len(imu_t)))
        if args.odom_out and n_done > 0:
            # IMU-rate odometry between the last update and this frame, in
            # chunks of 16 targets (the stamps the window covers).
            span = imu_t[(imu_t > t_state) & (imu_t <= min(t, imu_t[seg][-1]))]
            win_t, win_w, win_a = (_t64(x[seg], dev).to(dt)[None] for x in (imu_t, imu_w, imu_a))
            for c0 in range(0, len(span), 16):
                chunk = span[c0:c0 + 16]
                tgt = np.full(16, chunk[-1])
                tgt[:len(chunk)] = chunk
                imu16_b, _ = fast_state_propagate(state, win_t, win_w, win_a, _t64(tgt, dev).to(dt)[None],
                                                  noises, gravity, eng.prop_opts)
                host_reads += 1
                o = imu16_b[0].double().cpu().numpy()
                odom_rows.extend((float(chunk[k]), o[k]) for k in range(len(chunk)))
        t0 = time.perf_counter()
        if fdrv is not None:
            it_w = np.full(W, np.inf)
            iw_w = np.zeros((W, 3))
            ia_w = np.zeros((W, 3))
            m = imu_t[seg].shape[0]
            it_w[:m], iw_w[:m], ia_w[:m] = imu_t[seg], imu_w[seg], imu_a[seg]
            state, bank, fev, out = fdrv.step_stream(state, bank, fev, img, it_w, iw_w, ia_w, t)
            t1 = time.perf_counter()
            pq = torch.cat([out.p[0], out.q[0].to(out.p.dtype)]).double().cpu().numpy()
            host_reads += 1
            t2 = time.perf_counter()
            p_np, q_np = pq[0:3], pq[3:7]
            cnt = fdrv.last_counters[0]
            pstats = dict(fdrv.last_plane_stats[0])
            pstats["state planes"] = float(cnt[2])
            pstats["num constraint updates"] = float(cnt[1])
            pstats["dropped plane updates"] = float(cnt[8])
            last_tri = fdrv.last_tri[0]
            f2p_map = fdrv.tracker.feat_to_plane(0)
            n_bank_i, n_slam_i, n_planes_i = int(cnt[4]), -1, int(cnt[2])
            counters.append([int(cnt[2]), int(cnt[0]), int(cnt[1]), int(cnt[8]), int(cnt[3]), int(cnt[4]), -1])
        else:
            reads0 = pipe.n_host_reads
            obs = pipe.process_image(img, state, bank, imu_t=imu_t[seg], imu_w=imu_w[seg], t_new=t)
            t1 = time.perf_counter()
            frame = pipe.make_frame(obs, imu_t[seg], imu_w[seg], imu_a[seg], t, dtype=dt)
            state, bank, out = step(eng, state, bank, frame)
            got = torch.cat([out.p[0].double(), out.q[0].double(),
                             torch.stack([out.n_planes[0], out.n_plane_init[0], out.n_plane_constraints[0],
                                          out.n_plane_dropped[0], out.n_msckf_used[0], out.n_bank[0],
                                          out.n_slam[0]]).double()]).cpu().numpy()
            host_reads += pipe.n_host_reads - reads0 + 1
            t2 = time.perf_counter()
            p_np, q_np = got[0:3], got[3:7]
            c = [int(v) for v in got[7:14]]
            pstats = dict(pipe.last_plane_stats)
            pstats["state planes"] = float(c[0])
            pstats["num constraint updates"] = float(c[2])
            pstats["dropped plane updates"] = float(c[3])
            last_tri = pipe.last_tri
            f2p_map = pipe.feat_to_plane
            n_bank_i, n_slam_i, n_planes_i = c[5], c[6], c[0]
            counters.append(c)
        t_state = float(np_dt(t))
        rec.add(t + t_base, {"tracking": t1 - t0, "total": t2 - t0})
        if pmap is not None and last_tri is not None:
            lids_m, _, lp3_m, lok_m = last_tri
            pmap.add_frame(lids_m, lp3_m, lok_m, f2p_map)
        prec.add(t + t_base, pstats)
        times.append(t)
        poss.append(p_np)
        quats.append(q_np)
        n_done += 1
        if printer.get_print_level() <= printer.DEBUG:
            printer.print_debug(f"state t={t + t_base:.3f} q={q_np.round(4)} p={p_np.round(3)} "
                                f"bank={n_bank_i} slam={n_slam_i} planes={n_planes_i}")
        if args.ckpt and n_done % args.ckpt_every == 0:
            from ov_plane_tpu_torch.utils.checkpoint import save_npz

            save_npz(args.ckpt, state, bank)
            np.savez(args.ckpt + ".meta.npz", next_frame=i + args.downsample,
                     next_id=(int(fev.next_id[0]) if fdrv is not None else pipe.fe.next_id),
                     times=np.asarray(times) + t_base, poss=np.asarray(poss), quats=np.asarray(quats),
                     timing_rows=np.asarray(rec.rows, dtype=float), plane_rows=np.asarray(prec.rows, dtype=float))
            print(f"[euroc] checkpoint at frame {n_done} -> {args.ckpt}")
        if n_done % 50 == 0:
            mstat = f", map={pmap.stats()['n_points']}pts" if pmap is not None else ""
            print(f"[euroc] {n_done} frames, t={t + t_base:.2f}, p={p_np.round(3)}, "
                  f"bank={n_bank_i}, slam={n_slam_i}, planes={n_planes_i}{mstat}")
    frames_it.close()
    if fdrv is not None:
        fdrv.flush_stream()
        fdrv.close()
        host_reads += fdrv.n_pulls      # the driver's packed pull of each frame
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t_loop = time.perf_counter() - t_loop

    times_out = np.asarray(times) + t_base
    eio.write_tum(args.out, times_out, np.asarray(poss), np.asarray(quats))
    rec.write(args.timing)
    if args.plane_csv:
        prec.write(args.plane_csv)
    if args.odom_out and odom_rows:
        ot = np.asarray([r[0] for r in odom_rows]) + t_base
        o16 = np.stack([r[1] for r in odom_rows])
        eio.write_tum(args.odom_out, ot, o16[:, 4:7], o16[:, 0:4])
        print(f"[euroc] wrote IMU-rate odometry {args.odom_out} ({len(ot)} poses)")
    print(f"[euroc] wrote {args.out} ({n_done} frames)")
    n_dropped_total = int(sum(r[12] for r in prec.rows if len(r) > 12))
    if n_dropped_total:
        print(f"[euroc] WARNING: {n_dropped_total} qualifying plane groups exceeded "
              f"tpu.max_planes_per_frame and were dropped (raise the cap for parity)")
    map_stats = None
    if pmap is not None:
        map_stats = pmap.stats()
        print(f"[euroc] persistent map: {map_stats['n_points']} pts / {map_stats['n_planes']} planes "
              f"({map_stats['n_inserted_total']} inserted, voxel {args.map_voxel} m)")
        if args.map_out:
            from ov_plane_tpu_torch.native import VoxelPointMap

            pts_m, pid_m = pmap.cloud()
            # Consolidate across insert epochs through the native voxel grid
            # (the ikd-tree's Add_Points(downsample=true), ikd_tree.h:240-261).
            grid = VoxelPointMap(voxel=max(4 * args.map_voxel, 0.2), downsample=args.map_voxel)
            grid.add(pts_m, pid_m.astype(np.int32), downsample=True)
            pts_d, pid_d = grid.flatten(max_n=max(len(pts_m), 1))
            np.savez(args.map_out, points=pts_d, plane_id=pid_d, points_raw=pts_m, plane_id_raw=pid_m)
            print(f"[euroc] wrote map cloud {args.map_out} ({len(pts_d)} pts, {len(pts_m)} pre-consolidation)")

    ate = None
    if have_gt and n_done > 10:
        t_gt, p_gt, q_gt, *_ = eio.read_euroc_gt(gt_path)
        gi = np.clip(np.searchsorted(t_gt - t_base, np.asarray(times)), 0, len(t_gt) - 1)
        cpu = torch.device("cpu")
        ate_p, ate_o, _, _ = ate_posyaw(*(_t64(x, cpu) for x in (poss, quats, p_gt[gi], q_gt[gi])))
        ate = (float(ate_p), float(ate_o))
        print(f"[euroc] ATE posyaw: {ate[0]:.3f} m / {ate[1]:.3f} deg")
    return {"init": init_kind, "start_idx": start_idx, "n_done": n_done, "times": times_out,
            "p": np.asarray(poss), "q": np.asarray(quats), "counters": np.asarray(counters, np.int64),
            "counter_names": ("n_planes", "n_plane_init", "n_plane_constraints", "n_plane_dropped",
                              "n_msckf_used", "n_bank", "n_slam"),
            "host_reads": host_reads, "init_seconds": t_init, "loop_seconds": t_loop, "ate": ate,
            "map": map_stats}


if __name__ == "__main__":
    main()
