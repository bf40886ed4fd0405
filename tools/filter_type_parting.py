#!/usr/bin/env python3
"""Where the port's f32 filter parts from its f64 one, on the CPU alone.

    python3 tools/filter_type_parting.py mc [--frames 48]
    python3 tools/filter_type_parting.py sweep [--frames 47]
    python3 tools/filter_type_parting.py ransac

``mc``: the planes-ON arm of ``run_mc_vision`` (tabletop, sparse, streams
0-1 of ``chip_smoke.py`` phase 15's draws made on the CPU) with the filter in
f32 and in f64, under the script's own wire and sampler (u8, ``mm_bf16``)
and the exact ``mm`` sampler on the f32 wire: the share of slot-frames with
equal track ids and valid flags, the frames whose plane counters differ,
and the stage trace of the first 12 frames (``chip_smoke._stage_trace``).
``sweep``: each ladder variant of ``scripts/run_sweep`` (2 streams of the
6 s room scan) through ``chip_smoke.cpu_run`` in f32 and f64: the per-frame
counters compared. ``ransac``: the gyro RANSAC of frames 2-4 of the ``mc``
arm (f64 filter) rerun on its recorded inputs, with the current points or
the rotation moved by a small random amount: the inlier flips.

No card is needed; ``--threads`` sets torch's CPU threads (default 4).
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as cs  # noqa: E402


def mc_inputs(frames: int):
    from ov_plane_tpu_torch.scripts import run_mc_vision as mc
    from ov_plane_tpu_torch.sim import simulator

    cfg, render = mc.scene_config("tabletop", False)
    truth = simulator.build_sim(cfg, max_obs=cfg.tpu.max_obs_per_frame, device="cpu")
    sim = mc.noisy_streams(cfg, truth, cs.MC_SEEDS, 17)
    images = np.stack(list(mc.noisy_images(mc.render_frames(cfg, truth, render, frames, "cpu"), cs.MC_SEEDS, 17)))
    return cs._to_host(sim, 2), images[:, :2]


def run_mc(frames: int):
    host, images = mc_inputs(frames)
    for wire in (("auto", "auto"), ("mm", "f32")):
        res = {}
        for dt in (torch.float64, torch.float32):
            t = time.time()
            res[dt] = cs._mc_cpu_reference(host, images, *wire, dt, cs.MC_TRACE)
            print(f"[mc] {wire[0]}, filter {dt}: {frames} frames in {time.time() - t:.1f} s", flush=True)
        a, b = res[torch.float64], res[torch.float32]
        same = (a["ids"] == b["ids"]) & (a["valid"] == b["valid"])
        part = int(np.argmin(same.reshape(frames, -1).all(axis=1))) + 1 if not same.all() else None
        planes = (a["counters"][..., 0:3] == b["counters"][..., 0:3]).all(axis=(1, 2))
        print(f"[mc] {wire[0]}: f32 against f64 filter, ids and valid equal on {100 * same.mean():.2f}% of "
              f"slot-frames (first difference at frame {part}); plane counters equal on {int(planes.sum())} of "
              f"{frames} frames, apart on {(np.nonzero(~planes)[0] + 1).tolist()}; max|dp| "
              f"{np.abs(a['p'] - b['p']).max():.3e} m")
        found = cs._stage_trace("[mc]", b["stages"], a["stages"], part, "f32 vs f64 filter")
        print(f"[mc] {wire[0]}: first differing decision {found}")


def run_sweep(frames: int):
    from ov_plane_tpu_torch.scripts import run_sweep as rs
    from ov_plane_tpu_torch.sim import simulator

    truths = {}
    for name, (max_slam, use_planes) in rs.VARIANTS.items():
        cfg = rs.make_config(6.0, "", max_slam, use_planes)
        cfg.tpu.use_info_compression = True
        if use_planes not in truths:
            truths[use_planes] = simulator.build_sim(cfg, max_obs=cfg.tpu.max_obs_per_frame, device="cpu")
        sim = rs.noisy_scene(cfg, 2, "cpu", truths[use_planes])
        a, b = (cs.cpu_run(cfg, sim, frames, dt) for dt in (torch.float64, torch.float32))
        names = (("n_msckf_used", "n_bank", "n_clones") + (cs.PLANE_COUNTERS if use_planes else ())
                 + (cs.SLAM_COUNTERS if max_slam else ()))
        equal = {k: int((getattr(a, k) == getattr(b, k)).sum()) for k in names}
        print(f"[sweep] {name}: f32 against f64, stream-frames with equal counters of {2 * frames}: {equal}; "
              f"max|dp| {(a.p - b.p.double()).abs().max().item():.3e} m")


def run_ransac():
    from ov_plane_tpu_torch.frontend.ransac import gyro_ransac

    host, images = mc_inputs(4)
    rec = cs._mc_cpu_reference(host, images, "auto", "auto", torch.float64, 4)["stages"]
    rng = np.random.default_rng(0)

    def jitter(x, eps):
        return torch.from_numpy(rng.normal(0, eps, x.shape).astype(np.float32))

    for f in (2, 3, 4):
        *args, opts = rec[f - 1]["RANSAC inputs"]
        t = [torch.from_numpy(x) for x in args]
        base = gyro_ransac(*t, opts)[0]
        moved = {f"points by {eps:g}": (t[0], t[1] + jitter(t[1], eps), t[2], t[3]) for eps in (1e-7, 3e-5)}
        moved["rotation by 1e-7 relative"] = (t[0], t[1], t[2], t[3] * (1 + jitter(t[3], 1e-7)))
        print(f"[ransac] frame {f} ({int(t[2].sum())} matches): inlier flips "
              + ", ".join(f"{k} {int((gyro_ransac(*v, opts)[0] != base).sum())}" for k, v in moved.items()))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("what", choices=("mc", "sweep", "ransac"))
    ap.add_argument("--frames", type=int, default=None)
    ap.add_argument("--threads", type=int, default=4)
    args = ap.parse_args(argv)
    torch.set_num_threads(args.threads)
    if args.what == "mc":
        run_mc(args.frames or cs.MC_FRAMES)
    elif args.what == "sweep":
        run_sweep(args.frames or cs.SWEEP_FRAMES)
    else:
        run_ransac()
    return 0


if __name__ == "__main__":
    sys.exit(main())
