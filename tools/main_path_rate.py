#!/usr/bin/env python3
"""Stream-frames/s of the port's main path, to compare two checkouts on one card.

    python3 tools/main_path_rate.py [--root CHECKOUT] [--frames N]

Imports ``ov_plane_tpu_torch`` from CHECKOUT (default: this repository) and
drives it as ``chip_smoke.py`` phase 4 does: the committed simulator scene,
64 Monte-Carlo streams re-noised from seed 7, ``VioEngine`` + ``run_sequence``
in f32 on the card; 3 frames of warm-up, then a timed run from a fresh state
over N frames (default: every frame). Prints the card's name and power limit,
then one JSON line: the checkout, frames, wall seconds, stream-frames/s and
the two kernels' launch counts.

The rate is host-bound and moves between machine calls, so compare two
checkouts only within one call, in separate processes, alternating
(A B B A).
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import torch

BATCH = 64
SEED = 7


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--frames", type=int, default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("main_path_rate: needs a CUDA card", file=sys.stderr)
        return 2
    root = str(Path(args.root).resolve())
    sys.path.insert(0, root)
    import ov_plane_tpu_torch
    from ov_plane_tpu_torch.models.feature_bank import FeatureBank
    from ov_plane_tpu_torch.models.manager import VioEngine, init_state_with_gt, run_sequence
    from ov_plane_tpu_torch.ops import kernels
    from ov_plane_tpu_torch.sim.simulator import apply_noise, load_scene, noise_params
    from ov_plane_tpu_torch.utils.config import slice_config

    if not ov_plane_tpu_torch.__file__.startswith(root):
        raise RuntimeError(f"imported {ov_plane_tpu_torch.__file__}, not the package under {root}")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip().splitlines()[0])
    kernels.build()
    cfg = slice_config()
    truth = load_scene(dtype=torch.float32, device="cuda")
    sim = apply_noise(truth, noise_params(cfg), BATCH, torch.Generator(device="cuda").manual_seed(SEED))
    eng = VioEngine.from_config(cfg, device="cuda")
    n_frames = sim.cam_t.shape[0] - 1 if args.frames is None else args.frames

    def fresh():
        st = init_state_with_gt(eng, cfg, t0=sim.cam_t_imu[0].expand(BATCH), q0=sim.gt_q[0].expand(BATCH, 4),
                                p0=sim.gt_p[0].expand(BATCH, 3), v0=sim.gt_v[0].expand(BATCH, 3),
                                bg0=sim.gt_bg_cam[:, 0], ba0=sim.gt_ba_cam[:, 0], dtype=torch.float32,
                                device="cuda")
        return st, FeatureBank.create(cfg.tpu.max_features, eng.layout.max_clones, BATCH, torch.float32, "cuda")

    state, bank = fresh()
    run_sequence(eng, state, bank, sim, imu_window=cfg.tpu.max_imu_per_frame, n_frames=3)
    state, bank = fresh()
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t = time.time()
    run_sequence(eng, state, bank, sim, imu_window=cfg.tpu.max_imu_per_frame, n_frames=n_frames)
    torch.cuda.synchronize()
    wall = time.time() - t
    print(json.dumps({"root": root, "frames": n_frames, "wall_s": wall,
                      "stream_frames_per_s": BATCH * n_frames / wall,
                      "launches": {"gram_reduce": kernels.gram_reduce.launches,
                                   "kalman_downdate": kernels.kalman_downdate.launches}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
