"""One-command real-data experiment protocol (counterpart of ``scripts/run_real_suite.py``).

Given a directory of EuRoC-style ASL sequence folders (each holding
``mav0/``) and/or ROS1 ``.bag`` files, this runs the reference's evaluation
protocol unattended:

* per sequence × estimator variant (the four columns of the reference's
  experiment scripts, ``results/run_ros_eth.sh:31-52,86-99``):

      M-PT   points only, MSCKF        (num_slam=0,  planes off)
      MS-PT  points only, MSCKF+SLAM   (num_slam=15, planes off)
      M-PL   plane-aided MSCKF         (num_slam=0,  planes on)
      MS-PL  plane-aided MSCKF+SLAM    (num_slam=15, planes on)

  each replayed by ``python -m ov_plane_tpu_torch.scripts.run_euroc`` in a
  process of its own, saving TUM estimates and timing CSVs in the
  reference's results layout (``algorithms/<variant>/<seq>/<run>_estimate.txt``,
  ``launch/serial.launch:97-103``);
* the posyaw-aligned ATE comparison table over all variants
  (``ov_eval error_comparison``) and per-stage timing statistics
  (``timing_comparison``), written beside the results.

``--dry-run`` synthesizes two small ASL stand-ins with the port's
``make_synth_asl`` (in this process) and runs the same protocol on them. The replays of
``.bag`` files fail while ``run_euroc --bag`` is not ported; the suite
records them as failed runs. Unlike the JAX script, the suite probes no
network endpoint.

Usage:
    python -m ov_plane_tpu_torch.scripts.run_real_suite --data-root /data/euroc --out DIR [--device cuda|cpu]
    python -m ov_plane_tpu_torch.scripts.run_real_suite --dry-run --out DIR
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import subprocess
import sys
import time

from ov_plane_tpu_torch.scripts import make_synth_asl, ov_eval

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# (num_slam, use_planes): run_ros_eth.sh's mode loop with sigma_constraint at the protocol's 0.010.
VARIANTS = {
    "M-PT": (0, False),
    "MS-PT": (15, False),
    "M-PL": (0, True),
    "MS-PL": (15, True),
}
# The --dry-run stand-ins: (name, seconds, points on planes), 60 free points each.
DRY_RUN_SEQUENCES = (("synth_table_01", 8.0, 40), ("synth_table_02", 8.0, 40))


def discover_sequences(data_root: str):
    """(kind, name, path) of the ASL folders (holding mav0/) and .bag files under data_root."""
    seqs = []
    for entry in sorted(os.listdir(data_root)):
        p = os.path.join(data_root, entry)
        if os.path.isdir(p) and os.path.isdir(os.path.join(p, "mav0")):
            seqs.append(("asl", entry, p))
        elif entry.endswith(".bag"):
            seqs.append(("bag", os.path.splitext(entry)[0], p))
    return seqs


def extract_asl_gt_tum(seq_path: str, out_txt: str) -> bool:
    """mav0/state_groundtruth_estimate0/data.csv → TUM (t x y z qx qy qz qw).

    EuRoC gt columns: t[ns], p_RS_R(3), q_RS(w,x,y,z), v, bw, ba (the file
    the reference's serial driver reads for its alignment)."""
    gt_csv = os.path.join(seq_path, "mav0", "state_groundtruth_estimate0", "data.csv")
    if not os.path.exists(gt_csv):
        return False
    rows = []
    with open(gt_csv) as f:
        for line in f:
            if line.startswith("#") or not line.strip():
                continue
            v = line.strip().split(",")
            t = float(v[0]) * 1e-9
            px, py, pz = float(v[1]), float(v[2]), float(v[3])
            qw, qx, qy, qz = float(v[4]), float(v[5]), float(v[6]), float(v[7])
            rows.append((t, px, py, pz, qx, qy, qz, qw))
    with open(out_txt, "w") as f:
        f.write("# timestamp(s) tx ty tz qx qy qz qw\n")
        for r in rows:
            f.write(" ".join(f"{x:.9f}" for x in r) + "\n")
    return bool(rows)


def _child_env() -> dict:
    """The environment of a child process: this checkout first on the module path."""
    path = os.environ.get("PYTHONPATH", "")
    return dict(os.environ, PYTHONPATH=REPO + (os.pathsep + path if path else ""))


def run_one(kind, seq_path, est_path, time_path, num_slam, use_planes, args):
    """One replay in a process of its own; returns (ok, seconds, last lines of its output)."""
    cmd = [sys.executable, "-m", "ov_plane_tpu_torch.scripts.run_euroc",
           "--out", est_path, "--timing", time_path, "--max-slam", str(num_slam),
           "--plane-csv", os.path.splitext(time_path)[0] + "_planes.csv", "--device", args.device]
    cmd += (["--bag", seq_path] if kind == "bag" else ["--data", seq_path])
    if use_planes:
        cmd.append("--use-planes")
    if args.config:
        cmd += ["--config", args.config]
    if args.max_frames:
        cmd += ["--max-frames", str(args.max_frames)]
    if args.fused:
        cmd.append("--fused")
    if args.sim_calib:
        cmd.append("--sim-calib")
    if args.extra:
        cmd += args.extra.split()
    t0 = time.time()
    r = subprocess.run(cmd, env=_child_env(), capture_output=True, text=True, timeout=args.run_timeout)
    ok = r.returncode == 0 and os.path.exists(est_path)
    tail = "\n".join((r.stdout + r.stderr).strip().splitlines()[-4:])
    return ok, time.time() - t0, tail


def synthesize(data_root: str, device: str):
    """The --dry-run stand-ins that ``data_root`` does not hold yet, written
    by the port's make_synth_asl."""
    os.makedirs(data_root, exist_ok=True)
    for name, dur, npl in DRY_RUN_SEQUENCES:
        if os.path.isdir(os.path.join(data_root, name, "mav0")):
            continue
        print(f"[suite] synthesizing {name} ...", flush=True)
        cfg = make_synth_asl.synth_config(duration=dur, num_pts=60, num_pts_plane=npl)
        make_synth_asl.write_sim_asl(os.path.join(data_root, name), cfg, device=device)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--data-root", default="", help="directory of ASL sequence folders and/or .bag files")
    ap.add_argument("--out", required=True, help="results root")
    ap.add_argument("--variants", default="M-PT,MS-PT,M-PL,MS-PL")
    ap.add_argument("--runs", type=int, default=1,
                    help="repeat runs per cell (the reference's euroc protocol uses 1; the replay is deterministic)")
    ap.add_argument("--config", default="", help="estimator_config.yaml for all runs")
    ap.add_argument("--max-frames", type=int, default=0)
    ap.add_argument("--fused", action="store_true", help="use the fused vision step in each replay")
    ap.add_argument("--sim-calib", action="store_true",
                    help="sequences were synthesized with the simulator's calibration (make_synth_asl "
                         "stand-ins); implied by --dry-run")
    ap.add_argument("--device", default="cuda", help="where the replays run ('cuda' or 'cpu')")
    ap.add_argument("--run-timeout", type=int, default=7200)
    ap.add_argument("--extra", default="", help="extra run_euroc arguments (verbatim)")
    ap.add_argument("--dry-run", action="store_true",
                    help="synthesize two small ASL stand-ins and run the full protocol on them")
    args = ap.parse_args(argv)

    os.makedirs(args.out, exist_ok=True)
    data_root = args.data_root
    if args.dry_run:
        args.sim_calib = True
        args.max_frames = args.max_frames or 60
        data_root = os.path.join(args.out, "synth_data")
        synthesize(data_root, args.device)
    if not data_root or not os.path.isdir(data_root):
        sys.exit(f"[suite] no data: --data-root {data_root!r} missing")

    seqs = discover_sequences(data_root)
    if not seqs:
        sys.exit(f"[suite] {data_root} holds no ASL folders or .bag files")
    print(f"[suite] {len(seqs)} sequences: {[s[1] for s in seqs]}")

    gt_dir = os.path.join(args.out, "truths")
    os.makedirs(gt_dir, exist_ok=True)
    have_gt = {name for kind, name, path in seqs
               if kind == "asl" and extract_asl_gt_tum(path, os.path.join(gt_dir, name + ".txt"))}
    print(f"[suite] ground truth extracted for {sorted(have_gt)}")

    variants = [v.strip() for v in args.variants.split(",") if v.strip()]
    algo_root = os.path.join(args.out, "algorithms")
    time_root = os.path.join(args.out, "timings")
    manifest = []
    for variant in variants:
        num_slam, use_planes = VARIANTS[variant]
        for kind, name, path in seqs:
            for j in range(args.runs):
                est_dir = os.path.join(algo_root, variant, name)
                tim_dir = os.path.join(time_root, variant, name)
                os.makedirs(est_dir, exist_ok=True)
                os.makedirs(tim_dir, exist_ok=True)
                est = os.path.join(est_dir, f"{j:02d}_estimate.txt")
                tim = os.path.join(tim_dir, f"{j:02d}_timing.csv")
                print(f"[suite] {variant} / {name} / run {j:02d} ...", flush=True)
                ok, wall, tail = run_one(kind, path, est, tim, num_slam, use_planes, args)
                print(f"[suite]   {'ok' if ok else 'FAILED'} in {wall:.0f}s")
                if not ok:
                    print("[suite]   tail:\n" + tail)
                manifest.append({"variant": variant, "seq": name, "run": j, "ok": ok, "wall_s": round(wall, 1)})
    with open(os.path.join(args.out, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1)
    n_fail = sum(1 for m in manifest if not m["ok"])

    # ATE comparison table (ov_eval error_comparison protocol).
    if have_gt:
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            ov_eval.main(["error_comparison", gt_dir, *(os.path.join(algo_root, v) for v in variants),
                          "--device", args.device])
        print(buf.getvalue())
        with open(os.path.join(args.out, "ate_comparison.txt"), "w") as f:
            f.write(buf.getvalue())

    # Timing statistics.
    tim_files = [p for v in variants for _, name, _ in seqs
                 if os.path.exists(p := os.path.join(time_root, v, name, "00_timing.csv"))]
    if tim_files:
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            ov_eval.main(["timing_comparison", *tim_files, "--device", args.device])
        with open(os.path.join(args.out, "timing_comparison.txt"), "w") as f:
            f.write(buf.getvalue())

    print(f"[suite] done: {len(manifest) - n_fail}/{len(manifest)} runs ok; results in {args.out}")
    return 1 if n_fail else 0


if __name__ == "__main__":
    sys.exit(main())
