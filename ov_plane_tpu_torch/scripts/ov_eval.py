"""Trajectory and timing analysis, the ov_eval commands the reference's result
scripts drive (counterpart of ``scripts/ov_eval.py``):

  error_dataset      ATE (posyaw) + RPE of one or more runs against one gt file
  error_comparison   per-algorithm mean/std ATE over sequence directories
  timing_comparison  per-column mean/std/99th/max of timing CSVs
                     (timing_custom.cpp:37-151, with a LaTeX row)

Trajectory files are TUM (t x y z qx qy qz qw, the JPL R_GtoI convention
``eval/io.write_tum`` writes). The ground truth is associated to each
estimate time by linear interpolation (slerp for the orientation), as
ov_eval intersects trajectories. The metrics run in float64 on ``--device``
(the card by default).

Usage:
  python -m ov_plane_tpu_torch.scripts.ov_eval error_dataset      <gt.txt> <est.txt> [...]
  python -m ov_plane_tpu_torch.scripts.ov_eval error_comparison   <gt_dir> <algo_dir> [...]
  python -m ov_plane_tpu_torch.scripts.ov_eval timing_comparison  <timing.csv> [...]
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch

from ov_plane_tpu_torch.eval.io import read_tum
from ov_plane_tpu_torch.eval.metrics import ate_posyaw, rpe
from ov_plane_tpu_torch.utils.torchenv import resolve_device


def _slerp(q0, q1, u):
    d = np.sum(q0 * q1, axis=-1, keepdims=True)
    q1 = np.where(d < 0, -q1, q1)
    d = np.abs(d)
    th = np.arccos(np.clip(d, -1.0, 1.0))
    sth = np.sin(th)
    w0 = np.where(sth > 1e-9, np.sin((1 - u) * th) / np.where(sth > 1e-9, sth, 1.0), 1 - u)
    w1 = np.where(sth > 1e-9, np.sin(u * th) / np.where(sth > 1e-9, sth, 1.0), u)
    q = w0 * q0 + w1 * q1
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


def associate(t_est, t_gt, p_gt, q_gt, max_dt=0.02):
    """The ground truth interpolated at the estimate times; estimate times
    outside the ground truth's span are dropped. Returns (keep, near, p, q)."""
    keep = (t_est >= t_gt[0]) & (t_est <= t_gt[-1])
    t = t_est[keep]
    i1 = np.clip(np.searchsorted(t_gt, t), 1, len(t_gt) - 1)
    i0 = i1 - 1
    u = ((t - t_gt[i0]) / np.maximum(t_gt[i1] - t_gt[i0], 1e-12))[:, None]
    p = (1 - u) * p_gt[i0] + u * p_gt[i1]
    q = _slerp(q_gt[i0], q_gt[i1], u)
    near = np.minimum(np.abs(t - t_gt[i0]), np.abs(t_gt[i1] - t)) <= max_dt
    return keep, near, p, q


def eval_one(gt_path, est_path, device="cuda"):
    """ATE and RPE of one estimate file against one ground-truth file, or
    None below 10 associated poses."""
    dev = resolve_device(device)
    t_g, p_g, q_g = read_tum(gt_path)
    t_e, p_e, q_e = read_tum(est_path)
    keep, near, p_gi, q_gi = associate(t_e, t_g, p_g, q_g)
    p_e, q_e = p_e[keep][near], q_e[keep][near]
    p_gi, q_gi = p_gi[near], q_gi[near]
    if len(p_e) < 10:
        return None
    t = [torch.as_tensor(a, dtype=torch.float64, device=dev) for a in (p_e, q_e, p_gi, q_gi)]
    ate_p, ate_o, _, _ = ate_posyaw(*t)
    length = float(np.sum(np.linalg.norm(np.diff(p_gi, axis=0), axis=1)))
    segs = tuple(L for L in (8.0, 16.0, 24.0, 32.0, 40.0, 48.0) if L < 0.5 * length)
    rpes = rpe(*t, segment_lengths=segs) if segs else {}
    return {
        "n": len(p_e), "length": length,
        "ate_pos": float(ate_p), "ate_ori_deg": float(ate_o),
        "rpe": {L: (float(o), float(p)) for L, (o, p) in rpes.items()},
    }


def cmd_error_dataset(args):
    print(f"ground truth: {args.paths[0]}")
    for est in args.paths[1:]:
        r = eval_one(args.paths[0], est, args.device)
        if r is None:
            print(f"  {os.path.basename(est)}: <too few associated poses>")
            continue
        print(f"  {os.path.basename(est)}: ATE {r['ate_ori_deg']:.3f} deg / "
              f"{r['ate_pos']:.3f} m   ({r['n']} poses, {r['length']:.1f} m path)")
        for L, (o, p) in r["rpe"].items():
            print(f"    RPE {L:>4.0f} m: {o:.3f} deg / {p:.3f} m")


def comparison(gt_dir, algo_dirs, device="cuda"):
    """{algorithm: {sequence: [eval_one of each run]}} over the sequences of
    ``gt_dir`` (a sequence is ``<algo>/<seq>/*.txt`` or ``<algo>/<seq>.txt``)."""
    gts = {os.path.splitext(f)[0]: os.path.join(gt_dir, f)
           for f in sorted(os.listdir(gt_dir)) if f.endswith(".txt")}
    out = {}
    for algo_dir in algo_dirs:
        cells = {}
        for seq, gt_path in gts.items():
            seq_dir = os.path.join(algo_dir, seq)
            if os.path.isdir(seq_dir):
                runs = [os.path.join(seq_dir, f) for f in sorted(os.listdir(seq_dir)) if f.endswith(".txt")]
            else:
                one = os.path.join(algo_dir, seq + ".txt")
                runs = [one] if os.path.exists(one) else []
            cells[seq] = [r for r in (eval_one(gt_path, p, device) for p in runs) if r]
        out[os.path.basename(algo_dir.rstrip("/"))] = cells
    return gts, out


def cmd_error_comparison(args):
    gts, table = comparison(args.paths[0], args.paths[1:], args.device)
    print(f"{'algorithm':<24}" + "".join(f"{s:<22}" for s in gts))
    for algo, cells in table.items():
        row = []
        for seq in gts:
            vals = [r["ate_pos"] for r in cells[seq]]
            oris = [r["ate_ori_deg"] for r in cells[seq]]
            row.append(f"{np.mean(oris):.3f}/{np.mean(vals):.3f}±{np.std(vals):.3f}" if vals else "-")
        print(f"{algo:<24}" + "".join(f"{c:<22}" for c in row))
    print("(cells: ATE ori_deg / pos_m ± std over runs, posyaw alignment)")


def timing_stats(path):
    """(frames, [(column, mean, std, 99th, max)]) of one timing CSV."""
    with open(path) as f:
        header = f.readline().strip().lstrip("#").split(",")
    data = np.loadtxt(path, delimiter=",", skiprows=1, ndmin=2)
    cols = header[1:] if data.shape[1] == len(header) else header
    vals = data[:, 1:] if data.shape[1] == len(header) else data
    return vals.shape[0], [(name.strip(), np.mean(vals[:, j]), np.std(vals[:, j]), np.percentile(vals[:, j], 99),
                            np.max(vals[:, j])) for j, name in enumerate(cols)]


def cmd_timing_comparison(args):
    """Per-column statistics of timing CSVs (timing_custom.cpp:37-151:
    mean/std/99th/max per column plus a LaTeX table row)."""
    for path in args.paths:
        n, stats = timing_stats(path)
        print(f"{path} ({n} frames)")
        print(f"  {'stage':<22}{'mean':>10}{'std':>10}{'99th':>10}{'max':>10}")
        for name, mean, std, p99, vmax in stats:
            print(f"  {name:<22}{mean:>10.4f}{std:>10.4f}{p99:>10.4f}{vmax:>10.4f}")
        print("  LaTeX: " + " & ".join(f"{mean:.3f} $\\pm$ {std:.3f}" for _, mean, std, _, _ in stats) + r" \\")


COMMANDS = {"error_dataset": cmd_error_dataset, "error_comparison": cmd_error_comparison,
            "timing_comparison": cmd_timing_comparison}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = ap.add_subparsers(dest="cmd", required=True)
    for name in COMMANDS:
        p = sub.add_parser(name)
        p.add_argument("paths", nargs="+")
        p.add_argument("--device", default="cuda", help="where the metrics run ('cuda' or 'cpu')")
    args = ap.parse_args(argv)
    COMMANDS[args.cmd](args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
