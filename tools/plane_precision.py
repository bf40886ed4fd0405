#!/usr/bin/env python3
"""Which stage of a filter path carries the card's f32 error, on one CUDA card.

    python3 tools/plane_precision.py [--frames 60] [--path plane|ms-pl] [--seeds 7 8 ...]
                                     [--variants "card f32" "card f32, plain kernels" ...]

Drives the plane path as ``chip_smoke.py`` phase 5 does (``plane_config``,
the committed M-PL scene, 64 streams re-noised from seed 7 in f32 on the
card), or with ``--path ms-pl`` the MS-PL path of phase 5b
(``ms_pl_config``, SLAM landmarks on the same scene), over the first N
frames in several precisions, and holds streams 0 and 1 of each run
against the port's f64 CPU run of the same two streams (the reference of
``chip_smoke.py``):

* ``card f32``: the smoke's run;
* ``card f64``: every stage in f64 (the f32 noise draws, cast up);
* ``card f32, <stage> in f64``: one stage's inputs cast up to f64 and its
  state cast back to f32: the classic update (``msckf_update``), and within
  it the triangulation, the two kernels, the compression of (Λ, η) to rows
  (``information_to_compressed``); the plane stages (``plane_delayed_init``
  and ``msckf_plane_update``); the SLAM stages (``slam_update`` and
  ``slam_delayed_init``, MS-PL only);
* ``card f32, plain kernels``: both kernels replaced by their plain
  versions (cuBLAS products, another order of the f32 sums);
* ``card f32, classic update compressed by QR``: the classic update's rows
  compressed by QR (``ekf.measurement_compress``) instead of the information
  form, whose Gram squares the stack's condition number;
* ``CPU f32``: the two streams on the CPU in f32 (plain kernel versions).

``--seeds`` repeats the whole comparison for each seed of the noise draw
(the smoke's is 7) and ends with each variant's largest |Δp| and |Δq| over
the seeds; ``--variants`` runs only the variants named.

For each it prints max |Δp| and max |Δq| over the window, the frame of the
largest |Δq|, the largest |Δq| within frames 1-20 and 1-40, on how many
stream-frames the five plane counters equal the reference's, and the frames
where the count of features that passed the classic update's χ² gate
differs from the reference's.
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from ov_plane_tpu_torch.models import manager, msckf  # noqa: E402
from ov_plane_tpu_torch.ops import kernels  # noqa: E402


def _cast(x, dtype):
    """x with every float tensor in it (in a tensor tree, a tuple) cast to dtype."""
    if isinstance(x, torch.Tensor):
        return x.to(dtype) if x.is_floating_point() else x
    if hasattr(x, "tensors"):
        return x.replace(**{k: _cast(v, dtype) for k, v in x.tensors().items()})
    if isinstance(x, tuple):
        items = [_cast(v, dtype) for v in x]
        return type(x)(*items) if hasattr(x, "_fields") else tuple(items)
    return x


def _float_dtype(x):
    if isinstance(x, torch.Tensor):
        return x.dtype if x.is_floating_point() else None
    parts = x.tensors().values() if hasattr(x, "tensors") else x if isinstance(x, tuple) else ()
    return next((d for d in map(_float_dtype, parts) if d is not None), None)


def in_f64(fn):
    """``fn`` run in f64 on inputs of any float type; its outputs come back in
    the type of the first float tensor among its arguments. Attributes of
    ``fn`` (a kernel wrapper's launch count) are carried over."""
    @functools.wraps(fn)
    def run(*args, **kw):
        dtype = next(d for d in map(_float_dtype, (*args, *kw.values())) if d is not None)
        out = fn(*(_cast(a, torch.float64) for a in args), **{k: _cast(v, torch.float64) for k, v in kw.items()})
        return _cast(out, dtype)
    return run


# (module, attribute) pairs run in f64 by each mixed variant.
STAGES_F64 = {
    "msckf_update": [(manager, "msckf_update")],
    "triangulation": [(msckf, "triangulate")],
    "kernels": [(kernels, "gram_reduce"), (kernels, "kalman_downdate")],
    "compression": [(msckf, "information_to_compressed")],
    "plane stages": [(manager, "plane_delayed_init"), (manager, "msckf_plane_update")],
    "SLAM stages": [(manager, "slam_update"), (manager, "slam_delayed_init")],
}
# Stages swapped for other functions (the plain versions) by a variant.
SWAPPED = {"plain kernels": [(kernels, "gram_reduce", kernels.gram_reduce_ref),
                             (kernels, "kalman_downdate", kernels.kalman_downdate_ref)]}


def card_run(spec, cfg, sim, n_frames: int, dtype, f64_stage: str | None = None, qr: bool = False):
    """The card's run; ``qr`` compresses the classic update's rows by QR
    instead of the information form (no ``gram_reduce``)."""
    from ov_plane_tpu_torch.models.manager import VioEngine, run_sequence

    patched = [(mod, name, getattr(mod, name)) for mod, name in STAGES_F64.get(f64_stage, [])]
    for mod, name, fn in patched:
        setattr(mod, name, in_f64(fn))
    for mod, name, fn in SWAPPED.get(f64_stage, []):
        patched.append((mod, name, getattr(mod, name)))
        setattr(mod, name, fn)
    try:
        sim_d = sim._replace(**{k: _cast(v, dtype) for k, v in sim._asdict().items()})
        eng = VioEngine.from_config(cfg, device="cuda")
        if qr:
            eng = dataclasses.replace(eng, msckf_opts=eng.msckf_opts._replace(use_info_compression=False))
        st, bk = chip_smoke._fresh(eng, cfg, sim_d, chip_smoke.BATCH, "cuda", dtype)
        outs = run_sequence(eng, st, bk, sim_d, imu_window=cfg.tpu.max_imu_per_frame, n_frames=n_frames)[2]
        torch.cuda.synchronize()
        return outs
    finally:
        for mod, name, fn in patched:
            setattr(mod, name, fn)


def report(label: str, outs, ref, n: int, seconds: float):
    """Print one variant's comparison with the reference; returns (max|Δp|, max|Δq|)."""
    dq = (outs.q[:2, :n].double().cpu() - ref.q).abs().amax(dim=(0, 2))
    dp = (outs.p[:2, :n].double().cpu() - ref.p).abs().amax(dim=(0, 2))
    names = chip_smoke.PLANE_COUNTERS + (chip_smoke.SLAM_COUNTERS if hasattr(ref, "n_slam") else ())
    same = [int((getattr(outs, c)[:2, :n].cpu() == getattr(ref, c)).sum()) for c in names]
    used = (outs.n_msckf_used[:2, :n].cpu() != ref.n_msckf_used).nonzero().tolist()
    worst = int(dq.argmax())
    print(f"[precision] {label}: max|dp| {dp.max().item():.3e} m, max|dq| {dq.max().item():.3e} at frame "
          f"{worst + 1}; max|dq| frames 1-20 {dq[:20].max().item():.3e}, 1-40 {dq[:40].max().item():.3e}; "
          f"plane and SLAM counters equal on {min(same)} of {2 * n} stream-frames; MSCKF features used differ "
          f"on (stream, frame) {[(b, f + 1) for b, f in used[:6]]} ({seconds:.1f} s)", flush=True)
    return dp.max().item(), dq.max().item()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--frames", type=int, default=60)
    ap.add_argument("--path", choices=("plane", "ms-pl"), default="plane")
    ap.add_argument("--seeds", type=int, nargs="+", default=[chip_smoke.SEED])
    ap.add_argument("--variants", nargs="+", default=None, help="labels of the variants to run (default: all)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("plane_precision: needs a CUDA card", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip().splitlines()[0])
    kernels.build()
    spec = next(p for p in chip_smoke.PATHS if p.name == args.path)
    n = args.frames
    worst = {}
    for seed in args.seeds:
        cfg, _, sim, _ = chip_smoke._setup(spec, "cuda", torch.float32, seed=seed)
        t = time.time()
        ref = chip_smoke.cpu_run(cfg, sim, n)
        print(f"[precision] seed {seed}, reference: CPU f64, streams 0-1, {n} frames ({time.time() - t:.1f} s)",
              flush=True)
        variants = [("card f32", torch.float32, None, False), ("card f64", torch.float64, None, False)]
        variants += [(f"card f32, {stage} in f64", torch.float32, stage, False) for stage in STAGES_F64
                     if stage != "SLAM stages" or cfg.state.max_slam_features > 0]
        variants += [("card f32, plain kernels", torch.float32, "plain kernels", False),
                     ("card f32, classic update compressed by QR", torch.float32, None, True), ("CPU f32",)]
        for label, *how in variants:
            if args.variants is not None and label not in args.variants:
                continue
            t = time.time()
            outs = (chip_smoke.cpu_run(cfg, sim, n, dtype=torch.float32) if label == "CPU f32"
                    else card_run(spec, cfg, sim, n, *how))
            dp, dq = report(f"seed {seed}, {label}", outs, ref, n, time.time() - t)
            w = worst.get(label, (0.0, 0.0))
            worst[label] = (max(w[0], dp), max(w[1], dq))
    if len(args.seeds) > 1:
        for label, (dp, dq) in worst.items():
            print(f"[precision] {label}, largest over seeds {args.seeds}: max|dp| {dp:.3e} m, max|dq| {dq:.3e}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
