#!/usr/bin/env python3
"""Device time of two trees' Gram kernels at every launch shape, alternately, on one card.

    git archive <commit> ov_plane_tpu_torch chip_smoke.py | tar -x -C build/parent
    python3 tools/kernel_compare.py --parent build/parent [--dtype f64] [--rounds 2] [--out FILE]

Times, in turns (parent, this tree, this tree, parent, … for ``--rounds``
pairs), each kernel of both trees at every shape of ``chip_smoke.PATH_SHAPES``
in ``--dtype``, with phase 3's own means (``chip_smoke._inputs``,
``chip_smoke.device_ms``: 10 calls, L2 flushed before each), each tree in a
process of its own that builds its kernels from its own sources. This tree's
process also checks each result against the plain version (max |kernel −
plain| / max |plain|, bitwise symmetry) and times one PyTorch library call
(``torch.bmm`` for the gram, ``torch.baddbmm`` for the downdate). Prints the
card, a row per shape (both trees' times per round, the library's) and
whether this tree is faster than the parent in every round; the raw numbers
go to ``--out`` (``build/kernel_compare.json``).
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def time_tree(root: str, dtype: str, check: bool) -> dict:
    """In this process: the kernels of the tree at ``root`` at every launch shape."""
    sys.path.insert(0, root)
    import torch

    import chip_smoke
    from ov_plane_tpu_torch.ops import kernels

    kernels.build()
    dt = {"f32": torch.float32, "f64": torch.float64}[dtype]
    g = torch.Generator(device="cuda").manual_seed(chip_smoke.SEED + 1)
    out = {}
    for kname in ("gram_reduce", "kalman_downdate"):
        kern, ref_fn = getattr(kernels, kname), getattr(kernels, kname + "_ref")
        for B, M, D, _ in chip_smoke.path_shapes(kname, dt):
            args = chip_smoke._inputs(kname, B, M, D, dt, g, zero_rows=False)
            row = {"ms": chip_smoke.device_ms(lambda: kern(*args), n=10)}
            if check:
                res, vec = kern(*args)
                ref, rvec = ref_fn(*args)
                scale = max(ref.abs().max().item(), rvec.abs().max().item())
                row["err"] = max((res - ref).abs().max().item(), (vec - rvec).abs().max().item()) / scale
                row["symmetric"] = torch.equal(res, res.mT)
                if kname == "gram_reduce":
                    X, x = args
                    Xa = torch.cat([X, x[..., None]], dim=-1)
                    lib = lambda: torch.bmm(X.transpose(-1, -2), Xa)  # noqa: E731
                else:
                    P, X, x = args
                    Xa = torch.cat([X, -x[..., None]], dim=-1)
                    Pa = torch.cat([P, torch.zeros(B, D, 1, device="cuda", dtype=dt)], dim=-1)
                    lib = lambda: torch.baddbmm(Pa, X.transpose(-1, -2), Xa, alpha=-1.0)  # noqa: E731
                row["library_ms"] = chip_smoke.device_ms(lib, n=10)
            out[f"{kname} {B} {M} {D}"] = row
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", required=True, help="a directory holding the other tree's package and chip_smoke.py")
    ap.add_argument("--dtype", default="f64", choices=("f32", "f64"))
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--out", default=str(ROOT / "build" / "kernel_compare.json"))
    ap.add_argument("--worker", nargs=2, metavar=("ROOT", "CHECK"), help=argparse.SUPPRESS)
    a = ap.parse_args()
    if a.worker:
        print("JSON " + json.dumps(time_tree(a.worker[0], a.dtype, a.worker[1] == "1")))
        return 0
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip().splitlines()[0]
    print(smi)
    order = []
    for r in range(a.rounds):
        order += [("parent", a.parent), ("tree", str(ROOT))] if r % 2 == 0 else [("tree", str(ROOT)), ("parent", a.parent)]
    runs = {"parent": [], "tree": []}
    for name, root in order:
        check = name == "tree" and not runs["tree"]
        proc = subprocess.run([sys.executable, __file__, "--parent", a.parent, "--dtype", a.dtype, "--worker", root,
                               "1" if check else "0"], capture_output=True, text=True, timeout=1200)
        lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("JSON ")]
        if proc.returncode != 0 or not lines:
            print(proc.stdout[-3000:], proc.stderr[-3000:])
            raise RuntimeError(f"timing {name} ({root}) failed")
        runs[name].append(json.loads(lines[-1][5:]))
    first = runs["tree"][0]
    print(f"{'kernel, shape (B, M, D)':36s} {'parent ms':>22s} {'this tree ms':>22s} {'library ms':>11s}  err       faster")
    all_faster = True
    for key, row in first.items():
        p = [r[key]["ms"] for r in runs["parent"] if key in r]
        t = [r[key]["ms"] for r in runs["tree"]]
        faster = bool(p) and max(t) < min(p)
        all_faster &= faster
        print(f"{key:36s} {' / '.join(f'{v:.5f}' for v in p):>22s} {' / '.join(f'{v:.5f}' for v in t):>22s} "
              f"{row['library_ms']:11.5f}  {row['err']:.2e}{'' if row['symmetric'] else ' ASYMMETRIC'}  "
              f"{'yes' if faster else 'NO'}")
    out = Path(a.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps({"card": smi, "dtype": a.dtype, "order": [n for n, _ in order], **runs}, indent=1))
    print(f"this tree faster than the parent at every shape in every round: {all_faster}; {smi}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
