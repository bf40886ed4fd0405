"""The span phase of a ``--trace 1`` run: once the profiled frames are
read, ``FRAMES`` more frames of every stream with the profiler off and the
program's own recorder on (``ov_plane_tpu_torch.utils.trace``), then one
synchronization and the recorder's export. The counter metrics
(``msckf_used_pct``) read that export.

The first metric that asks (:func:`of`) runs the phase on the context's
run and keeps the export in ``ctx["spans"]``. So a cell that lists such a
metric steps ``FRAMES`` frames more than one that lists none, and its output
check compares them with the others; the harness's ``run.py`` does not know
of the phase. Where the program has no recorder (no module
``ov_plane_tpu_torch.utils.trace``), or the context no run, nothing is
stepped and :func:`of` gives None; any other failure to import the
recorder fails the run.

The phase prints each span's host ms per frame on one line of stderr. Those
host times are not metrics: the phase follows the profiled frames, after
which a frame's host time can read up to half again the window's
(PERF.md §6); span host-time metrics wait for the phase to run before them.
"""

from __future__ import annotations

import sys
import time

FRAMES = 4
RECORDER = "ov_plane_tpu_torch.utils.trace"


def of(ctx: dict):
    """The span phase's export (``trace.export()`` with ``wall_s``, the
    phase's wall seconds), or None where there is nothing to record."""
    if "spans" not in ctx:
        ctx["spans"] = _phase(ctx.get("run"))
    return ctx["spans"]


def _phase(run):
    if run is None:
        return None
    import importlib

    import torch

    try:
        trace = importlib.import_module(RECORDER)
    except ModuleNotFoundError as e:
        if e.name != RECORDER:
            raise
        return None                     # a program without the recorder

    def sync():
        if torch.cuda.is_available():
            torch.cuda.synchronize()

    sync()
    trace.reset()
    trace.enable()
    try:
        t = time.time()
        for _ in range(FRAMES):
            run.step()
        sync()
        out = trace.export()
        out["wall_s"] = time.time() - t
    finally:
        trace.disable()
        trace.reset()
    names = dict.fromkeys(s["name"] for s in out["spans"])
    split = {n: round(host_ms(out, (n,)), 3) for n in names}
    print(f"benchmark: span phase after the profiled frames, {out['frames']} frames in {out['wall_s']:.3f} s; "
          f"host ms per frame {split}; counters {out['counters']}", file=sys.stderr)
    return out


def host_ms(exp: dict | None, names) -> float | None:
    """Host ms per frame inside the spans named ``names``; None without an
    export, frames or such a span."""
    if not exp or not exp["frames"]:
        return None
    ns = [s["end_ns"] - s["start_ns"] for s in exp["spans"] if s["name"] in names and s["end_ns"] is not None]
    return 1e-6 * sum(ns) / exp["frames"] if ns else None


def share_pct(exp: dict | None, part: str, whole: str) -> float | None:
    """100 · counter ``part`` / counter ``whole``; None without an export
    or where ``whole`` counted nothing."""
    if not exp:
        return None
    c = exp["counters"]
    return 100.0 * c[part] / c[whole] if c.get(whole) and part in c else None
