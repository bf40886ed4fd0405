#!/usr/bin/env python3
"""The benchmark of the port (``ov_plane_tpu_torch``) on one CUDA card.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

One process runs one cell of ``BENCHMARK.json`` once: it builds the port's
kernels, makes the cell's inputs from the seed, warms up, steps frames of
all B streams for ``--seconds`` seconds, checks what the sampled streams
produced against the benchmark's plain reference, and prints one JSON line
last. With ``--trace 0`` the line carries the cell's end-to-end metrics;
with ``--trace 1`` the same window runs, then a few frames under
``torch.profiler``, and the line carries its per-layer metrics.

Everything a cell needs is found by name: ``configs/<config>.json`` (the
program's configuration, the driver, the limits of the output check),
``traffic/<mix>.json`` (streams, sampled streams, traced frames),
``drivers/<driver>.py`` and ``references/<driver>.py``, and
``metrics/<metric>.py`` for each per-layer metric.

Exits nonzero with no result line where there is no card or fewer than the
cell asks for, and where the JAX package or JAX is found loaded in this
process once the window has closed. ``run_cell(..., control="tf32")`` runs
the port with TF32 matrix products, the precision below the configuration's
float32: the output check's control (``tests/test_bench_card.py``).
"""

import time

T0 = time.time()

import os  # noqa: E402

# One process with few threads: the host's numerical libraries stay on one
# thread each.
for _var in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS"):
    os.environ.setdefault(_var, "1")

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
for _p in (str(HERE.parent), str(HERE)):     # the checkout (the port) and the benchmark's own modules
    if _p not in sys.path:
        sys.path.insert(0, _p)


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def set_precision(tf32: bool):
    import torch

    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    torch.set_float32_matmul_precision("high" if tf32 else "highest")


def build_program(device):
    """The port's CUDA kernels, on a card: built once per checkout into its
    fixed ``build/`` directory."""
    from ov_plane_tpu_torch.ops import kernels

    if device.type == "cuda":
        kernels.build()


def forbidden_loaded() -> list[str]:
    from common import FORBIDDEN

    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def within(value: float, limit) -> bool:
    """A compared number against its limit: at most ``limit``; a non-finite
    number is never within."""
    return math.isfinite(value) and value <= limit


def run_cell(cell: dict, seed: int, seconds: float, trace: bool, device="cuda", control: str | None = None,
             t0: float = T0) -> dict:
    """One run of ``cell`` (``common.load_cell``): the result line's fields
    and the numbers the output check compared (``checks``)."""
    import torch

    from common import load_driver, load_metric
    from refrun import run_reference

    device = torch.device(device)
    on_card = device.type == "cuda"
    config, traffic = cell["config"], cell["traffic"]
    driver = load_driver(config)
    tf32 = control == "tf32"

    def sync():
        if on_card:
            torch.cuda.synchronize()

    build_program(device)
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    set_precision(tf32)
    run = driver.Run(config, traffic, seed, device)
    for _ in range(config["warm_frames"]):
        set_precision(tf32)
        run.step()
    sync()
    gc.collect()

    # The window: frames of all B streams until --seconds have passed, then
    # a synchronization. A CUDA event after each frame times the frames. A
    # traced run reports no end-to-end metric: its window ends at the
    # synchronization after the last frame, and the traced frames follow on.
    events = []
    t_start = time.time()
    setup_s = t_start - t0
    if on_card:
        events.append(torch.cuda.Event(enable_timing=True))
        events[-1].record()
    n = 0
    while True:
        set_precision(tf32)
        run.step()
        n += 1
        if on_card:
            events.append(torch.cuda.Event(enable_timing=True))
            events[-1].record()
        if time.time() - t_start >= seconds:
            break
    sync()
    wall = time.time() - t_start
    B = run.B
    metrics = {"stream_frames_per_s": {"value": B * n / wall, "unit": "stream-frames/s"},
               "setup_s": {"value": setup_s, "unit": "s"}}
    frame_ms = [a.elapsed_time(b) for a, b in zip(events, events[1:])] if on_card else []
    dev = {"platform": "gpu" if on_card else "cpu",
           "kind": torch.cuda.get_device_name(device) if on_card else "cpu",
           "count": cell["cell"]["chips"]}

    breakdown = None
    if trace:
        from torch.profiler import ProfilerActivity, profile, record_function

        import devtrace as btrace

        calls: dict = {}
        nt = traffic["trace_frames"]
        with btrace.kernel_ranges(calls):
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                t = time.time()
                for _ in range(nt):
                    set_precision(tf32)
                    with record_function("bench.frame"):
                        run.step()
                sync()
                traced_s = time.time() - t
        tr = btrace.read(prof, nt, traced_s, calls)
        del prof
        ctx = dict(trace=tr, frame_ms=frame_ms, wall_per_frame_s=wall / n, run=run, card=dev["kind"])
        metrics = {}
        for m in cell["per_layer"]:
            v = load_metric(m["name"]).read(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        dev.update(busy_s=tr.busy_s(), window_s=tr.window_s)
        breakdown = {"device_ops": tr.top_device_ops(), "idle_gaps": tr.idle_gaps()}
        del tr, ctx
    dev["memory_peak_bytes"] = int(torch.cuda.max_memory_allocated(device)) if on_card else 0

    # The output check, once the program's state is freed.
    n_ref = min(run.reference_frames(), config["compared_frames"])
    rec = run.truncate(run.recorded(), n_ref)
    module, jobs = run.reference_job(rec, n_ref)
    run.free()
    del run
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    refs, ref_loaded, ref_s = run_reference(module, jobs)
    detail: dict = {}
    checks = driver.compare(rec, refs, cell["limits"], detail)
    correct = all(within(v, lim) for _, v, lim in checks) and not ref_loaded
    out = {"correct": correct, "attempted": B * n, "failed": 0, "metrics": metrics, "device": dev}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = {name: {"value": v, "limit": lim} for name, v, lim in checks}
    out["_info"] = dict(frames=n, wall_s=wall, frame_ms=frame_ms, reference_frames=n_ref, reference_s=ref_s, reference_loaded=ref_loaded,
                        sampled_streams=len(jobs), compared=detail)
    return out


def main(argv=None) -> int:
    args = parse_args(argv)
    from common import BUILD, load_cell

    cell = load_cell(args.workload)
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(BUILD / "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(BUILD / "triton"))
    import torch

    chips = cell["cell"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"benchmark: the cell needs {chips} CUDA card(s); this machine has {n}", file=sys.stderr)
        return 2
    out = run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda")
    found = forbidden_loaded()
    if found:
        print(f"benchmark: modules of {found} are loaded in the process that reports: no result", file=sys.stderr)
        return 3
    info = out.pop("_info")
    ms = info.pop("frame_ms")
    info["frame_ms_min_max"] = [min(ms), max(ms)] if ms else None
    info.pop("compared", None)
    print(f"benchmark: {args.workload} seed {args.seed}: {info}", file=sys.stderr)
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']!r} limit <= {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
