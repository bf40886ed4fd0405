"""Runs the reference of the output check: one process per sampled stream,
spawned (so that it starts from a fresh import and loads only the
benchmark's own modules), on the CPU, after the window has closed and the
port's state is freed. Every process is waited for before this returns."""

from __future__ import annotations

import concurrent.futures
import importlib
import multiprocessing
import os
import sys
import time

from common import FORBIDDEN, PROGRAM


def _job(module: str, args: tuple):
    """One reference run; returns (result, top-level names of the port, the
    JAX package or JAX found loaded in this process)."""
    out = importlib.import_module(f"references.{module}").run(*args)
    found = sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN + (PROGRAM,)))
    return out, found


def run_reference(module: str, jobs: list[tuple]) -> tuple[list, list, float]:
    """(results in the order of ``jobs``, forbidden modules any process
    loaded, seconds). Uses at most the host's cores, one thread each (the
    processes inherit the harness's one-thread settings)."""
    t = time.time()
    workers = max(1, min(len(jobs), os.cpu_count() or 1))
    ctx = multiprocessing.get_context("spawn")
    with concurrent.futures.ProcessPoolExecutor(max_workers=workers, mp_context=ctx) as pool:
        futs = [pool.submit(_job, module, args) for args in jobs]
        done = [f.result() for f in futs]
    found = sorted({name for _, names in done for name in names})
    return [r for r, _ in done], found, time.time() - t
