#!/usr/bin/env python3
"""Smoke run of the PyTorch port (ov_plane_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases (any failure raises and the exit code is nonzero):

1. versions, the card's name and power limit, true-f32 matmul flags;
2. build the CUDA kernels from ``ov_plane_tpu_torch/csrc`` with nvcc;
3. (3c first) the IMU window kernel against its plain loop at the
   benchmark cells' windows (B = 512 and 1024, W = 64, f32) and one f64
   stream, and the host time per call of each (3d, after the Grams'
   timings: each one's device time, L2 flushed before each call); then
   check each Gram kernel against its plain PyTorch version on the card over a
   sweep of shapes (SWEEP: tile, chunk and range edges, empty inputs, masked
   rows, a data pointer 4 bytes off 16-byte alignment; LONE_SHAPES: one
   stream, where the f64 downdate splits more than 64 rows over a cluster),
   in f32 and f64, for
   tolerance, exact symmetry and bitwise-equal repeated calls; then time, at
   each path's shapes in the type they launch in (the classic update's gram
   is f64 on every path; the anchored, tabletop and replay runs' shapes
   too), the kernel, the earlier simple tile kernel (tools/gram_simple.cu,
   f32 only, a yardstick built here beside the package's kernels), the
   plain version and one PyTorch library call by
   device time alone (the durations of their CUDA kernels as torch.profiler
   reports them, median of 10 calls, L2 flushed before each), and the
   wrapper's host time per call;
4. drive the point path: the bench's simulator scene, 64 Monte-Carlo streams
   from a seeded generator, ``VioEngine`` + ``run_sequence`` over its first
   12 frames in f32, timed from a fresh state after a 2-step warm-up, then
   steps 4-8 again from the timed run's state after step 3 with the host
   synchronizations counted; check the launch counts, finiteness,
   stream 0's accuracy and the agreement of two streams with an f64 CPU run
   of the port (the pose within the path's limits, and the per-frame count
   of features that passed the χ² gate equal on every stream-frame; every
   CPU reference is computed in its lane's workers as it is queued, see
   ``CpuRefs``); profile 1 frame;
5. drive the plane path the same way (``plane_config``, the committed M-PL
   scene, its first 24 frames, 64 streams, f32): also the plane states and
   constraint updates, every final CP within 0.10 m of a true plane, and the
   per-frame plane counters against the f64 CPU run (24 frames);
5b. drive the MS-PL path the same way (``ms_pl_config``: SLAM landmarks and
   planes, D = 147, the M-PL scene, 26 frames): also SLAM inits and
   landmarks on every stream, landmark updates, and the per-frame SLAM and
   plane counters against the f64 CPU run (26 frames, the first SLAM inits
   at frame 20); then 4 streams of MS-PT with anchored landmarks
   (``ANCHORED_MSCKF_INVERSE_DEPTH``, planes off) step by step until
   landmarks have moved to a new anchor clone, its launch counts checked;
6. drive the vision path, the system's main path (``vision_config``, the
   bench's vision mode): render the first 36 frames of the committed vision scene
   on the card, add each stream's fixed pixel noise, quantize to the 8-bit
   lattice and stage the ring on the card; ``VioEngine.from_config`` →
   ``FusedVisionDriver(cfg, eng, 64)`` → ``init_frontend`` → ``stage_image``
   → ``step_batch`` per frame → ``flush_stream``. A 12-frame warm-up counts
   the host synchronizations in steps 3-12 (only the one packed pull), then 36
   frames from a fresh state are timed: launch counts, stream 0's accuracy,
   the host detector's plane labels reaching the step over the 64 streams,
   and streams 0–1 against the port's CPU
   run (frontend f32, filter f64; queued) over 12 frames: track ids and valid
   flags, the per-frame plane counters (equal) and the pose; a 1-frame profile by range;
6b. the fused path's plane update on the tabletop scene (``tabletop_config``,
   the JAX package's plane-firing scene): its 46 frames rendered on the card,
   16 streams through ``step_batch`` in f32: the launch counts, CP plane
   inits, planes in the state and constraint updates must appear, and the
   plane counters of stream 0 and of the first other stream with a plane in
   the state are held against the port's CPU run (filter f64) of the same
   inputs: stream 0's first plane at the same frame and its counters equal
   on at least 44 of 46 frames (the other stream printed);
8. the dataset replay (``scripts/run_euroc``, the real suite's MS-PL
   variant at one stream, D = 156) on an ASL folder that
   ``scripts/make_synth_asl`` writes from the 10 s tabletop scene (frames
   rendered on the card at 752×480, PNGs) with marker 7 drawn on the table
   in frames 30-45 (the tests' overlay): the host pipeline with GT init and
   ArUco landmarks (``use_aruco`` through ``--config``, D = 204, 46 frames,
   f64), ``--fused`` (11 frames, f64) and ``--no-gt-init --f32`` (the
   dynamic init must succeed, then 11 frames): 21 downdates and no gram per
   frame, ATE posyaw below 0.5 m, every output file written, SLAM landmarks
   and a plane in the host path's state, the marker detected exactly on the
   frames that show it, its corners in the state from the first SLAM frame
   and never marginalized (the decoder's host ms per frame printed), and
   the host path against the port's CPU run of the same folder (every
   counter equal on the first 10 frames, the ArUco ids and SLAM slots on
   every frame, the pose within REPLAY_POSE_LIMITS over the first 16);
   frames/s, host reads and kernels per frame printed;
10. the algorithm ladder (``scripts/run_sweep``): the M-PL scene built on
   the card by the port's ``build_sim`` and held to the committed one (ids
   equal, floats within 1e-9); then M-PT, MS-PT, M-PL and MS-PL over 20
   noise seeds of the whole 47-frame 6 s room scan, each as 20
   streams in f32: exact launch
   counts, CP planes and SLAM landmarks where the variant has them, every
   TUM file and the ``ov_eval`` table, streams 0-1 against the port's CPU
   f64 run (47 frames, every counter equal, the pose within (1e-2 m, 1e-3)),
   and each variant's mean RMSE and NEES within 3 combined standard errors
   of the committed JAX reference's whole-scan statistics
   (``data/sweep_jax_reference.npz``);
12. online calibration (time offset, extrinsics, intrinsics): the
   configuration of tests/test_torch_calib.py on the 20 s scene that
   ``build_sim`` makes on the card with a 15 ms camera-IMU offset, 16
   streams each from its own ``perturb_calibration(cfg, seed=1+b)`` and
   dt = 0, 60 frames in f32 with the information form: exact launch counts,
   the 16-stream mean intrinsics error below CAL_INTR_RATIO and |dt error|
   below CAL_DT_RATIO of their starts, streams 0-1 against the CPU f64 run
   (12 frames, every counter equal, the pose within (1e-2 m, 1e-3));
13. the ZUPT in its three formulations (standard, ``integrated_accel``,
   ``explicit_zero_motion``) through ``manager.step`` on 16 streams of the
   stationary and rotating IMU windows of tests/test_updaters.py (64
   samples): accept decisions, clone counts and times as the JAX package
   gives them and equal to the CPU f64 run's, exact launch counts;
14. M-PL on the scene ``build_sim`` makes on the card, 16 streams, 22
   frames, with plane RANSAC (CP planes where the CPU f64 run has them) and
   with ground-truth injection, each with its launch counts and streams 0-1
   against the CPU f64 run (12 frames);
15. ``scripts/run_mc_vision`` through its entry point (the tabletop scene,
   sparse, 8 seeds, 48 frames per arm, planes ON and OFF): both arms finite,
   per-seed ATE and the paired statistics, the launch counts, constraint
   updates and a plane in the state in the ON arm, none in the OFF arm, the
   arms' ATEs apart; the ON arm's streams 0-1 against the port's CPU run
   over all 48 frames: a rerun with the exact ``mm`` sampler on the f32
   wire held (ids and valid flags on ≥ 99 % of slot-frames, the plane
   counters on ≥ MC_PLANES_MIN_EQUAL frames, the pose within (1e-2 m,
   1e-3)), the script's own arm (u8 wire, ``mm_bf16``) printed against the
   CPU run with the filter in f64 and in f32 and, where it parts, traced
   stage by stage over its first MC_TRACE frames; frame 2's KLT on
   identical inputs on the card and the CPU under each sampler
   (``mm_bf16``: status equal, tracked points within KLT_TRACE_LIMIT px);
16. (after phase 6) the chained dispatch: the vision path with
   ``FusedVisionDriver(chain=4)`` and ``step_batch_chunk`` at B = 64 on the
   vision phase's staged frames, one warm-up chunk and 2 timed chunks: no
   host synchronization but the pull's event wait in any chunk, one pull
   per chunk, exactly 4× the per-frame launches per chunk, stream-frames/s
   at K = 1 and K = 4 and the ``last_times`` decomposition printed, streams
   0-1 against their CPU f64 chained run (queued);
17. (after phase 4) ``parallel.replay.batched_replay`` on the point path,
   B = 64, its 12 frames: poses bitwise those of phase 4's ``run_sequence``,
   the fleet RMSE equal to the host's recomputation;
18. (after phase 17) ``utils.profiling.run_sequence_profiled`` on the point
   path, 6 frames: the median ms per stage, every row's stages adding up
   to its total;
19. two spawned processes on the one card joined by gloo, each with a time
   limit: (a) the point path in f64 with ``tpu.shard_axis = "sp"`` over 16
   frames within 1e-8 m of the unsharded run, the ranks' states bitwise
   equal, the per-rank gram through the kernel; (b) the vision path
   dp-sharded at 2 ranks × 2 streams against 4 streams in one process; (c)
   ``sharded_knn`` against ``knn``;
   phases 4-21 run in three lanes at once (``LANES``: lane 0 in this
   process, the others spawned, each with its CPU references), then each
   lane's comparisons with its references;
8b. (after phase 8) ``run_euroc --bag --loop-out --viz-dir``: a bz2 bag
   written by the port's ``eval/rosbag`` from phase 8's ASL folder, 6 frames
   after the GT init in the host path's configuration against phase 8's
   host path within REPLAY_POSE_LIMITS, a loop pack (where the
   triangulations exist) and the three debug images every 2 frames, the
   launch counts;
20. (after phase 15) the KLT samplers alone at the vision step's shapes
   (B = 64, 640×480, the driver's slots of FAST corners): device and host ms
   per call of each of the five samplers, ``rowmm`` against ``slice`` on the
   card and ``rowmm_bf16`` against its CPU run (queued) within KLT_LIMITS;
21. ``scripts/run_persistent_map`` (4 s) and ``scripts/viz_replay`` (2.5 s):
   files written, arrays finite, the AR overlay drawn where a plane is in
   the state, the launch counts;
22. print the ``{"kernels": [...]}`` line, then the card and the device line last.

Needs a CUDA card: without one it exits with code 2 and prints no result.
"""

from __future__ import annotations

import bisect
import concurrent.futures
import contextlib
import ctypes
import hashlib
import json
import multiprocessing
import statistics
import subprocess
import sys
import time
import warnings
from pathlib import Path
from typing import NamedTuple

import torch

BATCH = 64
SEED = 7
ANCHOR_BATCH = 4        # streams of the anchored-landmark run
TABLETOP_BATCH = 16     # streams of the tabletop phase
# Each path's kernel shapes (B, M, D): the gram stacks 40 features × (3·12 − 3)
# rows over the D state columns (93 on the point path, 114 with 8 plane
# slots); the downdate closes the classic update with M = D rows, and on the
# plane path the grouped plane update and both delayed-init candidates with
# M = D + 1.
GRAM_M = 40 * (3 * 12 - 3)
# The vision path stacks max(max_msckf_update, max_msckf_in_update) = 40
# features too, and adds the eight merge slots' 3-row downdates per frame.
# The MS-PL path (D = 147 with 12 landmark slots) adds the SLAM update (its
# QR-compressed rows, M = D) and the eight delayed-init candidates' leftover
# rows (M = 3K − 3 = 33) to the plane path's downdates; the anchored run
# (MS-PT, the same layout) has the classic update, the SLAM update and the
# eight candidates at its own B. The tabletop phase (16 streams through the
# fused driver) compresses its classic update by QR, so it launches no gram:
# the vision path's downdates at its B. The classic update forms its Gram in
# f64 whatever the filter's type (models/msckf.py), so every gram launch of
# the f32 paths is f64. The replay (phase 8, one stream, D = 156 with 15
# landmark slots, QR compression: no gram) launches 21 downdates per frame:
# the classic and SLAM updates (M = D), the grouped plane update and both
# plane-init candidates (M = D + 1), the eight SLAM-init candidates (M = 33)
# and the eight merge slots (M = 3), in f64, and in f32 under ``--f32`` (its
# dynamic-init mode).
REPLAY_D = 156
# The ladder sweep (phase 10) runs its 20 seeds as 20 streams, in f32 with the
# information form: M-PT and M-PL at D = 114 (one landmark slot and 8 plane
# slots, as StateLayout gives a planes-off layout too), MS-PT and MS-PL at
# D = 147 (12 landmark slots). Its downdates: the classic update (M = D) on
# every variant, the grouped plane update and both init candidates (M = D + 1)
# on the plane variants, the SLAM update (M = D) and the eight SLAM-init
# candidates (M = 33) on the SLAM variants.
SWEEP_SEEDS = 20
# Slice 8 (phases 12-15), at 16 streams: the calibration run (D = 129: 15
# calibration columns on the 114 of sim_config's layout) launches the classic
# update's f64 gram and its downdate (M = D); the ZUPT (the in-step
# configuration of tests/test_updaters.py, D = 114, QR compression: no gram)
# its 6·(W − 1) = 378-row update, the classic update (M = D) and, in the
# explicit formulation, a 9-row update; the plane-RANSAC and ground-truth
# runs the M-PL path's shapes. The vision Monte-Carlo (scripts/run_mc_vision,
# 8 seeds of the sparse tabletop protocol: 4 plane slots, D = 102) launches
# the vision path's shapes at its own D on the ON arm and the classic update's
# on the OFF arm.
CAL_BATCH = 16
CAL_D = 129
MC_D = 102
F32, F64 = torch.float32, torch.float64
# Each lane of phases (LANES) computes its CPU references as it queues
# them, in WORKERS spawned processes of WORKER_THREADS threads each: with
# three lanes, three lane processes and six workers share the 8 cores.
WORKERS, WORKER_THREADS = 2, 1
# Slice 9 (phases 16-19): the chain runs the vision path's shapes; the batched
# replay and the staged profiler the point path's; the sharded point replay
# (f64) launches the gram on each rank's half of the 1320 stacked rows and
# the downdate in f64; the dp-sharded vision run the vision path's shapes at
# 2 streams per rank and, in its one-process comparison, at 4.
# Slice 10: the replay's host path runs with ArUco landmarks (use_aruco, D =
# 156 + 3 · 16 ArUco landmark slots) and launches its 21 downdates per frame
# at that D, and so does the bag replay; run_persistent_map
# (sim_config with planes, QR compression: no gram) the classic and grouped
# plane updates and both init candidates in f64 at D = 114, viz_replay (10
# SLAM slots and planes, D = 141) those and the SLAM update and its eight
# init candidates.
# (path, kernel, (B, M, D), dtype) of every launch shape.
PATH_SHAPES = [
    ("point", "gram_reduce", (BATCH, GRAM_M, 93), F64),
    ("point", "kalman_downdate", (BATCH, 93, 93), F32),
    ("plane", "gram_reduce", (BATCH, GRAM_M, 114), F64),
    *(("plane", "kalman_downdate", (BATCH, M, 114), F32) for M in (114, 115)),
    ("ms-pl", "gram_reduce", (BATCH, GRAM_M, 147), F64),
    *(("ms-pl", "kalman_downdate", (BATCH, M, 147), F32) for M in (147, 148, 33)),
    ("vision", "gram_reduce", (BATCH, GRAM_M, 114), F64),
    *(("vision", "kalman_downdate", (BATCH, M, 114), F32) for M in (114, 115, 3)),
    ("anchored", "gram_reduce", (ANCHOR_BATCH, GRAM_M, 147), F64),
    *(("anchored", "kalman_downdate", (ANCHOR_BATCH, M, 147), F32) for M in (147, 33)),
    *(("tabletop", "kalman_downdate", (TABLETOP_BATCH, M, 114), F32) for M in (114, 115, 3)),
    *(("replay", "kalman_downdate", (1, M, REPLAY_D), dt) for dt in (F32, F64)
      for M in (REPLAY_D, REPLAY_D + 1, 33, 3)),
    *(("sweep", "gram_reduce", (SWEEP_SEEDS, GRAM_M, D), F64) for D in (114, 147)),
    *(("sweep", "kalman_downdate", (SWEEP_SEEDS, M, 114), F32) for M in (114, 115)),
    *(("sweep", "kalman_downdate", (SWEEP_SEEDS, M, 147), F32) for M in (147, 148, 33)),
    ("calib", "gram_reduce", (CAL_BATCH, GRAM_M, CAL_D), F64),
    ("calib", "kalman_downdate", (CAL_BATCH, CAL_D, CAL_D), F32),
    *(("zupt", "kalman_downdate", (CAL_BATCH, M, 114), F32) for M in (378, 114, 9)),
    *((p, "gram_reduce", (CAL_BATCH, GRAM_M, 114), F64) for p in ("ransac", "gt")),
    *((p, "kalman_downdate", (CAL_BATCH, M, 114), F32) for p in ("ransac", "gt") for M in (114, 115)),
    ("mc-vision", "gram_reduce", (8, GRAM_M, MC_D), F64),
    *(("mc-vision", "kalman_downdate", (8, M, MC_D), F32) for M in (MC_D, MC_D + 1, 3)),
    ("chain", "gram_reduce", (BATCH, GRAM_M, 114), F64),
    *(("chain", "kalman_downdate", (BATCH, M, 114), F32) for M in (114, 115, 3)),
    ("batched-replay", "gram_reduce", (BATCH, GRAM_M, 93), F64),
    ("batched-replay", "kalman_downdate", (BATCH, 93, 93), F32),
    ("profiled", "gram_reduce", (BATCH, GRAM_M, 93), F64),
    ("profiled", "kalman_downdate", (BATCH, 93, 93), F32),
    *(("replay", "kalman_downdate", (1, M, REPLAY_D + 48), F64) for M in (REPLAY_D + 48, REPLAY_D + 49, 33, 3)),
    *(("bag", "kalman_downdate", (1, M, REPLAY_D + 48), F64) for M in (REPLAY_D + 48, REPLAY_D + 49, 33, 3)),
    *(("persistent-map", "kalman_downdate", (1, M, 114), F64) for M in (114, 115)),
    *(("viz", "kalman_downdate", (1, M, 141), F64) for M in (141, 142, 33)),
    ("sharded", "gram_reduce", (BATCH, GRAM_M // 2, 93), F64),
    ("sharded", "kalman_downdate", (BATCH, 93, 93), F64),
    *(("sharded-dp", "gram_reduce", (b, GRAM_M, 114), F64) for b in (2, 4)),
    *(("sharded-dp", "kalman_downdate", (b, M, 114), F32) for b in (2, 4) for M in (114, 115, 3)),
]
PATH_NAMES = tuple(dict.fromkeys(p for p, *_ in PATH_SHAPES))


def path_shapes(kname: str, dtype=None, path: str | None = None):
    """(B, M, D, dtype) of every launch shape of ``kname`` (on ``path``, in ``dtype``), sorted."""
    return sorted({(*sh, dt) for p, k, sh, dt in PATH_SHAPES
                   if k == kname and dtype in (None, dt) and path in (None, p)},
                  key=lambda s: (s[3] == F64, s[:3]))


# The shape whose numbers lead each kernel's entry of the {"kernels": ...}
# line: the gram's on the vision path (f64), and the downdate's largest
# there (M = D + 1, three of the vision path's twelve launches per frame and
# most of their time).
LEAD = {"gram_reduce": (BATCH, GRAM_M, 114, torch.float64), "kalman_downdate": (BATCH, 115, 114, torch.float32)}
# f32 kernel vs plain: max|kernel − plain| ≤ TOL·max|plain| (the row sums run
# in another order); f64 the same at 1e-12.
TOL = {torch.float32: 1e-5, torch.float64: 1e-12}
# Published dense peaks (NVIDIA H100 data sheets): memory bytes/s and FLOP/s
# by type. f32 outside the tensor cores (TF32 is off); f64 on the tensor
# cores (DMMA), which run full f64 and which cuBLAS uses for the library
# rows' f64 products: twice the rate outside them.
PEAKS = {"SXM": (3.35e12, {F32: 67e12, F64: 67e12}),
         "PCIe": (2.0e12, {F32: 51e12, F64: 51e12}),
         "NVL": (3.9e12, {F32: 60e12, F64: 60e12})}


def card_peaks(name: str):
    """(memory bytes/s, {dtype: FLOP/s}) of the card ``name``."""
    for key in ("PCIe", "NVL"):
        if key in name:
            return PEAKS[key]
    return PEAKS["SXM"]


EARLIER_SRC = Path(__file__).resolve().parent / "tools" / "gram_simple.cu"
FLUSH_BYTES = 256 << 20  # written before each timed call: five times the 50 MB L2
TIME_CALLS = 10         # timed calls of each kernel, plain version and library call per shape
# The correctness sweep: every D (tile edges 31/32/63/95/96, the filters' 93,
# 114 and 147, the calibrated 195, the largest 300) with every M (empty, one
# chunk or less, chunk and row-range edges, the filters' 33, 93, 114, 115,
# 147, 148 and 1320, a long 4096), B cycling over 1, 5, 64. Even entries take
# H at storage offset 1 (4 bytes off 16-byte alignment in f32), and every
# entry has a band of zero (masked) rows.
SWEEP_D = (1, 31, 32, 63, 93, 95, 96, 114, 147, 195, 300)
SWEEP_M = (0, 1, 3, 33, 93, 94, 114, 115, 147, 148, 300, 792, 1320, 4096)
SWEEP_B = (1, 5, 64)
SWEEP = [(SWEEP_B[(i + j) % 3], M, D) for i, D in enumerate(SWEEP_D) for j, M in enumerate(SWEEP_M)]
# One stream at the replays' and scripts' D (in f64 the rows of a stream of
# more than 64 are split over a cluster): M = D, D + 1, 33 and 3, and a
# stream whose last row slice is short.
LONE_SHAPES = [(1, M, D) for D in (141, 156, 204) for M in (D, D + 1, 33, 3)] + [(1, 999, 141)]


def _is_flush(name: str) -> bool:
    """The flush's own kernels: the uint8 rewrite and read (and a memset the read may launch)."""
    return "bitwise_not" in name or "unsigned char" in name or name.startswith("Memset")


def device_ms(fn, n: int = 15, warmup: int = 3, attempts: int = 3, parts: dict | None = None,
              raw: bool = False) -> float:
    """Median device time of one call of ``fn``: the summed durations of the
    CUDA kernels it launches, as torch.profiler reports them. Before each call
    two kernels rewrite and then read FLUSH_BYTES of uint8, so every call finds
    the L2 cold and clean (no write-back of the flush's own lines is left to
    it); they are left out of the sum, and so is the host's time between
    launches. A profile that lost a kernel (the count is checked) is taken
    again. ``parts``, if given, receives each kernel's median ms by name.
    ``raw`` reads the profiler's raw events (``_raw_events``), for a call of
    tens of thousands of kernels."""
    from torch.profiler import ProfilerActivity, profile

    buf = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device="cuda")

    def flush():
        buf.bitwise_not_()
        buf.amax()

    for _ in range(warmup):
        flush()
        fn()
    torch.cuda.synchronize()
    for _ in range(attempts):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            torch.cuda.synchronize()
            for _ in range(n):
                flush()
                fn()
            torch.cuda.synchronize()
        if raw:  # (name, start µs, duration µs)
            events = sorted(((name, t0 / 1e3, dur / 1e3) for name, dev, t0, dur in _raw_events(prof) if dev),
                            key=lambda e: e[1])
        else:
            events = sorted(((e.name, e.time_range.start, e.time_range.end - e.time_range.start)
                             for e in prof.events() if e.device_type.name == "CUDA"), key=lambda e: e[1])
        calls, in_flush, by_name = [], True, {}
        for name, _, dur in events:
            if _is_flush(name):
                in_flush = True
                continue
            if in_flush:
                calls.append(0.0)
                in_flush = False
            calls[-1] += dur
            by_name.setdefault(name, []).append(dur)
        if len(calls) == n and all(c > 0 for c in calls):
            if parts is not None:
                parts.update({k: statistics.median(v) / 1e3 for k, v in by_name.items()})
            return statistics.median(calls) / 1e3
        print(f"[time] the profile holds {len(calls)} of {n} timed calls; profiling again")
    raise RuntimeError(f"the profiler did not record the {n} timed calls in {attempts} attempts")


def host_us(fn, n: int = 200) -> float:
    """Median host time of one call of ``fn`` (its launch, not its device work)."""
    fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(n):
        t = time.perf_counter()
        fn()
        ts.append(time.perf_counter() - t)
    torch.cuda.synchronize()
    return statistics.median(ts) * 1e6


def start_earlier_build(kernels):
    """Start nvcc on the earlier simple tile kernel (EARLIER_SRC), the timing
    yardstick, with the package's flags; returns a function that waits for
    it and returns its launcher ``earlier(X, x, base=None)`` for f32 CUDA
    tensors: (Gram, vec) without a base, (base − Gram, vec) with one."""
    src = EARLIER_SRC.read_bytes()
    out = kernels.BUILD_DIR / f"libovp_gram_simple_{hashlib.sha256(src).hexdigest()[:16]}.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(".tmp")
    proc = None if out.exists() else subprocess.Popen(
        [kernels._nvcc(), *kernels.NVCC_FLAGS, "-o", str(tmp), str(EARLIER_SRC)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)

    def wait():
        if proc is not None:
            report = proc.communicate()[0]
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed for {EARLIER_SRC.name}:\n{report}")
            tmp.replace(out)
        fn = ctypes.CDLL(str(out)).ovp_gram_simple_f32
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int

        def earlier(X, x, base=None):
            B, M, D = X.shape
            res = torch.empty(B, D, D, device=X.device)
            vec = torch.empty(B, D, device=X.device)
            err = fn(X.data_ptr(), x.data_ptr(), None if base is None else base.data_ptr(), res.data_ptr(),
                     vec.data_ptr(), B, M, D, torch.cuda.current_stream().cuda_stream)
            if err != 0:
                raise RuntimeError(f"gram_simple kernel launch failed with cudaError_t {err}")
            return res, vec
        return earlier
    return wait


def _inputs(kname, B, M, D, dtype, g, offset=False, zero_rows=True):
    dev = "cuda"
    n = B * M * D
    X = torch.randn(n + 1, generator=g, device=dev, dtype=dtype)[1:] if offset else \
        torch.randn(n, generator=g, device=dev, dtype=dtype)
    X = X.view(B, M, D)
    x = torch.randn(B, M, generator=g, device=dev, dtype=dtype)
    if zero_rows and M >= 3:
        X[:, M // 3:M // 2] = 0.0
        x[:, M // 3:M // 2] = 0.0
    if kname == "gram_reduce":
        return (X, x)
    A = torch.randn(B, D, D, generator=g, device=dev, dtype=dtype)
    P = A @ A.transpose(-1, -2) / D + torch.eye(D, device=dev, dtype=dtype)
    return (P, X, x)


def check_kernels(kernels):
    """Phase 3a: each kernel against its plain version over the path shapes
    and the sweep, f32 and f64: tolerance, bitwise symmetry, two calls
    bitwise equal. Returns the max |kernel − plain| at each path shape in
    its type, by (kernel, (B, M, D, dtype))."""
    g = torch.Generator(device="cuda").manual_seed(SEED)
    errs, failures = {}, []
    for kname in ("gram_reduce", "kalman_downdate"):
        kern, ref_fn = getattr(kernels, kname), getattr(kernels, kname + "_ref")
        for dtype in (torch.float32, torch.float64):
            worst = 0.0
            on_path = [sh[:3] for sh in path_shapes(kname, dtype)]
            shapes = [(sh, False) for sh in on_path] + [(s, i % 2 == 0) for i, s in enumerate(LONE_SHAPES + SWEEP)]
            for (B, M, D), offset in shapes:
                args = _inputs(kname, B, M, D, dtype, g, offset=offset)
                try:
                    out, vec = kern(*args)
                    out2, vec2 = kern(*args)
                    ref, ref_vec = ref_fn(*args)
                    torch.cuda.synchronize()
                except Exception:
                    print(f"[check] {kname} {str(dtype)[6:]} B={B} M={M} D={D} offset={offset} raised")
                    raise
                err = max((out - ref).abs().max().item(), (vec - ref_vec).abs().max().item() if vec.numel() else 0.0)
                scale = max(ref.abs().max().item(), ref_vec.abs().max().item() if vec.numel() else 0.0)
                ok = (err <= TOL[dtype] * scale and torch.equal(out, out.transpose(-1, -2))
                      and torch.equal(out, out2) and torch.equal(vec, vec2) and bool(torch.isfinite(out).all()))
                worst = max(worst, err / scale if scale > 0 else err)
                if (B, M, D) in on_path and not offset:
                    errs.setdefault((kname, (B, M, D, dtype)), err)
                if not ok:
                    failures.append(f"{kname} {str(dtype)[6:]} B={B} M={M} D={D} offset={offset}: err {err:.3e} "
                                    f"limit {TOL[dtype] * scale:.3e} symmetric {torch.equal(out, out.mT)} "
                                    f"repeatable {torch.equal(out, out2) and torch.equal(vec, vec2)}")
                    print(f"[check] FAIL {failures[-1]}")
            print(f"[check] {kname} {str(dtype)[6:]}: {len(shapes)} shapes, worst max_abs_err/max|plain| "
                  f"{worst:.3e} (limit {TOL[dtype]:.0e}); bitwise symmetric and repeatable")
    if failures:
        raise RuntimeError(f"{len(failures)} kernel checks failed: {failures[:5]}")
    return errs


def time_kernels(kernels, errs, earlier_kernel):
    """Phase 3b: device time (torch.profiler, cold L2) of each kernel, of the
    plain version and of one library call at each path shape in its type,
    and of the earlier simple tile kernel (f32 only; checked against the
    plain version first); the wrapper's host time; the bound. Returns the
    rows by (kernel, (B, M, D, dtype))."""
    g = torch.Generator(device="cuda").manual_seed(SEED + 1)
    mem_bps, flops_by_type = card_peaks(torch.cuda.get_device_name(0))
    rows = {}
    todo = [(k, sh) for k in ("gram_reduce", "kalman_downdate") for sh in path_shapes(k)]
    for kname, (B, M, D, dtype) in todo:
        kern, ref_fn = getattr(kernels, kname), getattr(kernels, kname + "_ref")
        args = _inputs(kname, B, M, D, dtype, g, zero_rows=False)
        size = torch.finfo(dtype).bits // 8
        if kname == "gram_reduce":
            X, x = args
            Xa = torch.cat([X, x[..., None]], dim=-1)
            lib = lambda: torch.bmm(X.transpose(-1, -2), Xa)  # [HᵀH | Hᵀr]  # noqa: E731
            earlier = lambda: earlier_kernel(X, x)  # noqa: E731
            bytes_ = size * (B * M * D + B * M + B * D * D + B * D)
        else:
            P, X, x = args
            Xa = torch.cat([X, -x[..., None]], dim=-1)
            Pa = torch.cat([P, torch.zeros(B, D, 1, device="cuda", dtype=dtype)], dim=-1)
            lib = lambda: torch.baddbmm(Pa, X.transpose(-1, -2), Xa, alpha=-1.0)  # [P−WᵀW | −Wᵀu]  # noqa: E731
            earlier = lambda: earlier_kernel(X, x, P)  # noqa: E731
            bytes_ = size * (2 * B * D * D + B * M * D + B * M + B * D)
        flops = 2 * B * M * (D * (D + 1) // 2 + D)  # upper triangle + the folded column
        t_bytes, t_ops = bytes_ / mem_bps * 1e3, flops / flops_by_type[dtype] * 1e3
        bound = max(t_bytes, t_ops)
        e_ms = None
        if dtype == torch.float32:
            e_out, ref_out = earlier(), ref_fn(*args)
            e_err = max((a - b).abs().max().item() for a, b in zip(e_out, ref_out))
            if not e_err <= TOL[torch.float32] * max(b.abs().max().item() for b in ref_out):
                raise RuntimeError(f"the earlier {kname} kernel disagrees with the plain version: {e_err:.3e}")
            e_ms = device_ms(earlier, n=TIME_CALLS)
        calls_before = kern.launches
        k_parts = {}
        k_ms = device_ms(lambda: kern(*args), n=TIME_CALLS, parts=k_parts)
        k_host = host_us(lambda: kern(*args), n=100)
        kern.launches = calls_before
        p_ms, l_ms = device_ms(lambda: ref_fn(*args), n=TIME_CALLS), device_ms(lib, n=TIME_CALLS)
        tname = str(dtype)[6:]
        rows[(kname, (B, M, D, dtype))] = dict(
            dtype=tname, max_abs_err=errs[(kname, (B, M, D, dtype))], ms=k_ms, device_ms=k_ms,
            earlier_device_ms=e_ms, plain_ms=p_ms, library_ms=l_ms, bound_ms=bound,
            bound_by="bytes" if t_bytes >= t_ops else "operations", pct_of_bound=100.0 * bound / k_ms,
            host_us_per_call=k_host, bytes=bytes_, flops=flops)
        earlier_s = f"earlier kernel {e_ms:.5f} ms, " if e_ms is not None else ""
        print(f"[time] {kname} {tname} B={B} M={M} D={D}, device time, cold L2: kernel {k_ms:.5f} ms "
              f"({100 * bound / k_ms:.1f}% of bound), {earlier_s}plain {p_ms:.5f} ms, "
              f"library {l_ms:.5f} ms, bound {bound:.5f} ms ({'bytes' if t_bytes >= t_ops else 'operations'}; "
              f"{bytes_ / 1e6:.3f} MB, {flops / 1e9:.4f} GFLOP)")
        print(f"[time] {kname} its kernels: " + ", ".join(f"{k.split('<')[0].split()[-1]} {v:.5f} ms"
                                                        for k, v in k_parts.items()))
        print(f"[time] {kname} wrapper host time {k_host:.2f} us per call")
    return rows


# The IMU window kernel (phase 3c): the benchmark cells' windows in f32 and
# one stream in f64 (the replays), (B, W, dtype), each against the plain loop.
IMU_SHAPES = [(512, 64, F32), (1024, 64, F32), (1, 64, F64)]
IMU_PAIR_FLOP = 7000    # per valid sample pair and stream, F's and G's zero blocks skipped (csrc/imu_propagate.cu)
IMU_PLAIN_CALLS = 3     # timed calls of the plain loop (some 40 thousand kernels each)


def _imu_inputs(B, W, dtype, g):
    """A filter's window at 400 Hz for B streams (the arguments of
    ``propagate_mean_cov`` but the options): t0 and t1 inside the first and
    the last sample pair, the later half of the streams padded with +inf
    times past two thirds of the window."""
    kw = dict(dtype=torch.float64, device="cuda")
    q = torch.randn(B, 4, generator=g, **kw)
    q[:, 3] = q[:, 3].abs() + 1.0
    q = q / q.norm(dim=1, keepdim=True)
    imu = torch.cat([q, torch.randn(B, 6, generator=g, **kw), 1e-2 * torch.randn(B, 3, generator=g, **kw),
                     0.1 * torch.randn(B, 3, generator=g, **kw)], dim=1)
    fej = imu + 1e-3 * torch.randn(B, 16, generator=g, **kw)
    fej[:, :4] = fej[:, :4] / fej[:, :4].norm(dim=1, keepdim=True)
    t = 10.0 + torch.rand(B, 1, generator=g, **kw) + 0.0025 * torch.arange(W, **kw)
    t0, t1 = t[:, 0] + 0.00075, t[:, -1] - 0.001
    t[B // 2:, W - W // 3:] = float("inf")
    w = 0.3 * torch.randn(B, W, 3, generator=g, **kw)
    a = torch.tensor([0.0, 0.0, 9.81], **kw) + torch.randn(B, W, 3, generator=g, **kw)
    noises = torch.tensor([1.6968e-4, 2.0e-3, 1.9393e-5, 3.0e-3], **kw) ** 2
    return [x.to(dtype) for x in (imu, fej, t, w, a, t0, t1, noises, torch.tensor([0.0, 0.0, 9.81], **kw))]


def check_imu_kernel(kernels):
    """Phase 3c, before any profile (the profiler's hooks stay on every later
    launch): the IMU window kernel against the plain loop at IMU_SHAPES, in
    the benchmark's options (RK4, FEJ): f64 within TOL, f32 no further from
    the f64 loop than 4 times the f32 loop (at least 1e-7), two calls
    bitwise equal, one launch a call; the host time per call of each and
    the bound. Returns the rows and the calls to time by (B, W, dtype)."""
    from ov_plane_tpu_torch.state import propagator as prop

    g = torch.Generator(device="cuda").manual_seed(SEED + 2)
    mem_bps, flops_by_type = card_peaks(torch.cuda.get_device_name(0))
    opts = prop.PropagatorOptions()
    rows, runs = {}, {}
    for B, W, dtype in IMU_SHAPES:
        x64 = _imu_inputs(B, W, torch.float64, g)
        x = [v.to(dtype) for v in x64]
        kern = lambda x=x: prop.propagate_mean_cov(*x, opts)  # noqa: E731
        plain = lambda x=x: prop.propagate_mean_cov_ref(*x, opts)  # noqa: E731
        before = kernels.imu_propagate.launches
        got, again = kern(), kern()
        calls = kernels.imu_propagate.launches - before
        ref, mine = prop.propagate_mean_cov_ref(*x64, opts), plain()
        torch.cuda.synchronize()
        errs = {}
        for name, k, k2, r, p in zip(("imu", "imu_fej", "phi", "qd", "last_w"), got, again, ref, mine):
            err = (k.double() - r).abs().max().item()
            limit = TOL[F64] * r.abs().max().item() if dtype == F64 else \
                max(4 * (p.double() - r).abs().max().item(), 1e-7)
            errs[name] = err
            if not (err <= limit and torch.equal(k, k2) and calls == 2):
                raise RuntimeError(f"imu_propagate B={B} W={W} {str(dtype)[6:]} {name}: err {err:.3e} limit "
                                   f"{limit:.3e}, repeatable {torch.equal(k, k2)}, launches {calls} for 2 calls")
        ta, tb = (torch.minimum(torch.maximum(v, x64[5][:, None]), x64[6][:, None]) for v in (x64[2][:, :-1],
                                                                                             x64[2][:, 1:]))
        pairs = int(((tb - ta > 0) & torch.isfinite(tb - ta)).sum())
        size = torch.finfo(dtype).bits // 8
        bytes_ = size * (B * (16 + 16 + 7 * W + 2) + 7 + B * (16 + 16 + 225 + 225 + 3))
        flops = IMU_PAIR_FLOP * pairs
        t_bytes, t_ops = bytes_ / mem_bps * 1e3, flops / flops_by_type[dtype] * 1e3
        k_host = host_us(kern, n=100)
        p_host = host_us(plain, n=IMU_PLAIN_CALLS) / 1e3
        kernels.imu_propagate.launches = before
        runs[(B, W, dtype)] = (kern, plain)
        rows[(B, W, dtype)] = dict(dtype=str(dtype)[6:], max_abs_err=errs, valid_pairs=pairs, bytes=bytes_,
                                   flops=flops, bound_ms=max(t_bytes, t_ops),
                                   bound_by="bytes" if t_bytes >= t_ops else "operations",
                                   host_us_per_call=k_host, plain_host_ms=p_host)
        print(f"[imu] B={B} W={W} {str(dtype)[6:]}: max err against the f64 loop " +
              ", ".join(f"{k} {v:.3e}" for k, v in errs.items()) + f"; {pairs} valid pairs; host per call: "
              f"kernel {k_host:.2f} us, plain loop {p_host:.2f} ms")
    return rows, runs


def time_imu_kernel(rows, runs):
    """Phase 3d, after the Gram kernels' timings (so their profiles run as
    before): the device time (cold L2) of the IMU window kernel and of the
    plain loop at each of ``check_imu_kernel``'s shapes; adds them to its rows."""
    for key, (kern, plain) in runs.items():
        row = rows[key]
        k_ms = device_ms(kern, n=TIME_CALLS)
        p_ms = device_ms(plain, n=IMU_PLAIN_CALLS, raw=True)
        row.update(ms=k_ms, device_ms=k_ms, plain_ms=p_ms, pct_of_bound=100.0 * row["bound_ms"] / k_ms)
        print(f"[imu] B={key[0]} W={key[1]} {row['dtype']}, device time, cold L2: kernel {k_ms:.5f} ms "
              f"({row['pct_of_bound']:.2f}% of bound), plain loop {p_ms:.5f} ms, bound {row['bound_ms']:.5f} ms "
              f"({row['bound_by']}; {row['bytes'] / 1e6:.3f} MB, {row['flops'] / 1e9:.4f} GFLOP)")
    return rows


class PathSpec(NamedTuple):
    """One path of the filter that the script drives at full width."""
    name: str
    config: str             # function of ov_plane_tpu_torch.utils.config
    scene: str              # attribute of ov_plane_tpu_torch.sim.simulator holding the scene's path
    per_frame: dict         # kernel launches per stepped frame
    sync_start: int         # first of the SYNC_STEPS steps checked for host synchronizations (then profiled from)
    ref_frames: int         # frames of the f64 CPU reference
    n_frames: int | None = None  # stepped frames (None: the whole scene)
    pose_limits: tuple = (1e-2, 1e-3)   # card f32 vs CPU f64: max |Δp| in m, max |Δq|


# The earlier paths are cut in depth to pay for the later phases within the
# time limit (PERF.md §4 lists each cut): the ladder sweep of phase 10 runs
# the point and plane filters again, at 20 streams, with their own CPU check.
PATHS = (
    # Phase 4: the point path on the bench scene (slice 1), cut to its first
    # 12 frames (its CPU check 12).
    PathSpec("point", "slice_config", "SCENE_PATH", {"gram_reduce": 1, "kalman_downdate": 1}, 4, 12, 12),
    # Phase 5: the plane path on the M-PL scene (slice 3), cut to its first
    # 24 frames (CPU check 24): the downdate closes the classic update, the
    # grouped plane update and both delayed-init candidates; the first plane
    # state appears at frame 20. Its sync check covers steps 4-8: the MS-PL
    # path's (below) covers every plane stage with planes in the state.
    PathSpec("plane", "plane_config", "PLANE_SCENE_PATH", {"gram_reduce": 1, "kalman_downdate": 4}, 4, 24, 24),
    # Phase 5b: MS-PL on the same scene (slice 5): the plane path's downdates,
    # the SLAM update and the eight delayed-init candidates; the first SLAM
    # inits come at frame 20, so its first 26 frames hold 6 frames of
    # landmarks, the sync check covers steps 21-25 and the CPU check frames
    # 1-26. It holds
    # the pose limits of every path: with the classic update's Gram formed
    # and factored in f64, the card's f32 run read at most |Δp| 1.842e-4 m and
    # |Δq| 1.670e-5 over the noise draws of seeds 7-12 (8.178e-3 before;
    # PERF.md §6).
    PathSpec("ms-pl", "ms_pl_config", "PLANE_SCENE_PATH", {"gram_reduce": 1, "kalman_downdate": 13}, 21, 26, 26),
)
PATH_WARM = 2           # untimed warm-up steps of each path before its timed run
SYNC_STEPS = 5          # steps of each path replayed with host synchronizations counted
PLANE_COUNTERS = ("n_planes", "n_plane_init", "n_plane_constraints", "n_plane_merges", "n_plane_dropped")
SLAM_COUNTERS = ("n_slam", "n_slam_init", "n_slam_update")


def _setup(spec: PathSpec, device, dtype, seed: int = SEED):
    from ov_plane_tpu_torch.models.manager import VioEngine
    from ov_plane_tpu_torch.sim import simulator
    from ov_plane_tpu_torch.utils import config

    cfg = getattr(config, spec.config)()
    truth = simulator.load_scene(getattr(simulator, spec.scene), dtype=dtype, device=device)
    sim = simulator.apply_noise(truth, simulator.noise_params(cfg), BATCH,
                                torch.Generator(device=device).manual_seed(seed))
    return cfg, truth, sim, VioEngine.from_config(cfg, device=device)


def _fresh(eng, cfg, s, b, device, dt):
    from ov_plane_tpu_torch.models.feature_bank import FeatureBank
    from ov_plane_tpu_torch.models.manager import init_state_with_gt

    st = init_state_with_gt(eng, cfg, t0=s.cam_t_imu[0].expand(b), q0=s.gt_q[0].expand(b, 4),
                            p0=s.gt_p[0].expand(b, 3), v0=s.gt_v[0].expand(b, 3),
                            bg0=s.gt_bg_cam[:b, 0], ba0=s.gt_ba_cam[:b, 0], dtype=dt, device=device)
    return st, FeatureBank.create(cfg.tpu.max_features, eng.layout.max_clones, b, dt, device)


def cpu_run(cfg, sim, n_frames: int, dtype=torch.float64):
    """The first two streams of the card's noisy scene ``sim`` through the
    port on the CPU (plain kernel versions) in ``dtype``; returns the outputs."""
    from ov_plane_tpu_torch.models.manager import VioEngine, run_sequence

    noisy = ("imu_w", "imu_a", "obs_uv", "gt_bg", "gt_ba", "gt_bg_cam", "gt_ba_cam")
    sim_cpu = sim._replace(**{k: v[:2].to(dtype).cpu() for k, v in sim._asdict().items() if k in noisy},
                           **{k: v.to(dtype).cpu() if v.is_floating_point() else v.cpu()
                              for k, v in sim._asdict().items()
                              if isinstance(v, torch.Tensor) and k not in noisy})
    eng = VioEngine.from_config(cfg, device="cpu")
    st, bk = _fresh(eng, cfg, sim_cpu, 2, "cpu", dtype)
    return run_sequence(eng, st, bk, sim_cpu, imu_window=cfg.tpu.max_imu_per_frame, n_frames=n_frames)[2]


def _cpu_reference(cfg, arrays: dict, n_frames: int) -> dict:
    """``cpu_run`` in a process of its own (a ``CpuRefs`` worker): ``arrays``
    holds the noisy scene's fields as numpy arrays; returns the outputs as
    numpy arrays."""
    return {k: v.numpy() for k, v in cpu_run(cfg, _from_host(arrays), n_frames)._asdict().items()}


def drive_path(spec: PathSpec, refs: CpuRefs):
    """Phases 4 and 5: one path of the port at full width, B streams in f32
    over the scene; returns (n_frames, launches, info). Its CPU f64
    reference is queued on ``refs``; ``info["finish"]()`` holds the card to
    it."""
    from ov_plane_tpu_torch import convert  # noqa: F401  (package import check)
    from ov_plane_tpu_torch.eval.metrics import rmse_nees
    from ov_plane_tpu_torch.models.manager import run_sequence
    from ov_plane_tpu_torch.ops import kernels

    tag = f"[{spec.name}]"
    dev, dtype = "cuda", torch.float32
    t = time.time()
    cfg, truth, sim, eng = _setup(spec, dev, dtype)
    total = sim.cam_t.shape[0] - 1
    n_frames = total if spec.n_frames is None else min(spec.n_frames, total)
    window = cfg.tpu.max_imu_per_frame
    print(f"{tag} scene {total + 1} frames, {sim.imu_t.shape[0]} IMU samples, {truth.obs_id.shape[1]} observation "
          f"slots; D={eng.layout.dim}; B={BATCH}; {n_frames} frames stepped; set-up {time.time() - t:.2f} s")

    # The CPU f64 reference of two streams is queued.
    n_ref = min(spec.ref_frames, n_frames)
    job = refs.submit(spec.name, _cpu_reference, cfg, _to_host(sim, 2), n_ref)

    # Warm-up (library handles, the allocator at this path's shapes): PATH_WARM
    # untimed steps from a fresh state. Then the timed run from a fresh
    # state, its state after step s0 - 1 kept; then, untimed, SYNC_STEPS steps from
    # that state with host synchronizations counted (warnings from
    # torch.cuda.set_sync_debug_mode), the state after them kept for the
    # profile.
    s0, s1 = spec.sync_start, spec.sync_start + SYNC_STEPS
    state, bank = _fresh(eng, cfg, sim, BATCH, dev, dtype)
    run_sequence(eng, state, bank, sim, imu_window=window, n_frames=PATH_WARM)
    state, bank = _fresh(eng, cfg, sim, BATCH, dev, dtype)
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t = time.time()
    state, bank, outs_a = run_sequence(eng, state, bank, sim, imu_window=window, n_frames=s0 - 1)
    at_s0 = (state, bank)
    state, bank, outs_b = run_sequence(eng, state, bank, sim, imu_window=window, n_frames=n_frames - s0 + 1,
                                       start=s0)
    torch.cuda.synchronize()
    wall = time.time() - t
    outs = type(outs_a)(*(torch.cat(ab, dim=1) for ab in zip(outs_a, outs_b)))
    launches = {"gram_reduce": kernels.gram_reduce.launches, "kalman_downdate": kernels.kalman_downdate.launches}
    print(f"{tag} {BATCH}x{n_frames} stream-frames in {wall:.3f} s: "
          f"{BATCH * n_frames / wall:.1f} stream-frames/s ({n_frames / wall:.2f} frames/s per stream)")
    print(f"{tag} launches: {launches}")
    for k, n in launches.items():
        if n != spec.per_frame[k] * n_frames:
            raise RuntimeError(f"{k} launched {n} times over {n_frames} frames, not {spec.per_frame[k]} per frame")
    t = time.time()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            snapshot = run_sequence(eng, *at_s0, sim, imu_window=window, n_frames=9, start=s0)[:2]
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    syncs = sorted({str(w.message).splitlines()[0] for w in caught
                    if "synchronizing CUDA operation" in str(w.message)})
    print(f"{tag} host synchronizations inside steps {s0}-{s1 - 1}: {len(syncs)} {syncs[:5]} "
          f"(check {time.time() - t:.1f} s)")
    if syncs:
        raise RuntimeError("the step synchronizes with the host")

    for name, v in outs._asdict().items():
        if v.is_floating_point() and not torch.isfinite(v).all():
            raise RuntimeError(f"non-finite output {name}")
    if not (torch.isfinite(state.cov).all() and torch.isfinite(state.imu).all()):
        raise RuntimeError("non-finite final state")
    m = rmse_nees(outs.q.double(), outs.p.double(), outs.cov_diag_imu[..., 0:3].double(),
                  outs.cov_diag_imu[..., 3:6].double(), sim.gt_q[1:n_frames + 1].double(),
                  sim.gt_p[1:n_frames + 1].double())
    rmse0 = m["rmse_pos"][0].item()
    print(f"{tag} stream 0: rmse_pos={rmse0:.4f} m rmse_ori={m['rmse_ori_deg'][0].item():.4f} deg; "
          f"mean over {BATCH} streams: rmse_pos={m['rmse_pos'].mean().item():.4f} m "
          f"rmse_ori={m['rmse_ori_deg'].mean().item():.4f} deg "
          f"nees_ori={m['nees_ori'].mean().item():.3f} nees_pos={m['nees_pos'].mean().item():.3f}; "
          f"msckf features used per frame (mean) {outs.n_msckf_used.float().mean().item():.2f}")
    if not rmse0 < 0.5:
        raise RuntimeError(f"stream 0 position RMSE {rmse0:.3f} m is not below 0.5 m")
    info = dict(stream_frames_per_s=BATCH * n_frames / wall, wall_s=wall, n_frames=n_frames,
                eng=eng, cfg=cfg, sim=sim, snapshot=snapshot, outs=outs)
    if eng.use_planes:
        info.update(check_planes(tag, state, outs, truth))
    if eng.use_slam:
        check_slam(tag, state, outs)

    def finish():
        """Two of the streams through the port on the CPU in f64 (plain kernel
        versions, in the worker), against the card's f32 run."""
        from ov_plane_tpu_torch.models.manager import StepOutput

        ref = StepOutput(**{k: torch.from_numpy(v) for k, v in job.result().items()})
        dp = (outs.p[:2, :n_ref].double().cpu() - ref.p).abs().max().item()
        dq = (outs.q[:2, :n_ref].double().cpu() - ref.q).abs().max().item()
        print(f"{tag} card f32 vs CPU f64, 2 streams x {n_ref} frames: max|dp|={dp:.3e} m max|dq|={dq:.3e}")
        agree = compare_counters(tag, outs, ref, n_ref, ("n_msckf_used",)
                                 + (PLANE_COUNTERS if eng.use_planes else ()) + (SLAM_COUNTERS if eng.use_slam else ()))
        if min(agree.values()) < 1.0:
            raise RuntimeError(f"{tag} per-frame counters differ from the CPU f64 run's: share of stream-frames "
                               f"equal {agree}")
        if not (dp < spec.pose_limits[0] and dq < spec.pose_limits[1]):
            raise RuntimeError(f"{tag} the card's run disagrees with the CPU f64 reference (limits {spec.pose_limits})")

    info["finish"] = finish
    return n_frames, launches, info


def check_planes(tag, state, outs, truth):
    """The plane path's own checks: plane states were made and used, and every
    active CP lies within 0.10 m of a true plane CP (tests/test_e2e_planes.py)."""
    n_planes = outs.n_planes.max().item()
    n_constraints = outs.n_plane_constraints.sum().item()
    dropped = outs.n_plane_dropped.sum().item()
    print(f"{tag} in-state planes at most {n_planes} per stream; plane constraint updates {n_constraints} "
          f"({n_constraints / outs.n_planes.shape[0]:.1f} per stream); delayed inits "
          f"{outs.n_plane_init.sum().item()} (counted before the 2 s delay gate, as in JAX); "
          f"n_plane_dropped summed {dropped}")
    if n_planes == 0 or n_constraints == 0:
        raise RuntimeError("no plane state or no plane constraint update on any stream")
    cp_est = state.plane_cp[state.plane_active].double()
    if cp_est.shape[0]:
        dist = torch.cdist(cp_est, truth.plane_cp.double()).min(dim=1).values
        print(f"{tag} {cp_est.shape[0]} active CPs at the end; distance to the nearest true CP: "
              f"max {dist.max().item():.4f} m, mean {dist.mean().item():.4f} m")
        if not dist.max().item() < 0.10:
            raise RuntimeError("an active plane CP lies farther than 0.10 m from every true plane CP")
    else:
        print(f"{tag} no active CP at the end")
    return dict(n_plane_dropped=dropped, n_plane_constraints=n_constraints)


def check_slam(tag, state, outs):
    """The SLAM path's own checks: every stream initialized landmarks and
    held some in the state at some frame, and landmark updates were applied."""
    inits = outs.n_slam_init.sum(dim=1)
    held = outs.n_slam.max(dim=1).values
    first = (outs.n_slam_init.sum(dim=0) > 0).nonzero()
    print(f"{tag} SLAM: first init at frame {int(first[0]) + 1 if first.numel() else None}; inits per stream "
          f"min {inits.min().item()} mean {inits.float().mean().item():.1f}; landmarks held at most "
          f"{held.max().item()} (min over streams {held.min().item()}); landmark updates "
          f"{outs.n_slam_update.sum().item()} ({outs.n_slam_update.float().mean().item():.2f} per stream-frame); "
          f"{state.slam_active.sum().item()} landmarks active at the end")
    if not (inits.min().item() > 0 and held.min().item() > 0 and outs.n_slam_update.sum().item() > 0):
        raise RuntimeError("a stream initialized no SLAM landmark, or no landmark update was applied")
    if not torch.isfinite(state.slam_p[state.slam_active]).all():
        raise RuntimeError("non-finite SLAM landmark")


def compare_counters(tag, outs, ref, n_ref, names):
    """Per-frame counters (features that passed the χ² gate, the plane
    counters) of the card's f32 run against the CPU f64 run; where f32 takes
    a gate that f64 does not (or the reverse), the frame and the counter are
    printed. Returns each counter's share of agreeing stream-frames."""
    agree = {}
    for name in names:
        card = getattr(outs, name)[:2, :n_ref].cpu()
        cpu = getattr(ref, name)
        diff = (card != cpu).nonzero().tolist()
        agree[name] = 1.0 - len(diff) / card.numel()
        print(f"{tag} {name} per frame: card == CPU f64 on {card.numel() - len(diff)} of {card.numel()} "
              f"stream-frames; totals card {card.sum().item()} CPU {cpu.sum().item()}")
        for b, f in diff[:10]:
            print(f"{tag}   gate flipped: stream {b} frame {f + 1} {name} card {card[b, f].item()} "
                  f"CPU f64 {cpu[b, f].item()}")
    return agree


def _raw_events(prof):
    """(name, on the device, start ns, duration ns) of every event of a
    profile, read from the profiler's raw results: building ``prof.events()``
    takes minutes for a few frames of ~60k kernels each."""
    events = [(e.name(), e.device_type().name == "CUDA", e.start_ns(), e.duration_ns(), e.is_user_annotation())
              for e in prof.profiler.kineto_results.events()]
    # A range's device-side annotation (a range open around a kernel, such
    # as the step's own ``manager.step``) is no device work.
    return [(name, dev, t0, dur) for name, dev, t0, dur, note in events if not (dev and note)]


PROFILE_FRAMES = 1      # frames of each path's profile window


def profile_frames(spec: PathSpec, info: dict, n: int = PROFILE_FRAMES):
    """Where a frame's time goes (torch.profiler over the n frames after the
    checked window, from the state the path's run kept): device kernel time
    and kernel count per frame, the device's idle share of an unprofiled
    frame (from the path's run), and each stage's host time (inflated by the
    profiler's own overhead) and kernel launches."""
    from ov_plane_tpu_torch.models.manager import STAGES, run_sequence
    from torch.profiler import ProfilerActivity, profile

    tag = f"[profile {spec.name}]"
    eng, cfg, sim = info["eng"], info["cfg"], info["sim"]
    st, bk = info["snapshot"]
    first = spec.sync_start + SYNC_STEPS
    frame_wall_ms = 1e3 * info["wall_s"] / info["n_frames"]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.time()
        run_sequence(eng, st, bk, sim, imu_window=cfg.tpu.max_imu_per_frame, n_frames=n, start=first)
        torch.cuda.synchronize()
        wall_ms = (time.time() - t) * 1e3
    report_profile(tag, prof, STAGES, first, n, frame_wall_ms, wall_ms)


def report_profile(tag, prof, ranges, first, n, frame_wall_ms, wall_ms):
    """Print a profile of n frames: kernels and device busy time per frame,
    the device's idle share of an unprofiled frame, each range's host ms
    (inflated by the profiler) and kernel launches, the largest kernels."""
    t = time.time()
    events = _raw_events(prof)
    kern = [(name, dur) for name, dev, _, dur in events if dev]
    busy_ms = sum(dur for _, dur in kern) / 1e6 / n
    if busy_ms <= 0:
        print(f"{tag} the profiler recorded no device time: device idle share not measured")
        return
    print(f"{tag} frames {first}-{first + n - 1}: {len(kern) / n:.0f} kernels per frame, device busy {busy_ms:.2f} ms; "
          f"unprofiled frame {frame_wall_ms:.2f} ms -> device idle {100 * (1 - busy_ms / frame_wall_ms):.1f}%; "
          f"profiled frame {wall_ms / n:.2f} ms")
    spans = sorted((t0, t0 + dur, name) for name, dev, t0, dur in events if name in ranges and not dev)
    host = dict.fromkeys(ranges, 0.0)
    for s0, s1, name in spans:
        host[name] += (s1 - s0) / 1e6 / n
    launches = dict.fromkeys(ranges, 0)
    starts = [s0 for s0, _, _ in spans]
    for name, dev, t0, _ in events:
        if not dev and name.startswith(("cudaLaunchKernel", "cuLaunchKernel")):
            i = bisect.bisect_right(starts, t0) - 1
            if i >= 0 and t0 <= spans[i][1]:
                launches[spans[i][2]] += 1
    print(f"{tag} host ms per frame by range (profiled): " + ", ".join(f"{k} {v:.2f}" for k, v in host.items()))
    print(f"{tag} kernel launches per frame by range: " + ", ".join(f"{k} {v / n:.0f}" for k, v in launches.items()))
    by_name = {}
    for name, dur in kern:
        tot, c = by_name.get(name, (0, 0))
        by_name[name] = (tot + dur, c + 1)
    for name, (tot, c) in sorted(by_name.items(), key=lambda kv: kv[1][0], reverse=True)[:6]:
        print(f"{tag}   {tot / 1e6 / n:8.3f} ms/frame  x{c // n:5d}  {name[:80]}")
    print(f"{tag} events read in {time.time() - t:.1f} s")


VISION_FRAMES = 36      # the first 36 of the bench's 80 vision frames (bench.py:116)
VISION_WARM = 12        # warm-up frames, the host synchronizations counted from the third
VISION_REF = 12         # frames of streams 0-1 against the port's CPU run
ANCHOR_FRAMES = 36      # its frames: the first inits at frame 20 move anchor some 11 frames later
TABLETOP_LAYERS = dict(texture_cell=0.1, speckle_cells=((0.05, 0.12, 0.30), 0.12))   # tests/test_fused_planes.py
VISION_PER_FRAME = {"gram_reduce": 1, "kalman_downdate": 12}   # classic 1, plane 1, init 2, merge slots 8
ANCHOR_PER_FRAME = {"gram_reduce": 1, "kalman_downdate": 10}   # classic 1, SLAM update 1, init candidates 8
TABLETOP_PER_FRAME = {"gram_reduce": 0, "kalman_downdate": 12}  # the vision path's, the classic update by QR
TABLETOP_MIN_EQUAL = 44  # of stream 0's 46 frames, plane counters equal to the CPU f64 run's (46 seen)
VISION_RANGES = ("frontend.preprocess", "frontend.klt", "frontend.ransac", "frontend.fast", "frontend.triangulate",
                 "step.propagate_and_clone", "step.ingest", "step.triage", "step.plane_init", "step.plane_msckf",
                 "step.msckf_update", "step.marginalize", "host.plane_detect", "pull")


class VisionRun(NamedTuple):
    cfg: object
    truth: object
    imu: tuple              # host (imu_t [Ti], imu_w [B, Ti, 3], imu_a [B, Ti, 3], cam_t_imu [Tc])
    gt_bg0: torch.Tensor    # [B, 3] the noisy draws' bias truth at frame 0
    gt_ba0: torch.Tensor
    ring: list              # staged frames, [B, h, w] on the card
    sampler: str
    wire: str


def vision_setup(cfg, eng):
    """The vision scene's 80 frames rendered on the card, each stream's fixed
    pixel noise (σ 0.01, bench.py:278-280) added, quantized to the 8-bit
    lattice (the bench's camera ADC, bench.py:293-300) and staged; the IMU
    noise of 64 Monte-Carlo streams."""
    import numpy as np
    from ov_plane_tpu_torch.frontend.fused import FusedVisionDriver
    from ov_plane_tpu_torch.frontend.synthetic import render_frame_textured
    from ov_plane_tpu_torch.ops.quat import quat_2_rot
    from ov_plane_tpu_torch.sim import simulator

    truth = simulator.load_scene(simulator.VISION_SCENE_PATH, dtype=torch.float64, device="cuda")
    sim = simulator.apply_noise(truth, simulator.noise_params(cfg), BATCH,
                                torch.Generator(device="cuda").manual_seed(SEED))
    g = torch.Generator(device="cuda").manual_seed(SEED + 2)
    w, h = cfg.cam_wh
    noise = 0.01 * torch.randn(BATCH, h, w, generator=g, device="cuda")
    drv = FusedVisionDriver(cfg, eng, BATCH)
    R_ItoC = quat_2_rot(torch.tensor(cfg.cam_extrinsics[0:4], dtype=torch.float64))
    p_IinC = torch.tensor(cfg.cam_extrinsics[4:7], dtype=torch.float64)
    t = time.time()
    ring = []
    for i in range(1, VISION_FRAMES + 1):
        img = render_frame_textured(truth.plane_corners, truth.plane_normal, truth.plane_d,
                                    quat_2_rot(truth.gt_q[i]), truth.gt_p[i], R_ItoC, p_IinC,
                                    cfg.cam_intrinsics, tuple(cfg.cam_wh))
        x = torch.clamp(img[None] + noise, 0.0, 1.0)
        ring.append(drv.stage_image(torch.round(x * 255.0) * (1.0 / 255.0)))
    torch.cuda.synchronize()
    mb = sum(r.numel() * r.element_size() for r in ring) / 1e6
    print(f"[vision] rendered and staged {VISION_FRAMES} frames x {BATCH} streams ({w}x{h}, {mb:.0f} MB ring, "
          f"{ring[0].dtype}) in {time.time() - t:.2f} s")
    info = drv.wire_guard_info or {}
    print(f"[vision] wire guard: wire={drv.vopts.img_wire} sampler={drv.vopts.klt.sampler} "
          f"u8_lossless={info.get('u8_lossless')} ({info.get('reason')})")
    imu = (truth.imu_t.cpu().numpy(), sim.imu_w.cpu().numpy(), sim.imu_a.cpu().numpy(), truth.cam_t_imu.cpu().numpy())
    return VisionRun(cfg, truth, imu, sim.gt_bg_cam[:, 0], sim.gt_ba_cam[:, 0], ring, drv.vopts.klt.sampler,
                     drv.vopts.img_wire)


def _imu_window(run: VisionRun, i: int, streams=slice(None)):
    """Frame i's IMU windows of the chosen streams, +inf padded (bench.py:195-205),
    from host copies (a read of a device scalar here would synchronize)."""
    import numpy as np

    W = run.cfg.tpu.max_imu_per_frame
    imu_t, imu_w, imu_a, cam_t = run.imu
    b = imu_w[streams].shape[0]
    s0 = int(run.truth.imu_window_start[i])
    m = min(W, imu_t.shape[0] - s0)
    it = np.full((b, W), np.inf)
    iw = np.zeros((b, W, 3))
    ia = np.zeros((b, W, 3))
    it[:, :m] = imu_t[s0:s0 + m]
    iw[:, :m] = imu_w[streams, s0:s0 + m]
    ia[:, :m] = imu_a[streams, s0:s0 + m]
    return it, iw, ia, np.full(b, float(cam_t[i]))


def _chunk_windows(run: VisionRun, i0: int, k: int, streams=slice(None)):
    """Frames i0..i0+k-1's IMU windows and times stacked over a chunk: [k, b, ...]."""
    import numpy as np

    ws = [_imu_window(run, i0 + j, streams) for j in range(k)]
    return tuple(np.stack([w[n] for w in ws]) for n in range(4))


def vision_driver(run: VisionRun, eng, b: int, device, dtype, chain: int = 1):
    """A fresh driver (chunks of ``chain`` frames), state, bank and tracker state for b streams."""
    from ov_plane_tpu_torch.frontend.fused import FusedVisionDriver
    from ov_plane_tpu_torch.models.feature_bank import FeatureBank
    from ov_plane_tpu_torch.models.manager import init_state_with_gt

    tr = run.truth
    # The bench spreads the detector's per-stream Delaunay calls over 4 threads (bench.py:261-264).
    drv = FusedVisionDriver(run.cfg, eng, b, sampler=run.sampler, img_wire=run.wire, plane_threads=4, chain=chain)
    st = init_state_with_gt(eng, run.cfg, t0=tr.cam_t_imu[0].expand(b), q0=tr.gt_q[0].expand(b, 4),
                            p0=tr.gt_p[0].expand(b, 3), v0=tr.gt_v[0].expand(b, 3), bg0=run.gt_bg0[:b],
                            ba0=run.gt_ba0[:b], dtype=dtype, device=device)
    bank = FeatureBank.create(run.cfg.tpu.max_features, eng.layout.max_clones, b, dtype, device)
    return drv, st, bank, drv.init_frontend()


def drive_vision(refs: CpuRefs):
    """Phase 6: the vision path at full width; returns (n_frames, launches,
    info), ``info["finish"]()`` holding streams 0-1 to the CPU reference
    queued on ``refs``."""
    from ov_plane_tpu_torch.eval.metrics import rmse_nees
    from ov_plane_tpu_torch.models.manager import VioEngine
    from ov_plane_tpu_torch.ops import kernels
    from ov_plane_tpu_torch.utils.config import vision_config

    tag = "[vision]"
    t = time.time()
    cfg = vision_config()
    eng = VioEngine.from_config(cfg, device="cuda")
    run = vision_setup(cfg, eng)
    print(f"{tag} D={eng.layout.dim}; B={BATCH}; {VISION_FRAMES} frames; set-up {time.time() - t:.2f} s")

    # Warm-up: VISION_WARM frames; host synchronizations counted in steps
    # 3-VISION_WARM (the first two make the libraries' handles), pulls
    # counted by the driver.
    drv, st, bank, fev = vision_driver(run, eng, BATCH, "cuda", torch.float32)
    t = time.time()
    syncs, pulls = [], []
    for i in range(1, VISION_WARM + 1):
        n0 = drv.n_pulls
        torch.cuda.synchronize()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            if i >= 3:
                torch.cuda.set_sync_debug_mode("warn")
            try:
                st, bank, fev, _ = drv.step_batch(st, bank, fev, run.ring[i - 1], *_imu_window(run, i))
            finally:
                torch.cuda.set_sync_debug_mode("default")
        if i >= 3:
            syncs.append(sorted({str(w.message).splitlines()[0] for w in caught
                                 if "synchronizing CUDA operation" in str(w.message)}))
            pulls.append(drv.n_pulls - n0)
    torch.cuda.synchronize()
    print(f"{tag} warm-up {VISION_WARM} frames in {time.time() - t:.1f} s; steps 3-{VISION_WARM}: host "
          f"synchronizations other than the pull per step {[len(x) for x in syncs]} {sum(syncs, [])[:5]}; "
          f"packed pulls read per step {pulls}")
    if any(syncs) or pulls != [1] * len(pulls):
        raise RuntimeError("a vision step synchronizes with the host other than by its one packed pull")
    snapshot = (drv, st, bank, fev)

    # The timed run from a fresh state.
    drv, st, bank, fev = vision_driver(run, eng, BATCH, "cuda", torch.float32)
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    counters, pulls_ref, qs, ps, covs, stamps = [], [], [], [], [], []
    t = time.time()
    labelled = n_labels = 0
    for i in range(1, VISION_FRAMES + 1):
        stamps.append(time.time())      # before step i: the host-bound step's own pace
        fed = (drv._label_ids >= 0).sum(axis=1)
        labelled, n_labels = labelled + int((fed > 0).sum()), n_labels + int(fed.sum())
        st, bank, fev, out = drv.step_batch(st, bank, fev, run.ring[i - 1], *_imu_window(run, i))
        qs.append(out.q)
        ps.append(out.p)
        covs.append(out.cov_diag_imu[:, 0:6])
        if i > 1:
            counters.append(drv.last_counters.copy())
            pulls_ref.append(drv.last_pull[:2].copy())
    drv.flush_stream()
    torch.cuda.synchronize()
    wall = time.time() - t
    drv.close()
    counters.append(drv.last_counters.copy())
    pulls_ref.append(drv.last_pull[:2].copy())
    launches = {"gram_reduce": kernels.gram_reduce.launches, "kalman_downdate": kernels.kalman_downdate.launches}
    print(f"{tag} {BATCH}x{VISION_FRAMES} stream-frames in {wall:.3f} s: {BATCH * VISION_FRAMES / wall:.2f} "
          f"stream-frames/s ({VISION_FRAMES / wall:.3f} frames/s per stream, {1e3 * wall / VISION_FRAMES:.1f} ms "
          f"per frame of {BATCH} streams)")
    print(f"{tag} launches: {launches}")
    for k, n in launches.items():
        if n != VISION_PER_FRAME[k] * VISION_FRAMES:
            raise RuntimeError(f"{k} launched {n} times over {VISION_FRAMES} frames, "
                               f"not {VISION_PER_FRAME[k]} per frame")
    import numpy as np

    cnt = np.stack(counters)                                   # [T, B, 9]
    for name, col in (("tracked", 5), ("RANSAC-kept", 6), ("new FAST", 7)):
        print(f"{tag} {name} per frame (mean over streams): " + " ".join(f"{v:.1f}" for v in cnt[:, :, col].mean(1)))
    q, p, cov = torch.stack(qs, 1), torch.stack(ps, 1), torch.stack(covs, 1)
    if not (torch.isfinite(q).all() and torch.isfinite(p).all() and torch.isfinite(st.cov).all()):
        raise RuntimeError("non-finite vision state")
    tr = run.truth
    m = rmse_nees(q.double(), p.double(), cov[..., 0:3].double(), cov[..., 3:6].double(),
                  tr.gt_q[1:VISION_FRAMES + 1], tr.gt_p[1:VISION_FRAMES + 1])
    rmse0 = m["rmse_pos"][0].item()
    n_planes, n_constr, n_init = int(cnt[:, :, 2].max()), int(cnt[:, :, 1].sum()), int(cnt[:, :, 0].sum())
    print(f"{tag} stream 0: rmse_pos={rmse0:.4f} m rmse_ori={m['rmse_ori_deg'][0].item():.4f} deg; mean over "
          f"{BATCH} streams rmse_pos={m['rmse_pos'].mean().item():.4f} m; in-state planes at most {n_planes}, "
          f"plane constraint updates {n_constr}, delayed-init candidates {n_init} (counted before the 2 s delay "
          f"gate, as in JAX); plane labels fed on {labelled} stream-frames ({n_labels} labels); "
          f"msckf features per frame (mean) {cnt[:, :, 3].mean():.2f}")
    if not rmse0 < 0.5:
        raise RuntimeError(f"stream 0 position RMSE {rmse0:.3f} m is not below 0.5 m")
    # The plane work this scene gives in its frames: the host detector's labels
    # reach the step. The delayed init finds no candidate in f64, in the JAX
    # package too (the plane witness of tests/test_torch_fused.py, PERF.md
    # §6), so streams 0-1's plane counters are held equal to the CPU f64 run
    # below (a spurious candidate from an f32 error fails there); the
    # tabletop phase (6b) holds the fused path's delayed init, and the plane
    # path (phase 5) plane states and constraint updates.
    if labelled == 0:
        raise RuntimeError("no plane label reached the step on any stream")

    # Streams 0-1 through the port on the CPU (frontend f32, filter f64), queued.
    job = refs.submit("vision", _vision_cpu_reference, torch.stack(run.ring[:VISION_REF])[:, :2].cpu().numpy(),
                      _host_imu(run, slice(0, 2)), run.gt_bg0[:2].cpu().numpy(), run.gt_ba0[:2].cpu().numpy(),
                      run.sampler, run.wire)
    info = dict(stream_frames_per_s=BATCH * VISION_FRAMES / wall, wall_s=wall, n_frames=VISION_FRAMES,
                run=run, snapshot=snapshot, stamps=stamps)

    def finish():
        ref = job.result()
        card = np.stack(pulls_ref[:VISION_REF])[:, :2]
        hold_vision_to_cpu(tag, card, cnt[:VISION_REF, :2], p[:2, :VISION_REF], q[:2, :VISION_REF], ref, job.seconds)

    info["finish"] = finish
    return VISION_FRAMES, launches, info


def _host_imu(run: VisionRun, streams) -> tuple:
    imu_t, imu_w, imu_a, cam_t = run.imu
    return imu_t, imu_w[streams], imu_a[streams], cam_t


def _vision_cpu_reference(frames, imu, gt_bg0, gt_ba0, sampler: str, wire: str, chain: int = 1) -> dict:
    """The vision scene's streams through the port on the CPU (frontend f32,
    filter f64) in a ``CpuRefs`` worker: ``frames`` the staged u8 wire
    [T, b, h, w], ``imu`` those streams' host IMU arrays; frame by frame or
    in chunks of ``chain``. Returns the pulls and counters read (after each
    step but the first, and after the flush; a chunk's pull [K, b, ...]) and
    p, q [b, T, ...]."""
    import numpy as np

    from ov_plane_tpu_torch.models.manager import VioEngine
    from ov_plane_tpu_torch.sim import simulator
    from ov_plane_tpu_torch.utils.config import vision_config

    cfg = vision_config()
    truth = simulator.load_scene(simulator.VISION_SCENE_PATH, dtype=torch.float64, device="cpu")
    run = VisionRun(cfg, truth, imu, torch.from_numpy(gt_bg0), torch.from_numpy(gt_ba0), None, sampler, wire)
    eng = VioEngine.from_config(cfg, device="cpu")
    drv, st, bank, fev = vision_driver(run, eng, gt_bg0.shape[0], "cpu", torch.float64, chain)
    frames = torch.from_numpy(frames)
    pulls, counters, ps, qs = [], [], [], []
    for c in range(frames.shape[0] // chain):
        if chain == 1:
            st, bank, fev, out = drv.step_batch(st, bank, fev, frames[c], *_imu_window(run, c + 1))
            ps.append(out.p[None])
            qs.append(out.q[None])
        else:
            st, bank, fev, out = drv.step_batch_chunk(st, bank, fev, frames[c * chain:(c + 1) * chain],
                                                      *_chunk_windows(run, c * chain + 1, chain))
            ps.append(out.p)
            qs.append(out.q)
        if c > 0:
            pulls.append(drv.last_pull.copy())
            counters.append(drv.last_counters.copy())
    drv.flush_stream()
    drv.close()
    pulls.append(drv.last_pull.copy())
    counters.append(drv.last_counters.copy())
    return dict(pulls=np.stack(pulls), counters=np.stack(counters), p=torch.cat(ps).transpose(0, 1).numpy(),
                q=torch.cat(qs).transpose(0, 1).numpy())


def hold_vision_to_cpu(tag, card_pulls, card_counters, p, q, ref: dict, seconds: float):
    """Streams 0-1 of a vision run on the card against their CPU run (f64
    filter): track ids and valid flags equal on ≥ 99 % of slot-frames, the
    plane counters (inits, constraints, planes in the state) equal on every
    step read, the pose within (1e-2 m, 1e-3); the share of steps on which
    every counter is equal is printed. ``card_pulls`` [..., 2, cap+3, 8] and
    ``card_counters`` [steps, 2, 9] as ``ref`` holds them; p, q [2, T, ...]."""
    import numpy as np

    card = card_pulls.reshape(-1, *card_pulls.shape[-3:])[:, :, :-3]
    cpu = ref["pulls"].reshape(-1, *ref["pulls"].shape[-3:])[:, :, :-3]
    same = (card[..., 0] == cpu[..., 0]) & (card[..., 3] == cpu[..., 3])
    frac = same.mean()
    plane_card, plane_cpu = card_counters[..., 0:3], ref["counters"][..., 0:3]
    plane_same = bool((plane_card == plane_cpu).all())
    all_same = (card_counters == ref["counters"]).all(axis=(1, 2))
    T = ref["p"].shape[1]
    dp = float(np.abs(p[:, :T].double().cpu().numpy() - ref["p"]).max())
    dq = float(np.abs(q[:, :T].double().cpu().numpy() - ref["q"]).max())
    print(f"{tag} card f32 vs CPU (frontend f32, filter f64; {seconds:.1f} s in a worker), 2 streams x {T} "
          f"frames: ids and valid equal on {int(same.sum())} of {same.size} slot-frames ({100 * frac:.2f}%); plane "
          f"counters (inits, constraints, planes) equal on {int((plane_card == plane_cpu).all(axis=(1, 2)).sum())} "
          f"of {len(plane_card)} steps read (card sums {plane_card.sum(axis=(0, 1)).tolist()}, CPU "
          f"{plane_cpu.sum(axis=(0, 1)).tolist()}); all 9 counters equal on {int(all_same.sum())} of {len(all_same)}; "
          f"max|dp|={dp:.3e} m max|dq|={dq:.3e}")
    if not (frac >= 0.99 and plane_same and dp <= 1e-2 and dq <= 1e-3):
        raise RuntimeError(f"{tag} the card's vision run disagrees with the CPU reference")
    return frac, dp, dq


def profile_vision(info: dict, n: int = PROFILE_FRAMES):
    """Where a vision frame's time goes: n frames after the warm-up, from its
    driver and state, under torch.profiler (``report_profile``)."""
    from torch.profiler import ProfilerActivity, profile

    tag = "[profile vision]"
    run = info["run"]
    drv, st, bank, fev = info["snapshot"]
    frame_wall_ms = 1e3 * info["wall_s"] / info["n_frames"]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.time()
        for i in range(VISION_WARM + 1, VISION_WARM + n + 1):
            st, bank, fev, _ = drv.step_batch(st, bank, fev, run.ring[i - 1], *_imu_window(run, i))
        torch.cuda.synchronize()
        wall_ms = (time.time() - t) * 1e3
    drv.flush_stream()
    drv.close()
    report_profile(tag, prof, VISION_RANGES, VISION_WARM + 1, n, frame_wall_ms, wall_ms)


def drive_anchored():
    """Phase 5b, second part: anchored landmarks (OpenVINS's default SLAM
    representation) on MS-PT, 4 streams in f32, one ``run_sequence`` frame
    at a time until some active landmark has moved to a new anchor clone;
    returns (n_frames, launches, info)."""
    from ov_plane_tpu_torch.models.manager import VioEngine, run_sequence
    from ov_plane_tpu_torch.ops import kernels
    from ov_plane_tpu_torch.sim import simulator
    from ov_plane_tpu_torch.utils.config import ms_pl_config

    tag = "[anchored]"
    t = time.time()
    cfg = ms_pl_config()
    cfg.state.use_plane_constraint = False
    cfg.state.use_plane_slam_feats = False
    cfg.state.feat_rep_slam = "ANCHORED_MSCKF_INVERSE_DEPTH"
    eng = VioEngine.from_config(cfg, device="cuda")
    b = ANCHOR_BATCH
    truth = simulator.load_scene(simulator.PLANE_SCENE_PATH, dtype=torch.float32, device="cuda")
    sim = simulator.apply_noise(truth, simulator.noise_params(cfg), b, torch.Generator(device="cuda").manual_seed(SEED))
    state, bank = _fresh(eng, cfg, sim, b, "cuda", torch.float32)
    prev = None
    changes = inits = 0
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t_run = time.time()
    for i in range(1, ANCHOR_FRAMES + 1):
        state, bank, out = run_sequence(eng, state, bank, sim, imu_window=cfg.tpu.max_imu_per_frame, n_frames=1,
                                        start=i)
        cur = (state.slam_id.cpu(), state.slam_active.cpu(), state.slam_anchor_slot.cpu())
        inits += int(out.n_slam_init.sum())
        if prev is not None:
            kept = cur[1] & prev[1] & (cur[0] == prev[0])
            changes += int((kept & (cur[2] != prev[2])).sum())
        prev = cur
        if (cur[1] & (cur[2] < 0)).any():
            raise RuntimeError(f"frame {i}: an active anchored landmark has no anchor clone")
    wall = time.time() - t_run
    launches = {"gram_reduce": kernels.gram_reduce.launches, "kalman_downdate": kernels.kalman_downdate.launches}
    print(f"{tag} launches: {launches}")
    for k, n in launches.items():
        if n != ANCHOR_PER_FRAME[k] * ANCHOR_FRAMES:
            raise RuntimeError(f"{k} launched {n} times over {ANCHOR_FRAMES} frames, "
                               f"not {ANCHOR_PER_FRAME[k]} per frame")
    if not (torch.isfinite(state.cov).all() and torch.isfinite(state.imu).all()
            and torch.isfinite(state.slam_p[state.slam_active]).all()):
        raise RuntimeError("non-finite state on the anchored run")
    print(f"{tag} MS-PT, {cfg.state.feat_rep_slam}, D={eng.layout.dim}, {b} streams x {ANCHOR_FRAMES} frames in "
          f"{time.time() - t:.1f} s: {inits} landmark inits, {changes} anchor changes of active landmarks, "
          f"{int(prev[1].sum())} landmarks active at the end, stream 0's anchors {prev[2][0].tolist()}")
    if inits == 0 or changes == 0:
        raise RuntimeError("no anchored landmark was initialized or moved to a new anchor")
    return ANCHOR_FRAMES, launches, dict(stream_frames_per_s=b * ANCHOR_FRAMES / wall, anchor_changes=changes)


def _drive_fused(drv, st, bank, fev, frames, run, b, on_card):
    """Frames through ``step_batch`` for the first b streams; returns the
    per-frame (inits, constraints, planes) [b, T, 3] and the final state."""
    rows = []
    for i in range(1, len(frames) + 1):
        img = frames[i - 1].expand(b, -1, -1).contiguous()
        st, bank, fev, out = drv.step_batch(st, bank, fev, img if on_card else img.cpu(),
                                            *_imu_window(run, i, slice(0, b)))
        rows.append(torch.stack([out.n_plane_init, out.n_plane_constraints, out.n_planes], dim=1).cpu())
    drv.flush_stream()
    drv.close()
    return torch.stack(rows, dim=1), st


def _tabletop_cpu_reference(frames, imu, gt_bg0, gt_ba0):
    """The tabletop phase's chosen streams through the port on the CPU
    (frontend f32, filter f64) in a ``CpuRefs`` worker: ``frames`` numpy
    [T, h, w], ``imu`` the streams' host IMU arrays. Returns the counters."""
    from ov_plane_tpu_torch.models.manager import VioEngine
    from ov_plane_tpu_torch.sim import simulator
    from ov_plane_tpu_torch.utils.config import tabletop_config

    cfg = tabletop_config()
    truth = simulator.load_scene(simulator.TABLETOP_SCENE_PATH, dtype=torch.float64, device="cpu")
    run = VisionRun(cfg, truth, imu, torch.from_numpy(gt_bg0), torch.from_numpy(gt_ba0), None, "mm", "f32")
    b = gt_bg0.shape[0]
    eng = VioEngine.from_config(cfg, device="cpu")
    cnt, _ = _drive_fused(*vision_driver(run, eng, b, "cpu", torch.float64), [torch.from_numpy(f) for f in frames],
                          run, b, False)
    return cnt.numpy()


def drive_tabletop(refs: CpuRefs):
    """Phase 6b: the fused path's plane update on the tabletop scene; returns
    (n_frames, launches, info), ``info["finish"]()`` holding stream 0 to the
    CPU reference queued on ``refs``."""
    from ov_plane_tpu_torch.frontend.synthetic import render_frame_textured
    from ov_plane_tpu_torch.models.manager import VioEngine
    from ov_plane_tpu_torch.ops import kernels
    from ov_plane_tpu_torch.ops.quat import quat_2_rot
    from ov_plane_tpu_torch.sim import simulator
    from ov_plane_tpu_torch.utils.config import tabletop_config

    tag = "[tabletop]"
    t = time.time()
    cfg = tabletop_config()
    eng = VioEngine.from_config(cfg, device="cuda")
    truth = simulator.load_scene(simulator.TABLETOP_SCENE_PATH, dtype=torch.float64, device="cuda")
    sim = simulator.apply_noise(truth, simulator.noise_params(cfg), TABLETOP_BATCH,
                                torch.Generator(device="cuda").manual_seed(SEED + 3))
    n_frames = truth.cam_t.shape[0] - 1
    R_ItoC = quat_2_rot(torch.tensor(cfg.cam_extrinsics[0:4], dtype=torch.float64))
    p_IinC = torch.tensor(cfg.cam_extrinsics[4:7], dtype=torch.float64)
    frames = [render_frame_textured(truth.plane_corners, truth.plane_normal, truth.plane_d, quat_2_rot(truth.gt_q[i]),
                                    truth.gt_p[i], R_ItoC, p_IinC, cfg.cam_intrinsics, tuple(cfg.cam_wh),
                                    **TABLETOP_LAYERS) for i in range(1, n_frames + 1)]
    torch.cuda.synchronize()
    # Float frames off the 8-bit lattice: the f32 wire and the exact sampler,
    # what the wire guard resolves them to (the frames are staged here).
    run = VisionRun(cfg, truth, (truth.imu_t.cpu().numpy(), sim.imu_w.cpu().numpy(), sim.imu_a.cpu().numpy(),
                                 truth.cam_t_imu.cpu().numpy()), sim.gt_bg_cam[:, 0], sim.gt_ba_cam[:, 0], None,
                    "mm", "f32")
    print(f"{tag} D={eng.layout.dim}; {n_frames} frames rendered on the card in {time.time() - t:.2f} s; "
          f"B={TABLETOP_BATCH}, f32")

    drv, st, bank, fev = vision_driver(run, eng, TABLETOP_BATCH, "cuda", torch.float32)
    kernels.reset_launch_counts()
    t = time.time()
    cnt, st = _drive_fused(drv, st, bank, fev, frames, run, TABLETOP_BATCH, True)
    wall = time.time() - t
    launches = {"gram_reduce": kernels.gram_reduce.launches, "kalman_downdate": kernels.kalman_downdate.launches}
    n_init, n_constr, n_planes = int(cnt[..., 0].sum()), int(cnt[..., 1].sum()), int(cnt[..., 2].max())
    in_state = int((cnt[..., 2].max(dim=1).values > 0).sum())
    print(f"{tag} {TABLETOP_BATCH}x{n_frames} stream-frames in {wall:.3f} s (wire {drv.vopts.img_wire}, sampler "
          f"{drv.vopts.klt.sampler}); launches {launches}; plane inits {n_init} (counted before the 2 s delay "
          f"gate), constraint updates {n_constr}, planes in the state at most {n_planes}, on {in_state} of "
          f"{TABLETOP_BATCH} streams")
    for k, n in launches.items():
        if n != TABLETOP_PER_FRAME[k] * n_frames:
            raise RuntimeError(f"{k} launched {n} times over {n_frames} frames, "
                               f"not {TABLETOP_PER_FRAME[k]} per frame")
    if not (torch.isfinite(st.cov).all() and torch.isfinite(st.imu).all()):
        raise RuntimeError("non-finite tabletop state")
    if n_init < 1 or n_planes < 1 or n_constr < 1:
        raise RuntimeError("the fused path's plane update did not fire on the tabletop scene")

    # Stream 0 and the first other stream with a plane in the state through
    # the port on the CPU (frontend f32, filter f64), same inputs, queued.
    # Stream 0 must agree (its first plane enters the state at frame
    # 42 on both); on the other, an f32 gate that f64 does not take is printed.
    sel = [0] + [int(b) for b in (cnt[:, :, 2].max(dim=1).values > 0).nonzero()[:, 0] if b > 0][:1]
    imu_t, imu_w, imu_a, cam_t = run.imu
    # One job per stream: the longest references, split so that they end with the others.
    frames_host = torch.stack(frames).cpu().numpy()
    jobs = [refs.submit(f"tabletop {b}", _tabletop_cpu_reference, frames_host, (imu_t, imu_w[[b]], imu_a[[b]], cam_t),
                        run.gt_bg0[[b]].cpu().numpy(), run.gt_ba0[[b]].cpu().numpy()) for b in sel]
    info = dict(stream_frames_per_s=TABLETOP_BATCH * n_frames / wall, wall_s=wall, n_frames=n_frames, streams=sel)

    def finish():
        same = []
        for j, b in enumerate(sel):
            card_b, cpu_b = cnt[b], torch.from_numpy(jobs[j].result())[0]
            first = [int(c[:, 2].nonzero()[0]) + 1 if c[:, 2].any() else None for c in (card_b, cpu_b)]
            same.append(int((card_b == cpu_b).all(dim=1).sum()))
            print(f"{tag} stream {b}, card f32 vs CPU f64: first frame with a plane in the state {first[0]} vs "
                  f"{first[1]}; (inits, constraints, planes) equal on {same[-1]} of {n_frames} frames")
            for f in range(35, n_frames):
                print(f"{tag}   frame {f + 1}: card {card_b[f].tolist()} CPU {cpu_b[f].tolist()}")
            if b == 0 and (first[0] is None or first[0] != first[1] or same[-1] < TABLETOP_MIN_EQUAL):
                raise RuntimeError(f"stream 0's plane counters disagree with the CPU f64 run: first plane at frame "
                                   f"{first[0]} vs {first[1]}, equal on {same[-1]} of {n_frames} frames "
                                   f"(at least {TABLETOP_MIN_EQUAL} needed)")
        info["counters_equal"] = same

    info["finish"] = finish
    return n_frames, launches, info


REPLAY_FRAMES = 56      # of the 10 s tabletop scene, written as an ASL folder (the dynamic init takes frame 36)
# The host path replays frames 2-47 after the GT init at frame 1 with ArUco
# landmarks on (``use_aruco`` through ``--config``, D = 204): SLAM and plane
# inits come after the 2 s delay, and marker 7, drawn on the table in frames
# ARUCO_SHOWN..ARUCO_HIDDEN-1 (tests/test_torch_aruco.py's replay), has its
# corners' tracks at the marginalization boundary then, so they enter the
# state near frame 42 and must survive the two frames without the marker.
REPLAY_HOST_FRAMES = 46
REPLAY_FUSED_FRAMES = 11  # run_euroc reports the ATE past 10 frames
REPLAY_DYN_FRAMES = 11  # replayed after the dynamic init
REPLAY_REF = 10         # frames of the host path held against the port's CPU run, every counter equal
REPLAY_PER_FRAME = {"gram_reduce": 0, "kalman_downdate": 21}
# Card f64 against CPU f64 over the first REPLAY_REF frames of the host
# path: max |Δp| in m, max |Δq|, ten times the first card readings
# (2.914e-7 m, 1.780e-7: the frontend's f32 KLT and the kernels' sums run
# in another order on the card).
REPLAY_POSE_LIMITS = (3e-6, 2e-6)
ARUCO_SHOWN, ARUCO_HIDDEN = 30, 46
ARUCO_MARKER = dict(marker_id=7, size=120, origin=(-0.22, 0.01, 0.81), axis_x=(1.0, 0.0, 0.0),
                    axis_y=(0.0, 1.0, 0.0), side=0.10)
ARUCO_REF = 16          # frames of the host path whose pose is held to the CPU run (all 46 printed)
ARUCO_D = REPLAY_D + 3 * 16     # the replay's layout with tpu.max_aruco_landmarks = 16 landmark slots
ARUCO_MAX_ID = 1 + 4 * 1024
ARUCO_IDS = [29, 30, 31, 32]     # marker 7's corner ids


def _draw_marker(data: str) -> float:
    """Draw ARUCO_MARKER into frames ARUCO_SHOWN..ARUCO_HIDDEN-1 of the ASL
    folder (tests/helpers/aruco_overlay.py); returns the host seconds."""
    import numpy as np

    sys.path.insert(0, str(Path(__file__).resolve().parent / "tests" / "helpers"))
    from aruco_overlay import camera_pose, overlay_marker

    from ov_plane_tpu_torch.eval import png
    from ov_plane_tpu_torch.frontend.aruco import generate_marker
    from ov_plane_tpu_torch.sim import simulator
    from ov_plane_tpu_torch.utils.config import sim_config

    cfg = sim_config()
    with np.load(simulator.TABLETOP_REPLAY_SCENE_PATH) as z:
        gt_q, gt_p = z["gt_q"], z["gt_p"]
    m = ARUCO_MARKER
    marker = generate_marker(m["marker_id"], m["size"])
    t = time.time()
    frames = sorted(Path(data, "mav0", "cam0", "data").glob("*.png"))
    for k in range(ARUCO_SHOWN, ARUCO_HIDDEN):
        R_GtoC, p_CinG = camera_pose(gt_q[k], gt_p[k], cfg.cam_extrinsics)
        png.write_gray(frames[k], overlay_marker(png.read_gray(frames[k]), marker, R_GtoC, p_CinG,
                                                 cfg.cam_intrinsics, m["origin"], m["axis_x"], m["axis_y"],
                                                 m["side"]))
    return time.time() - t


def drive_replay(refs: CpuRefs):
    """Phase 8: the dataset replay, the real suite's MS-PL variant at one
    stream (``scripts/run_euroc`` with ``--sim-calib --use-planes --max-slam
    15``, D = 156) on an ASL folder that the port's ``make_synth_asl`` writes
    from the 10 s tabletop scene (frames rendered on the card at 752×480,
    PNGs by ``eval/png``) with marker 7 drawn on the table in frames 30-45:
    (a) the host pipeline, GT init, f64, with ArUco landmarks (``use_aruco``
    through ``--config``, D = 204); (b) ``--fused``, GT init, f64; (c)
    ``--no-gt-init --f32``: the dynamic initialization must succeed, then
    the filter replays in f32. Returns (n_frames, launches, info) of the
    host path."""
    import tempfile

    import numpy as np

    from ov_plane_tpu_torch.ops import kernels
    from ov_plane_tpu_torch.scripts.make_synth_asl import write_asl
    from torch.profiler import ProfilerActivity, profile

    tag = "[replay]"
    # The folder outlives the phase: its CPU run is queued on ``refs``, and
    # the bag phase reads it.
    tmp = tempfile.mkdtemp(prefix="ovp_replay_")
    data = f"{tmp}/seq"
    w = write_asl(data, scene="tabletop", frames=REPLAY_FRAMES, seed=SEED, device="cuda")
    drawn = _draw_marker(data)
    Path(tmp, "aruco.yaml").write_text("%YAML:1.0\nuse_aruco: true\n")
    print(f"{tag} ASL folder: {w['frames']} frames (752x480 PNG) + {w['imu']} IMU samples written in "
          f"{w['seconds']:.2f} s; marker 7 drawn on frames {ARUCO_SHOWN}-{ARUCO_HIDDEN - 1} in {drawn:.2f} s (host)")

    def run(mode, flags, device="cuda"):
        kernels.reset_launch_counts()
        t = time.time()
        r = _replay_run(tmp, mode, flags, device)
        r["seconds"] = time.time() - t
        r["launches"] = {"gram_reduce": kernels.gram_reduce.launches,
                         "kalman_downdate": kernels.kalman_downdate.launches}
        return r

    runs = {}
    for mode, flags, n in (("host", ["--config", f"{tmp}/aruco.yaml"], REPLAY_HOST_FRAMES),
                           ("fused", ["--fused"], REPLAY_FUSED_FRAMES),
                           ("dynamic", ["--no-gt-init", "--f32"], REPLAY_DYN_FRAMES)):
        r = runs[mode] = run(mode, [*flags, "--max-frames", str(n)])
        n_done = r["n_done"]
        sizes = {k: Path(v).stat().st_size for k, v in r["files"].items()}
        with np.load(r["files"]["map.npz"]) as z:
            n_map = int(z["points"].shape[0])
        print(f"{tag} {mode}: init {r['init']} (first frame replayed {r['start_idx']}, init {r['init_seconds']:.2f} s);"
              f" {n_done} frames in {r['loop_seconds']:.2f} s = {n_done / r['loop_seconds']:.2f} frames/s; "
              f"host reads (synchronizations) per frame {r['host_reads'] / n_done:.2f}; launches {r['launches']}; "
              f"ATE posyaw {r['ate'][0]:.4f} m / {r['ate'][1]:.3f} deg; map {n_map} points "
              f"({r['map']['n_planes']} planes); files {sizes}; run {r['seconds']:.1f} s")
        c = dict(zip(r["counter_names"], r["counters"].T))
        print(f"{tag} {mode}: per frame n_msckf_used {c['n_msckf_used'].tolist()}")
        print(f"{tag} {mode}: per frame n_slam {c['n_slam'].tolist()} n_planes {c['n_planes'].tolist()} "
              f"constraints {c['n_plane_constraints'].tolist()}")
        if n_done != n or not (np.isfinite(r["p"]).all() and np.isfinite(r["q"]).all()):
            raise RuntimeError(f"the {mode} replay stepped {n_done} of {n} frames or gave non-finite poses")
        for k, per in REPLAY_PER_FRAME.items():
            if r["launches"][k] != per * n_done:
                raise RuntimeError(f"{mode}: {k} launched {r['launches'][k]} times over {n_done} frames, "
                                   f"not {per} per frame")
        if r["ate"] is None or not r["ate"][0] < 0.5:
            raise RuntimeError(f"{mode}: ATE posyaw {r['ate']} is not below 0.5 m")
        if min(sizes.values()) == 0 or n_map == 0:
            raise RuntimeError(f"{mode}: an output file is empty ({sizes}, map points {n_map})")
        if mode == "host" and not (c["n_slam"].max() > 0 and c["n_planes"].max() > 0):
            raise RuntimeError("no SLAM landmark or no plane entered the host path's state")
    if runs["dynamic"]["init"] != "dynamic":
        raise RuntimeError(f"the no-GT replay initialized by {runs['dynamic']['init']}, not dynamically")
    host = runs["host"]
    _check_aruco(tag, host)

    # The host path's frames through the port's CPU run (f64 both), queued.
    job = refs.submit("replay", _replay_cpu_reference, tmp)

    # Kernels and device time per frame of the host path's replay: a
    # profiled run of 1 frame after the GT init.
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        pr = run("profile_host", ["--config", f"{tmp}/aruco.yaml", "--max-frames", "1"])
        torch.cuda.synchronize()
    ev = [e for e in _raw_events(prof) if e[1]]
    kernels_per_frame = {"host": len(ev) / pr["n_done"]}
    print(f"{tag} host replay, profiled run of {pr['n_done']} frames (after a GT init): "
          f"{kernels_per_frame['host']:.0f} kernels per frame, device busy "
          f"{sum(e[3] for e in ev) / 1e6 / pr['n_done']:.2f} ms per frame, wall "
          f"{1e3 * pr['loop_seconds'] / pr['n_done']:.1f} ms per frame (profiled)")
    info = dict(stream_frames_per_s=host["n_done"] / host["loop_seconds"], folder=tmp, host_pq=(host["p"], host["q"]),
                decoder_ms=statistics.median(host["aruco_ms"]),
                modes={m: dict(frames=r["n_done"], frames_per_s=r["n_done"] / r["loop_seconds"],
                               host_reads_per_frame=r["host_reads"] / r["n_done"], init=r["init"],
                               start_idx=r["start_idx"], ate=r["ate"]) for m, r in runs.items()},
                kernels_per_frame=kernels_per_frame)

    def finish():
        import shutil

        ref = job.result()
        shutil.rmtree(tmp, ignore_errors=True)
        n = host["n_done"]
        dp = np.abs(host["p"] - ref["p"]).max(axis=1)
        dq = np.abs(host["q"] - ref["q"]).max(axis=1)
        same = (host["counters"][:REPLAY_REF] == ref["counters"][:REPLAY_REF]).all(axis=1)
        same_ids = len(ref["aruco_ids"]) == n and all(np.array_equal(a, b) for a, b in
                                                      zip(host["aruco_ids"], ref["aruco_ids"]))
        same_slam = (np.array_equal(host["slam_id"], ref["slam_id"])
                     and np.array_equal(host["slam_active"], ref["slam_active"]))
        print(f"{tag} host path card f64 vs CPU f64 ({job.seconds:.1f} s in a worker), {n} frames: every counter "
              f"equal on {int(same.sum())} of the first {REPLAY_REF}; ArUco ids equal on every frame {same_ids}, "
              f"SLAM slots equal on every frame {same_slam}; first {REPLAY_REF} frames max|dp|="
              f"{dp[:REPLAY_REF].max():.3e} m max|dq|={dq[:REPLAY_REF].max():.3e}, first {ARUCO_REF} "
              f"{dp[:ARUCO_REF].max():.3e} m / {dq[:ARUCO_REF].max():.3e}, all {dp.max():.3e} m / {dq.max():.3e}")
        if not same.all():
            raise RuntimeError(f"per-frame counters differ from the CPU run's: card {host['counters'][:REPLAY_REF]} "
                               f"CPU {ref['counters'][:REPLAY_REF]}")
        if not (same_ids and same_slam):
            raise RuntimeError(f"{tag} the card's ArUco detections or SLAM slots differ from the CPU run's")
        if not (dp[:ARUCO_REF].max() < REPLAY_POSE_LIMITS[0] and dq[:ARUCO_REF].max() < REPLAY_POSE_LIMITS[1]):
            raise RuntimeError(f"the card's replay disagrees with the CPU run (limits {REPLAY_POSE_LIMITS})")
        info["card_vs_cpu"] = (float(dp[:REPLAY_REF].max()), float(dq[:REPLAY_REF].max()))

    info["finish"] = finish
    return host["n_done"], host["launches"], info


def _check_aruco(tag: str, r: dict):
    """The ArUco checks of the host path: the marker detected on exactly the
    frames that show it, its corners' landmarks in the state before the
    frames without it and never marginalized; prints the decoder's host ms."""
    import numpy as np

    n = r["n_done"]
    frames = np.arange(2, 2 + n)           # the GT init takes frame 1
    seen = np.array([len(i) > 0 for i in r["aruco_ids"]])
    shown = (frames >= ARUCO_SHOWN) & (frames < ARUCO_HIDDEN)
    aruco = (r["slam_id"] >= 1) & (r["slam_id"] < ARUCO_MAX_ID) & r["slam_active"]
    n_ar = aruco.sum(axis=1)
    print(f"{tag} host: ArUco decoder host ms per frame median {statistics.median(r['aruco_ms']):.2f}, max "
          f"{max(r['aruco_ms']):.2f}; detections on frames {frames[seen].tolist()}; ArUco landmarks in the state "
          f"per frame {n_ar.tolist()}")
    if len(seen) != n or not (seen == shown).all() or any(sorted(set(i.tolist())) != ARUCO_IDS
                                                          for i, s in zip(r["aruco_ids"], seen) if s):
        raise RuntimeError(f"{tag} the marker was not detected exactly on the frames that show it")
    if not aruco.any():
        raise RuntimeError(f"{tag} no ArUco landmark entered the state")
    entered = int(np.argmax(n_ar > 0))
    if frames[entered] >= ARUCO_HIDDEN or (np.diff(n_ar[entered:]) < 0).any() or n_ar[-1] != len(ARUCO_IDS):
        raise RuntimeError(f"{tag} the ArUco landmarks entered at frame {frames[entered]} or left the state")


def _replay_run(tmp: str, mode: str, flags, device: str) -> dict:
    """``run_euroc`` on the ASL folder ``tmp/seq`` with the replay phase's
    flags, its files under ``tmp``; under ``use_aruco`` also each frame's
    detected ids, the decoder's host ms and the SLAM slots."""
    import numpy as np

    from ov_plane_tpu_torch.frontend.aruco import ArucoTracker
    from ov_plane_tpu_torch.scripts import run_euroc

    files = {k: f"{tmp}/{mode}_{k}" for k in ("traj.txt", "timing.csv", "plane.csv", "map.npz")}
    args = ["--data", f"{tmp}/seq", "--sim-calib", "--use-planes", "--max-slam", "15", *flags,
            "--out", files["traj.txt"], "--timing", files["timing.csv"], "--plane-csv", files["plane.csv"],
            "--map-out", files["map.npz"], "--device", device, "--verbosity", "WARNING"]
    rec = {"aruco_ids": [], "aruco_ms": [], "slam_id": [], "slam_active": []}
    detect, step = ArucoTracker.detect, run_euroc.step

    def detect_rec(self, img):
        t = time.perf_counter()
        ids, uv = detect(self, img)
        rec["aruco_ms"].append(1e3 * (time.perf_counter() - t))
        rec["aruco_ids"].append(np.asarray(ids))
        return ids, uv

    def step_rec(*a, **k):
        out = step(*a, **k)
        rec["slam_id"].append(out[0].slam_id[0].cpu().numpy())
        rec["slam_active"].append(out[0].slam_active[0].cpu().numpy())
        return out

    ArucoTracker.detect, run_euroc.step = detect_rec, step_rec
    try:
        r = run_euroc.main(args)
    finally:
        ArucoTracker.detect, run_euroc.step = detect, step
    r["files"] = files
    if rec["slam_id"]:
        r.update(rec, slam_id=np.stack(rec["slam_id"]), slam_active=np.stack(rec["slam_active"]))
    return r


def _replay_cpu_reference(tmp: str) -> dict:
    """The host path through the port on the CPU, in a ``CpuRefs`` worker."""
    r = _replay_run(tmp, "cpu", ["--config", f"{tmp}/aruco.yaml", "--max-frames", str(REPLAY_HOST_FRAMES)], "cpu")
    return {k: r[k] for k in ("p", "q", "counters", "aruco_ids", "slam_id", "slam_active")}


SWEEP_FRAMES = 47          # the whole scan (CP planes and SLAM landmarks from frame 20)
SWEEP_REF_FRAMES = 47      # frames of streams 0-1 against the port's CPU f64 run
SWEEP_PER_FRAME = {"M-PT": {"gram_reduce": 1, "kalman_downdate": 1},     # classic
                   "MS-PT": {"gram_reduce": 1, "kalman_downdate": 10},   # classic, SLAM update, 8 SLAM inits
                   "M-PL": {"gram_reduce": 1, "kalman_downdate": 4},     # classic, plane update, 2 plane inits
                   "MS-PL": {"gram_reduce": 1, "kalman_downdate": 13}}   # all of the above
SWEEP_SE = 3.0             # the port's mean within 3 combined standard errors of the JAX reference's
SWEEP_METRICS = ("rmse_pos", "rmse_ori_deg", "nees_pos", "nees_ori")


def drive_sweep(refs: CpuRefs):
    """Phase 10: the algorithm ladder (``scripts/run_sweep``) on the card.
    Builds the M-PL configuration's 30 s scene with the port's ``build_sim``
    and holds it to the committed one; then runs every variant (M-PT, MS-PT,
    M-PL, MS-PL) over 20 noise seeds of the 6 s room scan that the committed
    JAX reference (``data/sweep_jax_reference.npz``) was run on, as 20
    streams in f32 with the information form: the exact launch counts, CP
    planes and SLAM landmarks where the variant has them, every TUM file and
    the ov_eval table, streams 0-1 against the port's CPU f64 run of the
    same noisy instances (every counter equal, the pose within (1e-2 m,
    1e-3)), and each variant's mean RMSE and NEES within SWEEP_SE combined
    standard errors of JAX's over its 20 seeds. Returns (frames, launches,
    info) summed over the variants, ``info["finish"]()`` holding the card to
    the CPU references queued on ``refs``."""
    import io
    import math
    import tempfile

    import numpy as np

    from ov_plane_tpu_torch.eval.metrics import rmse_nees
    from ov_plane_tpu_torch.models.manager import StepOutput
    from ov_plane_tpu_torch.ops import kernels
    from ov_plane_tpu_torch.scripts import ov_eval, run_sweep
    from ov_plane_tpu_torch.sim import simulator
    from ov_plane_tpu_torch.utils.config import plane_config

    tag = "[sweep]"
    ref_path = Path(simulator.__file__).resolve().parents[1] / "data" / "sweep_jax_reference.npz"
    with np.load(ref_path) as z:
        ref = {k: z[k] for k in z.files}
    duration, seeds = float(ref["duration"]), int(ref["seeds"])
    if seeds != SWEEP_SEEDS:
        raise RuntimeError(f"the JAX reference has {seeds} seeds, not {SWEEP_SEEDS}")

    # 1. The M-PL configuration's scene, built on the card, against the committed one.
    cfg = plane_config()
    torch.cuda.synchronize()
    t = time.time()
    truth = simulator.build_sim(cfg, max_obs=cfg.tpu.max_obs_per_frame, device="cuda")
    torch.cuda.synchronize()
    build_s = time.time() - t
    worst = 0.0
    with np.load(simulator.PLANE_SCENE_PATH) as z:
        for k in z.files:
            a = getattr(truth, k)
            a = a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
            if a.shape != z[k].shape:
                raise RuntimeError(f"build_sim's {k} has the shape {a.shape}, the committed scene's {z[k].shape}")
            if np.issubdtype(z[k].dtype, np.integer):
                if not np.array_equal(a, z[k]):
                    raise RuntimeError(f"build_sim's {k} differs from the committed scene's")
            else:
                worst = max(worst, float(np.abs(a - z[k]).max()))
    print(f"{tag} build_sim of the M-PL scene on the card: {truth.cam_t.shape[0]} frames, {truth.imu_t.shape[0]} IMU "
          f"samples, {truth.feat_p.shape[0]} map points in {build_s:.2f} s; ids and plane ids equal to the committed "
          f"scene's, floats within {worst:.3e} (limit 1e-9)")
    if not worst < 1e-9:
        raise RuntimeError("build_sim departs from the committed M-PL scene by more than 1e-9")

    # 2-8. The ladder.
    truths, runs, info = {}, {}, {"build_sim_s": build_s, "scene_max_abs_err": worst, "variants": {}}
    launches_total = {"gram_reduce": 0, "kalman_downdate": 0}
    frames_total, stream_frames, wall_total = 0, 0, 0.0
    with tempfile.TemporaryDirectory(prefix="ovp_sweep_") as out:
        cpu_refs = {}
        for name, (max_slam, use_planes) in run_sweep.VARIANTS.items():
            vcfg = run_sweep.make_config(duration, "", max_slam, use_planes)
            if use_planes not in truths:
                truths[use_planes] = simulator.build_sim(vcfg, max_obs=vcfg.tpu.max_obs_per_frame, device="cuda")
            sim = run_sweep.noisy_scene(vcfg, seeds, "cuda", truths[use_planes])
            torch.cuda.synchronize()
            kernels.reset_launch_counts()
            t = time.time()
            run = run_sweep.run_variant(vcfg, seeds, "cuda", sim=sim, n_frames=SWEEP_FRAMES)
            torch.cuda.synchronize()
            wall = time.time() - t
            launches = {"gram_reduce": kernels.gram_reduce.launches,
                        "kalman_downdate": kernels.kalman_downdate.launches}
            F = run.t.shape[0]
            outs = run.outs
            print(f"{tag} {name}: D={run.eng.layout.dim}, {seeds}x{F} stream-frames in {wall:.3f} s: "
                  f"{seeds * F / wall:.2f} stream-frames/s; launches {launches}")
            for k, n in launches.items():
                if n != SWEEP_PER_FRAME[name][k] * F:
                    raise RuntimeError(f"{name}: {k} launched {n} times over {F} frames, "
                                       f"not {SWEEP_PER_FRAME[name][k]} per frame")
            for k, v in outs._asdict().items():
                if v.is_floating_point() and not torch.isfinite(v).all():
                    raise RuntimeError(f"{name}: non-finite output {k}")
            with_planes = int((outs.n_planes.max(dim=1).values > 0).sum())
            first_plane = (outs.n_planes.max(dim=0).values > 0).nonzero()
            with_slam = int((outs.n_slam.max(dim=1).values > 0).sum())
            print(f"{tag} {name}: streams with a CP plane in the state {with_planes} of {seeds} (first at frame "
                  f"{int(first_plane[0]) + 1 if first_plane.numel() else None}; "
                  f"JAX {int(ref[f'{name}/first_plane_frame'])}), "
                  f"plane constraint updates {int(outs.n_plane_constraints.sum())}; streams with SLAM landmarks "
                  f"{with_slam} (JAX's first at frame {int(ref[f'{name}/first_slam_frame'])}), landmark updates "
                  f"{int(outs.n_slam_update.sum())}")
            if use_planes and not (with_planes > 0 and int(outs.n_plane_constraints.sum()) > 0):
                raise RuntimeError(f"{name}: no CP plane entered the state, or no constraint update")
            if max_slam > 0 and not (with_slam > 0 and int(outs.n_slam_update.sum()) > 0):
                raise RuntimeError(f"{name}: no SLAM landmark entered the state, or no landmark update")
            if not use_planes and with_planes:
                raise RuntimeError(f"{name}: a plane entered the state of a planes-off variant")
            run_sweep.write_variant(out, name, "room_scan", run, truth=not runs)
            runs[name] = run

            # Streams 0-1 of the same noisy instances through the port on the CPU in f64, queued.
            cpu_refs[name] = refs.submit(f"sweep {name}", _cpu_reference, vcfg, _to_host(sim, 2), SWEEP_REF_FRAMES)

            # Statistics against the committed JAX reference.
            m = rmse_nees(outs.q.double(), outs.p.double(), outs.cov_diag_imu[..., 0:3].double(),
                          outs.cov_diag_imu[..., 3:6].double(), truths[use_planes].gt_q[1:F + 1].double(),
                          truths[use_planes].gt_p[1:F + 1].double())
            stats = {}
            # The committed statistics of the whole scan, or of its first F frames.
            prefix = name if F == sim.cam_t_imu.shape[0] - 1 else f"{name}/f{F}"
            for k in SWEEP_METRICS:
                port, jax_ref = m[k].cpu().numpy(), ref[f"{prefix}/{k}"]
                se = math.sqrt(port.var(ddof=1) / port.size + jax_ref.var(ddof=1) / jax_ref.size)
                z = abs(port.mean() - jax_ref.mean()) / se if se > 0 else 0.0
                stats[k] = dict(port=float(port.mean()), jax=float(jax_ref.mean()), se=se, z=z)
                print(f"{tag} {name}: {k} over {F} frames, mean card {port.mean():.5f} (std "
                      f"{port.std(ddof=1):.5f}) vs JAX {jax_ref.mean():.5f} (std {jax_ref.std(ddof=1):.5f}); "
                      f"combined standard error {se:.5f}, |difference| = {z:.2f} of it (limit {SWEEP_SE})")
            bad = [k for k, v in stats.items() if not v["z"] <= SWEEP_SE]
            if bad:
                raise RuntimeError(f"{name}: the mean {bad} departs from the JAX reference by more than "
                                   f"{SWEEP_SE} combined standard errors")
            info["variants"][name] = dict(D=run.eng.layout.dim, frames=F, wall_s=wall,
                                          stream_frames_per_s=seeds * F / wall, launches=launches,
                                          stats=stats, streams_with_planes=with_planes,
                                          streams_with_slam=with_slam)
            for k in launches_total:
                launches_total[k] += launches[k]
            frames_total += F
            stream_frames += seeds * F
            wall_total += wall

        # 3. Every TUM file and the ov_eval table.
        files = [Path(out) / "truths" / "room_scan.txt"] + [
            Path(out) / "algorithms" / v / "room_scan" / f"estimate_{k}.txt" for v in runs for k in range(seeds)]
        missing = [str(f) for f in files if not (f.exists() and f.stat().st_size > 0)]
        if missing:
            raise RuntimeError(f"TUM files missing or empty: {missing[:5]}")
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            ov_eval.main(["error_comparison", str(Path(out) / "truths"),
                          *(str(Path(out) / "algorithms" / v) for v in runs), "--device", "cuda"])
        table = buf.getvalue()
        print(f"{tag} {len(files)} TUM files written; the ov_eval error_comparison table:")
        print(table, end="")
        rows = {line.split()[0]: line.split()[1] for line in table.splitlines()[1:-1]}
        if sorted(rows) != sorted(runs) or any("±" not in c for c in rows.values()):
            raise RuntimeError(f"the ov_eval table lacks a variant or a value: {rows}")
    info.update(stream_frames_per_s=stream_frames / wall_total, ov_eval=rows)

    def finish():
        """The card's f32 runs against the CPU f64 references."""
        for name, (max_slam, use_planes) in run_sweep.VARIANTS.items():
            cpu = StepOutput(**{k: torch.from_numpy(v) for k, v in cpu_refs[name].result().items()})
            outs = runs[name].outs
            dp = (outs.p[:2, :SWEEP_REF_FRAMES].double().cpu() - cpu.p).abs().max().item()
            dq = (outs.q[:2, :SWEEP_REF_FRAMES].double().cpu() - cpu.q).abs().max().item()
            print(f"{tag} {name}: card f32 vs CPU f64, 2 streams x {SWEEP_REF_FRAMES} frames: max|dp|={dp:.3e} m "
                  f"max|dq|={dq:.3e}")
            agree = compare_counters(f"{tag} {name}", outs, cpu, SWEEP_REF_FRAMES,
                                     ("n_msckf_used", "n_bank", "n_clones")
                                     + (PLANE_COUNTERS if use_planes else ()) + (SLAM_COUNTERS if max_slam else ()))
            if min(agree.values()) < 1.0:
                raise RuntimeError(f"{name}: per-frame counters differ from the CPU f64 run's: {agree}")
            if not (dp < 1e-2 and dq < 1e-3):
                raise RuntimeError(f"{name}: the card's run disagrees with the CPU f64 run (limits (1e-2 m, 1e-3))")
            info["variants"][name]["card_vs_cpu"] = (dp, dq)

    info["finish"] = finish
    return frames_total, launches_total, info


# --------------------------------------------------------------------------- slice 8: calibration, ZUPT,
# plane RANSAC, ground truths and the vision Monte-Carlo (phases 12-15)

# The calibration run's depth and its intrinsics bound: test_calib.py's 0.6x
# holds for its one perturbation after the whole 187-frame scene; over the
# perturbations of seeds 1-16 the JAX package's 16-stream mean is 0.719 of
# its start at frame 60 and 0.695 at frame 120, the port's the same to three
# decimals (tests/test_torch_calib.py run as a script), so the card's mean is
# held to 0.8x at 60 frames (|dt| to 0.5x; 0.016 there).
CAL_FRAMES = 60
CAL_INTR_RATIO, CAL_DT_RATIO = 0.8, 0.5
MC_SEEDS, MC_FRAMES = 8, 48   # the vision Monte-Carlo's seeds and frames per arm (first plane near frame 42)
CAL_DT = 0.015          # the scene's camera-IMU offset (tests/test_calib_dt.py)
CAL_REF = 12            # frames of streams 0-1 against the port's CPU f64 run
CAL_PER_FRAME = {"gram_reduce": 1, "kalman_downdate": 1}      # the classic update
ZUPT_FRAMES = 3
ZUPT_FORMS = ("standard", "integrated_accel", "explicit_zero_motion")
# The ZUPT's own downdate (6·(W−1) rows), the classic update's (QR-compressed,
# M = D), and the explicit formulation's 9-row update.
ZUPT_PER_FRAME = {"standard": {"gram_reduce": 0, "kalman_downdate": 2},
                  "integrated_accel": {"gram_reduce": 0, "kalman_downdate": 2},
                  "explicit_zero_motion": {"gram_reduce": 0, "kalman_downdate": 3}}
RANSAC_FRAMES = 22      # the M-PL scene's first plane enters the state at frame 20
MC_ARGS = ["--scene", "tabletop", "--densities", "sparse", "--seeds", str(MC_SEEDS), "--max-frames",
           str(MC_FRAMES)]
MC_REF = MC_FRAMES      # frames of the ON arm's streams 0-1 against the port's CPU run
MC_PLANES_MIN_EQUAL = 44  # of the 48 frames, plane counters of streams 0-1 equal to the CPU run's (tabletop: 44 of 46)
KLT_TRACE_LIMIT = 1e-5  # px: frame 2's tracked points, card against CPU on identical inputs
MC_PER_FRAME = {"ON": {"gram_reduce": 1, "kalman_downdate": 12}, "OFF": {"gram_reduce": 1, "kalman_downdate": 1}}


def calib_config(info: bool = True):
    """tests/test_torch_calib.py's configuration (tests/test_calib.py:17-30
    with all three calibration blocks on), with the information form."""
    from ov_plane_tpu_torch.utils.config import sim_config

    cfg = sim_config()
    cfg.sim.traj_duration = 20.0
    cfg.state.max_slam_features = 0
    cfg.state.use_plane_constraint = False
    cfg.state.use_plane_slam_feats = False
    cfg.state.do_calib_camera_pose = True
    cfg.state.do_calib_camera_intrinsics = True
    cfg.state.do_calib_camera_timeoffset = True
    cfg.num_pts = 50
    cfg.num_pts_plane = 0
    cfg.tpu.max_features = 160
    cfg.tpu.max_obs_per_frame = 80
    cfg.tpu.max_msckf_update = 40
    cfg.tpu.use_info_compression = info
    return cfg


def _to_host(sim, streams: int) -> dict:
    """A noisy SimData as numpy arrays, its noisy fields cut to the first streams."""
    from ov_plane_tpu_torch import convert

    return {k: ((v[:streams] if k in convert.NOISY_FIELDS else v).cpu().numpy() if isinstance(v, torch.Tensor)
                else v) for k, v in sim._asdict().items()}


def _from_host(arrays: dict, dtype=torch.float64):
    from ov_plane_tpu_torch.sim.simulator import SimData

    return SimData(**{k: (torch.from_numpy(v).to(dtype) if v.dtype.kind == "f" else torch.from_numpy(v))
                      if k != "imu_window_start" and v is not None else v for k, v in arrays.items()})


def _calib_state(eng, cfg_est, sim, calib, b, device, dtype):
    """A fresh state of b streams whose calibration starts at ``calib``
    (cam_zeta [B, 8], calib_cam [B, 7]) and dt = 0."""
    st, bank = _fresh(eng, cfg_est, sim._replace(cam_t_imu=sim.cam_t), b, device, dtype)
    zeta, ext = (torch.as_tensor(x[:b], dtype=dtype, device=device) for x in calib)
    return st.replace(cam_zeta=zeta, calib_cam=ext), bank


def _calib_errors(st, cfg):
    """Per stream: the intrinsics error ‖(fx, fy, cx, cy) − truth‖ and |dt − truth|."""
    zt = torch.as_tensor(cfg.cam_intrinsics[:4], dtype=torch.float64)
    return (torch.linalg.vector_norm(st.cam_zeta[:, :4].double().cpu() - zt, dim=1),
            (st.calib_dt.double().cpu() - CAL_DT).abs())


def _calib_cpu_reference(cfg, cfg_est, arrays: dict, n_frames: int, calib) -> dict:
    """Streams of the calibration scene (numpy ``arrays``) through the port
    on the CPU in f64, frame by frame from their perturbed calibrations: the
    outputs and the per-frame calibration errors. Runs in a ``CpuRefs`` worker."""
    from ov_plane_tpu_torch.models.manager import VioEngine, run_sequence

    sim = _from_host(arrays)
    eng = VioEngine.from_config(cfg_est, device="cpu")
    st, bk = _calib_state(eng, cfg_est, sim, calib, sim.imu_w.shape[0], "cpu", torch.float64)
    outs, errs = [], []
    for i in range(1, n_frames + 1):
        st, bk, out = run_sequence(eng, st, bk, sim, imu_window=cfg_est.tpu.max_imu_per_frame, n_frames=1, start=i)
        outs.append(out)
        errs.append(torch.stack(_calib_errors(st, cfg), dim=1))
    res = {k: torch.cat([getattr(o, k) for o in outs], dim=1).numpy() for k in outs[0]._fields}
    res["calib_err"] = torch.stack(errs, dim=1).numpy()          # [b, T, 2]
    return res


def drive_calib(refs: CpuRefs):
    """Phase 12: online calibration (time offset, extrinsics, intrinsics) on
    CAL_BATCH streams in f32 with the information form; returns (n_frames,
    launches, info), ``info["finish"]()`` holding the card to the CPU
    reference queued on ``refs``."""
    import copy

    import numpy as np

    from ov_plane_tpu_torch.models.manager import StepOutput, VioEngine, run_sequence
    from ov_plane_tpu_torch.ops import kernels
    from ov_plane_tpu_torch.sim import simulator

    tag = "[calib]"
    cfg = calib_config()
    cfg.calib_camimu_dt = CAL_DT
    t = time.time()
    truth = simulator.build_sim(cfg, max_obs=cfg.tpu.max_obs_per_frame, device="cuda")
    sim = simulator.apply_noise(truth, simulator.noise_params(cfg), CAL_BATCH,
                                torch.Generator(device="cuda").manual_seed(SEED + 5))
    sim = sim._replace(**{k: v.float() for k, v in sim._asdict().items()
                          if isinstance(v, torch.Tensor) and v.is_floating_point()})
    cfg_est = copy.deepcopy(cfg)
    cfg_est.calib_camimu_dt = 0.0
    perturbed = [simulator.perturb_calibration(cfg, seed=1 + b) for b in range(CAL_BATCH)]
    calib = (np.stack([z for _, z, _ in perturbed]), np.stack([e for _, _, e in perturbed]))
    eng = VioEngine.from_config(cfg_est, device="cuda")
    n_frames = CAL_FRAMES
    print(f"{tag} scene {truth.cam_t.shape[0]} frames built on the card with a {1e3 * CAL_DT:.0f} ms offset; "
          f"D={eng.layout.dim}; B={CAL_BATCH}; f32; {n_frames} frames; set-up {time.time() - t:.2f} s")
    job = refs.submit("calib", _calib_cpu_reference, cfg, cfg_est, _to_host(sim, 2), n_frames, calib)

    st, bank = _calib_state(eng, cfg_est, sim, calib, CAL_BATCH, "cuda", torch.float32)
    e0, d0 = _calib_errors(st, cfg)
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t = time.time()
    st, bank, outs = run_sequence(eng, st, bank, sim, imu_window=cfg.tpu.max_imu_per_frame, n_frames=n_frames)
    torch.cuda.synchronize()
    wall = time.time() - t
    launches = {"gram_reduce": kernels.gram_reduce.launches, "kalman_downdate": kernels.kalman_downdate.launches}
    print(f"{tag} {CAL_BATCH}x{n_frames} stream-frames in {wall:.3f} s: {CAL_BATCH * n_frames / wall:.2f} "
          f"stream-frames/s; launches {launches}")
    for k, n in launches.items():
        if n != CAL_PER_FRAME[k] * n_frames:
            raise RuntimeError(f"{k} launched {n} times over {n_frames} frames, not {CAL_PER_FRAME[k]} per frame")
    if not (torch.isfinite(st.cov).all() and torch.isfinite(st.imu).all() and torch.isfinite(outs.p).all()):
        raise RuntimeError("non-finite calibration state")
    e1, d1 = _calib_errors(st, cfg)
    ri, rd = float(e1.mean() / e0.mean()), float(d1.mean() / d0.mean())
    print(f"{tag} mean over {CAL_BATCH} streams: intrinsics error {e0.mean():.4f} -> {e1.mean():.4f} px "
          f"({ri:.3f} of its start, limit {CAL_INTR_RATIO}), |dt error| {1e3 * d0.mean():.3f} -> "
          f"{1e3 * d1.mean():.3f} ms ({rd:.3f}, limit {CAL_DT_RATIO}); extrinsic position error at the end "
          f"{(st.calib_cam[:, 4:7].double().cpu() - torch.tensor(cfg.cam_extrinsics[4:7])).norm(dim=1).max():.4f} m "
          f"at most")
    if not (ri < CAL_INTR_RATIO and rd < CAL_DT_RATIO):
        raise RuntimeError(f"the calibration errors did not fall below {CAL_INTR_RATIO}x (intrinsics) and "
                           f"{CAL_DT_RATIO}x (dt) their starts")

    info = dict(stream_frames_per_s=CAL_BATCH * n_frames / wall, wall_s=wall, n_frames=n_frames,
                intrinsics_ratio=ri, dt_ratio=rd)

    def finish():
        ref = job.result()
        cpu = StepOutput(**{k: torch.from_numpy(v) for k, v in ref.items() if k != "calib_err"})
        err = ref["calib_err"]                                       # [2, T, 2]
        met = (err[0, :, 0] < 0.6 * float(e0[0])) & (err[0, :, 1] < CAL_DT_RATIO * CAL_DT)
        first = int(np.argmax(met)) + 1 if met.any() else None
        print(f"{tag} the CPU f64 run of stream 0 meets test_calib.py's 0.6x and {CAL_DT_RATIO}x first at frame "
              f"{first} of {n_frames}; its ratios at the end {err[0, -1, 0] / float(e0[0]):.3f} and "
              f"{err[0, -1, 1] / CAL_DT:.3f}")
        info["stream0_first_frame"] = first
        info["card_vs_cpu"] = _hold_to_cpu(tag, outs, cpu, CAL_REF, ("n_msckf_used", "n_bank", "n_clones"))

    info["finish"] = finish
    return n_frames, launches, info


def _hold_to_cpu(tag, outs, cpu, n_ref, names, limits=(1e-2, 1e-3)):
    """Streams 0-1 of the card's f32 run against the CPU f64 run: every
    counter equal on every stream-frame, the pose within ``limits``."""
    cpu = cpu._replace(**{k: v[:, :n_ref] for k, v in cpu._asdict().items()})
    dp = (outs.p[:2, :n_ref].double().cpu() - cpu.p).abs().max().item()
    dq = (outs.q[:2, :n_ref].double().cpu() - cpu.q).abs().max().item()
    print(f"{tag} card f32 vs CPU f64, 2 streams x {n_ref} frames: max|dp|={dp:.3e} m max|dq|={dq:.3e}")
    agree = compare_counters(tag, outs, cpu, n_ref, names)
    if min(agree.values()) < 1.0:
        raise RuntimeError(f"{tag} per-frame counters differ from the CPU f64 run's: {agree}")
    if not (dp < limits[0] and dq < limits[1]):
        raise RuntimeError(f"{tag} the card's run disagrees with the CPU f64 run (limits {limits})")
    return dp, dq


def zupt_config(form: str):
    """tests/test_updaters.py's in-step configuration (a ZUPT on every frame,
    the disparity override off) at the default IMU window (W = 64)."""
    from ov_plane_tpu_torch.utils.config import sim_config

    cfg = sim_config()
    cfg.try_zupt = True
    cfg.zupt_options.chi2_multipler = 1.0
    cfg.zupt_max_disparity = 0.0
    cfg.zupt_integrated_accel = form == "integrated_accel"
    if form == "explicit_zero_motion":
        cfg.zupt_only_at_beginning = False
        cfg.zupt_explicit_zero_motion = True
    cfg.state.max_slam_features = 0
    cfg.state.use_plane_constraint = False
    cfg.state.use_plane_slam_feats = False
    cfg.state.do_calib_camera_pose = False
    cfg.state.do_calib_camera_intrinsics = False
    cfg.state.do_calib_camera_timeoffset = False
    cfg.tpu.max_features = 32
    cfg.tpu.max_obs_per_frame = 16
    cfg.tpu.max_msckf_update = 8
    return cfg


def _zupt_frames(cfg, form, rng, q_now, k):
    """Frame k's IMU windows of the ZUPT streams: the first half stationary
    (measuring R_GtoI·g, a little noise), the second rotating at 0.5 rad/s;
    on the explicit formulation's first frame every stream rotates."""
    import numpy as np

    from ov_plane_tpu_torch.ops.quat import quat_2_rot

    B, W, g = CAL_BATCH, cfg.tpu.max_imu_per_frame, cfg.gravity_mag
    ts = np.tile(np.linspace(k * 0.1, (k + 1) * 0.1, W), (B, 1))
    a_body = (quat_2_rot(torch.as_tensor(q_now)) @ torch.tensor([0.0, 0.0, g], dtype=torch.float64)).numpy()
    w = np.tile([0.5, 0.0, 0.0], (B, W, 1))
    a = np.repeat(a_body[:, None], W, axis=1)
    still = np.arange(B) < B // 2
    if not (form == "explicit_zero_motion" and k == 0):
        w[still] = 1e-5 * rng.normal(size=(int(still.sum()), W, 3))
        a[still] += 1e-4 * rng.normal(size=(int(still.sum()), W, 3))
    return ts, w, a


def _zupt_run(form: str, device, dtype, inputs=None):
    """ZUPT_FRAMES frames of the ZUPT streams through ``manager.step``.
    Returns (per-frame (t, num_clones, has_moved) [T, B, 3], the inputs,
    the final state, launches)."""
    import numpy as np

    from ov_plane_tpu_torch.models.feature_bank import FeatureBank
    from ov_plane_tpu_torch.models.manager import FrameData, VioEngine, init_state_with_gt, step
    from ov_plane_tpu_torch.ops import kernels

    cfg = zupt_config(form)
    eng = VioEngine.from_config(cfg, device=device)
    B = CAL_BATCH
    z = torch.zeros(B, 3, dtype=torch.float64)
    st = init_state_with_gt(eng, cfg, t0=torch.zeros(B), q0=torch.tensor([[0.0, 0.0, 0.0, 1.0]]).expand(B, 4),
                            p0=z, v0=z, bg0=z, ba0=z, dtype=dtype, device=device)
    bank = FeatureBank.create(cfg.tpu.max_features, eng.layout.max_clones, B, dtype, device)
    O = cfg.tpu.max_obs_per_frame
    rng = np.random.default_rng(11)
    made, rows = [], []
    q_now = np.tile([0.0, 0.0, 0.0, 1.0], (B, 1))
    kernels.reset_launch_counts()
    for k in range(ZUPT_FRAMES):
        ts, w, a = inputs[k] if inputs is not None else _zupt_frames(cfg, form, rng, q_now, k)
        made.append((ts, w, a))
        as_t = lambda x: torch.as_tensor(x, dtype=dtype, device=device)  # noqa: E731
        frame = FrameData(imu_t=as_t(ts), imu_w=as_t(w), imu_a=as_t(a), t_new=as_t(np.full(B, (k + 1) * 0.1)),
                          obs_id=torch.full((B, O), -1, dtype=torch.int32, device=device),
                          obs_uv=torch.zeros(B, O, 2, dtype=dtype, device=device),
                          obs_plane=torch.full((B, O), -1, dtype=torch.int32, device=device))
        st, bank, _ = step(eng, st, bank, frame)
        rows.append(torch.stack([st.t.double(), st.num_clones.double(), st.has_moved.double()], dim=1).cpu())
        q_now = st.imu[:, 0:4].double().cpu().numpy()
    launches = {"gram_reduce": kernels.gram_reduce.launches, "kalman_downdate": kernels.kalman_downdate.launches}
    return torch.stack(rows).numpy(), made, st, launches


def drive_zupt():
    """Phase 13: each ZUPT formulation on CAL_BATCH streams (half stationary,
    half rotating) through ``manager.step`` in f32; returns (n_frames,
    launches, info)."""
    import numpy as np

    tag = "[zupt]"
    launches_total = {"gram_reduce": 0, "kalman_downdate": 0}
    info = {"forms": {}}
    B, wall_total = CAL_BATCH, 0.0
    for form in ZUPT_FORMS:
        _zupt_run(form, "cuda", torch.float32)            # warm-up
        torch.cuda.synchronize()
        t = time.time()
        card, inputs, st, launches = _zupt_run(form, "cuda", torch.float32)
        torch.cuda.synchronize()
        wall = time.time() - t
        cpu, _, cst, _ = _zupt_run(form, "cpu", torch.float64, inputs)
        # What the JAX package gives (tests/test_updaters.py): a stationary
        # stream's ZUPT is accepted (time advances, no clone); a rotating one
        # is rejected and the frame clones. The explicit formulation clones on
        # its first (rotating) frame, then holds one clone.
        still = np.arange(B) < B // 2
        clones = np.where(still, 0, np.arange(1, ZUPT_FRAMES + 1)[:, None])
        if form == "explicit_zero_motion":
            clones = np.where(still, 1, np.arange(1, ZUPT_FRAMES + 1)[:, None])
        moved = np.broadcast_to(~still if form != "explicit_zero_motion" else np.ones(B, bool), (ZUPT_FRAMES, B))
        t_ok = np.allclose(card[..., 0], np.arange(1, ZUPT_FRAMES + 1)[:, None] * 0.1, atol=1e-6)
        accept = np.diff(np.concatenate([np.zeros((1, B)), card[..., 1]]), axis=0) == 0
        print(f"{tag} {form}: {B}x{ZUPT_FRAMES} stream-frames in {wall:.3f} s; launches {launches}; accepted per "
              f"frame {accept.sum(axis=1).tolist()} of {B}; clones at the end {card[-1, :, 1].astype(int).tolist()}")
        if not (t_ok and np.array_equal(card[..., 1], clones) and np.array_equal(card[..., 2] > 0, moved)):
            raise RuntimeError(f"{form}: time, clone counts or has_moved are not what the JAX package gives")
        if not (np.array_equal(card[..., 1:], cpu[..., 1:]) and np.allclose(card[..., 0], cpu[..., 0], atol=1e-6)):
            raise RuntimeError(f"{form}: the card's ZUPT decisions differ from the CPU f64 run's")
        dv = (st.imu.double().cpu() - cst.imu).abs().max().item()
        print(f"{tag} {form}: accept flags, clone counts and times equal to the CPU f64 run's; max|Δimu| {dv:.3e}")
        if not (torch.isfinite(st.cov).all() and dv < 1e-3):
            raise RuntimeError(f"{form}: non-finite state or the card's state departs from the CPU f64 run's")
        for k, n in launches.items():
            if n != ZUPT_PER_FRAME[form][k] * ZUPT_FRAMES:
                raise RuntimeError(f"{form}: {k} launched {n} times over {ZUPT_FRAMES} frames, "
                                   f"not {ZUPT_PER_FRAME[form][k]} per frame")
            launches_total[k] += n
        info["forms"][form] = dict(wall_s=wall, launches=launches, imu_err=dv)
        wall_total += wall
    info.update(stream_frames_per_s=B * ZUPT_FRAMES * len(ZUPT_FORMS) / wall_total, wall_s=wall_total)
    return ZUPT_FRAMES * len(ZUPT_FORMS), launches_total, info


def drive_ransac_gt(refs: CpuRefs):
    """Phase 14: M-PL (``plane_config``) on CAL_BATCH streams of the scene that
    ``build_sim`` makes on the card, 22 frames each in f32: with plane RANSAC,
    then with ground-truth injection. Returns {"ransac": ..., "gt": ...},
    each (n_frames, launches, info) with ``info["finish"]()`` holding the
    card to its CPU reference queued on ``refs``."""
    from ov_plane_tpu_torch.models.manager import VioEngine, run_sequence
    from ov_plane_tpu_torch.ops import kernels
    from ov_plane_tpu_torch.sim import simulator
    from ov_plane_tpu_torch.utils.config import plane_config

    cfg0 = plane_config()
    truth = simulator.build_sim(cfg0, max_obs=cfg0.tpu.max_obs_per_frame, device="cuda")
    sim = simulator.apply_noise(truth, simulator.noise_params(cfg0), CAL_BATCH,
                                torch.Generator(device="cuda").manual_seed(SEED + 6))
    sim = sim._replace(**{k: v.float() for k, v in sim._asdict().items()
                          if isinstance(v, torch.Tensor) and v.is_floating_point()})
    results = {}
    for name, field in (("ransac", "use_plane_ransac"), ("gt", "use_groundtruths")):
        tag = f"[{name}]"
        cfg = plane_config()
        setattr(cfg.state, field, True)
        eng = VioEngine.from_config(cfg, device="cuda")
        n_ref = RANSAC_FRAMES if name == "ransac" else CAL_REF
        job = refs.submit(name, _cpu_reference, cfg, _to_host(sim, 2), n_ref)
        st, bank = _fresh(eng, cfg, sim, CAL_BATCH, "cuda", torch.float32)
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        t = time.time()
        st, bank, outs = run_sequence(eng, st, bank, sim, imu_window=cfg.tpu.max_imu_per_frame,
                                      n_frames=RANSAC_FRAMES)
        torch.cuda.synchronize()
        wall = time.time() - t
        launches = {"gram_reduce": kernels.gram_reduce.launches, "kalman_downdate": kernels.kalman_downdate.launches}
        per = PATHS[1].per_frame
        print(f"{tag} D={eng.layout.dim}; {CAL_BATCH}x{RANSAC_FRAMES} stream-frames in {wall:.3f} s: "
              f"{CAL_BATCH * RANSAC_FRAMES / wall:.2f} stream-frames/s; launches {launches}; streams with a CP plane "
              f"at frame {RANSAC_FRAMES} {int((outs.n_planes[:, -1] > 0).sum())} of {CAL_BATCH}; constraint "
              f"updates {int(outs.n_plane_constraints.sum())}")
        for k, n in launches.items():
            if n != per[k] * RANSAC_FRAMES:
                raise RuntimeError(f"{tag} {k} launched {n} times over {RANSAC_FRAMES} frames, not {per[k]} per frame")
        if not (torch.isfinite(st.cov).all() and torch.isfinite(outs.p).all()):
            raise RuntimeError(f"{tag} non-finite state")
        info = dict(stream_frames_per_s=CAL_BATCH * RANSAC_FRAMES / wall, wall_s=wall, n_frames=RANSAC_FRAMES)
        info["finish"] = _ransac_gt_finish(tag, name, job, outs, info)
        results[name] = (RANSAC_FRAMES, launches, info)
    return results


def _ransac_gt_finish(tag, name, job, outs, info):
    """Phase 14's comparison of one run with its CPU f64 reference."""
    from ov_plane_tpu_torch.models.manager import StepOutput

    def finish():
        cpu = StepOutput(**{k: torch.from_numpy(v) for k, v in job.result().items()})
        info["card_vs_cpu"] = _hold_to_cpu(tag, outs, cpu, CAL_REF,
                                           ("n_msckf_used", "n_bank", "n_clones") + PLANE_COUNTERS)
        if name == "ransac":
            cpu_planes = cpu.n_planes[:, -1] > 0
            card_planes = outs.n_planes[:2, -1].cpu() > 0
            print(f"{tag} CP planes in the state at frame {RANSAC_FRAMES} on streams 0-1: card "
                  f"{card_planes.tolist()}, CPU f64 {cpu_planes.tolist()}")
            if not cpu_planes.any() or (cpu_planes & ~card_planes).any():
                raise RuntimeError(f"{tag} no CP plane on a stream where the CPU f64 run has one")

    return finish


MC_TRACE = 12           # frames of the ON arm whose frontend stages are recorded for the stage trace
TRACE_STAGES = ("flow prior", "KLT", "RANSAC", "FAST", "triangulation")


@contextlib.contextmanager
def _stage_recorder(rec: list, n: int):
    """Records streams 0-1's frontend stage outputs of the first n frames of
    ``fused_vision_step`` into ``rec`` (one dict per frame, as numpy): the
    KLT's mask and flow prior, its points and status, the RANSAC inliers,
    the FAST detections and the whole-track triangulations. The stage
    functions are wrapped for the run and restored after it."""
    from ov_plane_tpu_torch.frontend import fast, fused, klt

    orig = (klt.track, fused.gyro_ransac, fast.detect_grid, fused._solve_tracks)

    def host(*xs):
        return tuple(x[:2].detach().cpu().numpy() for x in xs)

    def track(prep0, prep1, pts0, mask, opts, init_flow=None):
        out = orig[0](prep0, prep1, pts0, mask, opts, init_flow)
        if len(rec) < n:
            rec.append({"flow prior": host(mask, init_flow), "KLT": host(*out)})
        return out

    def stage(name, fn, pick):
        def wrapped(*a, **k):
            out = fn(*a, **k)
            if rec and name not in rec[-1]:
                rec[-1][name] = host(*pick(out))
                if name == "RANSAC":          # its inputs too: (uvn1, uvn2, mask, R_1to2), options
                    rec[-1]["RANSAC inputs"] = host(*a[:4]) + (a[4],)
            return out
        return wrapped

    klt.track = track
    fused.gyro_ransac = stage("RANSAC", orig[1], lambda out: out[:1])
    fast.detect_grid = stage("FAST", orig[2], lambda out: out)
    fused._solve_tracks = stage("triangulation", orig[3], lambda out: out)
    try:
        yield rec
    finally:
        klt.track, fused.gyro_ransac, fast.detect_grid, fused._solve_tracks = orig


def _mc_arm(cfg, sim, images, dtype, device, sampler: str, wire: str, record: int = 0) -> dict:
    """The planes-ON arm of ``run_mc_vision.run_variant`` over given noisy
    images [n, b, H, W] (numpy) of the first b streams of ``sim``, with the
    driver's sampler and wire as given ('auto' resolves against the first
    image, as the script's driver does). Returns per frame the track ids
    and valid flags [n, b, cap], p [n, b, 3], q [n, b, 4] and the nine
    pulled counters [n, b, 9] as numpy, the driver's KLT options and tracker
    state after the last frame, and (``record`` > 0) streams 0-1's frontend
    stages over the first ``record`` frames (``_stage_recorder``)."""
    import copy

    import numpy as np

    from ov_plane_tpu_torch.models.manager import VioEngine

    cfg = copy.deepcopy(cfg)
    cfg.state.use_plane_constraint = True
    cfg.state.use_plane_slam_feats = True
    b = images.shape[1]
    host = lambda x: x.detach().double().cpu().numpy()  # noqa: E731
    run = VisionRun(cfg, sim, (host(sim.imu_t), host(sim.imu_w[:b]), host(sim.imu_a[:b]), host(sim.cam_t_imu)),
                    sim.gt_bg_cam[:b, 0], sim.gt_ba_cam[:b, 0], None, sampler, wire)
    drv, st, bank, fev = vision_driver(run, VioEngine.from_config(cfg, device=device), b, device, dtype)
    rows = {"ids": [], "valid": [], "p": [], "q": []}
    counters, stages = [], []
    with _stage_recorder(stages, record) if record else contextlib.nullcontext():
        for i in range(1, len(images) + 1):
            st, bank, fev, out = drv.step_batch(st, bank, fev, drv.stage_image(images[i - 1]),
                                                *_imu_window(run, i))
            for k, v in (("ids", fev.ids), ("valid", fev.valid), ("p", out.p), ("q", out.q)):
                rows[k].append(v)
            if i > 1:                 # the pipelined pull read in step i is frame i - 1's
                counters.append(drv.last_counters.copy())
    drv.flush_stream()
    counters.append(drv.last_counters.copy())
    drv.close()
    res = {k: torch.stack(v).cpu().numpy() for k, v in rows.items()}
    res["p"], res["q"] = res["p"].astype("float64"), res["q"].astype("float64")
    return dict(res, counters=np.stack(counters), stages=stages, klt=drv.vopts.klt, fev=fev)


def _mc_cpu_reference(arrays: dict, images, sampler: str, wire: str, dtype=torch.float64, record: int = 0) -> dict:
    """Streams 0-1 of the vision Monte-Carlo's ON arm through the port on the
    CPU (frontend f32, filter in ``dtype``), with the card's IMU draws, the
    script's image noise and the driver's sampler and wire as given, the
    stages of its first ``record`` frames recorded; runs in a ``CpuRefs``
    worker."""
    from ov_plane_tpu_torch.scripts import run_mc_vision as mc

    cfg, _ = mc.scene_config("tabletop", False)
    res = _mc_arm(cfg, _from_host(arrays), images, dtype, "cpu", sampler, wire, record)
    return {k: v for k, v in res.items() if k in ("ids", "valid", "p", "q", "counters", "stages")}


def _mc_agreement(tag, what, card, ref, n_ref, cpu_filter="f64"):
    """Streams 0-1 of the ON arm over n_ref frames, card against the CPU
    reference (dicts or runs of run_mc_vision): the share of slot-frames
    with equal track ids and valid flags, the pose's largest difference, and
    the frames on which the plane counters (inits, constraint updates,
    planes in the state) of both streams are equal."""
    import numpy as np

    card = card._asdict() if hasattr(card, "_asdict") else card
    same = (card["ids"][:n_ref, :2] == ref["ids"]) & (card["valid"][:n_ref, :2] == ref["valid"])
    dp = float(np.abs(card["p"][:n_ref, :2] - ref["p"]).max())
    dq = float(np.abs(card["q"][:n_ref, :2] - ref["q"]).max())
    first = int(np.argmin(same.reshape(n_ref, -1).all(axis=1))) + 1 if not same.all() else None
    plane_card, plane_cpu = card["counters"][:n_ref, :2, 0:3], ref["counters"][..., 0:3]
    planes_equal = int((plane_card == plane_cpu).all(axis=(1, 2)).sum())

    def first_plane(c):
        return [int(np.argmax(c[:, k, 2] > 0)) + 1 if (c[:, k, 2] > 0).any() else None for k in range(2)]

    print(f"{tag} {what}, card f32 vs CPU (frontend f32, filter {cpu_filter}), 2 streams x {n_ref} frames: ids "
          f"and valid equal on {int(same.sum())} of {same.size} slot-frames ({100 * same.mean():.2f}%; first frame "
          f"with a difference {first}); plane counters (inits, constraints, planes) equal on {planes_equal} of "
          f"{n_ref} frames (card sums {plane_card.sum(axis=(0, 1)).astype(int).tolist()}, CPU "
          f"{plane_cpu.sum(axis=(0, 1)).astype(int).tolist()}; first plane in the state card "
          f"{first_plane(plane_card)}, CPU {first_plane(plane_cpu)}); max|dp|={dp:.3e} m max|dq|={dq:.3e}")
    return float(same.mean()), dp, dq, planes_equal


def _klt_trace(tag, cfg, sim, images):
    """Frame 2's KLT stage of the ON arm on identical inputs on the card and
    on the CPU, under the exact sampler and the script's own (``mm_bf16``).
    The tracker state after frame 1 (its points and mask) comes from the CPU
    run, the images are the script's frames 1-2 of streams 0-1 (the scene's
    histogram method is NONE), the flow prior is zero; prints the pyramids'
    and the tracked points' largest difference and the track status flips,
    and returns {sampler: (status flips, max|Δp1| px where both track)}.
    The exact sampler sums in f32 in each device's order (about 4e-5 px
    apart); ``mm_bf16`` in f64 (equal bit for bit)."""
    from ov_plane_tpu_torch.frontend import klt as fklt

    one = _mc_arm(cfg, _from_host(_to_host(sim, 2)), images[:1, :2], torch.float64, "cpu", "mm", "f32")
    opts, fev = one["klt"], one["fev"]
    mask = fev.valid & fev.has_prev[:, None]
    res, out = {}, {}
    for sampler in ("mm", "mm_bf16"):
        for dev in ("cuda", "cpu"):
            pyr = [fklt.prepare_pyramid(fklt.build_pyramid(torch.from_numpy(images[i, :2]).to(dev), opts.levels),
                                        opts.window) for i in (0, 1)]
            p1, ok = fklt.track(pyr[0], pyr[1], fev.uv.to(dev), mask.to(dev), opts._replace(sampler=sampler))
            res[sampler, dev] = (pyr[1].padded, p1.cpu(), ok.cpu())
        (pyr_g, p_g, ok_g), (pyr_c, p_c, ok_c) = res[sampler, "cuda"], res[sampler, "cpu"]
        dpyr = max(float((a.cpu() - b).abs().max()) for a, b in zip(pyr_g, pyr_c))
        both = ok_g & ok_c
        dp1 = float((p_g - p_c).norm(dim=-1)[both].max()) if both.any() else 0.0
        flips = int((ok_g != ok_c).sum())
        out[sampler] = (flips, dp1)
        print(f"{tag} frame-2 KLT on identical inputs, {sampler}: pyramids max|Δ| {dpyr:.3e}; of "
              f"{int(mask.sum())} tracked points, status differs on {flips} (card ok "
              f"{int(ok_g.sum())}, CPU ok {int(ok_c.sum())}); max|Δp1| {dp1:.3e} px where both are ok"
              + (f" (limit {KLT_TRACE_LIMIT})" if sampler == "mm_bf16" else ""))
    return out


def _stage_trace(tag, card: list, cpu: list, part: int | None, what: str = "card vs CPU"):
    """Streams 0-1's recorded frontend stages (``_stage_recorder``) of two
    runs (``what``), frame by frame up to ``part`` (the first frame whose
    tracks differ, 1-based): the input tracks, the flow prior, the KLT's
    points and status, the RANSAC inliers, the FAST corners and the
    triangulations. Prints each frame and returns (frame, stage) of the
    first decision that differs, or None within the recorded frames."""
    import numpy as np

    def dmax(a, b, m):
        return float(np.abs(a - b)[m].max()) if m.any() else 0.0

    for k in range(min(len(card), len(cpu), part or len(card))):
        a, b = card[k], cpu[k]
        (m_a, f_a), (m_b, f_b) = a["flow prior"], b["flow prior"]
        (p_a, ok_a), (p_b, ok_b) = a["KLT"], b["KLT"]
        (n_a, nok_a), (n_b, nok_b) = a["FAST"], b["FAST"]
        (t_a, tok_a), (t_b, tok_b) = a["triangulation"], b["triangulation"]
        m, both = m_a & m_b, ok_a & ok_b
        flips = {"flow prior": int((m_a != m_b).sum()), "KLT": int((ok_a != ok_b)[m].sum()),
                 "RANSAC": int((a["RANSAC"][0] != b["RANSAC"][0])[both].sum()),
                 "FAST": int((nok_a != nok_b).sum()), "triangulation": int((tok_a != tok_b).sum())}
        print(f"{tag} stage trace, frame {k + 1}, {what}: input tracks differ on {flips['flow prior']} slots; "
              f"flow prior max|Δ| {dmax(f_a, f_b, m):.3e} px; KLT max|Δp1| {dmax(p_a, p_b, both):.3e} px, "
              f"status flips {flips['KLT']}; RANSAC inlier flips {flips['RANSAC']}; FAST corner flips "
              f"{flips['FAST']} (max|Δuv| {dmax(n_a, n_b, nok_a & nok_b):.3e} px); triangulation flips "
              f"{flips['triangulation']} (max|Δp3| {dmax(t_a, t_b, tok_a & tok_b):.3e} m)")
        first = next((name for name in TRACE_STAGES if flips[name]), None)
        if first is not None:
            return k + 1, first
    return None


def _ransac_on_both(tag, frame: int, rec: dict):
    """The RANSAC of one recorded frame (streams 0-1) rerun on its recorded
    inputs on the card and on the CPU; prints the inlier flips."""
    from ov_plane_tpu_torch.frontend.ransac import gyro_ransac

    *args, opts = rec["RANSAC inputs"]
    inl = {dev: gyro_ransac(*(torch.from_numpy(a).to(dev) for a in args), opts)[0].cpu() for dev in ("cuda", "cpu")}
    flips = int((inl["cuda"] != inl["cpu"]).sum())
    print(f"{tag} frame {frame}'s RANSAC on identical inputs (the card run's), card vs CPU: inlier flips {flips}, "
          f"recorded flips against the card run {int((inl['cuda'].numpy() != rec['RANSAC'][0]).sum())}")


def drive_mc_vision(refs: CpuRefs):
    """Phase 15: ``scripts/run_mc_vision`` through its entry point on the card
    (the tabletop scene, sparse, MC_SEEDS seeds, MC_FRAMES frames, planes ON
    and OFF); returns (n_frames, launches, info), ``info["finish"]()``
    holding the ON arm to the CPU references queued on ``refs``."""
    import numpy as np

    from ov_plane_tpu_torch.ops import kernels
    from ov_plane_tpu_torch.scripts import run_mc_vision as mc
    from ov_plane_tpu_torch.sim import simulator

    tag = "[mc-vision]"
    runs = {}
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t = time.time()
    mc.main(MC_ARGS, runs=runs)
    torch.cuda.synchronize()
    wall = time.time() - t
    launches = {"gram_reduce": kernels.gram_reduce.launches, "kalman_downdate": kernels.kalman_downdate.launches}
    on, off = runs[("sparse", "ON")], runs[("sparse", "OFF")]
    n = on.p.shape[0]
    plane_work = {}
    for arm, run in (("ON", on), ("OFF", off)):
        c = run.counters                                   # [n, seeds, 9]
        streams = c[..., 2].max(axis=0) > 0
        first = int(np.argmax(c[..., 2].max(axis=1) > 0)) + 1 if streams.any() else None
        plane_work[arm] = (int(c[..., 1].sum()), int(c[..., 2].max()))
        print(f"{tag} {arm}: {MC_SEEDS}x{n} stream-frames in {run.wall_s:.3f} s: {MC_SEEDS * n / run.wall_s:.2f} "
              f"stream-frames/s; constraint updates {plane_work[arm][0]} over the run ({run.n_constraints} in the "
              f"last pull, as the script counts them); planes in the state at most {plane_work[arm][1]}, on "
              f"{int(streams.sum())} of {MC_SEEDS} streams (first at frame {first}); per-seed ATE (m, deg) "
              + " ".join(f"({a:.4f}, {o:.3f})" for a, o in run.ates))
        if not (np.isfinite(run.p).all() and np.isfinite(run.q).all() and np.isfinite(run.ates).all()):
            raise RuntimeError(f"{tag} the {arm} arm is not finite")
    expect = {k: n * (MC_PER_FRAME["ON"][k] + MC_PER_FRAME["OFF"][k]) for k in launches}
    print(f"{tag} the script took {wall:.1f} s (scene, renders and both arms); launches {launches}")
    if launches != expect:
        raise RuntimeError(f"{tag} launches {launches}, not {expect} (ON {MC_PER_FRAME['ON']}, "
                           f"OFF {MC_PER_FRAME['OFF']} per frame)")
    if not (plane_work["ON"][0] > 0 and plane_work["ON"][1] > 0):
        raise RuntimeError(f"{tag} the ON arm made no constraint update or put no plane in the state")
    if plane_work["OFF"][0] != 0:
        raise RuntimeError(f"{tag} the OFF arm made plane constraint updates")
    if np.array_equal(np.asarray(on.ates), np.asarray(off.ates)):
        raise RuntimeError(f"{tag} the ON and OFF arms give the same per-seed ATEs")

    # The same inputs as the script's ON arm, remade here: its scene, its
    # IMU draws and its image noise for the first MC_REF frames.
    cfg, render = mc.scene_config("tabletop", False)
    truth = simulator.build_sim(cfg, max_obs=cfg.tpu.max_obs_per_frame, device="cuda")
    sim = mc.noisy_streams(cfg, truth, MC_SEEDS, 17)
    frames = mc.render_frames(cfg, truth, render, MC_REF, "cuda")
    images = np.stack(list(mc.noisy_images(frames, MC_SEEDS, 17)))           # [MC_REF, MC_SEEDS, H, W]
    # Streams 0-1 of the script's own arm (u8 wire, the mm_bf16 sampler its
    # frames resolve to) and of a rerun with the exact mm sampler on the f32
    # wire against their CPU runs (filter f64; the script's arm also against
    # the filter in f32); frame 2's KLT on identical inputs shows the
    # tracker's agreement alone, and a rerun of the script's arm records its
    # first MC_TRACE frames' stages for the stage trace.
    exact = _mc_arm(cfg, sim, images, torch.float32, "cuda", "mm", "f32")
    traced = _mc_arm(cfg, sim, images[:MC_TRACE], torch.float32, "cuda", "auto", "auto", MC_TRACE)
    same = all(np.array_equal(traced[k], getattr(on, k)[:MC_TRACE]) for k in ("ids", "valid", "p", "q"))
    print(f"{tag} the traced rerun of the script's ON arm, its first {MC_TRACE} frames: ids, valid flags and pose "
          f"{'bitwise equal to' if same else 'apart from'} the script's run")
    host = _to_host(sim, 2)
    jobs = {("auto", "f64"): refs.submit("mc-vision auto", _mc_cpu_reference, host, images[:, :2], "auto", "auto",
                                         torch.float64, MC_TRACE),
            ("mm", "f64"): refs.submit("mc-vision mm", _mc_cpu_reference, host, images[:, :2], "mm", "f32"),
            ("auto", "f32"): refs.submit("mc-vision auto f32", _mc_cpu_reference, host, images[:, :2], "auto",
                                         "auto", torch.float32)}
    trace = _klt_trace(tag, cfg, sim, images)
    flips, dp1 = trace["mm_bf16"]
    if flips or dp1 > KLT_TRACE_LIMIT:
        raise RuntimeError(f"{tag} frame 2's KLT under mm_bf16 on identical inputs differs between the card and "
                           f"the CPU: {flips} status flips, max|Δp1| {dp1:.3e} px")
    info = dict(stream_frames_per_s=2 * MC_SEEDS * n / (on.wall_s + off.wall_s), wall_s=wall, n_frames=n,
                on_rate=MC_SEEDS * n / on.wall_s, off_rate=MC_SEEDS * n / off.wall_s)

    def finish():
        held = {w: _mc_agreement(tag, what, card, jobs[w].result(), MC_REF, w[1])
                for w, what, card in ((("mm", "f64"), "ON arm, exact sampler (f32 wire, mm)", exact),
                                      (("auto", "f64"), "ON arm as the script ran it (u8, mm_bf16)", on),
                                      (("auto", "f32"), "ON arm as the script ran it (u8, mm_bf16)", on))}
        ok = {w: frac >= 0.99 and dp <= 1e-2 and dq <= 1e-3 and planes >= MC_PLANES_MIN_EQUAL
              for w, (frac, dp, dq, planes) in held.items()}
        info.update(card_vs_cpu=held)
        if not ok["auto", "f64"]:
            # Where the script's arm parts from its CPU run: its recorded stages.
            ref = jobs["auto", "f64"].result()
            same = (traced["ids"][:, :2] == ref["ids"][:MC_TRACE]) & (traced["valid"][:, :2] == ref["valid"][:MC_TRACE])
            part = int(np.argmin(same.reshape(MC_TRACE, -1).all(axis=1))) + 1 if not same.all() else None
            found = _stage_trace(tag, traced["stages"], ref["stages"], part)
            if found:
                _ransac_on_both(tag, found[0], traced["stages"][found[0] - 1])
            print(f"{tag} the script's arm parts from its CPU run (filter f64): tracks first differ at frame {part} "
                  f"of the {MC_TRACE} traced; first differing decision: "
                  + (f"frame {found[0]}, stage {found[1]}" if found else "none in the traced frames"))
        if not ok["mm", "f64"]:
            raise RuntimeError(f"{tag} the card's ON arm (exact sampler) disagrees with the CPU reference")

    info["finish"] = finish
    return n, launches, info


CHAIN_K = 4             # frames per chunk of the chained dispatch (phase 16)
CHAIN_CHUNKS = 2        # timed chunks, after one warm-up chunk
PROFILED_FRAMES = 6     # frames of the staged profiler (phase 18)
SHARD_FRAMES = 16       # frames of the sharded point replay (phase 19a)
SHARD_VISION_STREAMS, SHARD_VISION_FRAMES = 4, 8   # the dp-sharded vision run (phase 19b): 2 ranks x 2 streams
SHARD_KNN_POINTS, SHARD_KNN_K = 4096, 8            # sharded_knn (phase 19c): points over 2 ranks, neighbours
SHARD_WORLD, SHARD_TIMEOUT = 2, 600                # ranks on the one card (gloo), seconds each may take
SHARD_POSE_LIMIT = 1e-8                            # m: the sharded update against the unsharded one (f64)


def drive_chain(vision: dict, refs: CpuRefs):
    """Phase 16: the vision path in chunks of CHAIN_K frames
    (``FusedVisionDriver(chain=K)``, ``step_batch_chunk``) at full width on
    the vision phase's staged frames, from a fresh state: one warm-up chunk,
    then CHAIN_CHUNKS timed chunks. Every chunk is checked for host
    synchronizations (none but the pull's event wait), one pull read (none
    in the first) and K times the per-frame launches; stream-frames/s at
    K = 1 (the vision phase) and K = CHAIN_K and the ``last_times``
    decomposition are printed; streams 0-1 are held to their CPU f64 chained
    run (queued). Returns (frames, launches, info) of the timed chunks."""
    import numpy as np

    from ov_plane_tpu_torch.frontend.fused import FusedVisionDriver
    from ov_plane_tpu_torch.models.manager import VioEngine
    from ov_plane_tpu_torch.ops import kernels

    tag = "[chain]"
    run = vision["run"]
    K, n_chunks = CHAIN_K, 1 + CHAIN_CHUNKS
    eng = VioEngine.from_config(run.cfg, device="cuda")
    drv, st, bank, fev = vision_driver(run, eng, BATCH, "cuda", torch.float32, chain=K)
    chunks = [torch.stack(run.ring[c * K:(c + 1) * K]) for c in range(n_chunks)]
    wins = [_chunk_windows(run, c * K + 1, K) for c in range(n_chunks)]
    job = refs.submit("chain", _vision_cpu_reference, torch.stack(run.ring[:n_chunks * K])[:, :2].cpu().numpy(),
                      _host_imu(run, slice(0, 2)), run.gt_bg0[:2].cpu().numpy(), run.gt_ba0[:2].cpu().numpy(),
                      run.sampler, run.wire, K)
    syncs, pulls, per_chunk, times, ps, qs, pulls_ref, counters = [], [], [], [], [], [], [], []
    torch.cuda.synchronize()
    for c in range(n_chunks):
        if c == 1:
            torch.cuda.synchronize()
            kernels.reset_launch_counts()
            t = time.time()
        n0, g0, d0 = drv.n_pulls, kernels.gram_reduce.launches, kernels.kalman_downdate.launches
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                st, bank, fev, outs = drv.step_batch_chunk(st, bank, fev, chunks[c], *wins[c])
            finally:
                torch.cuda.set_sync_debug_mode("default")
        syncs.append(sorted({str(w.message).splitlines()[0] for w in caught
                             if "synchronizing CUDA operation" in str(w.message)}))
        pulls.append(drv.n_pulls - n0)
        per_chunk.append({"gram_reduce": kernels.gram_reduce.launches - g0,
                          "kalman_downdate": kernels.kalman_downdate.launches - d0})
        ps.append(outs.p)
        qs.append(outs.q)
        if c > 0:
            times.append(dict(drv.last_times))
            pulls_ref.append(drv.last_pull[:, :2].copy())
            counters.append(drv.last_counters[:2].copy())
    drv.flush_stream()
    torch.cuda.synchronize()
    wall = time.time() - t
    pulls_ref.append(drv.last_pull[:, :2].copy())
    counters.append(drv.last_counters[:2].copy())
    launches = {"gram_reduce": kernels.gram_reduce.launches, "kalman_downdate": kernels.kalman_downdate.launches}
    n_frames = K * CHAIN_CHUNKS
    # One more chunk under torch.profiler: kernels and device time per frame at K = CHAIN_K.
    from torch.profiler import ProfilerActivity, profile

    i0 = n_chunks * K + 1
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        drv.step_batch_chunk(st, bank, fev, torch.stack(run.ring[i0 - 1:i0 - 1 + K]), *_chunk_windows(run, i0, K))
        torch.cuda.synchronize()
    drv.flush_stream()
    drv.close()
    ev = [e for e in _raw_events(prof) if e[1]]
    busy_ms = sum(e[3] for e in ev) / 1e6 / K
    print(f"[profile chain] frames {i0}-{i0 + K - 1}: {len(ev) / K:.0f} kernels per frame, device busy {busy_ms:.2f} "
          f"ms per frame; timed frame {1e3 * wall / n_frames:.2f} ms -> device idle "
          f"{100 * (1 - busy_ms / (1e3 * wall / n_frames)):.1f}%")
    rate = BATCH * n_frames / wall
    expect = {k: K * n for k, n in VISION_PER_FRAME.items()}
    # K = 1 over the same frames: the vision phase's host time from step K + 1 to step K·n_chunks + 1.
    stamps = vision["stamps"]
    k1 = BATCH * n_frames / (stamps[K * n_chunks] - stamps[K])
    print(f"{tag} K={K}: {BATCH}x{n_frames} stream-frames (frames {K + 1}-{K * n_chunks}) in {wall:.3f} s: "
          f"{rate:.2f} stream-frames/s; K=1 over the same frames (the vision phase's steps): {k1:.2f}, over its "
          f"{VISION_FRAMES} frames: {vision['stream_frames_per_s']:.2f} stream-frames/s")
    print(f"{tag} per chunk: launches {per_chunk}; pulls read {pulls}; host synchronizations other than the "
          f"pull's event wait {[len(x) for x in syncs]} {sum(syncs, [])[:5]}")
    mean_t = {k: 1e3 * statistics.mean(t_[k] for t_ in times) for k in FusedVisionDriver.TIME_KEYS}
    print(f"{tag} last_times, ms per chunk of {K} frames (mean of {len(times)}): "
          + ", ".join(f"{k} {v:.2f}" for k, v in mean_t.items()))
    if any(syncs) or pulls != [0] + [1] * CHAIN_CHUNKS or any(pc != expect for pc in per_chunk):
        raise RuntimeError(f"{tag} a chunk synchronized with the host, read other than one pull, or launched "
                           f"other than {expect}")
    if launches != {k: CHAIN_CHUNKS * n for k, n in expect.items()}:
        raise RuntimeError(f"{tag} launches {launches} over {CHAIN_CHUNKS} chunks")
    p, q = torch.cat(ps).transpose(0, 1), torch.cat(qs).transpose(0, 1)          # [B, T, ...]
    if not (torch.isfinite(p).all() and torch.isfinite(q).all() and torch.isfinite(st.cov).all()):
        raise RuntimeError(f"{tag} non-finite state")
    info = dict(stream_frames_per_s=rate, wall_s=wall, n_frames=n_frames, last_times_ms=mean_t,
                k1_stream_frames_per_s=k1)

    def finish():
        hold_vision_to_cpu(tag, np.stack(pulls_ref), np.stack(counters), p[:2], q[:2], job.result(), job.seconds)

    info["finish"] = finish
    return n_frames, launches, info


def drive_batched_replay(point: dict):
    """Phase 17: ``parallel.replay.batched_replay`` (one rank, no mesh) on the
    point path at B = 64 in f32 over the point phase's frames from a fresh
    state: every stream's poses bitwise those of the point phase's
    ``run_sequence`` on the same inputs, the fleet RMSE equal to the one
    recomputed on the host from the outputs, the exact launch counts."""
    from ov_plane_tpu_torch.ops import kernels
    from ov_plane_tpu_torch.parallel.replay import batched_replay

    tag = "[batched-replay]"
    eng, cfg, sim, n, ref = point["eng"], point["cfg"], point["sim"], point["n_frames"], point["outs"]
    state, bank = _fresh(eng, cfg, sim, BATCH, "cuda", torch.float32)
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t = time.time()
    outs, rmse = batched_replay(eng, state, bank, sim, cfg.tpu.max_imu_per_frame, n_frames=n)
    torch.cuda.synchronize()
    wall = time.time() - t
    launches = {"gram_reduce": kernels.gram_reduce.launches, "kalman_downdate": kernels.kalman_downdate.launches}
    err = outs.p.double().cpu() - sim.gt_p[1:n + 1].double().cpu()
    host = torch.sqrt((err * err).sum(dim=-1).mean()).item()
    same = torch.equal(outs.p, ref.p) and torch.equal(outs.q, ref.q)
    diff = max((outs.p - ref.p).abs().max().item(), (outs.q - ref.q).abs().max().item())
    print(f"{tag} {BATCH}x{n} stream-frames in {wall:.3f} s ({BATCH * n / wall:.1f} stream-frames/s); launches "
          f"{launches}; poses bitwise those of run_sequence: {same} (max diff {diff:.3e}); fleet RMSE "
          f"{rmse.item():.9f} m, host recomputation {host:.9f} m")
    if launches != {k: v * n for k, v in PATHS[0].per_frame.items()}:
        raise RuntimeError(f"{tag} launches {launches}, not {PATHS[0].per_frame} per frame")
    if not same:
        raise RuntimeError(f"{tag} the poses differ from run_sequence's on the same inputs")
    if not abs(rmse.item() - host) <= 1e-12 * host:
        raise RuntimeError(f"{tag} the fleet RMSE {rmse.item()} differs from the host's {host}")
    return n, launches, dict(stream_frames_per_s=BATCH * n / wall, wall_s=wall, fleet_rmse=rmse.item())


def drive_profiled(point: dict):
    """Phase 18: ``utils.profiling.run_sequence_profiled`` on the point path
    (B = 64, f32, fresh state, PROFILED_FRAMES frames), each stage ended by
    ``torch.cuda.synchronize()``: the median ms per stage printed, every
    row's stages adding up to its total, the exact launch counts."""
    import numpy as np

    from ov_plane_tpu_torch.eval.io import TIMING_COLUMNS
    from ov_plane_tpu_torch.ops import kernels
    from ov_plane_tpu_torch.utils.profiling import run_sequence_profiled

    tag = "[profiled]"
    eng, cfg, sim = point["eng"], point["cfg"], point["sim"]
    state, bank = _fresh(eng, cfg, sim, BATCH, "cuda", torch.float32)
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t = time.time()
    rec = run_sequence_profiled(eng, state, bank, sim, cfg.tpu.max_imu_per_frame, max_frames=PROFILED_FRAMES)
    wall = time.time() - t
    launches = {"gram_reduce": kernels.gram_reduce.launches, "kalman_downdate": kernels.kalman_downdate.launches}
    rows = np.asarray(rec.rows)
    stages = ("propagation", "tracking", "msckf update", "re-tri & marg")
    parts = sum(rows[:, TIMING_COLUMNS.index(c)] for c in stages)
    total = rows[:, TIMING_COLUMNS.index("total")]
    med = {c: 1e3 * float(np.median(rows[:, TIMING_COLUMNS.index(c)])) for c in stages + ("total",)}
    print(f"{tag} {len(rows)} frames x {BATCH} streams, median ms per stage: "
          + ", ".join(f"{k} {v:.2f}" for k, v in med.items())
          + f"; largest |sum of stages - total| {np.abs(parts - total).max():.3e} s; launches {launches}")
    if len(rows) != PROFILED_FRAMES or not np.abs(parts - total).max() <= 1e-9 or not (total > 0).all():
        raise RuntimeError(f"{tag} the staged rows do not add up to their totals")
    if launches != {k: v * PROFILED_FRAMES for k, v in PATHS[0].per_frame.items()}:
        raise RuntimeError(f"{tag} launches {launches}, not {PATHS[0].per_frame} per frame")
    return PROFILED_FRAMES, launches, dict(stream_frames_per_s=BATCH * PROFILED_FRAMES / wall, wall_s=wall,
                                           median_ms=med)


def _shard_point_inputs(shard_axis: str = ""):
    """The point path's engine, noisy scene (B = 64, f64) and a fresh f64
    state, the same bits in every process (the noise from a seeded card
    generator); ``shard_axis`` shares the classic update's rows."""
    from ov_plane_tpu_torch.models.manager import VioEngine
    from ov_plane_tpu_torch.sim import simulator
    from ov_plane_tpu_torch.utils.config import slice_config

    cfg = slice_config()
    cfg.tpu.shard_axis = shard_axis
    truth = simulator.load_scene(simulator.SCENE_PATH, dtype=torch.float64, device="cuda")
    sim = simulator.apply_noise(truth, simulator.noise_params(cfg), BATCH,
                                torch.Generator(device="cuda").manual_seed(SEED))
    eng = VioEngine.from_config(cfg, device="cuda")
    return (cfg, sim, eng) + _fresh(eng, cfg, sim, BATCH, "cuda", torch.float64)


def _shard_vision_run():
    """The dp-sharded vision run's inputs, the same bits in every process:
    the vision scene's first SHARD_VISION_FRAMES frames of
    SHARD_VISION_STREAMS streams, rendered on the card with each stream's
    pixel noise, on the 8-bit lattice; the wire and sampler resolve as the
    vision phase's."""
    from ov_plane_tpu_torch.frontend.synthetic import render_frame_textured
    from ov_plane_tpu_torch.ops.quat import quat_2_rot
    from ov_plane_tpu_torch.sim import simulator
    from ov_plane_tpu_torch.utils.config import vision_config

    cfg, b = vision_config(), SHARD_VISION_STREAMS
    truth = simulator.load_scene(simulator.VISION_SCENE_PATH, dtype=torch.float64, device="cuda")
    sim = simulator.apply_noise(truth, simulator.noise_params(cfg), b, torch.Generator(device="cuda").manual_seed(SEED))
    w, h = cfg.cam_wh
    noise = 0.01 * torch.randn(b, h, w, generator=torch.Generator(device="cuda").manual_seed(SEED + 2), device="cuda")
    R_ItoC = quat_2_rot(torch.tensor(cfg.cam_extrinsics[0:4], dtype=torch.float64))
    p_IinC = torch.tensor(cfg.cam_extrinsics[4:7], dtype=torch.float64)
    frames = []
    for i in range(1, SHARD_VISION_FRAMES + 1):
        img = render_frame_textured(truth.plane_corners, truth.plane_normal, truth.plane_d, quat_2_rot(truth.gt_q[i]),
                                    truth.gt_p[i], R_ItoC, p_IinC, cfg.cam_intrinsics, tuple(cfg.cam_wh))
        frames.append(torch.round(torch.clamp(img[None] + noise, 0.0, 1.0) * 255.0) * (1.0 / 255.0))
    imu = (truth.imu_t.cpu().numpy(), sim.imu_w.cpu().numpy(), sim.imu_a.cpu().numpy(), truth.cam_t_imu.cpu().numpy())
    return VisionRun(cfg, truth, imu, sim.gt_bg_cam[:, 0], sim.gt_ba_cam[:, 0], frames, "auto", "auto")


def _shard_vision(run: VisionRun, eng, mesh=None) -> dict:
    """The vision run through ``step_batch`` of the global SHARD_VISION_STREAMS
    streams (this rank's slab under ``mesh``): per frame p, q and the pull
    read; the launches."""
    import numpy as np

    from ov_plane_tpu_torch.frontend.fused import FusedVisionDriver
    from ov_plane_tpu_torch.models.feature_bank import FeatureBank
    from ov_plane_tpu_torch.models.manager import init_state_with_gt
    from ov_plane_tpu_torch.ops import kernels

    drv = FusedVisionDriver(run.cfg, eng, SHARD_VISION_STREAMS, sampler=run.sampler, img_wire=run.wire, mesh=mesh)
    sl = slice(drv.batch_lo, drv.batch_lo + drv.B)
    b, tr = drv.B, run.truth
    st = init_state_with_gt(eng, run.cfg, t0=tr.cam_t_imu[0].expand(b), q0=tr.gt_q[0].expand(b, 4),
                            p0=tr.gt_p[0].expand(b, 3), v0=tr.gt_v[0].expand(b, 3), bg0=run.gt_bg0[sl],
                            ba0=run.gt_ba0[sl], dtype=torch.float32, device="cuda")
    bank = FeatureBank.create(run.cfg.tpu.max_features, eng.layout.max_clones, b, torch.float32, "cuda")
    fev = drv.init_frontend()
    kernels.reset_launch_counts()
    ps, qs, pulls = [], [], []
    for i in range(1, SHARD_VISION_FRAMES + 1):
        st, bank, fev, out = drv.step_batch(st, bank, fev, drv.stage_image(run.ring[i - 1][sl]),
                                            *_imu_window(run, i, sl))
        ps.append(out.p)
        qs.append(out.q)
        if i > 1:
            pulls.append(drv.last_pull.copy())
    drv.flush_stream()
    pulls.append(drv.last_pull.copy())
    torch.cuda.synchronize()
    return dict(p=torch.stack(ps, 1).double().cpu().numpy(), q=torch.stack(qs, 1).double().cpu().numpy(),
                pulls=np.stack(pulls), counters=drv.last_counters.copy(), batch_lo=drv.batch_lo,
                launches=np.array([kernels.gram_reduce.launches, kernels.kalman_downdate.launches]))


def _knn_inputs():
    g = torch.Generator(device="cuda").manual_seed(SEED + 4)
    pts = 2.0 * torch.randn(SHARD_KNN_POINTS, 3, generator=g, device="cuda", dtype=torch.float64)
    active = torch.rand(SHARD_KNN_POINTS, generator=g, device="cuda") > 0.1
    return pts, active, torch.randn(64, 3, generator=g, device="cuda", dtype=torch.float64)


def _sharded_worker(rank: int, world: int, port: int, out_path: str):
    """One rank of phase 19 on the card (gloo over CUDA tensors): (a) the
    point replay with the classic update's rows over 'sp', (b) the vision
    driver with its streams over 'dp', (c) ``sharded_knn``."""
    import numpy as np

    from ov_plane_tpu_torch.frontend.map_blocks import sharded_knn
    from ov_plane_tpu_torch.models.manager import VioEngine, run_sequence
    from ov_plane_tpu_torch.ops import kernels
    from ov_plane_tpu_torch.parallel import distributed

    torch.cuda.set_device(0)
    distributed.init_process("gloo", f"tcp://127.0.0.1:{port}", world, rank, timeout_s=SHARD_TIMEOUT)
    try:
        res = {}
        sp = distributed.global_mesh(("dp", "sp"), shape=(1, world))
        cfg, sim, eng, state, bank = _shard_point_inputs("sp")
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        t = time.time()
        state, bank, outs = run_sequence(eng, state, bank, sim, imu_window=cfg.tpu.max_imu_per_frame,
                                         n_frames=SHARD_FRAMES)
        torch.cuda.synchronize()
        res["a_wall"] = time.time() - t
        res["a_launches"] = np.array([kernels.gram_reduce.launches, kernels.kalman_downdate.launches])
        res.update({f"a_out_{k}": v.cpu().numpy() for k, v in outs._asdict().items()})
        res.update({f"a_state_{k}": v.cpu().numpy() for k, v in state.tensors().items()})

        dp = distributed.global_mesh(("dp",))
        run = _shard_vision_run()
        t = time.time()
        res.update({f"b_{k}": v for k, v in _shard_vision(run, VioEngine.from_config(run.cfg, device="cuda"),
                                                          dp).items()})
        res["b_wall"] = time.time() - t

        pts, active, q = _knn_inputs()
        sl = distributed.axis_slab(sp, "sp", SHARD_KNN_POINTS)
        d, idx = sharded_knn(pts[sl], active[sl], q, SHARD_KNN_K, sp.get_group("sp"))
        res.update(c_d=d.cpu().numpy(), c_idx=idx.cpu().numpy())
        np.savez(out_path, **res)
    finally:
        torch.distributed.destroy_process_group()


def drive_sharded():
    """Phase 19: two spawned processes on the one card, joined by gloo (NCCL
    refuses two ranks on one device; this PyTorch's gloo takes CUDA tensors
    in all_reduce, all_gather, all_gather_into_tensor, broadcast,
    reduce_scatter_tensor and barrier), each with a time limit of
    SHARD_TIMEOUT s. (a) The point path (B = 64, f64) with
    ``tpu.shard_axis = "sp"`` over SHARD_FRAMES frames: within
    SHARD_POSE_LIMIT m of the unsharded run on the card, every counter
    equal, both ranks' states bitwise equal, the per-rank gram (B, 660, 93)
    launched by the hand-written kernel once per frame. (b) The vision path
    dp-sharded at 2 ranks × 2 streams against 4 streams in one process:
    poses within the vision path's limits (1e-2 m, 1e-3), the share of equal
    track ids and counters printed. (c) ``sharded_knn`` against ``knn`` on
    one device. Returns {"sharded": (frames, launches, info), "sharded-dp": ...}."""
    import socket
    import tempfile

    import numpy as np

    from ov_plane_tpu_torch.frontend.map_blocks import MapBlocks, knn
    from ov_plane_tpu_torch.models.manager import VioEngine, run_sequence

    tag = "[sharded]"
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    ctx = multiprocessing.get_context("spawn")
    tmp = tempfile.mkdtemp(prefix="ovp_sharded_")
    outs = [f"{tmp}/rank{r}.npz" for r in range(SHARD_WORLD)]
    t = time.time()
    procs = [ctx.Process(target=_sharded_worker, args=(r, SHARD_WORLD, port, outs[r])) for r in range(SHARD_WORLD)]
    for proc in procs:
        proc.start()
    try:
        # The unsharded references in this process while the ranks run.
        cfg, sim, eng, state, bank = _shard_point_inputs()
        t_ref = time.time()
        _, _, ref = run_sequence(eng, state, bank, sim, imu_window=cfg.tpu.max_imu_per_frame, n_frames=SHARD_FRAMES)
        torch.cuda.synchronize()
        ref_wall = time.time() - t_ref
        vrun = _shard_vision_run()
        one = _shard_vision(vrun, VioEngine.from_config(vrun.cfg, device="cuda"))
        pts, active, q = _knn_inputs()
        m = MapBlocks.create(SHARD_KNN_POINTS, dtype=torch.float64, device="cuda")
        m.points, m.plane_id = pts, torch.where(active, 0, -1).to(torch.int32)
        d1, i1 = knn(m, q, SHARD_KNN_K)
        for proc in procs:
            proc.join(timeout=max(1.0, SHARD_TIMEOUT - (time.time() - t)))
    finally:
        for proc in procs:
            if proc.is_alive():
                proc.kill()
                proc.join()
    if any(proc.exitcode != 0 for proc in procs):
        raise RuntimeError(f"{tag} a rank failed or ran past {SHARD_TIMEOUT} s: exit codes "
                           f"{[proc.exitcode for proc in procs]}")
    ranks = []
    for o in outs:
        with np.load(o) as z:
            ranks.append({k: z[k] for k in z.files})
    print(f"{tag} {SHARD_WORLD} ranks on one card (gloo) finished in {time.time() - t:.1f} s")

    # (a) the sharded classic update.
    p_ref = ref.p.cpu().numpy()
    dps = [float(np.abs(r["a_out_p"] - p_ref).max()) for r in ranks]
    counters_equal = all(np.array_equal(r["a_out_n_msckf_used"], ref.n_msckf_used.cpu().numpy()) for r in ranks)
    keys = [k for k in ranks[0] if k.startswith(("a_out_", "a_state_"))]
    differ = [k for k in keys if not np.array_equal(ranks[0][k], ranks[1][k])]
    la = [r["a_launches"].tolist() for r in ranks]
    print(f"{tag} (a) point path, B={BATCH}, f64, rows over 'sp': max|dp| against the unsharded run "
          f"{['%.3e' % d for d in dps]} m (limit {SHARD_POSE_LIMIT}); n_msckf_used equal: {counters_equal}; ranks' "
          f"states and outputs bitwise equal: {not differ} {differ[:3]}; launches per rank (gram, downdate) {la}; "
          f"{SHARD_FRAMES} frames in {[round(float(r['a_wall']), 2) for r in ranks]} s per rank, unsharded "
          f"{ref_wall:.2f} s")
    if not (max(dps) <= SHARD_POSE_LIMIT and counters_equal and not differ):
        raise RuntimeError(f"{tag} the sharded update departs from the unsharded one, or the ranks part")
    if any(x != [SHARD_FRAMES, SHARD_FRAMES] for x in la):
        raise RuntimeError(f"{tag} (a) launches {la}, not one gram and one downdate per frame")

    # (b) the dp-sharded vision driver against one process.
    p_dist = np.concatenate([r["b_p"] for r in ranks])
    q_dist = np.concatenate([r["b_q"] for r in ranks])
    pulls = np.concatenate([r["b_pulls"] for r in ranks], axis=1)[:, :, :-3]
    cnt = np.concatenate([r["b_counters"] for r in ranks])
    same = (pulls[..., 0] == one["pulls"][:, :, :-3, 0]) & (pulls[..., 3] == one["pulls"][:, :, :-3, 3])
    dp_b, dq_b = float(np.abs(p_dist - one["p"]).max()), float(np.abs(q_dist - one["q"]).max())
    lb = [r["b_launches"].tolist() for r in ranks]
    expect = [VISION_PER_FRAME[k] * SHARD_VISION_FRAMES for k in ("gram_reduce", "kalman_downdate")]
    print(f"{tag} (b) vision dp-sharded, {SHARD_WORLD} ranks x {SHARD_VISION_STREAMS // SHARD_WORLD} streams against "
          f"{SHARD_VISION_STREAMS} streams in one process, {SHARD_VISION_FRAMES} frames: batch_lo "
          f"{[int(r['b_batch_lo']) for r in ranks]}; ids and valid equal on {100 * same.mean():.2f}% of slot-frames; "
          f"last counters equal on {int((cnt == one['counters']).all(axis=1).sum())} of {len(cnt)} streams; "
          f"max|dp|={dp_b:.3e} m max|dq|={dq_b:.3e}; launches per rank {lb} (one process {one['launches'].tolist()})")
    if not (dp_b <= 1e-2 and dq_b <= 1e-3) or [int(r["b_batch_lo"]) for r in ranks] != [0, 2]:
        raise RuntimeError(f"{tag} the dp-sharded vision run departs from the one-process run")
    if any(x != expect for x in lb) or one["launches"].tolist() != expect:
        raise RuntimeError(f"{tag} (b) launches {lb}, not {expect}")

    # (c) sharded_knn.
    knn_same = all(np.array_equal(r["c_d"], d1.cpu().numpy()) and np.array_equal(r["c_idx"], i1.cpu().numpy())
                   for r in ranks)
    print(f"{tag} (c) sharded_knn over {SHARD_WORLD} ranks, {SHARD_KNN_POINTS} points, 64 queries, k={SHARD_KNN_K}: "
          f"distances and indices equal to knn on one device: {knn_same}")
    if not knn_same:
        raise RuntimeError(f"{tag} sharded_knn differs from knn")
    import shutil

    shutil.rmtree(tmp, ignore_errors=True)
    launches_a = dict(zip(("gram_reduce", "kalman_downdate"), ranks[0]["a_launches"].tolist()))
    launches_b = dict(zip(("gram_reduce", "kalman_downdate"), ranks[0]["b_launches"].tolist()))
    return {"sharded": (SHARD_FRAMES, launches_a, dict(stream_frames_per_s=BATCH * SHARD_FRAMES / float(
                ranks[0]["a_wall"]), max_dp=max(dps), unsharded_stream_frames_per_s=BATCH * SHARD_FRAMES / ref_wall)),
            "sharded-dp": (SHARD_VISION_FRAMES, launches_b, dict(
                stream_frames_per_s=SHARD_VISION_STREAMS * SHARD_VISION_FRAMES / float(ranks[0]["b_wall"]),
                ids_equal=float(same.mean()), max_dp=dp_b, max_dq=dq_b))}


KLT_SAMPLERS = ("slice", "mm", "mm_bf16", "rowmm", "rowmm_bf16")
KLT_CALLS = 2           # timed calls of each sampler
KLT_FRAME = 60          # a textured view of the vision scene (its first frames give a few FAST corners)
# rowmm against slice on the card (the exact samplers' f32 limit in
# tests/test_torch_frontend.py::test_klt_track, 1e-3 px), and rowmm_bf16 on
# the card against its CPU run (mm_bf16's limits there: three quarters of the
# tracks within 1e-3 px; every track within 0.25 px, the rowmm_bf16 case's):
# (share of track flags equal, share of both-kept tracks within 1e-3 px, max px).
KLT_LIMITS = {"rowmm": (0.99, 0.99, None), "rowmm_bf16": (0.95, 0.75, 0.25)}


def _klt_inputs(cfg, eng):
    """The vision step's KLT inputs at B = 64: frame KLT_FRAME of the vision
    scene and a view a few millimetres away, rendered on the card with each
    stream's pixel noise, quantized as the bench's camera does; the step's
    FAST corners of the first in the driver's slots."""
    from ov_plane_tpu_torch.frontend import fast as ffast
    from ov_plane_tpu_torch.frontend.fused import FusedVisionDriver
    from ov_plane_tpu_torch.frontend.synthetic import render_frame_textured
    from ov_plane_tpu_torch.ops.quat import quat_2_rot
    from ov_plane_tpu_torch.sim import simulator

    truth = simulator.load_scene(simulator.VISION_SCENE_PATH, dtype=torch.float64, device="cuda")
    vo = FusedVisionDriver(cfg, eng, BATCH).vopts
    g = torch.Generator(device="cuda").manual_seed(SEED + 2)
    noise = 0.01 * torch.randn(BATCH, vo.h, vo.w, generator=g, device="cuda")
    R_ItoC = quat_2_rot(torch.tensor(cfg.cam_extrinsics[0:4], dtype=torch.float64))
    p_IinC = torch.tensor(cfg.cam_extrinsics[4:7], dtype=torch.float64)
    imgs = []
    # Frame KLT_FRAME and the camera moved by a few millimetres (from frame to
    # frame the scene moves too far for LK without the step's gyro prior).
    for dp in (0.0, truth.gt_p.new_tensor([0.004, -0.003, 0.002])):
        img = render_frame_textured(truth.plane_corners, truth.plane_normal, truth.plane_d,
                                    quat_2_rot(truth.gt_q[KLT_FRAME]), truth.gt_p[KLT_FRAME] + dp, R_ItoC, p_IinC,
                                    cfg.cam_intrinsics, tuple(cfg.cam_wh))
        imgs.append(torch.round(torch.clamp(img[None] + noise, 0.0, 1.0) * 255.0) * (1.0 / 255.0))
    uv, ok = ffast.detect_grid(imgs[0], torch.zeros(BATCH, 1, 2, device="cuda"),
                               torch.zeros(BATCH, 1, dtype=torch.bool, device="cuda"), vo.fast, vo.h, vo.w)
    pts = torch.zeros(BATCH, vo.cap, 2, device="cuda")
    mask = torch.zeros(BATCH, vo.cap, dtype=torch.bool, device="cuda")
    n = min(uv.shape[1], vo.cap)
    pts[:, :n], mask[:, :n] = uv[:, :n], ok[:, :n]
    return imgs, pts, mask, vo.klt._replace(fb_check=False)


def _klt_track(imgs, pts, mask, opts, sampler: str):
    from ov_plane_tpu_torch.frontend import klt as fklt

    pyr = [fklt.prepare_pyramid(fklt.build_pyramid(im, opts.levels), opts.window) for im in imgs]
    return fklt.track(pyr[0], pyr[1], pts, mask, opts._replace(sampler=sampler))


def _klt_cpu_reference(imgs, pts, mask, opts, sampler: str):
    """One sampler's track of the same inputs on the CPU, in a ``CpuRefs`` worker."""
    p1, ok = _klt_track([torch.from_numpy(x) for x in imgs], torch.from_numpy(pts), torch.from_numpy(mask),
                        opts, sampler)
    return p1.numpy(), ok.numpy()


def _agreement(p_a, ok_a, p_b, ok_b, mask):
    """(share of masked slots whose flags agree, share of both-kept tracks
    within 1e-3 px, max |Δ| px over them)."""
    flags = float((ok_a == ok_b)[mask].float().mean())
    both = ok_a & ok_b & mask
    d = (p_a - p_b).abs().amax(dim=-1)[both]
    return flags, float((d <= 1e-3).float().mean()), float(d.max()) if d.numel() else 0.0


def drive_klt_samplers(refs: CpuRefs):
    """The KLT samplers alone at the vision step's shapes (the counterpart of
    examples/ab_klt_tpu.py): ``klt.track`` of B = 64 streams' 640×480
    frame pair with each of the five samplers, device ms (the call's
    kernels in torch.profiler, L2 flushed) and host ms per call; rowmm held
    to slice on the card and rowmm_bf16 to its CPU run (queued), within
    KLT_LIMITS. Returns (n_frames, launches, info)."""
    from ov_plane_tpu_torch.models.manager import VioEngine
    from ov_plane_tpu_torch.ops import kernels
    from ov_plane_tpu_torch.utils.config import vision_config

    tag = "[klt-samplers]"
    cfg = vision_config()
    imgs, pts, mask, opts = _klt_inputs(cfg, VioEngine.from_config(cfg))
    kernels.reset_launch_counts()
    out, times = {}, {}
    for sampler in KLT_SAMPLERS:
        out[sampler] = _klt_track(imgs, pts, mask, opts, sampler)
        torch.cuda.synchronize()
        host = []
        for _ in range(KLT_CALLS):
            t = time.perf_counter()
            _klt_track(imgs, pts, mask, opts, sampler)
            host.append(1e3 * (time.perf_counter() - t))
            torch.cuda.synchronize()
        times[sampler] = (device_ms(lambda: _klt_track(imgs, pts, mask, opts, sampler), n=KLT_CALLS, warmup=1),
                          statistics.median(host))
        p1, ok = out[sampler]
        if not torch.isfinite(p1[ok]).all():
            raise RuntimeError(f"{tag} {sampler}: non-finite tracks")
        print(f"{tag} {sampler}: B={BATCH} {int(mask.sum())} points, {int(ok.sum())} tracked; device "
              f"{times[sampler][0]:.3f} ms, host {times[sampler][1]:.2f} ms per call")
    if out["slice"][1].sum() < 0.5 * mask.sum():
        raise RuntimeError(f"{tag} slice tracked {int(out['slice'][1].sum())} of {int(mask.sum())} points")
    if not (torch.equal(out["slice"][0], out["mm"][0]) and torch.equal(out["slice"][1], out["mm"][1])):
        raise RuntimeError(f"{tag} mm and slice, one path, disagree")
    flags, close, dmax = _agreement(*out["rowmm"], *out["slice"], mask)
    print(f"{tag} rowmm against slice: flags equal on {100 * flags:.2f} % of slots, {100 * close:.2f} % of tracks "
          f"within 1e-3 px, max {dmax:.3e} px")
    if flags < KLT_LIMITS["rowmm"][0] or close < KLT_LIMITS["rowmm"][1]:
        raise RuntimeError(f"{tag} rowmm departs from slice beyond {KLT_LIMITS['rowmm']}")
    host = ([im.cpu().numpy() for im in imgs], pts.cpu().numpy(), mask.cpu().numpy(), opts)
    job = refs.submit("klt-rowmm_bf16", _klt_cpu_reference, *host, "rowmm_bf16")
    card = tuple(x.cpu() for x in out["rowmm_bf16"])
    info = dict(stream_frames_per_s=BATCH / (times["slice"][1] / 1e3), times=times)

    def finish():
        p_c, ok_c = (torch.from_numpy(x) for x in job.result())
        flags, close, dmax = _agreement(*card, p_c, ok_c, mask.cpu())
        print(f"{tag} rowmm_bf16 card against CPU ({job.seconds:.1f} s in a worker): flags equal on "
              f"{100 * flags:.2f} % of slots, {100 * close:.2f} % of tracks within 1e-3 px, max {dmax:.3e} px")
        lim = KLT_LIMITS["rowmm_bf16"]
        if flags < lim[0] or close < lim[1] or dmax > lim[2]:
            raise RuntimeError(f"{tag} rowmm_bf16 on the card departs from its CPU run beyond {lim}")

    info["finish"] = finish
    return 1, {"gram_reduce": kernels.gram_reduce.launches, "kalman_downdate": kernels.kalman_downdate.launches}, info


BAG_FRAMES = 6          # replayed from the bag after the GT init


def drive_bag(replay_info: dict):
    """``run_euroc --bag --loop-out --viz-dir`` on a bz2 bag written (by the
    port's ``eval/rosbag`` writer) from the replay phase's ASL folder, GT from
    its csv, in the host path's configuration (ArUco on): BAG_FRAMES frames
    on the card against the replay phase's host path over the same frames
    within REPLAY_POSE_LIMITS, a loop pack every 2 frames where the
    triangulations exist and the three debug images every 2 frames.
    Returns (n_frames, launches, info)."""
    import numpy as np

    from ov_plane_tpu_torch.eval import png, rosbag
    from ov_plane_tpu_torch.ops import kernels
    from ov_plane_tpu_torch.scripts import run_euroc

    tag = "[bag]"
    tmp = replay_info["folder"]
    mav0 = Path(tmp, "seq", "mav0")
    t = time.time()
    imu = np.loadtxt(mav0 / "imu0" / "data.csv", delimiter=",", comments="#")
    msgs = [("/imu0", "sensor_msgs/Imu", row[0] * 1e-9, rosbag.serialize_imu(row[0] * 1e-9, row[1:4], row[4:7]))
            for row in imu]
    cam = np.genfromtxt(mav0 / "cam0" / "data.csv", delimiter=",", comments="#", dtype=str)
    for ns, name in cam[:BAG_FRAMES + 2]:
        img = png.read_gray(mav0 / "cam0" / "data" / name.strip()).astype(np.float64) / 255.0
        msgs.append(("/cam0/image_raw", "sensor_msgs/Image", float(ns) * 1e-9,
                     rosbag.serialize_image(float(ns) * 1e-9, img)))
    bag = f"{tmp}/seq.bag"
    rosbag.write_bag(bag, msgs, compression="bz2")
    print(f"{tag} wrote a bz2 bag of {len(msgs)} messages ({Path(bag).stat().st_size / 1e6:.1f} MB) in "
          f"{time.time() - t:.2f} s")
    kernels.reset_launch_counts()
    r = run_euroc.main(["--bag", bag, "--gt", str(mav0 / "state_groundtruth_estimate0" / "data.csv"),
                        "--sim-calib", "--use-planes", "--max-slam", "15", "--config", f"{tmp}/aruco.yaml",
                        "--max-frames", str(BAG_FRAMES),
                        "--out", f"{tmp}/bag_traj.txt", "--timing", f"{tmp}/bag_t.csv", "--plane-csv",
                        f"{tmp}/bag_p.csv", "--loop-out", f"{tmp}/loop", "--loop-every", "2", "--viz-dir",
                        f"{tmp}/viz", "--viz-every", "2", "--device", "cuda", "--verbosity", "WARNING"])
    launches = {"gram_reduce": kernels.gram_reduce.launches, "kalman_downdate": kernels.kalman_downdate.launches}
    n = r["n_done"]
    host = replay_info["host_pq"]
    dp = float(np.abs(r["p"] - host[0][:n]).max())
    dq = float(np.abs(r["q"] - host[1][:n]).max())
    packs = [np.load(f) for f in r["loop_files"]]
    pngs = [png.read(f) for f in r["viz_files"]]
    print(f"{tag} {n} frames in {r['loop_seconds']:.2f} s; against the ASL replay's host path: max|dp|={dp:.3e} m "
          f"max|dq|={dq:.3e}; {len(packs)} loop packs ({[len(p['feat_id']) for p in packs]} tracks), "
          f"{len(pngs)} debug PNGs; launches {launches}")
    if n != BAG_FRAMES or r["init"] != "gt":
        raise RuntimeError(f"{tag} init {r['init']}, {n} of {BAG_FRAMES} frames")
    if not (dp < REPLAY_POSE_LIMITS[0] and dq < REPLAY_POSE_LIMITS[1]):
        raise RuntimeError(f"{tag} the bag replay disagrees with the ASL replay (limits {REPLAY_POSE_LIMITS})")
    # A pack needs the whole-track triangulations, which start after a few frames.
    if not 1 <= len(packs) <= BAG_FRAMES // 2 or len(pngs) != 3 * (BAG_FRAMES // 2):
        raise RuntimeError(f"{tag} {len(packs)} loop packs and {len(pngs)} PNGs written")
    if not all(np.isfinite(p["feat_p_G"]).all() and p["depth_img"].shape == (480, 752) for p in packs) or \
            not all(x.shape == (480, 752, 3) for x in pngs):
        raise RuntimeError(f"{tag} a loop pack or a debug image is malformed")
    for k, per in REPLAY_PER_FRAME.items():
        if launches[k] != per * n:
            raise RuntimeError(f"{tag} {k} launched {launches[k]} times over {n} frames, not {per} per frame")
    return n, launches, dict(stream_frames_per_s=n / r["loop_seconds"])


VIZ_PM_DURATION, VIZ_DURATION = 4.0, 2.5     # s of the two scripts' simulated runs
PM_PER_FRAME = {"gram_reduce": 0, "kalman_downdate": 4}      # classic (QR), plane update and both candidates
VIZ_PER_FRAME = {"gram_reduce": 0, "kalman_downdate": 13}    # + the SLAM update and the eight SLAM candidates


def drive_viz():
    """``scripts/run_persistent_map`` and ``scripts/viz_replay`` on the card
    at their shortest useful durations: every file written, every array
    finite, the AR overlay drawn once a plane is in the state, exact launch
    counts. Returns {path: (n_frames, launches, info)}."""
    import tempfile

    import numpy as np

    from ov_plane_tpu_torch.eval import png
    from ov_plane_tpu_torch.ops import kernels
    from ov_plane_tpu_torch.scripts import run_persistent_map, viz_replay

    tag = "[viz]"
    tmp = tempfile.mkdtemp(prefix="ovp_viz_")
    out = {}
    kernels.reset_launch_counts()
    t = time.time()
    pm = run_persistent_map.main(["--duration", str(VIZ_PM_DURATION), "--out", f"{tmp}/pm.npz", "--device", "cuda"])
    pm_s = time.time() - t
    launches = {"gram_reduce": kernels.gram_reduce.launches, "kalman_downdate": kernels.kalman_downdate.launches}
    n = int(pm["n_frames"])
    with np.load(f"{tmp}/pm.npz") as z:
        arrays = {k: z[k] for k in z.files}
    finite = all(np.isfinite(v).all() for v in arrays.values() if v.dtype.kind == "f")
    has_plane = bool(np.any(pm["plane_cp"] != 0))
    print(f"{tag} run_persistent_map {VIZ_PM_DURATION} s: {n} frames in {pm_s:.1f} s, {len(pm['map_points'])} map "
          f"points, plane in the state {has_plane}, {len(pm['segments'])} overlay segments ({int(pm['overlay'].sum())} px), "
          f"launches {launches}")
    if not finite or len(pm["map_points"]) == 0 or (has_plane and len(pm["segments"]) == 0):
        raise RuntimeError(f"{tag} run_persistent_map: finite {finite}, plane {has_plane}, "
                           f"{len(pm['segments'])} segments")
    for k, per in PM_PER_FRAME.items():
        if launches[k] != per * n:
            raise RuntimeError(f"{tag} {k} launched {launches[k]} times over {n} frames, not {per} per frame")
    out["persistent-map"] = (n, launches, dict(stream_frames_per_s=n / pm_s))
    kernels.reset_launch_counts()
    t = time.time()
    v = viz_replay.main(["--duration", str(VIZ_DURATION), "--use-planes", "--out", f"{tmp}/viz", "--device", "cuda"])
    viz_s = time.time() - t
    launches = {"gram_reduce": kernels.gram_reduce.launches, "kalman_downdate": kernels.kalman_downdate.launches}
    n = len(v["t"])
    with np.load(f"{tmp}/viz/viz.npz") as z:
        finite = all(np.isfinite(z[k]).all() for k in z.files if z[k].dtype.kind == "f")
    pages = [png.read(p) for p in v["paths"]]
    print(f"{tag} viz_replay {VIZ_DURATION} s: {n} frames in {viz_s:.1f} s, RMSE {float(v['rmse_pos']):.4f} m, "
          f"pages {[p.shape for p in pages]}, launches {launches}")
    if not finite or len(pages) != 3 or not all((p != 255).any() for p in pages):
        raise RuntimeError(f"{tag} viz_replay: finite {finite}, {len(pages)} pages")
    for k, per in VIZ_PER_FRAME.items():
        if launches[k] != per * n:
            raise RuntimeError(f"{tag} {k} launched {launches[k]} times over {n} frames, not {per} per frame")
    out["viz"] = (n, launches, dict(stream_frames_per_s=n / viz_s))
    import shutil

    shutil.rmtree(tmp, ignore_errors=True)
    return out


def _warm_worker():
    """A CpuRefs worker's first job: import what the references run."""
    import ov_plane_tpu_torch.frontend.fused  # noqa: F401
    import ov_plane_tpu_torch.scripts.run_euroc  # noqa: F401
    import ov_plane_tpu_torch.scripts.run_mc_vision  # noqa: F401


def _reference_job(fn, args):
    """One CPU reference in a spawned worker: (seconds, fn(*args))."""
    torch.set_num_threads(WORKER_THREADS)
    t = time.time()
    value = fn(*args)
    return time.time() - t, value


class CpuRefs:
    """The CPU references of one lane's phases. ``submit`` hands a job to
    WORKERS spawned single-thread processes at once and returns its handle;
    ``run`` waits for every job. A handle's ``result()`` is its job's value
    once ``run`` has returned."""

    class Handle:
        def __init__(self, name):
            self.name, self.seconds, self._value = name, None, None

        def result(self):
            if self.seconds is None:
                raise RuntimeError(f"the CPU reference {self.name!r} is read before it ran")
            return self._value

    def __init__(self):
        self.jobs = []
        self.pool = None

    def start(self):
        """Spawn the workers now: they import the port while the lane's
        first phase runs."""
        self.pool = concurrent.futures.ProcessPoolExecutor(WORKERS, mp_context=multiprocessing.get_context("spawn"))
        for _ in range(WORKERS):
            self.pool.submit(_warm_worker)

    def close(self):
        """Stop the workers without waiting for their jobs (``shutdown``
        alone lets a running reference go on after the script has failed)."""
        if self.pool is not None:
            procs = list((self.pool._processes or {}).values())
            self.pool.shutdown(wait=False, cancel_futures=True)
            for proc in procs:
                proc.kill()
            self.pool = None

    def submit(self, name: str, fn, *args) -> "CpuRefs.Handle":
        if self.pool is None:
            self.start()
        handle = CpuRefs.Handle(name)
        self.jobs.append((handle, self.pool.submit(_reference_job, fn, args)))
        return handle

    def run(self):
        t = time.time()
        try:
            for h, future in self.jobs:
                h.seconds, h._value = future.result()
        except BaseException:
            self.close()
            raise
        if self.pool is not None:
            self.pool.shutdown()
            self.pool = None
        print(f"[refs] {len(self.jobs)} CPU references on {WORKERS} workers, done {time.time() - t:.1f} s after the "
              f"lane's last phase: " + ", ".join(f"{h.name} {h.seconds:.1f} s" for h, _ in self.jobs))


def _profiled_path(spec: PathSpec, refs: CpuRefs):
    res = drive_path(spec, refs)
    profile_frames(spec, res[2])
    return res


def _profiled_vision(refs: CpuRefs):
    res = drive_vision(refs)
    profile_vision(res[2])
    return res


# Phases 4-21 by name: each takes the lane's results so far and its CpuRefs
# and returns (n_frames, launches, info), or a dict of such by name.
PHASES = {
    **{spec.name: (lambda spec: lambda res, refs: _profiled_path(spec, refs))(spec) for spec in PATHS},
    "batched-replay": lambda res, refs: drive_batched_replay(res["point"][2]),
    "profiled": lambda res, refs: drive_profiled(res["point"][2]),
    "vision": lambda res, refs: _profiled_vision(refs),
    "tabletop": lambda res, refs: drive_tabletop(refs),
    "chain": lambda res, refs: drive_chain(res["vision"][2], refs),
    "replay": lambda res, refs: drive_replay(refs),
    "bag": lambda res, refs: drive_bag(res["replay"][2]),
    "sweep": lambda res, refs: drive_sweep(refs),
    "calib": lambda res, refs: drive_calib(refs),
    "zupt": lambda res, refs: drive_zupt(),
    "anchored": lambda res, refs: drive_anchored(),
    "ransac-gt": lambda res, refs: drive_ransac_gt(refs),
    "mc-vision": lambda res, refs: drive_mc_vision(refs),
    "klt-samplers": lambda res, refs: drive_klt_samplers(refs),
    "viz": lambda res, refs: drive_viz(),
    "sharded": lambda res, refs: drive_sharded(),
}
# Phases 4-21 in lanes that run at once on the one card: lane 0 in this
# process, each other lane in a spawned process of its own. Every step is
# host-bound (the card idles most of a frame, PERF.md §5), so the lanes
# share the card without waiting for it, and the script keeps within its
# time limit on a slower host; the rates printed after phase 3 are taken
# beside the other lanes. A phase that reads another's result follows it
# in its lane.
LANES = (
    ("point", "batched-replay", "profiled", "plane", "ms-pl", "vision", "tabletop", "chain", "anchored"),
    ("replay", "bag", "sweep", "zupt"),
    ("calib", "ransac-gt", "mc-vision", "klt-samplers", "viz", "sharded"),
)
LANE_TIMEOUT = 1000     # seconds a lane may take, its CPU references included


def drive_lane(lane: int, refs: CpuRefs) -> dict:
    """The phases of LANES[lane], then the comparisons with their CPU
    references (``refs``); returns each path's (n_frames, launches, info)."""
    results = {}
    try:
        for name in LANES[lane]:
            t = time.time()
            res = PHASES[name](results, refs)
            results.update(res if isinstance(res, dict) else {name: res})
            print(f"[{name}] phase took {time.time() - t:.1f} s")
        refs.run()
    finally:
        refs.close()
    t = time.time()
    for info in (info for _, _, info in results.values() if "finish" in info):
        info.pop("finish")()
    print(f"[refs] the comparisons with the CPU references took {time.time() - t:.1f} s")
    return results


def _lane_main(lane: int, out: str):
    """A spawned lane: its standard output and error to ``out``.log and
    ``out``.err, each path's (n_frames, launches, rate) to ``out``.json.
    SIGTERM stops it through its ``finally`` clauses, which stop its own
    processes."""
    import os
    import signal

    signal.signal(signal.SIGTERM, lambda *_: sys.exit(1))
    for fd, suffix in ((1, ".log"), (2, ".err")):
        with open(out + suffix, "w") as f:
            os.dup2(f.fileno(), fd)
    sys.stdout.reconfigure(line_buffering=True)
    from ov_plane_tpu_torch.ops import kernels
    from ov_plane_tpu_torch.utils.torchenv import resolve_device

    resolve_device("cuda")
    kernels.build()
    results = drive_lane(lane, CpuRefs())
    with open(out + ".json", "w") as f:
        json.dump({p: [n, {k: int(v) for k, v in launches.items()},
                       {"stream_frames_per_s": float(info["stream_frames_per_s"])}]
                   for p, (n, launches, info) in results.items()}, f)


def drive_lanes(refs: CpuRefs) -> dict:
    """Phases 4-21: every lane but the first spawned, the first here with
    ``refs``, all at once; then each spawned lane's output is printed and
    its results merged. Fails if a lane fails or runs past LANE_TIMEOUT."""
    import os
    import shutil
    import tempfile

    ctx = multiprocessing.get_context("spawn")
    tmp = tempfile.mkdtemp(prefix="ovp_lanes_")
    outs = {k: f"{tmp}/lane{k}" for k in range(1, len(LANES))}
    procs = {k: ctx.Process(target=_lane_main, args=(k, out)) for k, out in outs.items()}
    t = time.time()
    for proc in procs.values():
        proc.start()
    try:
        results = drive_lane(0, refs)
        for proc in procs.values():
            proc.join(timeout=max(1.0, LANE_TIMEOUT - (time.time() - t)))
    finally:
        for proc in procs.values():
            if proc.is_alive():
                proc.terminate()
                proc.join(timeout=20)
            if proc.is_alive():
                proc.kill()
                proc.join()
        for k, out in outs.items():
            for suffix, stream in ((".log", sys.stdout), (".err", sys.stderr)):
                text = Path(out + suffix).read_text() if os.path.exists(out + suffix) else ""
                if text:
                    stream.write(f"[lane {k}] its standard {'output' if suffix == '.log' else 'error'}:\n{text}")
                    stream.flush()
    codes = {k: proc.exitcode for k, proc in procs.items()}
    if any(c != 0 for c in codes.values()):
        raise RuntimeError(f"a lane failed or ran past {LANE_TIMEOUT} s: exit codes {codes}")
    for out in outs.values():
        with open(out + ".json") as f:
            results.update({p: tuple(v) for p, v in json.load(f).items()})
    shutil.rmtree(tmp, ignore_errors=True)
    print(f"[lanes] {len(LANES)} lanes took {time.time() - t:.1f} s")
    return results


def main() -> int:
    t_start = time.time()
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script needs a CUDA card", file=sys.stderr)
        return 2
    from ov_plane_tpu_torch import native
    from ov_plane_tpu_torch.ops import kernels
    from ov_plane_tpu_torch.utils.torchenv import resolve_device

    resolve_device("cuda")
    print(f"[env] python {sys.version.split()[0]} torch {torch.__version__} cuda {torch.version.cuda}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip().splitlines()
    print(smi[0])

    t = time.time()
    refs = CpuRefs()
    refs.start()
    earlier_build = start_earlier_build(kernels)
    native.build("delaunay")          # g++, while nvcc builds the yardstick
    native.build("ikd_grid")
    native.build("aruco")
    reports = kernels.build()
    earlier_kernel = earlier_build()
    print(f"[build] {len(reports)} kernels and the earlier one built with nvcc, the host Delaunay, voxel map and "
          f"ArUco candidate search with g++, "
          f"in {time.time() - t:.2f} s")
    for name, rep in reports.items():
        for line in rep.splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build] {name}: {line.strip()}")

    try:
        imu_checked = check_imu_kernel(kernels)
        rows = time_kernels(kernels, check_kernels(kernels), earlier_kernel)
        imu_rows = time_imu_kernel(*imu_checked)
        results = drive_lanes(refs)
    finally:
        refs.close()

    meta = {
        "gram_reduce": ("ov_plane_tpu_torch/csrc/gram_reduce.cu",
                        "ov_plane_tpu/ops/pallas_kernels.py:138"),
        "kalman_downdate": ("ov_plane_tpu_torch/csrc/kalman_downdate.cu",
                            "ov_plane_tpu/ops/pallas_kernels.py:249"),
    }
    out = []
    for name, (source, replaces) in meta.items():
        # Top level: the vision path (the system's main path) and LEAD's
        # shape; per path: its launches in its run and each of its shapes'
        # numbers.
        paths = {p: dict(launches=results[p][1][name], frames=results[p][0],
                         shapes=[dict(B=B, M=M, D=D, **rows[(name, (B, M, D, dt))])
                                 for B, M, D, dt in path_shapes(name, path=p)])
                 for p in PATH_NAMES}
        out.append(dict(name=name, route="cuda", source=source, replaces=replaces,
                        launches=results["vision"][1][name], shape=list(LEAD[name][:3]),
                        **rows[(name, LEAD[name])], paths=paths))
    out.append(dict(name="imu_propagate", route="cuda", source="ov_plane_tpu_torch/csrc/imu_propagate.cu",
                    replaces=None, shapes=[dict(B=B, W=W, **imu_rows[(B, W, dt)]) for B, W, dt in IMU_SHAPES]))
    for p, (n_frames, launches, info) in results.items():
        print(f"[{p}] stream-frames/s {info['stream_frames_per_s']:.2f} over {n_frames} frames")
    print(smi[0])
    print(f"[total] the whole script took {time.time() - t_start:.1f} s")
    print(json.dumps({"kernels": out}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
