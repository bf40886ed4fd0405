"""Per-stage wall-clock profiling of the filter step (counterpart of
``ov_plane_tpu/utils/profiling.py``).

The reference's rT1..rT8 stage bracketing and timing CSV
(VioManager.cpp:97-119, 879-928): the step runs as one stream of launches
with no synchronization inside, so this *staged* runner calls the same
stages of the point path (propagation, tracking, MSCKF update, re-tri &
marg) one at a time and ends each at a device synchronization, under the
reference CSV's column names (``eval.io.TimingRecorder``). The
synchronizations make these stages' times a different thing from the
step's: for the step's own host time per stage, record its spans
(``utils.trace``: ``enable``, step, ``export``); for kernel-level traces
use ``torch.profiler`` around ``models.manager.step``.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ov_plane_tpu_torch.eval.io import TimingRecorder
from ov_plane_tpu_torch.models import feature_bank as fb
from ov_plane_tpu_torch.models.manager import VioEngine, _imu_constants, triage
from ov_plane_tpu_torch.models.msckf import msckf_update
from ov_plane_tpu_torch.ops import cams
from ov_plane_tpu_torch.state.propagator import marginalize_oldest_clone, propagate_and_clone
from ov_plane_tpu_torch.state.vio_state import tree_where


def run_sequence_profiled(eng: VioEngine, state, bank, sim_data, imu_window: int,
                          max_frames: int | None = None) -> TimingRecorder:
    """Replay B streams of ``sim_data`` (``SimData`` with B streams) through
    the point path's stages with a timer around each (the first frames
    include the libraries' warm-up). Returns the TimingRecorder: one row per
    frame, its stages adding up to its ``total``."""
    rec = TimingRecorder()
    dev, B = state.imu.device, state.imu.shape[0]
    noises, gravity = _imu_constants(eng, state.imu.dtype, dev)
    n_frames = sim_data.cam_t_imu.shape[0] - 1
    if max_frames:
        n_frames = min(n_frames, max_frames)
    Ti = sim_data.imu_t.shape[-1]
    starts = np.asarray(sim_data.imu_window_start)
    cam_t_imu = sim_data.cam_t_imu.cpu().numpy()
    no_slam = torch.zeros(B, dtype=torch.bool, device=dev)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        return time.perf_counter()

    for i in range(1, n_frames + 1):
        stages = {}
        s = int(min(max(int(starts[i]), 0), Ti - imu_window))
        t0 = sync()
        state, slot = propagate_and_clone(state, sim_data.imu_t[s:s + imu_window].expand(B, imu_window),
                                          sim_data.imu_w[:, s:s + imu_window], sim_data.imu_a[:, s:s + imu_window],
                                          sim_data.cam_t[i].expand(B), noises, gravity, eng.prop_opts)
        t1 = sync()
        stages["propagation"] = t1 - t0

        obs_uv = sim_data.obs_uv[:, i]
        uvn = cams.undistort(obs_uv, state.cam_zeta[:, None, :], eng.cam_model)
        bank = fb.ingest(bank, sim_data.obs_id[i].expand(B, -1), obs_uv, uvn,
                         sim_data.obs_plane[i].expand(B, -1), slot)
        sel_idx, sel_valid, _, _ = triage(eng, state, bank, slot, no_slam)
        sel_valid = sel_valid & (state.num_clones >= eng.min_clones_to_update)[:, None]
        t2 = sync()
        stages["tracking"] = t2 - t1

        state, _, _, _ = msckf_update(state, eng.msckf_opts, fb._take(bank.uv, sel_idx), fb._take(bank.uvn, sel_idx),
                                      fb._take(bank.mask, sel_idx) & sel_valid[..., None])
        t3 = sync()
        stages["msckf update"] = t3 - t2

        F = bank.fid.shape[1]
        consumed = ((torch.arange(F, device=dev)[None, :, None] == sel_idx[:, None, :])
                    & sel_valid[:, None, :]).any(dim=-1)
        bank = fb.free_rows(bank, consumed)
        marg_slot = state.oldest_clone_slot
        over = state.num_clones > eng.max_clone_size
        state = marginalize_oldest_clone(state, eng.max_clone_size)
        bank = tree_where(over, fb.clear_clone_column(bank, marg_slot), bank)
        t4 = sync()
        stages["re-tri & marg"] = t4 - t3
        stages["total"] = t4 - t0
        rec.add(float(cam_t_imu[i]), stages)
    return rec
