"""Carry the JAX package's data across to the port's tensors.

The JAX package's state, feature bank and simulator data are pytrees of
arrays. Handed over as mappings of numpy arrays (field name -> array), these
functions build the port's [B, ...] containers: per-stream mappings are
stacked along a new leading stream dimension. Fields the port does not hold
yet (SLAM anchors, ground-truth injection) are ignored.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping, Sequence

import numpy as np
import torch

from ov_plane_tpu_torch.models.feature_bank import FeatureBank
from ov_plane_tpu_torch.sim.simulator import SimData, truth_from_arrays
from ov_plane_tpu_torch.state.layout import StateLayout
from ov_plane_tpu_torch.state.vio_state import VioState


def stack_streams(streams: Sequence[Mapping[str, np.ndarray]]) -> dict:
    """Per-stream mappings -> one mapping of [B, ...] arrays."""
    return {k: np.stack([np.asarray(s[k]) for s in streams]) for k in streams[0]}


def _tensor(a, dtype, device):
    a = np.asarray(a)
    if a.dtype == np.bool_:
        return torch.as_tensor(a, device=device)
    if np.issubdtype(a.dtype, np.integer):
        return torch.as_tensor(a.astype(np.int32), device=device)
    return torch.as_tensor(a, dtype=dtype, device=device)


def _fill(cls, arrays, dtype, device, **static):
    names = [f.name for f in dataclasses.fields(cls) if f.name not in static]
    return cls(**static, **{k: _tensor(arrays[k], dtype, device) for k in names})


def state_from_arrays(arrays: Mapping[str, np.ndarray], layout: StateLayout,
                      dtype=torch.float64, device="cpu") -> VioState:
    """VioState from [B, ...] arrays named as the JAX VioState's fields."""
    return _fill(VioState, arrays, dtype, device, layout=layout)


def bank_from_arrays(arrays: Mapping[str, np.ndarray], dtype=torch.float64, device="cpu") -> FeatureBank:
    """FeatureBank from [B, ...] arrays named as the JAX FeatureBank's fields."""
    return _fill(FeatureBank, arrays, dtype, device)


def sim_from_streams(streams: Sequence[Mapping[str, np.ndarray]], dtype=torch.float64,
                     device="cpu") -> SimData:
    """SimData of B streams from B noisy JAX SimData draws of one scene.

    The scene-wide fields come from the first draw; the noisy fields (IMU,
    pixels, bias truth) are stacked.
    """
    truth = truth_from_arrays(streams[0], dtype, device)
    noisy = stack_streams([{k: s[k] for k in ("imu_w", "imu_a", "gt_bg", "gt_ba", "obs_uv",
                                               "gt_bg_cam", "gt_ba_cam")} for s in streams])
    t = {k: torch.as_tensor(v, dtype=dtype, device=device) for k, v in noisy.items()}
    return SimData(
        imu_t=truth.imu_t, cam_t=truth.cam_t, cam_t_imu=truth.cam_t_imu, obs_id=truth.obs_id,
        obs_plane=truth.obs_plane, imu_window_start=truth.imu_window_start,
        gt_q=truth.gt_q, gt_p=truth.gt_p, gt_v=truth.gt_v, **t,
    )
