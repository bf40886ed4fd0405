"""Carry the JAX package's data across to the port's tensors.

The JAX package's state, feature bank and simulator data are pytrees of
arrays. Handed over as mappings of numpy arrays (field name -> array), these
functions build the port's [B, ...] containers: per-stream mappings are
stacked along a new leading stream dimension. A state carries its SLAM
landmark slots (``slam_p``, ``slam_p_fej``, ``slam_id``, ``slam_active``,
``slam_anchor_slot``), plane slots (``plane_cp``, ``plane_cp_fej``,
``plane_id``, ``plane_active``) and calibration (``calib_dt``, ``last_dt``,
``calib_cam``, ``cam_zeta`` and the covariance over the layout's calibration
columns), a bank its features' plane ids, SLAM marks (``is_slam``,
``slam_slot``) and truth columns (``gt_p``, ``gt_cp``); simulator data
carries the per-observation plane ids (``obs_plane``), each observation's
truth (``obs_gt_p``, ``obs_gt_cp``) and, for a plane scene, the true plane
CPs; :func:`sim_from_arrays` takes one draw or a vmapped batch of
draws, noisy or as the noiseless scene with its map. A fused frontend's
tracker state (:func:`frontend_from_arrays`) carries its prepared pyramid,
so both packages can start one step from the same state. Every function makes its tensors on the card unless the caller
asks for the CPU.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping, Sequence

import numpy as np
import torch

from ov_plane_tpu_torch.frontend.fused import FusedFrontendState
from ov_plane_tpu_torch.frontend.klt import PreparedPyramid
from ov_plane_tpu_torch.models.feature_bank import FeatureBank
from ov_plane_tpu_torch.sim.simulator import SimData, truth_from_arrays
from ov_plane_tpu_torch.state.layout import StateLayout
from ov_plane_tpu_torch.state.vio_state import VioState
from ov_plane_tpu_torch.utils.torchenv import resolve_device


# The fields of a simulator draw that carry its noise (the rest is the scene's).
NOISY_FIELDS = ("imu_w", "imu_a", "gt_bg", "gt_ba", "obs_uv", "gt_bg_cam", "gt_ba_cam")


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
    device = resolve_device(device)
    names = [f.name for f in dataclasses.fields(cls) if f.name not in static]
    return cls(**static, **{k: _tensor(arrays[k], dtype, device) for k in names})


def state_from_arrays(arrays: Mapping[str, np.ndarray], layout: StateLayout,
                      dtype=torch.float64, device="cuda") -> VioState:
    """VioState from [B, ...] arrays named as the JAX VioState's fields."""
    return _fill(VioState, arrays, dtype, device, layout=layout)


def bank_from_arrays(arrays: Mapping[str, np.ndarray], dtype=torch.float64, device="cuda") -> FeatureBank:
    """FeatureBank from [B, ...] arrays named as the JAX FeatureBank's fields."""
    return _fill(FeatureBank, arrays, dtype, device)


def sim_from_streams(streams: Sequence[Mapping[str, np.ndarray]], dtype=torch.float64,
                     device="cuda") -> SimData:
    """SimData of B streams from B noisy JAX SimData draws of one scene.

    The scene-wide fields come from the first draw; the noisy fields (IMU,
    pixels, bias truth) are stacked.
    """
    device = resolve_device(device)
    scene = {k: v for k, v in streams[0].items() if k not in NOISY_FIELDS}
    return _sim(scene, stack_streams([{k: s[k] for k in NOISY_FIELDS} for s in streams]), dtype, device)


def sim_from_arrays(arrays: Mapping[str, np.ndarray], noisy: bool = True, dtype=torch.float64,
                    device="cuda"):
    """The port's simulator data from one JAX ``SimData`` (field name ->
    numpy array), one draw or a vmapped batch of draws (the noisy fields
    then carry a leading stream dimension, and the scene-wide fields, equal
    over the batch, are taken from the first draw).

    ``noisy``: a ``SimData`` of B streams (B = 1 for one draw) with the
    draw's noise; otherwise the noiseless ``SimTruth`` with the map and each
    observation's truth (``feat_p``, ``feat_plane``, ``obs_gt_p``,
    ``obs_gt_cp``, ``plane_cp``)."""
    device = resolve_device(device)
    batched = np.ndim(arrays["imu_w"]) == 3
    scene = {k: np.asarray(v)[0] if batched else np.asarray(v) for k, v in arrays.items() if k not in NOISY_FIELDS}
    if not noisy:
        return truth_from_arrays(scene, dtype, device)
    return _sim(scene, {k: np.asarray(arrays[k]) if batched else np.asarray(arrays[k])[None] for k in NOISY_FIELDS},
                dtype, device)


def _sim(scene, noisy, dtype, device) -> SimData:
    """SimData from the scene-wide arrays and the [B, ...] noisy ones."""
    truth = truth_from_arrays(scene, dtype, device)
    t = {k: torch.as_tensor(v, dtype=dtype, device=device) for k, v in noisy.items()}
    return SimData(
        imu_t=truth.imu_t, cam_t=truth.cam_t, cam_t_imu=truth.cam_t_imu, obs_id=truth.obs_id,
        obs_plane=truth.obs_plane, imu_window_start=truth.imu_window_start,
        gt_q=truth.gt_q, gt_p=truth.gt_p, gt_v=truth.gt_v, obs_gt_p=truth.obs_gt_p,
        obs_gt_cp=truth.obs_gt_cp, **t,
    )


def frontend_from_arrays(arrays: Mapping, device="cuda") -> FusedFrontendState:
    """FusedFrontendState from [B, ...] arrays named as the JAX
    FusedFrontendState's fields; ``arrays["pyr"]`` maps ``padded`` and
    ``grads`` to the JAX PreparedPyramid's padded levels and gradient pairs
    (its unpadded ``imgs`` are not kept). Images and tracks are float32, as
    the JAX frontend holds them."""
    device = resolve_device(device)
    f32 = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.float32, device=device)  # noqa: E731
    pyr = arrays["pyr"]
    prepared = PreparedPyramid(tuple(f32(p) for p in pyr["padded"]),
                               tuple((f32(gx), f32(gy)) for gx, gy in pyr["grads"]))
    rest = {k: _tensor(arrays[k], torch.float32, device)
            for k in ("ids", "uv", "valid", "next_id", "tri_A", "tri_b", "tri_c", "tri_n", "has_prev")}
    return FusedFrontendState(pyr=prepared, **rest)
