"""Configuration tree of the PyTorch port.

An own copy of the part of ``ov_plane_tpu/utils/config.py`` that the batched
point-MSCKF filter reads: the same dataclass names, field names and
defaults, so one set of overrides configures both packages. Options of the
later slices (plane frontend, SLAM, ZUPT, YAML loading) are not carried yet.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List


@dataclass
class StateOptions:
    """Filter flags (reference: state/StateOptions.h:41-154)."""

    do_fej: bool = True
    use_rk4_integration: bool = True
    imu_avg: bool = True
    do_calib_camera_pose: bool = False
    do_calib_camera_intrinsics: bool = False
    do_calib_camera_timeoffset: bool = False
    max_clone_size: int = 11
    max_slam_features: int = 25
    max_msckf_in_update: int = 40
    feat_rep_msckf: str = "GLOBAL_3D"
    feat_rep_slam: str = "GLOBAL_3D"
    use_plane_constraint: bool = True
    use_plane_constraint_msckf: bool = True
    use_plane_slam_feats: bool = True
    use_groundtruths: bool = False


@dataclass
class NoiseManager:
    """IMU continuous-time noise densities (reference: utils/NoiseManager.h)."""

    sigma_w: float = 1.6968e-04
    sigma_wb: float = 1.9393e-05
    sigma_a: float = 2.0000e-3
    sigma_ab: float = 3.0000e-03

    @property
    def sigma_w_2(self):
        return self.sigma_w**2

    @property
    def sigma_wb_2(self):
        return self.sigma_wb**2

    @property
    def sigma_a_2(self):
        return self.sigma_a**2

    @property
    def sigma_ab_2(self):
        return self.sigma_ab**2


@dataclass
class UpdaterOptions:
    """Per-updater chi2 multiplier + pixel sigma (reference: update/UpdaterOptions.h)."""

    chi2_multipler: float = 5.0
    sigma_pix: float = 1.0


@dataclass
class FeatureInitializerOptions:
    """Triangulation options (reference: ov_core FeatureInitializerOptions)."""

    refine_features: bool = True
    max_runs: int = 5
    min_dist: float = 0.10
    max_dist: float = 60.0
    max_cond_number: float = 10000.0


@dataclass
class SimOptions:
    """Simulator options (reference: VioManagerOptions.h sim_* block); the
    port's scene is committed, so only the IMU rate of its noise is read."""

    freq_imu: float = 400.0


@dataclass
class TpuOptions:
    """Static capacities of the fixed-shape filter (same names as the JAX package)."""

    max_features: int = 768
    max_obs_per_frame: int = 512
    max_planes: int = 8
    max_msckf_update: int = 64
    max_imu_per_frame: int = 64
    shard_axis: str = ""
    use_info_compression: bool = False


@dataclass
class VioConfig:
    """Master config aggregate (reference: core/VioManagerOptions.h:62)."""

    state: StateOptions = field(default_factory=StateOptions)
    imu_noises: NoiseManager = field(default_factory=NoiseManager)
    msckf_options: UpdaterOptions = field(default_factory=lambda: UpdaterOptions(chi2_multipler=5.0, sigma_pix=1.0))
    featinit: FeatureInitializerOptions = field(default_factory=FeatureInitializerOptions)
    sim: SimOptions = field(default_factory=SimOptions)
    tpu: TpuOptions = field(default_factory=TpuOptions)

    gravity_mag: float = 9.81
    calib_camimu_dt: float = 0.0
    cam_model: str = "radtan"
    cam_intrinsics: List[float] = field(
        default_factory=lambda: [458.654, 457.296, 367.215, 248.375, -0.28340811, 0.07395907, 0.00019359, 1.76187114e-05]
    )
    cam_extrinsics: List[float] = field(default_factory=lambda: [0.0, 0.0, 0.0, 1.0, 0.0, 0.0, 0.0])
    use_aruco: bool = False
    try_zupt: bool = False


def sim_config(**overrides) -> VioConfig:
    """The simulator configuration (config/sim/estimator_config.yaml defaults).

    The same baked-in values as the JAX package's ``sim_config`` when the
    reference tree is absent. Dotted keyword overrides apply on top.
    """
    cfg = VioConfig()
    cfg.state.max_slam_features = 50
    cfg.msckf_options.chi2_multipler = 99999
    cfg.cam_model = "radtan"
    cfg.cam_intrinsics = [458.654, 457.296, 367.215, 248.375, -0.28340811, 0.07395907, 0.00019359, 1.76187114e-05]
    cfg.cam_extrinsics = [0.0, 0.0, 0.0, 1.0, 0.0, 0.0, 0.0]
    for key, value in overrides.items():
        obj = cfg
        parts = key.split(".")
        for p in parts[:-1]:
            obj = getattr(obj, p)
        setattr(obj, parts[-1], value)
    return cfg


def slice_config() -> VioConfig:
    """The filter configuration of the repo's simulator bench (``bench.py``
    sim mode: bank 192, 96 observation slots, 40 features per update,
    information-form compression, calibration off, D = 93) with plane
    constraints off. Its 30 s, 60-point scene is the committed one
    (``sim.simulator.load_scene``)."""
    cfg = sim_config()
    cfg.state.max_slam_features = 0
    cfg.state.do_calib_camera_pose = False
    cfg.state.do_calib_camera_intrinsics = False
    cfg.state.do_calib_camera_timeoffset = False
    cfg.state.use_plane_constraint = False
    cfg.tpu.max_features = 192
    cfg.tpu.max_obs_per_frame = 96
    cfg.tpu.max_msckf_update = 40
    cfg.tpu.use_info_compression = True
    cfg.tpu.max_planes = 1
    return cfg
