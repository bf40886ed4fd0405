"""Configuration tree of the PyTorch port.

An own copy of the part of ``ov_plane_tpu/utils/config.py`` that the port
reads (the point-MSCKF path, SLAM landmarks, the plane filter stages and the
fused vision frontend): the same dataclass names, field names and defaults,
so one set of overrides configures both packages. Options of the later
slices (ZUPT, ArUco, YAML loading) are not carried yet.
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

    # Plane options (reference: StateOptions.h "16 plane-specific options").
    use_plane_constraint: bool = True
    use_plane_constraint_msckf: bool = True
    use_plane_constraint_slamu: bool = True
    use_plane_constraint_slamd: bool = True
    use_plane_slam_feats: bool = True
    use_refine_plane_feat: bool = True
    use_plane_ransac: bool = False
    use_groundtruths: bool = False
    sigma_constraint: float = 0.05
    const_init_multi: float = 5.0
    const_init_chi2: float = 1.0
    max_msckf_plane: int = 20
    sigma_plane_merge: float = 0.1
    plane_merge_chi2: float = 1.0
    plane_merge_deg_max: float = 1.0
    plane_collect_init_feats: bool = True
    plane_collect_msckf_feats: bool = True
    plane_init_min_feat: int = 10
    plane_init_max_cond: float = 50.0
    plane_msckf_min_feat: int = 5
    plane_msckf_max_cond: float = 50.0
    # Robust plane refinement: CauchyLoss(1.0) on every factor and post-opt
    # inlier re-acceptance at 0.03 m with >= max(4, 0.8·n) survivors
    # (PlaneFitting.cpp:256,367,452-495); 0 disables.
    plane_refine_cauchy: float = 1.0
    plane_refine_max_error: float = 0.03
    plane_refine_min_inlier_ratio: float = 0.80
    # Plane-feature triangulation gates (plane_feat_* keys in YAML).
    plane_feat_min_obs: int = 2
    plane_min_dist: float = 0.10
    plane_max_dist: float = 60.0
    plane_max_cond_number: float = 20000.0


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
class TrackPlaneOptions:
    """Plane-frontend thresholds (reference: track_plane/TrackPlaneOptions.h:38-81)."""

    max_tri_side_px: float = 200.0
    max_norm_count: int = 8
    max_norm_avg_max: float = 20.0
    max_norm_avg_var: float = 20.0
    max_norm_deg: float = 25.0
    max_dist_between_z: float = 0.30
    max_pairwise_px: float = 100.0
    min_norms: int = 5
    check_old_feats: bool = True
    filter_num_feat: int = 4
    filter_z_thresh: float = 5.0
    # Incremental whole-track triangulation gates (TrackPlaneOptions.h:77-80).
    feat_init_min_obs: int = 4
    min_dist: float = 0.10
    max_dist: float = 60.0
    max_cond_number: float = 8000.0
    # Whole-track ray-intersection RMS gate: max(rel · depth, abs) meters.
    max_ray_rms_rel: float = 0.03
    max_ray_rms_abs: float = 0.10


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
    # Grouped out-of-state plane updates per frame: the reference processes
    # every group; overflow is counted in StepOutput.n_plane_dropped.
    max_planes_per_frame: int = 8
    max_imu_per_frame: int = 64
    shard_axis: str = ""
    use_info_compression: bool = False
    # Tilt-aware constraint whitening of each plane group:
    # sqrt(sigma_c² + σ_z² + (‖cp‖·σ_z/s_lat)²) (no reference analogue).
    sigma_c_adaptive: bool = False


@dataclass
class VioConfig:
    """Master config aggregate (reference: core/VioManagerOptions.h:62)."""

    state: StateOptions = field(default_factory=StateOptions)
    imu_noises: NoiseManager = field(default_factory=NoiseManager)
    msckf_options: UpdaterOptions = field(default_factory=lambda: UpdaterOptions(chi2_multipler=5.0, sigma_pix=1.0))
    slam_options: UpdaterOptions = field(default_factory=lambda: UpdaterOptions(chi2_multipler=5.0, sigma_pix=1.0))
    featinit: FeatureInitializerOptions = field(default_factory=FeatureInitializerOptions)
    trackplane: TrackPlaneOptions = field(default_factory=TrackPlaneOptions)
    sim: SimOptions = field(default_factory=SimOptions)
    tpu: TpuOptions = field(default_factory=TpuOptions)

    gravity_mag: float = 9.81
    calib_camimu_dt: float = 0.0
    cam_model: str = "radtan"
    cam_intrinsics: List[float] = field(
        default_factory=lambda: [458.654, 457.296, 367.215, 248.375, -0.28340811, 0.07395907, 0.00019359, 1.76187114e-05]
    )
    cam_wh: List[int] = field(default_factory=lambda: [752, 480])
    cam_extrinsics: List[float] = field(default_factory=lambda: [0.0, 0.0, 0.0, 1.0, 0.0, 0.0, 0.0])

    # Frontend knobs (reference: VioManagerOptions tracker block).
    num_pts: int = 150
    num_pts_plane: int = 150
    fast_threshold: int = 15
    grid_x: int = 20
    grid_y: int = 20
    min_px_dist: int = 15
    histogram_method: str = "HISTOGRAM"  # NONE, HISTOGRAM, CLAHE

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
    cfg.slam_options.chi2_multipler = 99999
    cfg.cam_model = "radtan"
    cfg.cam_wh = [752, 480]
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


def plane_config() -> VioConfig:
    """M-PL: the plane arm of the repo's algorithm ladder
    (``scripts/run_sweep.py`` ``VARIANTS["M-PL"]``: 30 s procedural
    ``room_scan``, 40 free points + 40 points on planes, bank 192, 96
    observation slots, 40 features per update, no SLAM landmarks, CP planes
    with point-on-plane constraints), with information-form compression on
    as the sweep sets it on an accelerator. Calibration off; K = 12 clone
    slots, 8 plane slots, D = 15 + 72 + 3 + 24 = 114. Its scene is the
    committed one (``sim.simulator.PLANE_SCENE_PATH``)."""
    cfg = sim_config()
    cfg.state.max_slam_features = 0
    cfg.state.do_calib_camera_pose = False
    cfg.state.do_calib_camera_intrinsics = False
    cfg.state.do_calib_camera_timeoffset = False
    cfg.state.use_plane_constraint = True
    cfg.state.use_plane_slam_feats = True
    cfg.state.use_plane_constraint_msckf = True
    cfg.tpu.max_features = 192
    cfg.tpu.max_obs_per_frame = 96
    cfg.tpu.max_msckf_update = 40
    cfg.tpu.max_planes = 8
    cfg.tpu.max_planes_per_frame = 8
    cfg.tpu.use_info_compression = True
    return cfg


def vision_config() -> VioConfig:
    """The fused vision path of the repo's bench (``bench.py`` vision mode,
    its headline workload): 640×480 radtan camera, planes on with
    point-on-plane constraints, no SLAM
    landmarks, calibration off, information-form compression, bank 128, 64
    feature slots per frame, 24 features per update, FAST top-up to 55
    features. K = 12 clone slots and 8 plane slots give D = 114. The same
    values as the bench sets them. Its scene is the committed one
    (``sim.simulator.VISION_SCENE_PATH``: a 6 s room scan, camera at 20 Hz),
    generated with the bench's simulator settings by
    ``tests/test_torch_scene.py``."""
    cfg = sim_config()
    cfg.state.max_slam_features = 0
    cfg.state.use_plane_constraint = True
    cfg.state.use_plane_slam_feats = True
    cfg.state.plane_init_min_feat = 8
    cfg.state.do_calib_camera_pose = False
    cfg.state.do_calib_camera_intrinsics = False
    cfg.state.do_calib_camera_timeoffset = False
    cfg.num_pts = 15
    cfg.num_pts_plane = 40
    cfg.cam_wh = [640, 480]
    cfg.cam_intrinsics = [300.0, 300.0, 320.0, 240.0, 0.0, 0.0, 0.0, 0.0]
    cfg.histogram_method = "NONE"
    cfg.tpu.max_features = 128
    cfg.tpu.max_obs_per_frame = 64
    cfg.tpu.max_msckf_update = 24
    cfg.tpu.use_info_compression = True
    cfg.trackplane.min_norms = 3
    cfg.trackplane.max_norm_avg_var = 30.0
    cfg.trackplane.max_norm_avg_max = 30.0
    cfg.msckf_options.chi2_multipler = 5.0
    cfg.state.plane_init_max_cond = 150.0
    cfg.state.plane_msckf_max_cond = 150.0
    cfg.msckf_options.sigma_pix = 2.0
    cfg.slam_options.sigma_pix = 2.0
    return cfg


def ms_pl_config() -> VioConfig:
    """MS-PL: the top arm of the repo's algorithm ladder (``scripts/run_sweep.py``
    ``VARIANTS["MS-PL"] = (12, True)``): :func:`plane_config` with 12 SLAM
    landmark slots, GLOBAL_3D landmarks (planes on), delayed SLAM init of up
    to 8 promoted tracks per frame, point-on-plane rows in the SLAM update
    and init. K = 12 clone slots, 12 landmark slots and 8 plane slots give
    D = 15 + 72 + 36 + 24 = 147. It runs on the committed M-PL scene
    (``sim.simulator.PLANE_SCENE_PATH``), whose generation does not read the
    landmark count."""
    cfg = plane_config()
    cfg.state.max_slam_features = 12
    return cfg


def tabletop_config() -> VioConfig:
    """The fused vision path on the JAX package's plane-firing scene
    (``tests/test_fused_planes.py``): a 6 s tabletop trajectory with the
    camera at 20 Hz, 50 points, the reference's stock plane gates, 640×480
    radtan camera, no SLAM landmarks, calibration off, bank 128, 64 feature
    slots per frame, 24 features per update, pixel sigma 2.0 (the renderer's
    KLT noise). K = 12 clone slots and 8 plane slots give D = 114. Its scene
    is the committed one (``sim.simulator.TABLETOP_SCENE_PATH``), generated
    with those simulator settings (``min_feature_gen_distance`` 1.0) by
    ``tests/test_torch_scene.py``."""
    cfg = sim_config()
    cfg.state.max_slam_features = 0
    cfg.state.use_plane_constraint = True
    cfg.state.use_plane_slam_feats = True
    cfg.state.do_calib_camera_pose = False
    cfg.state.do_calib_camera_intrinsics = False
    cfg.state.do_calib_camera_timeoffset = False
    cfg.num_pts = 50
    cfg.num_pts_plane = 0
    cfg.cam_wh = [640, 480]
    cfg.cam_intrinsics = [300.0, 300.0, 320.0, 240.0, 0.0, 0.0, 0.0, 0.0]
    cfg.histogram_method = "NONE"
    cfg.tpu.max_features = 128
    cfg.tpu.max_obs_per_frame = 64
    cfg.tpu.max_msckf_update = 24
    cfg.msckf_options.sigma_pix = 2.0
    cfg.slam_options.sigma_pix = 2.0
    return cfg
