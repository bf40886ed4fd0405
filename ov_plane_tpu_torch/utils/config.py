"""Configuration tree of the PyTorch port.

An own copy of the part of ``ov_plane_tpu/utils/config.py`` that the port
reads (the point-MSCKF path, SLAM landmarks, the plane filter stages, the
fused vision frontend and the dataset replay): the same dataclass names,
field names and defaults, so one set of overrides configures both packages,
and :func:`load_yaml` reads the reference's ``estimator_config.yaml`` into
it. The ZUPT and ArUco fields are carried for the YAML surface:
``VioEngine.from_config`` refuses the features that are not ported yet.
"""

from __future__ import annotations

import dataclasses
import re
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional


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
    max_slam_in_update: int = 25
    max_msckf_in_update: int = 40
    num_cameras: int = 1
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
    """Simulator options (reference: VioManagerOptions.h sim_* block), read
    by ``sim.simulator.build_sim``: the trajectory (``traj_path`` or the
    procedural ``traj_kind``), the camera and IMU rates, the start distance,
    the feature generation distances and the map seed."""

    seed_state_init: int = 0
    seed_perturb: int = 0
    seed_measurements: int = 0
    do_perturbation: bool = False
    traj_path: str = ""  # empty -> procedural trajectory
    # Seconds of a loaded trajectory to skip before the replay starts
    # (procedural kinds ignore it).
    traj_start: float = 0.0
    distance_threshold: float = 1.2
    freq_cam: float = 10.0
    freq_imu: float = 400.0
    min_feature_gen_distance: float = 2.0
    max_feature_gen_distance: float = 5.0
    # Procedural trajectory (no reference analogue): its length, its kind
    # (room_scan, slow_scan, corridor, tabletop) and a rigid world
    # translation (the planes follow through the trajectory's bounding box).
    traj_duration: float = 60.0
    traj_kind: str = "room_scan"
    world_offset: tuple = (0.0, 0.0, 0.0)


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
    zupt_options: UpdaterOptions = field(default_factory=lambda: UpdaterOptions(chi2_multipler=1.0, sigma_pix=1.0))
    featinit: FeatureInitializerOptions = field(default_factory=FeatureInitializerOptions)
    trackplane: TrackPlaneOptions = field(default_factory=TrackPlaneOptions)
    sim: SimOptions = field(default_factory=SimOptions)
    tpu: TpuOptions = field(default_factory=TpuOptions)

    verbosity: str = "INFO"  # console verbosity (utils.printer), applied by the entry points
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
    track_frequency: float = 21.0
    histogram_method: str = "HISTOGRAM"  # NONE, HISTOGRAM, CLAHE

    use_aruco: bool = False
    downsize_aruco: bool = True
    try_zupt: bool = False
    zupt_max_velocity: float = 0.1
    zupt_noise_multiplier: float = 50.0
    zupt_max_disparity: float = 0.5
    zupt_only_at_beginning: bool = True
    zupt_integrated_accel: bool = False
    zupt_explicit_zero_motion: bool = False


# Reference YAML key -> (section of VioConfig, field); a copy of the JAX package's map.
_YAML_MAP = {
    "use_fej": ("state", "do_fej"),
    "use_rk4int": ("state", "use_rk4_integration"),
    "use_imuavg": ("state", "imu_avg"),
    "calib_cam_extrinsics": ("state", "do_calib_camera_pose"),
    "calib_cam_intrinsics": ("state", "do_calib_camera_intrinsics"),
    "calib_cam_timeoffset": ("state", "do_calib_camera_timeoffset"),
    "max_clones": ("state", "max_clone_size"),
    "max_slam": ("state", "max_slam_features"),
    "max_slam_in_update": ("state", "max_slam_in_update"),
    "max_msckf_in_update": ("state", "max_msckf_in_update"),
    "max_cameras": ("state", "num_cameras"),
    "feat_rep_msckf": ("state", "feat_rep_msckf"),
    "feat_rep_slam": ("state", "feat_rep_slam"),
    "use_plane_constraint": ("state", "use_plane_constraint"),
    "use_plane_constraint_msckf": ("state", "use_plane_constraint_msckf"),
    "use_plane_constraint_slamu": ("state", "use_plane_constraint_slamu"),
    "use_plane_constraint_slamd": ("state", "use_plane_constraint_slamd"),
    "use_plane_slam_feats": ("state", "use_plane_slam_feats"),
    "use_refine_plane_feat": ("state", "use_refine_plane_feat"),
    "use_plane_ransac": ("state", "use_plane_ransac"),
    "use_groundtruths": ("state", "use_groundtruths"),
    "sigma_constraint": ("state", "sigma_constraint"),
    "const_init_multi": ("state", "const_init_multi"),
    "const_init_chi2": ("state", "const_init_chi2"),
    "max_msckf_plane": ("state", "max_msckf_plane"),
    "sigma_plane_merge": ("state", "sigma_plane_merge"),
    "plane_merge_chi2": ("state", "plane_merge_chi2"),
    "plane_merge_deg_max": ("state", "plane_merge_deg_max"),
    "plane_collect_init_feats": ("state", "plane_collect_init_feats"),
    "plane_collect_msckf_feats": ("state", "plane_collect_msckf_feats"),
    "plane_init_min_feat": ("state", "plane_init_min_feat"),
    "plane_init_max_cond": ("state", "plane_init_max_cond"),
    "plane_msckf_min_feat": ("state", "plane_msckf_min_feat"),
    "plane_msckf_max_cond": ("state", "plane_msckf_max_cond"),
    "plane_feat_min_obs": ("state", "plane_feat_min_obs"),
    "plane_min_dist": ("state", "plane_min_dist"),
    "plane_max_dist": ("state", "plane_max_dist"),
    "plane_max_cond_number": ("state", "plane_max_cond_number"),
    "plane_max_tri_side_px": ("trackplane", "max_tri_side_px"),
    "plane_max_norm_count": ("trackplane", "max_norm_count"),
    "plane_max_norm_avg_max": ("trackplane", "max_norm_avg_max"),
    "plane_max_norm_avg_var": ("trackplane", "max_norm_avg_var"),
    "plane_max_norm_deg": ("trackplane", "max_norm_deg"),
    "plane_max_dist_between_z": ("trackplane", "max_dist_between_z"),
    "plane_max_pairwise_px": ("trackplane", "max_pairwise_px"),
    "plane_min_norms": ("trackplane", "min_norms"),
    "plane_check_old_feats": ("trackplane", "check_old_feats"),
    "plane_feat_min_obs": ("trackplane", "feat_init_min_obs"),
    "plane_min_dist": ("trackplane", "min_dist"),
    "plane_max_dist": ("trackplane", "max_dist"),
    "plane_max_cond_number": ("trackplane", "max_cond_number"),
    "plane_filter_num_feat": ("trackplane", "filter_num_feat"),
    "plane_filter_z_thresh": ("trackplane", "filter_z_thresh"),
    "verbosity": (None, "verbosity"),
    "gravity_mag": (None, "gravity_mag"),
    "num_pts": (None, "num_pts"),
    "num_pts_plane": (None, "num_pts_plane"),
    "fast_threshold": (None, "fast_threshold"),
    "use_aruco": (None, "use_aruco"),
    "downsize_aruco": (None, "downsize_aruco"),
    "grid_x": (None, "grid_x"),
    "grid_y": (None, "grid_y"),
    "min_px_dist": (None, "min_px_dist"),
    "track_frequency": (None, "track_frequency"),
    "histogram_method": (None, "histogram_method"),
    "try_zupt": (None, "try_zupt"),
    "zupt_max_velocity": (None, "zupt_max_velocity"),
    "zupt_noise_multiplier": (None, "zupt_noise_multiplier"),
    "zupt_max_disparity": (None, "zupt_max_disparity"),
    "zupt_only_at_beginning": (None, "zupt_only_at_beginning"),
    "zupt_integrated_accel": (None, "zupt_integrated_accel"),
    "zupt_explicit_zero_motion": (None, "zupt_explicit_zero_motion"),
    "up_msckf_sigma_px": ("msckf_options", "sigma_pix"),
    "up_msckf_chi2_multipler": ("msckf_options", "chi2_multipler"),
    "up_slam_sigma_px": ("slam_options", "sigma_pix"),
    "up_slam_chi2_multipler": ("slam_options", "chi2_multipler"),
    "zupt_chi2_multipler": ("zupt_options", "chi2_multipler"),
    "sim_seed_state_init": ("sim", "seed_state_init"),
    "sim_seed_preturb": ("sim", "seed_perturb"),
    "sim_seed_measurements": ("sim", "seed_measurements"),
    "sim_do_perturbation": ("sim", "do_perturbation"),
    "sim_traj_path": ("sim", "traj_path"),
    "sim_distance_threshold": ("sim", "distance_threshold"),
    "sim_freq_cam": ("sim", "freq_cam"),
    "sim_freq_imu": ("sim", "freq_imu"),
    "sim_min_feature_gen_dist": ("sim", "min_feature_gen_distance"),
    "sim_max_feature_gen_dist": ("sim", "max_feature_gen_distance"),
}


# The YAML 1.1 plain scalars ``yaml.safe_load`` resolves, in the subset
# estimator configs use: booleans, null, decimal integers and floats.
_BOOL = {**dict.fromkeys("yes Yes YES true True TRUE on On ON".split(), True),
         **dict.fromkeys("no No NO false False FALSE off Off OFF".split(), False)}
_NULL = {"", "~", "null", "Null", "NULL"}
_INT = re.compile(r"[-+]?(?:0|[1-9][0-9_]*)")
_FLOAT = re.compile(r"[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?|\.[0-9_]+(?:[eE][-+][0-9]+)?")
_SPECIAL_FLOAT = {".inf": float("inf"), ".Inf": float("inf"), ".INF": float("inf"),
                  "+.inf": float("inf"), "+.Inf": float("inf"), "+.INF": float("inf"),
                  "-.inf": float("-inf"), "-.Inf": float("-inf"), "-.INF": float("-inf"),
                  ".nan": float("nan"), ".NaN": float("nan"), ".NAN": float("nan")}
_OTHER_NUMBER = re.compile(r"[-+]?(?:0[0-7_]+|0x[0-9a-fA-F_]+|0b[01_]+|[0-9][0-9_]*(?::[0-5]?[0-9])+(?:\.[0-9_]*)?)")
_TIMESTAMP = re.compile(r"[0-9]{4}-[0-9]{1,2}-[0-9]{1,2}(?:(?:[Tt]|[ \t]+).*)?")
_KEY = re.compile(r"([A-Za-z_][A-Za-z0-9_]*)\s*:(?:\s+|$)")


def _strip_comment(text: str) -> str:
    """``text`` up to a comment (`` #`` outside quotes)."""
    quote = None
    for i, ch in enumerate(text):
        if quote:
            if ch == quote:
                quote = None
        elif ch in "'\"":
            quote = ch
        elif ch == "#" and (i == 0 or text[i - 1] in " \t"):
            return text[:i].rstrip()
    return text.rstrip()


def _scalar(tok: str, where: str):
    tok = tok.strip()
    if len(tok) >= 2 and tok[0] == tok[-1] == '"':
        body = tok[1:-1]
        if "\\" in body or '"' in body:
            raise ValueError(f"{where}: escapes in double-quoted strings are not supported: {tok}")
        return body
    if len(tok) >= 2 and tok[0] == tok[-1] == "'":
        body = tok[1:-1]
        if "'" in body.replace("''", ""):
            raise ValueError(f"{where}: malformed single-quoted string: {tok}")
        return body.replace("''", "'")
    if tok and tok[0] in "'\"[]{}&*!|>%@`,":
        raise ValueError(f"{where}: unsupported YAML value {tok!r} (flat key: scalar lines only)")
    if tok in _BOOL:
        return _BOOL[tok]
    if tok in _NULL:
        return None
    if tok in _SPECIAL_FLOAT:
        return _SPECIAL_FLOAT[tok]
    if _INT.fullmatch(tok):
        return int(tok.replace("_", ""))
    if _FLOAT.fullmatch(tok):
        return float(tok.replace("_", ""))
    if _OTHER_NUMBER.fullmatch(tok) or _TIMESTAMP.fullmatch(tok):
        raise ValueError(f"{where}: octal, hexadecimal, binary, sexagesimal numbers and dates are not "
                         f"supported: {tok}")
    if ": " in tok or tok.endswith(":") or " #" in tok:
        raise ValueError(f"{where}: unsupported YAML value {tok!r}")
    return tok


def parse_yaml_text(text: str) -> Dict[str, Any]:
    """The flat subset of YAML that estimator configs use, with the standard
    library: an optional ``%YAML`` header and ``---`` marker, comments, and
    one ``key: value`` per line whose value is a scalar (string, bool,
    number, null) or a one-line ``[a, b, ...]`` list of scalars. It gives
    the dict ``yaml.safe_load`` gives for such a text and raises
    ``ValueError`` on anything else (nesting, block lists, tags, anchors,
    multi-line values, repeated keys)."""
    out: Dict[str, Any] = {}
    for n, line in enumerate(text.splitlines(), start=1):
        where = f"line {n}"
        if line.strip().startswith("%YAML") or line.strip() == "---":
            continue
        body = _strip_comment(line)
        if not body.strip():
            continue
        if body[0] in " \t":
            raise ValueError(f"{where}: nested or continued values are not supported: {line!r}")
        m = _KEY.match(body)
        if m is None:
            raise ValueError(f"{where}: expected 'key: value', got {line!r}")
        key, rest = m.group(1), body[m.end():].strip()
        if key in out:
            raise ValueError(f"{where}: key {key!r} repeated")
        if rest.startswith("["):
            if not rest.endswith("]") or "[" in rest[1:] or "{" in rest:
                raise ValueError(f"{where}: only one-line lists of scalars are supported: {rest!r}")
            inner = rest[1:-1].strip()
            out[key] = [] if not inner else [_scalar(v, where) for v in inner.split(",")]
        else:
            out[key] = _scalar(rest, where)
    return out


def load_yaml(path: str, base: Optional[VioConfig] = None, overrides: Optional[Dict[str, Any]] = None) -> VioConfig:
    """Load a reference-format ``estimator_config.yaml`` into a VioConfig
    (the JAX package's ``load_yaml``, parsed by :func:`parse_yaml_text`).

    Keys outside the map are collected in ``cfg._unknown_keys`` for the
    caller. The ``verbosity`` key is stored, not applied: entry points apply
    it (``printer.set_print_level(cfg.verbosity)``)."""
    cfg = dataclasses.replace(base) if base is not None else VioConfig()
    with open(path) as f:
        raw = parse_yaml_text(f.read())
    if overrides:
        raw.update(overrides)
    unknown = {}
    for key, value in raw.items():
        if key in _YAML_MAP:
            section, fieldname = _YAML_MAP[key]
            target = cfg if section is None else getattr(cfg, section)
            cast = type(getattr(target, fieldname))
            if cast is bool and isinstance(value, (int, float)):
                value = bool(value)
            elif cast in (int, float):
                value = cast(value)
            setattr(target, fieldname, value)
        else:
            unknown[key] = value
    cfg._unknown_keys = unknown  # type: ignore[attr-defined]
    return cfg


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
    (``sim.simulator.load_scene``), which ``sim.simulator.build_sim``
    rebuilds from this configuration. Beside the ladder's M-PT variant
    (``scripts/run_sweep.make_config``) it has one plane slot (D = 93, not
    114) and 60 points, not 40."""
    cfg = sim_config()
    cfg.sim.traj_duration = 30.0
    cfg.num_pts = 60
    cfg.num_pts_plane = 0
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
    committed one (``sim.simulator.PLANE_SCENE_PATH``), which
    ``sim.simulator.build_sim`` rebuilds from this configuration."""
    cfg = sim_config()
    cfg.sim.traj_duration = 30.0
    cfg.num_pts = 40
    cfg.num_pts_plane = 40
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
