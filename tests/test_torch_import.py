"""The PyTorch port stands alone: it imports neither JAX nor the JAX package,
and its entry points run on the card unless the caller asks for the CPU."""

import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from ov_plane_tpu_torch.models.feature_bank import FeatureBank
from ov_plane_tpu_torch.models.manager import VioEngine, init_state_with_gt
from ov_plane_tpu_torch.sim import simulator
from ov_plane_tpu_torch.utils.config import plane_config, slice_config

ROOT = Path(__file__).resolve().parents[1]
PACKAGE = ROOT / "ov_plane_tpu_torch"
FORBIDDEN = re.compile(
    r"^\s*(?:from|import)\s+(?:jax|jaxlib|flax|ov_plane_tpu)\b"
    r"|import_module\(\s*['\"](?:jax|jaxlib|flax|ov_plane_tpu)\b"
    r"|__import__\(\s*['\"](?:jax|jaxlib|flax|ov_plane_tpu)\b",
    re.MULTILINE,
)
MODULES = sorted(
    ".".join(p.relative_to(ROOT).with_suffix("").parts).removesuffix(".__init__")
    for p in PACKAGE.rglob("*.py")
)


def test_importing_the_port_loads_no_jax():
    code = (
        "import importlib, sys\n"
        f"for m in {MODULES!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'ov_plane_tpu'))\n"
        "print(len(bad), bad[:5])\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("0 "), out.stdout
    assert len(MODULES) >= 15


@pytest.mark.parametrize("path", sorted(PACKAGE.rglob("*.py")) + [ROOT / "chip_smoke.py"]
                         + sorted((ROOT / "tools").glob("*.py")),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_import_in_source(path):
    hits = FORBIDDEN.findall(path.read_text())
    assert not hits, f"{path.name} imports {hits}"


def test_entry_points_need_cuda_unless_asked_for_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = slice_config()
    with pytest.raises(RuntimeError, match="CUDA"):
        VioEngine.from_config(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        FeatureBank.create(cfg.tpu.max_features, 12, batch=1)
    for path in (simulator.SCENE_PATH, simulator.PLANE_SCENE_PATH, simulator.VISION_SCENE_PATH):
        with pytest.raises(RuntimeError, match="CUDA"):
            simulator.load_scene(path)
        assert simulator.load_scene(path, device="cpu").imu_t.device.type == "cpu"
    with pytest.raises(RuntimeError, match="CUDA"):
        VioEngine.from_config(plane_config())
    assert VioEngine.from_config(plane_config(), device="cpu").layout.dim == 114
    eng = VioEngine.from_config(cfg, device="cpu")
    z = torch.zeros(1, 3, dtype=torch.float64)
    q = torch.tensor([[0.0, 0.0, 0.0, 1.0]], dtype=torch.float64)
    with pytest.raises(RuntimeError, match="CUDA"):
        init_state_with_gt(eng, cfg, t0=torch.zeros(1), q0=q, p0=z, v0=z, bg0=z, ba0=z)
    st = init_state_with_gt(eng, cfg, t0=torch.zeros(1), q0=q, p0=z, v0=z, bg0=z, ba0=z, device="cpu")
    assert st.cov.device.type == "cpu" and st.cov.shape == (1, 93, 93)
    # The numeric policy is pinned by the entry points: no TF32 products.
    assert not torch.backends.cuda.matmul.allow_tf32
    assert torch.get_float32_matmul_precision() == "highest"


def test_later_slices_raise_not_implemented():
    """ArUco landmarks are the feature still to port. Sharded compression is
    ported (slice 9): without a process group for its axis it raises."""
    cfg = slice_config()
    cfg.use_aruco = True
    with pytest.raises(NotImplementedError, match="later slice"):
        VioEngine.from_config(cfg, device="cpu")
    cfg = slice_config()
    cfg.tpu.shard_axis = "seq"
    with pytest.raises(RuntimeError, match="no torch.distributed process group"):
        VioEngine.from_config(cfg, device="cpu")
    # Calibration, ZUPT, plane RANSAC and ground-truth injection run.
    for key, value in (("try_zupt", True), ("state.use_groundtruths", True),
                       ("state.do_calib_camera_pose", True), ("state.do_calib_camera_intrinsics", True),
                       ("state.do_calib_camera_timeoffset", True)):
        cfg = slice_config()
        obj, *path = key.split(".")
        target = cfg if not path else getattr(cfg, obj)
        setattr(target, path[-1] if path else obj, value)
        VioEngine.from_config(cfg, device="cpu")
    cfg = plane_config()
    cfg.state.use_plane_ransac = True
    assert VioEngine.from_config(cfg, device="cpu").plane_opts.use_ransac


def test_ms_pl_engine_has_slam_landmarks():
    from ov_plane_tpu_torch.utils.config import ms_pl_config

    eng = VioEngine.from_config(ms_pl_config(), device="cpu")
    lay = eng.layout
    assert (lay.max_clones, lay.max_slam, lay.max_planes) == (12, 12, 8)
    assert lay.dim == 15 + 72 + 36 + 24 == 147
    assert eng.use_slam and eng.max_slam == 12 and eng.slam_opts.max_init_per_frame == 8
    assert eng.slam_opts.use_plane_constraint_slamu and eng.slam_opts.use_plane_constraint_slamd
    # SLAM off keeps one (unused) landmark slot, as the JAX layout does.
    assert VioEngine.from_config(plane_config(), device="cpu").layout.max_slam == 1


@pytest.mark.parametrize("rep", ["GLOBAL_3D", "GLOBAL_FULL_INVERSE_DEPTH", "ANCHORED_3D", "ANCHORED_FULL_INVERSE_DEPTH",
                                 "ANCHORED_MSCKF_INVERSE_DEPTH", "ANCHORED_INVERSE_DEPTH_SINGLE"])
def test_landmark_representations_with_planes_off(rep):
    """Every 3-dof representation runs for MSCKF features and SLAM landmarks;
    the 1-dof ANCHORED_INVERSE_DEPTH_SINGLE does not fit the 3-column layout
    and raises, as in the JAX package (manager.py:161-172)."""
    from ov_plane_tpu_torch.ops import representations as reps

    for key in ("feat_rep_msckf", "feat_rep_slam"):
        cfg = slice_config()
        cfg.state.max_slam_features = 6
        setattr(cfg.state, key, rep)
        if rep == "ANCHORED_INVERSE_DEPTH_SINGLE":
            with pytest.raises(NotImplementedError, match="1-dof"):
                VioEngine.from_config(cfg, device="cpu")
            continue
        eng = VioEngine.from_config(cfg, device="cpu")
        opts = eng.msckf_opts if key == "feat_rep_msckf" else eng.slam_opts
        assert opts.jac.rep == reps.from_name(rep) and eng.layout.max_slam == 6


def test_planes_need_global_3d_features():
    for key in ("feat_rep_msckf", "feat_rep_slam"):
        cfg = plane_config()
        setattr(cfg.state, key, "ANCHORED_MSCKF_INVERSE_DEPTH")
        with pytest.raises(ValueError, match="GLOBAL_3D"):
            VioEngine.from_config(cfg, device="cpu")


def test_fused_frontend_imports_no_jax():
    code = ("import sys, ov_plane_tpu_torch.frontend.fused, ov_plane_tpu_torch.native, ov_plane_tpu_torch.convert\n"
            "print(sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'ov_plane_tpu')))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
    for m in ("frontend.fused", "frontend.klt", "frontend.fast", "frontend.ransac", "frontend.imageproc",
              "frontend.synthetic", "frontend.wire_guard", "frontend.plane_track_batch",
              "native", "convert"):
        assert f"ov_plane_tpu_torch.{m}" in MODULES


@pytest.mark.parametrize("path", sorted(PACKAGE.rglob("*.py")) + [ROOT / "chip_smoke.py"],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_reads_no_ovp_environment_variable(path):
    """The JAX driver's OVP_* switches are constructor arguments in the port."""
    assert "OVP_" not in path.read_text()


def test_vision_entry_points_need_cuda_unless_asked_for_cpu(monkeypatch):
    from ov_plane_tpu_torch import convert
    from ov_plane_tpu_torch.state.vio_state import VioState
    from ov_plane_tpu_torch.utils.config import vision_config

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    eng = VioEngine.from_config(vision_config(), device="cpu")
    assert eng.layout.dim == 114 and eng.max_msckf_batch == 40
    with pytest.raises(RuntimeError, match="CUDA"):
        VioState.create(eng.layout, 1)
    assert VioState.create(eng.layout, 1, device="cpu").cov.device.type == "cpu"
    import numpy as np
    with np.load(simulator.VISION_SCENE_PATH) as z:
        arrays = {k: z[k] for k in z.files}
    with pytest.raises(RuntimeError, match="CUDA"):
        simulator.truth_from_arrays(arrays)
    assert simulator.truth_from_arrays(arrays, device="cpu").plane_corners.shape[1:] == (4, 3)
    st = {k: v.numpy() for k, v in VioState.create(eng.layout, 1, device="cpu").tensors().items()}
    with pytest.raises(RuntimeError, match="CUDA"):
        convert.state_from_arrays(st, eng.layout)
    bank = {k: v.numpy() for k, v in FeatureBank.create(8, 12, 1, device="cpu").tensors().items()}
    with pytest.raises(RuntimeError, match="CUDA"):
        convert.bank_from_arrays(bank)
    with pytest.raises(RuntimeError, match="CUDA"):
        convert.frontend_from_arrays({"pyr": {"padded": [], "grads": []}})
    with pytest.raises(RuntimeError, match="CUDA"):
        convert.sim_from_streams([arrays])


def test_native_delaunay_builds_and_raises_on_failure(tmp_path):
    import numpy as np

    from ov_plane_tpu_torch import native

    tris = native.delaunay(np.array([[0.0, 0.0], [1.0, 0.0], [0.0, 1.0], [1.0, 1.0], [0.5, 0.4]]))
    assert tris.shape == (4, 3) and tris.dtype == np.int32
    assert native.delaunay(np.zeros((2, 2))).shape == (0, 3)
    lib = native.lib_path("delaunay")
    assert lib.exists() and lib.parent == ROOT / "build" / "ov_plane_tpu_torch"
    # A source that does not compile raises: there is no fallback triangulation.
    (tmp_path / "broken.cpp").write_text("this is not C++\n")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        native.build("broken", src_dir=tmp_path, build_dir=tmp_path / "build")
    assert "scipy" not in (PACKAGE / "native" / "__init__.py").read_text()
    assert (PACKAGE / "native" / "delaunay.cpp").read_bytes() == (ROOT / "ov_plane_tpu" / "native" /
                                                                    "delaunay.cpp").read_bytes()


def test_wire_guard_copy_resolves_as_the_jax_one():
    import numpy as np

    from ov_plane_tpu.frontend import wire_guard as j_wg
    from ov_plane_tpu_torch.frontend import wire_guard as t_wg

    rng = np.random.default_rng(0)
    lattice = (np.rint(rng.random((2, 8, 8)) * 255) / 255).astype(np.float32)
    for img in (lattice, lattice + 1e-2, lattice.astype(np.uint8)):
        for req in (("auto", "auto"), ("u8", "auto"), ("auto", "slice")):
            ours, theirs = t_wg.resolve_wire_and_sampler(img, *req), j_wg.resolve_wire_and_sampler(img, *req)
            assert ours[:2] == theirs[:2] and ours[2]["u8_lossless"] == theirs[2]["u8_lossless"]


IMAGE_OR_YAML = re.compile(r"^\s*(?:from|import)\s+(?:PIL|cv2|yaml)\b", re.MULTILINE)


def test_importing_the_port_loads_no_image_or_yaml_library():
    """The card's machine has neither PIL, OpenCV nor PyYAML: the PNG codec and
    the YAML parser are the port's own."""
    code = (
        "import importlib, sys\n"
        f"for m in {MODULES!r}:\n"
        "    importlib.import_module(m)\n"
        "print(sorted(m for m in sys.modules if m.split('.')[0] in ('PIL', 'cv2', 'yaml')))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]", out.stdout
    assert {"ov_plane_tpu_torch.scripts.run_euroc", "ov_plane_tpu_torch.scripts.make_synth_asl",
            "ov_plane_tpu_torch.eval.png", "ov_plane_tpu_torch.frontend.pipeline"} <= set(MODULES)


@pytest.mark.parametrize("path", sorted(PACKAGE.rglob("*.py")) + [ROOT / "chip_smoke.py"],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_image_or_yaml_import_in_source(path):
    hits = IMAGE_OR_YAML.findall(path.read_text())
    assert not hits, f"{path.name} imports {hits}"


def test_replay_entry_points_need_cuda_unless_asked_for_cpu(monkeypatch, tmp_path):
    from ov_plane_tpu_torch.frontend.map_blocks import MapBlocks, PersistentPlaneMap
    from ov_plane_tpu_torch.parallel.ingest import device_prefetch
    from ov_plane_tpu_torch.scripts import f32_update_candidates, make_synth_asl, run_euroc

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        f32_update_candidates.main()
    with pytest.raises(RuntimeError, match="CUDA"):
        make_synth_asl.write_asl(str(tmp_path / "seq"), frames=1)
    with pytest.raises(RuntimeError, match="CUDA"):
        run_euroc.main(["--data", str(tmp_path / "seq")])
    with pytest.raises(RuntimeError, match="CUDA"):
        PersistentPlaneMap(capacity=8)
    with pytest.raises(RuntimeError, match="CUDA"):
        MapBlocks.create(8)
    with pytest.raises(RuntimeError, match="CUDA"):
        device_prefetch([torch.zeros(2)])
    assert PersistentPlaneMap(capacity=8, device="cpu").stats()["n_points"] == 0
    # The modules the replay's other flags need are not ported: they raise.
    for flag in ("--bag", "--loop-out", "--viz-dir"):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            run_euroc.main(["--data", str(tmp_path / "seq"), flag, "x", "--device", "cpu"])


def test_native_voxel_map_is_the_jax_source():
    assert (PACKAGE / "native" / "ikd_grid.cpp").read_bytes() == (ROOT / "ov_plane_tpu" / "native" /
                                                                   "ikd_grid.cpp").read_bytes()


SIM_SLICE = ("ov_plane_tpu_torch.ops.spline", "ov_plane_tpu_torch.sim.trajectory", "ov_plane_tpu_torch.sim.simulator",
             "ov_plane_tpu_torch.frontend.synthetic", "ov_plane_tpu_torch.convert",
             "ov_plane_tpu_torch.scripts.make_synth_asl", "ov_plane_tpu_torch.scripts.run_sweep",
             "ov_plane_tpu_torch.scripts.ov_eval", "ov_plane_tpu_torch.scripts.run_monte_carlo",
             "ov_plane_tpu_torch.scripts.run_sim", "ov_plane_tpu_torch.scripts.run_real_suite")
STANDS_ALONE = re.compile(r"^\s*(?:from|import)\s+(?:jax|jaxlib|flax|ov_plane_tpu|PIL|cv2|yaml|matplotlib)\b",
                          re.MULTILINE)


def test_simulator_slice_loads_no_jax_image_or_plot_library():
    """The simulator and the Monte-Carlo entry points import none of JAX, the
    JAX package, PIL, OpenCV, PyYAML or matplotlib (the card's machine has
    no JAX, no image library and no plotting library)."""
    code = (
        "import importlib, sys\n"
        f"for m in {SIM_SLICE!r}:\n"
        "    importlib.import_module(m)\n"
        "print(sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'ov_plane_tpu', 'PIL', 'cv2', 'yaml', 'matplotlib')))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]", out.stdout
    assert set(SIM_SLICE) <= set(MODULES)


@pytest.mark.parametrize("module", SIM_SLICE)
def test_simulator_slice_source_stands_alone(module):
    path = ROOT / (module.replace(".", "/") + ".py")
    hits = STANDS_ALONE.findall(path.read_text())
    assert not hits, f"{path.name} imports {hits}"


def _flat(cfg) -> dict:
    import dataclasses

    out = {}
    for f in dataclasses.fields(cfg):
        v = getattr(cfg, f.name)
        if dataclasses.is_dataclass(v):
            out.update({f"{f.name}.{g.name}": getattr(v, g.name) for g in dataclasses.fields(v)})
        else:
            out[f.name] = v
    return out


def test_sweep_variants_are_the_named_configurations():
    """``run_sweep.make_config`` of a ladder variant, with the information
    form ``run_variant`` turns on on the card, against the configuration
    that names the same variant: M-PL is ``plane_config`` and MS-PL
    ``ms_pl_config`` field by field; ``slice_config`` (the bench's point
    path) departs from M-PT only where the bench scene does (one plane
    slot, 60 points, the unread plane-feature flag)."""
    from ov_plane_tpu_torch.scripts.run_sweep import VARIANTS, make_config
    from ov_plane_tpu_torch.utils.config import ms_pl_config

    def variant(name):
        cfg = make_config(30.0, "", *VARIANTS[name])
        cfg.tpu.use_info_compression = True
        return _flat(cfg)

    def diff(a, b):
        return {k for k in a if a[k] != b[k]}

    assert diff(variant("M-PL"), _flat(plane_config())) == set()
    assert diff(variant("MS-PL"), _flat(ms_pl_config())) == set()
    assert diff(variant("M-PT"), _flat(slice_config())) == {"tpu.max_planes", "num_pts", "state.use_plane_slam_feats"}
    assert diff(variant("MS-PT"), variant("M-PT")) == {"state.max_slam_features"}


def test_simulator_entry_points_need_cuda_unless_asked_for_cpu(monkeypatch, tmp_path):
    from ov_plane_tpu_torch.scripts import (make_synth_asl, ov_eval, run_monte_carlo, run_real_suite, run_sim,
                                            run_sweep)

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = make_synth_asl.synth_config(duration=2.0, num_pts=5)
    with pytest.raises(RuntimeError, match="CUDA"):
        simulator.build_sim(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        make_synth_asl.write_sim_asl(str(tmp_path / "seq"), cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        run_sweep.main(["--seeds", "1", "--duration", "2", "--out", str(tmp_path / "sweep")])
    with pytest.raises(RuntimeError, match="CUDA"):
        run_monte_carlo.main(["--seeds", "1", "--duration", "2"])
    with pytest.raises(RuntimeError, match="CUDA"):
        run_sim.main(["--duration", "2"])
    with pytest.raises(RuntimeError, match="CUDA"):
        run_real_suite.main(["--dry-run", "--out", str(tmp_path / "suite")])
    gt = tmp_path / "gt.txt"
    np.savetxt(gt, np.column_stack([np.arange(20.0), np.zeros((20, 6)), np.ones(20)]))
    with pytest.raises(RuntimeError, match="CUDA"):
        ov_eval.eval_one(str(gt), str(gt))
    assert ov_eval.eval_one(str(gt), str(gt), device="cpu")["ate_pos"] == 0.0
    truth = simulator.build_sim(cfg, device="cpu")
    assert truth.imu_t.device.type == "cpu" and truth.feat_p.shape[0] > 0


FILTER_SLICE = ("ov_plane_tpu_torch.models.zupt", "ov_plane_tpu_torch.models.plane_init",
                "ov_plane_tpu_torch.ops.planefit", "ov_plane_tpu_torch.ops.ekf", "ov_plane_tpu_torch.models.jacobians",
                "ov_plane_tpu_torch.state.propagator", "ov_plane_tpu_torch.models.manager",
                "ov_plane_tpu_torch.scripts.run_mc_vision")


def test_calibration_zupt_ransac_slice_loads_no_jax_image_or_yaml_library():
    """Calibration, ZUPT, plane RANSAC, ground truths and run_mc_vision import
    none of JAX, the JAX package, PIL, OpenCV or PyYAML."""
    code = (
        "import importlib, sys\n"
        f"for m in {FILTER_SLICE!r}:\n"
        "    importlib.import_module(m)\n"
        "print(sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'ov_plane_tpu', 'PIL', 'cv2', 'yaml')))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]", out.stdout
    assert set(FILTER_SLICE) <= set(MODULES)


@pytest.mark.parametrize("module", FILTER_SLICE)
def test_calibration_zupt_ransac_slice_source_stands_alone(module):
    path = ROOT / (module.replace(".", "/") + ".py")
    hits = STANDS_ALONE.findall(path.read_text())
    assert not hits, f"{path.name} imports {hits}"


def test_config_features_build_their_layout_and_options():
    """The four features ``from_config`` accepts since slice 8 reach the
    engine: calibration columns in the layout and the Jacobian and
    propagator options, the ZUPT options, plane RANSAC, ground truths."""
    cfg = slice_config()
    cfg.state.do_calib_camera_timeoffset = True
    cfg.state.do_calib_camera_pose = True
    cfg.state.do_calib_camera_intrinsics = True
    cfg.try_zupt = True
    cfg.zupt_integrated_accel = True
    cfg.state.use_groundtruths = True
    eng = VioEngine.from_config(cfg, device="cpu")
    assert eng.layout.dim == 93 + 15 and eng.layout.clone_base == 30
    assert eng.msckf_opts.jac.do_calib_camera_pose and eng.msckf_opts.jac.do_calib_camera_intrinsics
    assert eng.prop_opts.do_calib_camera_timeoffset
    assert eng.try_zupt and eng.zupt_opts.integrated_accel and eng.use_groundtruths
    z = torch.zeros(1, 3, dtype=torch.float64)
    q = torch.tensor([[0.0, 0.0, 0.0, 1.0]], dtype=torch.float64)
    st = init_state_with_gt(eng, cfg, t0=torch.zeros(1), q0=q, p0=z, v0=z, bg0=z, ba0=z, device="cpu")
    lay = eng.layout
    assert float(st.cov[0, lay.dt_idx, lay.dt_idx]) == 0.01**2
    assert float(st.cov[0, lay.cam_intr_idx, lay.cam_intr_idx]) == 1.0


def test_mc_vision_needs_cuda_unless_asked_for_cpu(monkeypatch):
    from ov_plane_tpu_torch.scripts import run_mc_vision

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        run_mc_vision.main(["--scene", "tabletop", "--seeds", "1", "--max-frames", "1"])
    cfg, render = run_mc_vision.scene_config("tabletop", False)
    with pytest.raises(RuntimeError, match="CUDA"):
        run_mc_vision.render_frames(cfg, simulator.load_scene(simulator.TABLETOP_SCENE_PATH, device="cpu"),
                                    render, 1)


SERVING_SLICE = ("ov_plane_tpu_torch.parallel.distributed", "ov_plane_tpu_torch.parallel.replay",
                 "ov_plane_tpu_torch.parallel.schur", "ov_plane_tpu_torch.utils.profiling",
                 "ov_plane_tpu_torch.frontend.fused", "ov_plane_tpu_torch.frontend.map_blocks",
                 "ov_plane_tpu_torch.models.msckf")


def test_serving_slice_loads_no_jax_image_or_yaml_library():
    """The chained driver, the data-parallel and sharded layer and the staged
    profiler import none of JAX, the JAX package, PIL, OpenCV or PyYAML."""
    code = (
        "import importlib, sys\n"
        f"for m in {SERVING_SLICE!r}:\n"
        "    importlib.import_module(m)\n"
        "print(sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'ov_plane_tpu', 'PIL', 'cv2', 'yaml')))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]", out.stdout
    assert set(SERVING_SLICE) <= set(MODULES)


@pytest.mark.parametrize("module", SERVING_SLICE)
def test_serving_slice_source_stands_alone(module):
    path = ROOT / (module.replace(".", "/") + ".py")
    hits = STANDS_ALONE.findall(path.read_text())
    assert not hits, f"{path.name} imports {hits}"


def test_shard_axis_and_chain_arguments_raise(monkeypatch):
    """``from_config`` with ``tpu.shard_axis`` and no process group raises
    (the update never runs unsharded in its place), and so does a process
    group whose current mesh lacks the axis; ``chain > 1`` raises under a
    mesh or at B = 0."""
    from ov_plane_tpu_torch.frontend.fused import FusedVisionDriver
    from ov_plane_tpu_torch.parallel import distributed
    from ov_plane_tpu_torch.utils.config import vision_config

    cfg = slice_config()
    cfg.tpu.shard_axis = "sp"
    with pytest.raises(RuntimeError, match="no torch.distributed process group"):
        VioEngine.from_config(cfg, device="cpu")
    monkeypatch.setattr(torch.distributed, "is_initialized", lambda: True)
    monkeypatch.setattr(distributed, "_MESH", None)
    with pytest.raises(RuntimeError, match="no such dimension"):
        VioEngine.from_config(cfg, device="cpu")
    vcfg = vision_config()
    eng = VioEngine.from_config(vcfg, device="cpu")
    for batch, mesh in ((0, None), (4, object())):
        with pytest.raises(ValueError, match="chain>1 needs batch mode without a mesh"):
            FusedVisionDriver(vcfg, eng, batch, chain=4, mesh=mesh)
