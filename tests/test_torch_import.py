"""The PyTorch port stands alone: it imports neither JAX nor the JAX package,
and its entry points run on the card unless the caller asks for the CPU."""

import re
import subprocess
import sys
from pathlib import Path

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
    for key, value in (("try_zupt", True), ("use_aruco", True),
                       ("state.use_groundtruths", True), ("tpu.shard_axis", "seq"),
                       ("state.do_calib_camera_pose", True), ("state.do_calib_camera_intrinsics", True),
                       ("state.do_calib_camera_timeoffset", True)):
        cfg = slice_config()
        obj, *path = key.split(".")
        target = cfg if not path else getattr(cfg, obj)
        setattr(target, path[-1] if path else obj, value)
        with pytest.raises(NotImplementedError, match="later slice"):
            VioEngine.from_config(cfg, device="cpu")
    cfg = plane_config()
    cfg.state.use_plane_ransac = True
    with pytest.raises(NotImplementedError, match="plane RANSAC"):
        VioEngine.from_config(cfg, device="cpu")


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
