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
from ov_plane_tpu_torch.utils.config import slice_config

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


@pytest.mark.parametrize("path", sorted(PACKAGE.rglob("*.py")) + [ROOT / "chip_smoke.py"],
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
    for key, value in (("state.max_slam_features", 25), ("try_zupt", True), ("use_aruco", True),
                       ("state.use_groundtruths", True), ("tpu.shard_axis", "seq"),
                       ("state.feat_rep_msckf", "ANCHORED_MSCKF_INVERSE_DEPTH"),
                       ("state.do_calib_camera_pose", True)):
        cfg = slice_config()
        obj, *path = key.split(".")
        target = cfg if not path else getattr(cfg, obj)
        setattr(target, path[-1] if path else obj, value)
        with pytest.raises(NotImplementedError, match="later slice"):
            VioEngine.from_config(cfg, device="cpu")
    cfg = slice_config()
    cfg.state.use_plane_constraint = True
    with pytest.raises(NotImplementedError, match="plane"):
        VioEngine.from_config(cfg, device="cpu")
