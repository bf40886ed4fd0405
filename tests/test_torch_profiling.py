"""The port's staged profiling runner (``utils/profiling.run_sequence_profiled``)
against the JAX package's (``tests/test_profiling.py``): the reference timing
CSV's schema, one row per frame at the same timestamps, stages that add up
to each row's total. The scene is the JAX draw of
``tests/test_torch_parallel.py``'s point replay (``test_profiling.py``'s
configuration but 24 features per update), committed in
``tests/data/torch_parallel_jax.npz``.
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_torch_parallel import REFERENCE, configure, port_run, scene_arrays  # noqa: E402

from ov_plane_tpu_torch.eval.io import TIMING_COLUMNS  # noqa: E402
from ov_plane_tpu_torch.utils.profiling import run_sequence_profiled  # noqa: E402

N_FRAMES = 8


@pytest.fixture(scope="module")
def arrays():
    with np.load(REFERENCE) as z:
        return scene_arrays({k: z[k] for k in z.files}, "point")


def _check_csv(rec, path):
    rec.write(str(path))
    with open(path) as f:
        header = f.readline().strip().lstrip("# ").split(",")
    assert header == TIMING_COLUMNS
    data = np.loadtxt(path, delimiter=",", skiprows=1, ndmin=2)
    cols = {c: data[:, k] for k, c in enumerate(TIMING_COLUMNS)}
    assert (cols["total"] > 0).all()
    parts = cols["propagation"] + cols["tracking"] + cols["msckf update"] + cols["re-tri & marg"]
    assert (cols["total"] >= parts * 0.99).all()
    s = rec.summary()
    assert s["total"]["max"] >= s["total"]["mean"] > 0
    return cols


def test_profiled_replay_matches_jax_schema(arrays, tmp_path):
    import jax.numpy as jnp

    from ov_plane_tpu.eval.io import TIMING_COLUMNS as J_COLUMNS
    from ov_plane_tpu.models.feature_bank import FeatureBank as JBank
    from ov_plane_tpu.models.manager import VioEngine as JEngine
    from ov_plane_tpu.models.manager import init_state_with_gt as j_init
    from ov_plane_tpu.sim.simulator import SimData as JSimData
    from ov_plane_tpu.utils.config import sim_config as j_sim_config
    from ov_plane_tpu.utils.profiling import run_sequence_profiled as j_profiled

    torch.set_num_threads(1)
    eng, cfg, sim, state, bank = port_run("point", arrays, batch=2)
    rec = run_sequence_profiled(eng, state, bank, sim, cfg.tpu.max_imu_per_frame, max_frames=N_FRAMES)
    assert len(rec.rows) == N_FRAMES
    cols = _check_csv(rec, tmp_path / "timing.csv")
    # The four stages bracket the whole row: they add up to its total.
    parts = sum(np.asarray([r[TIMING_COLUMNS.index(c)] for r in rec.rows])
                for c in ("propagation", "tracking", "msckf update", "re-tri & marg"))
    np.testing.assert_allclose(parts, cols["total"], rtol=1e-6)

    jcfg = configure(j_sim_config(), "point")
    jeng = JEngine.from_config(jcfg)
    jsim = JSimData(**{f: jnp.asarray(arrays[f]) if f in arrays else None for f in JSimData._fields})
    jst = j_init(jeng, jcfg, t0=jsim.cam_t_imu[0], q0=jsim.gt_q[0], p0=jsim.gt_p[0], v0=jsim.gt_v[0],
                 bg0=jsim.gt_bg_cam[0], ba0=jsim.gt_ba_cam[0])
    jrec = j_profiled(jeng, jst, JBank.create(jcfg.tpu.max_features, jeng.layout.max_clones), jsim,
                      jcfg.tpu.max_imu_per_frame, max_frames=N_FRAMES)
    assert TIMING_COLUMNS == J_COLUMNS
    assert len(jrec.rows) == len(rec.rows)
    np.testing.assert_array_equal([r[0] for r in rec.rows], [r[0] for r in jrec.rows])
    # The stages JAX's runner fills are the port's (the others stay zero).
    jrows, rows = np.asarray(jrec.rows), np.asarray(rec.rows)
    np.testing.assert_array_equal(rows[:, 1:] > 0, jrows[:, 1:] > 0)
