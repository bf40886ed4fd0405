"""The port's chained dispatch (``FusedVisionDriver(chain=K)``,
``stage_chunk``, ``step_batch_chunk``) and ``step_batch(pipelined=False)``
against the JAX driver.

The inputs are ``test_torch_fused``'s (two streams of the vision scene at
320×240, the f32 wire and the exact 'mm' sampler, the filter in f64,
planes on) over frames 59-74, where the host detector's labels reach the
step from frame 61 and the delayed plane init finds candidates. The JAX chain (``lax.scan`` over the fused step) and the
JAX non-pipelined steps take minutes to compile on the CPU, so their
records are committed in ``tests/data/torch_fused_chain_jax.npz``;
regenerate it with

    env JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_fused_chain.py

(about a minute). The port runs here.
"""

import copy
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_torch_fused import B, SAMPLER, WIRE, _labels, _rows, make_inputs  # noqa: E402

from ov_plane_tpu_torch.frontend import fused as t_fused  # noqa: E402
from ov_plane_tpu_torch.models.feature_bank import FeatureBank  # noqa: E402
from ov_plane_tpu_torch.models.manager import VioEngine, init_state_with_gt  # noqa: E402

K = 2                 # frames per chunk
K0, N_FRAMES = 58, 16  # frames K0+1..K0+16: 8 chunks
N_SYNC = 6            # frames of the pipelined=False comparison
REFERENCE = Path(__file__).resolve().parent / "data" / "torch_fused_chain_jax.npz"


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def inputs():
    return make_inputs(K0, N_FRAMES)


@pytest.fixture(scope="module")
def reference():
    with np.load(REFERENCE) as z:
        return {k: z[k] for k in z.files}


def chunk_inputs(inputs, c):
    """Chunk c: (imgs [K, B, h, w], imu_t [K, B, W], imu_w/imu_a [K, B, W, 3], t_new [K, B])."""
    _, frames, windows, _, _ = inputs
    ks = range(c * K, (c + 1) * K)
    return (np.stack([frames[k] for k in ks]), *(np.stack([windows[k][j] for k in ks]) for j in range(4)))


def _port_setup(inputs, planes=True, **driver_args):
    cfg, _, _, start, _ = inputs
    if not planes:
        cfg = copy.deepcopy(cfg)
        cfg.state.use_plane_constraint = False
        cfg.state.use_plane_slam_feats = False
    eng = VioEngine.from_config(cfg, device="cpu")
    drv = t_fused.FusedVisionDriver(cfg, eng, B, sampler=SAMPLER, img_wire=WIRE, **driver_args)
    state = init_state_with_gt(eng, cfg, **start, dtype=torch.float64, device="cpu")
    bank = FeatureBank.create(cfg.tpu.max_features, eng.layout.max_clones, B, torch.float64, "cpu")
    return drv, state, bank, drv.init_frontend()


def run_port_chain(inputs, n_chunks=N_FRAMES // K, planes=True, staged=False):
    """The port's chain: per chunk the labels fed, its own pull [K, B, cap+3, 8],
    the counters read after it (the previous chunk's), and p, q [K, B, 3/4]."""
    drv, st, bk, fe = _port_setup(inputs, planes, chain=K)
    recs = []
    for c in range(n_chunks):
        imgs, *win = chunk_inputs(inputs, c)
        labels = _labels(drv)
        st, bk, fe, outs = drv.step_batch_chunk(st, bk, fe, drv.stage_chunk(imgs) if staged else imgs, *win)
        recs.append(dict(labels=labels, pull=drv._pending[0].numpy().copy(), counters=drv.last_counters.copy(),
                         p=outs.p.numpy().copy(), q=outs.q.numpy().copy(), n_pulls=drv.n_pulls))
    drv.flush_stream()
    recs.append(dict(counters=drv.last_counters.copy(), n_pulls=drv.n_pulls))
    return recs


def run_port_frames(inputs, n_frames, planes=True, pipelined=True):
    """The port's per-frame loop: per frame the labels fed, its own pull, the
    counters read after it, p, q, and each stream's tracks handed to the detector."""
    _, frames, windows, _, _ = inputs
    drv, st, bk, fe = _port_setup(inputs, planes)
    recs = []
    for k in range(n_frames):
        labels = _labels(drv)
        st, bk, fe, out = drv.step_batch(st, bk, fe, frames[k], *windows[k], pipelined=pipelined)
        pull = drv.last_pull if not pipelined else drv._pending[0].numpy()
        recs.append(dict(labels=labels, pull=pull.copy(), counters=drv.last_counters.copy(),
                         p=out.p.numpy().copy(), q=out.q.numpy().copy(), times=dict(drv.last_times),
                         tri=[None if t is None else tuple(np.array(a, copy=True) for a in t) for t in drv.last_tri]))
    drv.flush_stream()
    return recs


def test_chain_matches_jax_chain(inputs, reference):
    """Planes on: the port's chain of K = 2 against the JAX ``step_batch_chunk``
    chunk by chunk: the labels fed, every integer output of the pull (ids,
    valid, ok3, the pulled counters), the chunk counters read after each
    call (event counts 0, 1, 3 and every other), and the poses at JAX's own
    1e-4 (``tests/test_fused_chain.py``: XLA reassociates the f32 frontend
    inside its scan)."""
    recs = run_port_chain(inputs)
    worst_p = worst_q = 0.0
    for c, r in enumerate(recs[:-1]):
        for j, name in enumerate(("label_ids", "label_pid", "merge_from", "merge_into")):
            np.testing.assert_array_equal(r["labels"][j], reference[f"chain{c}_labels{j}"], err_msg=f"chunk {c}: {name}")
        for k in range(K):
            jr, tr = _rows(reference[f"chain{c}_pull"][k]), _rows(r["pull"][k])
            for name in ("ids", "valid", "ok3", "counters"):
                np.testing.assert_array_equal(tr[name], jr[name], err_msg=f"chunk {c} frame {k}: {name}")
        np.testing.assert_array_equal(r["counters"][:, [0, 1, 3]], reference[f"chain{c}_counters"][:, [0, 1, 3]],
                                      err_msg=f"chunk {c}: event counters")
        np.testing.assert_array_equal(r["counters"], reference[f"chain{c}_counters"], err_msg=f"chunk {c}: counters")
        worst_p = max(worst_p, float(np.abs(r["p"] - reference[f"chain{c}_p"]).max()))
        worst_q = max(worst_q, float(np.abs(r["q"] - reference[f"chain{c}_q"]).max()))
    # flush_stream reads the last chunk's pull: the port aggregates its frames'
    # counters as step_batch_chunk does; the JAX flush keeps the last frame's
    # (fused.py:817-823), a difference kept on purpose (ROADMAP queue 3).
    last = [t_fused._unpack(f)[5] for f in reference[f"chain{N_FRAMES // K - 1}_pull"]]
    np.testing.assert_array_equal(reference["chain_flush_counters"], last[-1])
    agg = np.sum(last, axis=0)
    agg[:, t_fused.GAUGES] = np.max(last, axis=0)[:, t_fused.GAUGES]
    np.testing.assert_array_equal(recs[-1]["counters"], agg)
    n_lab = sum(int((r["labels"][0] >= 0).sum()) for r in recs[:-1])
    print(f"chain K={K}, {N_FRAMES} frames x {B} streams: {n_lab} plane labels fed; max|d p| {worst_p:.3e} m, "
          f"max|d q| {worst_q:.3e}")
    assert worst_p <= 1e-4 and worst_q <= 1e-4
    # Labels reached the step, the delayed plane init found candidates and MSCKF updates ran.
    assert n_lab > 0 and sum(r["counters"][:, 0].sum() for r in recs) > 0
    assert sum(r["counters"][:, 3].sum() for r in recs) > 0
    assert [r["n_pulls"] for r in recs] == list(range(N_FRAMES // K)) + [N_FRAMES // K]


def test_chain_equals_per_frame_loop_with_planes_off(inputs):
    """Planes off, the labels do not act on the filter, so the chain is the
    per-frame loop's computation: poses and pulls bitwise equal (the port
    has no scan to reassociate its frontend)."""
    n = 8
    loop = run_port_frames(inputs, n, planes=False)
    chain = run_port_chain(inputs, n // K, planes=False)
    for k in range(n):
        c, j = divmod(k, K)
        np.testing.assert_array_equal(chain[c]["pull"][j], loop[k]["pull"], err_msg=f"frame {k}: pull")
        np.testing.assert_array_equal(chain[c]["p"][j], loop[k]["p"], err_msg=f"frame {k}: p")
        np.testing.assert_array_equal(chain[c]["q"][j], loop[k]["q"], err_msg=f"frame {k}: q")
    assert sum(int(r["pull"][..., -3, 3].sum()) for r in chain[:-1]) > 0   # MSCKF updates ran


def test_staged_chunk_matches_raw(inputs):
    """A chunk staged by ``stage_chunk`` gives the raw chunk's bits."""
    raw = run_port_chain(inputs, 2, staged=False)
    staged = run_port_chain(inputs, 2, staged=True)
    for a, b in zip(raw[:-1], staged[:-1]):
        for name in ("pull", "p", "q", "counters"):
            np.testing.assert_array_equal(b[name], a[name], err_msg=name)


def test_step_batch_not_pipelined_matches_jax(inputs, reference):
    """``step_batch(pipelined=False)`` reads the frame's own pull: labels lag
    one frame. Against JAX's: the labels fed, the 9 counters, each stream's
    tracks handed to the detector, the poses; ``last_times`` carries the JAX
    driver's keys and ``last_dbg`` is counters[0, 5:8]."""
    recs = run_port_frames(inputs, N_SYNC, pipelined=False)
    for k, r in enumerate(recs):
        for j in range(4):
            np.testing.assert_array_equal(r["labels"][j], reference[f"sync{k}_labels{j}"], err_msg=f"frame {k}")
        np.testing.assert_array_equal(r["counters"], reference[f"sync{k}_counters"], err_msg=f"frame {k}")
        for s in range(B):
            ids, uv, p3, ok = r["tri"][s]
            np.testing.assert_array_equal(ids, reference[f"sync{k}_tri_ids"][s], err_msg=f"frame {k} stream {s}")
            np.testing.assert_array_equal(ok, reference[f"sync{k}_tri_ok"][s], err_msg=f"frame {k} stream {s}")
            np.testing.assert_allclose(uv, reference[f"sync{k}_tri_uv"][s], rtol=0, atol=1e-3)
        np.testing.assert_allclose(r["p"], reference[f"sync{k}_p"], rtol=0, atol=1e-4)
        np.testing.assert_allclose(r["q"], reference[f"sync{k}_q"], rtol=0, atol=1e-5)
        assert set(r["times"]) == set(reference["time_keys"]) and min(r["times"].values()) >= 0.0
    # The labels of frame k's own detection reach frame k+1.
    assert sum(int((r["labels"][0] >= 0).sum()) for r in recs) > 0


def test_last_times_device_is_the_step_host_time_on_the_cpu(inputs):
    """On the CPU the step runs inside its enqueue, so ``last_times["device"]``
    is the step's host time up to its pull: the sum of the host keys before
    it (on a card it is the device's elapsed time, ``tests/test_torch_cuda.py``)."""
    recs = run_port_frames(inputs, 3, planes=False)
    for r in recs:
        t = r["times"]
        assert t["device"] == t["wire_image"] + t["pack_payload"] + t["payload_put"] + t["dispatch_enqueue"] + \
            t["pull_wait"]
        assert t["device"] > 0.0
    assert recs[0]["times"]["pull_wait"] == 0.0 and recs[-1]["times"]["pull_wait"] > 0.0   # pipelined: no pull yet


def test_step_batch_chunk_needs_a_chain():
    """``step_batch_chunk`` raises on a driver made without ``chain=K``; the
    driver's ``last_times`` carry the JAX keys and ``last_dbg`` is
    counters[0, 5:8] from the start."""
    from ov_plane_tpu_torch.utils.config import vision_config

    cfg = vision_config()
    drv = t_fused.FusedVisionDriver(cfg, VioEngine.from_config(cfg, device="cpu"), 2)
    with pytest.raises(ValueError, match="chain=K"):
        drv.step_batch_chunk(None, None, None, np.zeros((2, 2, 8, 8)), None, None, None, None)
    assert drv.last_dbg.shape == (3,) and set(drv.last_times) == set(t_fused.FusedVisionDriver.TIME_KEYS)


# ----------------------------------------------------------------------
def generate():
    """The JAX records: the chain of K over N_FRAMES and N_SYNC frames of
    ``step_batch(pipelined=False)``."""
    import jax
    import jax.numpy as jnp

    from ov_plane_tpu.frontend import fused as j_fused
    from ov_plane_tpu.models.feature_bank import FeatureBank as JBank
    from ov_plane_tpu.models.manager import VioEngine as JEngine
    from ov_plane_tpu.models.manager import init_state_with_gt as j_init
    from test_torch_fused import _to_jax_cfg

    jax.config.update("jax_enable_x64", True)
    inputs = make_inputs(K0, N_FRAMES)
    cfg, frames, windows, start, _ = inputs
    jcfg = _to_jax_cfg(cfg)
    eng = JEngine.from_config(jcfg)

    def setup(chain):
        with pytest.MonkeyPatch.context() as mp:
            mp.setenv("OVP_IMG_WIRE", WIRE)
            mp.setenv("OVP_KLT_SAMPLER", SAMPLER)
            drv = j_fused.FusedVisionDriver(jcfg, eng, batch=B, chain=chain)
        sts = [j_init(eng, jcfg, t0=start["t0"][b], q0=start["q0"][b], p0=start["p0"][b], v0=start["v0"][b],
                      bg0=start["bg0"][b], ba0=start["ba0"][b], dtype=jnp.float64) for b in range(B)]
        state = jax.tree.map(lambda *x: jnp.stack(x), *sts)
        bank = jax.tree.map(lambda x: jnp.stack([x] * B),
                            JBank.create(jcfg.tpu.max_features, eng.layout.max_clones, dtype=jnp.float64))
        return drv, state, bank, jax.tree.map(lambda x: jnp.stack([x] * B), drv.init_frontend())

    out = {"time_keys": np.array(t_fused.FusedVisionDriver.TIME_KEYS)}
    drv, st, bk, fe = setup(K)
    for c in range(N_FRAMES // K):
        imgs, *win = chunk_inputs(inputs, c)
        out.update({f"chain{c}_labels{j}": a for j, a in enumerate(_labels(drv))})
        st, bk, fe, outs = drv.step_batch_chunk(st, bk, fe, imgs, *win)
        out[f"chain{c}_pull"] = np.asarray(drv._pending_pull)
        out[f"chain{c}_counters"] = np.asarray(drv.last_counters)
        out[f"chain{c}_p"], out[f"chain{c}_q"] = np.asarray(outs.p), np.asarray(outs.q)
    drv.flush_stream()
    out["chain_flush_counters"] = np.asarray(drv.last_counters)

    drv, st, bk, fe = setup(1)
    for k in range(N_SYNC):
        out.update({f"sync{k}_labels{j}": a for j, a in enumerate(_labels(drv))})
        st, bk, fe, o = drv.step_batch(st, bk, fe, frames[k], *windows[k], pipelined=False)
        out[f"sync{k}_counters"] = np.asarray(drv.last_counters)
        for j, name in enumerate(("ids", "uv", "p3", "ok")):
            out[f"sync{k}_tri_{name}"] = np.stack([np.asarray(t[j]) for t in drv.last_tri])
        out[f"sync{k}_p"], out[f"sync{k}_q"] = np.asarray(o.p), np.asarray(o.q)
    return out


if __name__ == "__main__":
    import time

    t = time.time()
    REFERENCE.parent.mkdir(exist_ok=True)
    np.savez_compressed(REFERENCE, **generate())
    print(f"wrote {REFERENCE} ({REFERENCE.stat().st_size} bytes) in {time.time() - t:.1f} s")
