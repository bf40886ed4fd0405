"""The port's span and counter recorder (``utils/trace.py``) in
``models.manager.step``, and the benchmark's readers of its export
(``benchmark/spanphase.py``, ``benchmark/metrics/``).

The run is ``test_torch_parallel``'s plane scene (its JAX draw, committed in
``tests/data/torch_parallel_jax.npz``) with 4 SLAM slots and no SLAM delay,
two streams in f64 on the CPU, so that within 14 frames the MSCKF, the plane
init and constraints and the SLAM init and update all run.
"""

import dataclasses
import statistics
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_torch_parallel import REFERENCE, configure, scene_arrays  # noqa: E402

from ov_plane_tpu_torch import convert  # noqa: E402
from ov_plane_tpu_torch.models.feature_bank import FeatureBank  # noqa: E402
from ov_plane_tpu_torch.models.manager import STAGES, VioEngine, init_state_with_gt, run_sequence  # noqa: E402
from ov_plane_tpu_torch.utils import config as tconfig  # noqa: E402
from ov_plane_tpu_torch.utils import trace  # noqa: E402

BENCH = Path(__file__).resolve().parents[1] / "benchmark"
B, N_FRAMES = 2, 14


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _recorder_left_off():
    yield
    trace.disable()
    trace.reset()


@pytest.fixture(scope="module")
def setup():
    with np.load(REFERENCE) as z:
        arrays = scene_arrays({k: z[k] for k in z.files}, "plane")
    cfg = configure(tconfig.sim_config(), "plane")
    cfg.state.max_slam_features = 4
    eng = dataclasses.replace(VioEngine.from_config(cfg, device="cpu"), dt_slam_delay=0.0)
    sim = convert.sim_from_arrays(arrays, device="cpu")
    sim = sim._replace(**{k: getattr(sim, k).expand(B, *getattr(sim, k).shape[1:]) for k in convert.NOISY_FIELDS})
    state = init_state_with_gt(eng, cfg, t0=sim.cam_t_imu[0].expand(B), q0=sim.gt_q[0].expand(B, 4),
                               p0=sim.gt_p[0].expand(B, 3), v0=sim.gt_v[0].expand(B, 3),
                               bg0=sim.gt_bg_cam[:, 0], ba0=sim.gt_ba_cam[:, 0], device="cpu")
    bank = FeatureBank.create(cfg.tpu.max_features, eng.layout.max_clones, B, device="cpu")
    return eng, cfg, sim, state, bank


def _run(setup, traced: bool, n_frames: int = N_FRAMES):
    eng, cfg, sim, state, bank = setup
    trace.reset()
    if traced:
        trace.enable()
    try:
        state, _, outs = run_sequence(eng, state, bank, sim, cfg.tpu.max_imu_per_frame, n_frames=n_frames)
        return state, outs, trace.export()
    finally:
        trace.disable()
        trace.reset()


@pytest.fixture(scope="module")
def plain(setup):
    return _run(setup, traced=False)


@pytest.fixture(scope="module")
def traced(setup):
    return _run(setup, traced=True)


def test_tracing_off_records_nothing_and_changes_no_output(plain, traced):
    """Off, nothing is recorded; on, the step's outputs and state are the
    same bits."""
    state_off, outs_off, exp = plain
    assert exp == dict(spans=[], counters={}, frames=0)
    state_on, outs_on, _ = traced
    for name, a, b in zip(outs_off._fields, outs_off, outs_on):
        assert torch.equal(a, b), name
    for name in ("imu", "cov", "clones_q", "clones_p", "slam_p", "plane_cp"):
        assert torch.equal(getattr(state_off, name), getattr(state_on, name)), name


def test_each_step_is_a_frame_with_its_stages_as_children(traced):
    """One ``manager.step`` span per frame, frames numbered in order; every
    other span is a stage of ``STAGES``, a child of its frame's step span
    inside its interval; self times are non-negative."""
    spans = traced[2]["spans"]
    assert traced[2]["frames"] == N_FRAMES
    roots = [i for i, s in enumerate(spans) if s["name"] == "manager.step"]
    assert [spans[i]["frame"] for i in roots] == list(range(N_FRAMES))
    assert all(spans[i]["parent"] == -1 for i in roots)
    children = {i: [] for i in roots}
    for s in spans:
        if s["name"] == "manager.step":
            continue
        assert s["name"] in STAGES
        root = spans[s["parent"]]
        assert root["name"] == "manager.step" and s["frame"] == root["frame"]
        assert root["start_ns"] <= s["start_ns"] <= s["end_ns"] <= root["end_ns"]
        children[s["parent"]].append(s)
    for i in roots:
        kids = sorted(children[i], key=lambda s: s["start_ns"])
        assert {"step.propagate_and_clone", "step.msckf_update", "step.slam_init"} <= {s["name"] for s in kids}
        assert all(a["end_ns"] <= b["start_ns"] for a, b in zip(kids, kids[1:]))    # siblings do not overlap
        self_ns = spans[i]["end_ns"] - spans[i]["start_ns"] - sum(s["end_ns"] - s["start_ns"] for s in kids)
        assert self_ns >= 0


def test_counters_equal_the_step_outputs_they_mirror(traced):
    """``msckf.used`` sums ``n_msckf_used`` over streams and frames, and the
    tracks that entered the update are at least those it used."""
    _, outs, exp = traced
    c = exp["counters"]
    assert set(c) == {"msckf.selected", "msckf.used"}
    assert c["msckf.used"] == int(outs.n_msckf_used.sum())
    assert c["msckf.selected"] >= c["msckf.used"] > 0


def test_spans_lie_on_the_profilers_clock(setup):
    """Under torch.profiler (CPU activity) each program span holds the kineto
    range of its name and order to within 50 µs at either end (the two
    clocks agree), and the median distance of the ends is within 0.1 ms.
    The span reads the clock just outside the range, so a pause between the
    two readings (the thread descheduled, a garbage collection) widens the
    span and never moves it inside the range."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _, _, exp = _run(setup, traced=True, n_frames=2)
    kineto = {}
    for e in prof.profiler.kineto_results.events():
        if e.is_user_annotation():
            kineto.setdefault(e.name(), []).append((e.start_ns(), e.start_ns() + e.duration_ns()))
    ours = {}
    for s in exp["spans"]:
        ours.setdefault(s["name"], []).append((s["start_ns"], s["end_ns"]))
    gaps = []
    for name, mine in ours.items():
        theirs = sorted(kineto[name])
        assert len(theirs) == len(mine), name
        for (a, b), (ka, kb) in zip(mine, theirs):
            assert ka - a >= -50_000 and b - kb >= -50_000, (name, ka - a, b - kb)
            gaps += [abs(a - ka), abs(b - kb)]
    assert len(gaps) >= 2 * 2 * (1 + 6)
    assert statistics.median(gaps) <= 100_000, statistics.median(gaps)


def test_spans_opened_before_a_reset_leave_the_new_recording_whole():
    trace.enable()
    with trace.span("manager.step", frame=True):
        trace.reset()
        with trace.span("step.ingest"):
            pass
    with trace.span("manager.step", frame=True):
        trace.count("msckf.used", torch.tensor([1, 2]))
        trace.count("msckf.used", 3)
    exp = trace.export()
    assert [(s["name"], s["parent"], s["frame"]) for s in exp["spans"]] == [
        ("step.ingest", -1, -1), ("manager.step", -1, 0)]
    assert exp["counters"] == {"msckf.used": 6} and exp["frames"] == 1


# ----------------------------------------------------------------------
# The benchmark's readers of the export.

def _reader(name):
    if str(BENCH) not in sys.path:
        sys.path.append(str(BENCH))
    import importlib.util

    spec = importlib.util.spec_from_file_location(f"bench_metric_{name}", BENCH / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def _span(name, start_ms, end_ms, frame, parent=-1):
    return dict(name=name, start_ns=int(start_ms * 1e6), end_ns=int(end_ms * 1e6), parent=parent, frame=frame)


HAND_MADE = dict(
    frames=2,
    spans=[_span("manager.step", 0, 100, 0), _span("step.propagate_and_clone", 1, 51, 0, 0),
           _span("step.slam_marginalize", 60, 61, 0, 0), _span("step.slam_update", 61, 71, 0, 0),
           _span("step.slam_init", 71, 80, 0, 0),
           _span("manager.step", 200, 320, 1), _span("step.propagate_and_clone", 201, 271, 1, 5),
           _span("step.slam_update", 280, 300, 1, 5)],
    counters={"msckf.selected": 40.0, "msckf.used": 30.0, "slam.init_candidates": 8.0, "slam.inits": 2.0})
READERS = {"msckf_used_pct": 75.0}
# The span phase's stderr split: host ms per frame inside these spans.
HOST_MS = {("manager.step",): 110.0, ("step.propagate_and_clone",): 60.0,
           ("step.slam_marginalize", "step.slam_update", "step.slam_init"): 20.0}


@pytest.mark.parametrize("name", sorted(READERS))
def test_reader_gives_none_without_an_export(name):
    read = _reader(name)
    assert read({}) is None                                    # no run: no span phase
    assert read({"spans": None}) is None                       # a program without the recorder
    assert read({"spans": dict(frames=0, spans=[], counters={})}) is None
    assert read({"spans": dict(HAND_MADE, counters={k: 0.0 for k in HAND_MADE["counters"]},
                               spans=[s for s in HAND_MADE["spans"] if s["name"] == "step.ingest"])}) is None


@pytest.mark.parametrize("name", sorted(READERS))
def test_reader_reads_a_hand_made_export(name):
    assert _reader(name)({"spans": HAND_MADE}) == pytest.approx(READERS[name], rel=1e-12)


def _spanphase():
    _reader("msckf_used_pct")
    import spanphase

    return spanphase


@pytest.mark.parametrize("names", sorted(HOST_MS))
def test_host_ms_reads_a_hand_made_export(names):
    spanphase = _spanphase()
    assert spanphase.host_ms(HAND_MADE, names) == pytest.approx(HOST_MS[names], rel=1e-12)
    assert spanphase.host_ms(None, names) is None
    assert spanphase.host_ms(dict(HAND_MADE, frames=0), names) is None
    assert spanphase.host_ms(dict(HAND_MADE, spans=[]), names) is None


def test_span_phase_steps_the_run_with_the_recorder_on():
    """``spanphase.of`` steps the context's run ``FRAMES`` times with the
    recorder on, keeps the export in the context, and leaves the recorder
    off and empty."""
    spanphase = _spanphase()

    class Run:
        steps = 0

        def step(self):
            Run.steps += 1
            with trace.span("manager.step", frame=True):
                with trace.span("step.propagate_and_clone"):
                    trace.count("msckf.selected", torch.tensor([2, 2]))
                    trace.count("msckf.used", torch.tensor([1, 2]))

    ctx = {"run": Run()}
    exp = spanphase.of(ctx)
    assert Run.steps == spanphase.FRAMES and exp["frames"] == spanphase.FRAMES and ctx["spans"] is exp
    assert exp["counters"] == {"msckf.selected": 4.0 * spanphase.FRAMES, "msckf.used": 3.0 * spanphase.FRAMES}
    assert _reader("msckf_used_pct")(ctx) == 75.0 and spanphase.host_ms(exp, ("manager.step",)) > 0
    assert spanphase.of(ctx) is exp and Run.steps == spanphase.FRAMES       # once per run
    assert trace.export() == dict(spans=[], counters={}, frames=0)
    assert not trace.RECORDER.on


def test_span_phase_steps_nothing_in_a_program_without_the_recorder(monkeypatch):
    """Laid over a tree whose program has no ``utils.trace``, the phase
    steps no frame and every reader gives None (no exception)."""
    spanphase = _spanphase()

    class Run:
        def step(self):
            raise AssertionError("stepped")

    monkeypatch.setitem(sys.modules, "ov_plane_tpu_torch.utils.trace", None)
    ctx = {"run": Run()}
    assert spanphase.of(ctx) is None
    assert all(_reader(name)(ctx) is None for name in READERS)


def test_span_phase_fails_where_the_recorder_fails_to_import(monkeypatch):
    """Only a missing recorder module is a program without the recorder: a
    recorder that exists but cannot be imported fails the run."""
    spanphase = _spanphase()
    import importlib

    real = importlib.import_module

    def broken(name, *args):
        if name == spanphase.RECORDER:
            raise ModuleNotFoundError("No module named 'ov_plane_tpu_torch.utils.missing'",
                                      name="ov_plane_tpu_torch.utils.missing")
        return real(name, *args)

    monkeypatch.setattr(importlib, "import_module", broken)

    class Run:
        def step(self):
            raise AssertionError("stepped")

    with pytest.raises(ModuleNotFoundError):
        spanphase.of({"run": Run()})
