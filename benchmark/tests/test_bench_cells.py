"""BENCHMARK.json and the files it names, read as data."""

import json
import re
import shutil

import pytest

from common import ROOT, load_cell, load_metric, read_json, sample_streams

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = read_json(ROOT / "BENCHMARK.json")
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_benchmark_json_keeps_to_the_contract():
    b = BENCH
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert b["command"] == ["python3", "benchmark/run.py"] and b["paths"] == ["benchmark"]
    assert isinstance(b["run_seconds"], int) and 1 <= b["run_seconds"] <= 51
    assert len(json.dumps(b)) < 64 * 1024
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer") for x in b[k]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert (ROOT / c["file"]).is_file() and c["file"].startswith("benchmark/")
        assert all(NAME.match(k) for k in c["reduced"])
        assert any(w["config"] == c["name"] for w in b["workloads"])
    pairs = set()
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] == 1
        assert 1 <= len(w["why"]) <= 200 and (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
    e2e = {m["name"] for m in b["end_to_end"]}
    assert "setup_s" in e2e
    for m in b["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher") and 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in b["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["moves"] in e2e and UNIT.match(m["unit"])
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert set(m.get("workloads", CELLS)) <= set(CELLS)
        assert (ROOT / "benchmark" / "metrics" / f"{m['name']}.py").is_file()


@pytest.mark.parametrize("name", CELLS)
def test_every_cell_loads_with_its_files(name):
    cell = load_cell(name)
    cfg = cell["config"]
    assert (ROOT / "benchmark" / "drivers" / f"{cfg['driver']}.py").is_file()
    assert (ROOT / "benchmark" / "references" / f"{cfg['driver']}.py").is_file()
    assert (ROOT / "benchmark" / cfg["scene"]).is_file()
    assert cell["traffic"]["batch"] >= 1 and cell["per_layer"] and cell["end_to_end"]
    for m in cell["per_layer"]:
        assert callable(load_metric(m["name"]).read)


def test_a_cell_and_a_metric_added_as_data_alone_are_listed(tmp_path):
    """A later change adds a cell, its traffic and a metric by adding files and
    entries: the harness finds them by name without an edit of any file."""
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("data", "__pycache__", "tests"))
    b = json.loads(json.dumps(BENCH))
    b["workloads"].append({"name": "ms_pt.room-b8", "config": "ms_pt", "traffic": "room-b8", "chips": 1,
                           "why": "a dummy"})
    b["per_layer"].append({"name": "dummy_count", "unit": "count", "better": "lower", "source": "program_counter",
                           "layer": "frame loop", "moves": "stream_frames_per_s", "workloads": ["ms_pt.room-b8"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(b))
    (tmp_path / "benchmark" / "traffic" / "room-b8.json").write_text(
        json.dumps({"batch": 8, "sampled_streams": 2, "trace_frames": 1}))
    (tmp_path / "benchmark" / "metrics" / "dummy_count.py").write_text("def read(ctx):\n    return 7.0\n")
    cell = load_cell("ms_pt.room-b8", root=tmp_path)
    assert cell["traffic"]["batch"] == 8 and cell["config"]["driver"] == "sequence"
    assert "dummy_count" in [m["name"] for m in cell["per_layer"]]
    assert load_metric("dummy_count", root=tmp_path).read({}) == 7.0
    assert "dummy_count" not in [m["name"] for m in load_cell("ms_pt.room-b512", root=tmp_path)["per_layer"]]


@pytest.mark.parametrize("seed", [0, 7, 2**31 + 5, 2**40 + 3])
def test_sampled_streams_one_from_each_part(seed):
    for batch in (2, 3, 512, 1024):
        s = sample_streams(seed, batch, 4)
        assert s == sample_streams(seed, batch, 4) and s == sorted(s)
        k = min(4, batch)
        assert len(s) == k and all(batch * j // k <= x < batch * (j + 1) // k for j, x in enumerate(s))


def test_a_number_against_its_limit():
    import run as brun

    assert brun.within(1e-4, 9e-4) and not brun.within(1e-3, 9e-4)
    assert not brun.within(float("inf"), 1.0) and not brun.within(float("nan"), 1.0)
    assert brun.within(0.0, 0.0) and brun.within(0, 0) and not brun.within(1, 0)

