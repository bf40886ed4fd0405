"""What a run may load: no JAX, no JAX package; the reference not even the port."""

import json
import shutil
import subprocess
import sys

from common import FORBIDDEN, PROGRAM, ROOT

HARNESS = ["run", "common", "inputs", "refrun", "devtrace", "roofline", "references.sequence"]


def _loaded(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=300,
                         env={"PATH": "/usr/bin:/bin", "HOME": str(ROOT / "build"), "PYTHONPATH": ""})
    assert out.returncode == 0, out.stderr
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_the_harness_and_the_program_load_no_jax():
    code = ("import sys, json; sys.path[:0] = ['benchmark', '.']\n"
            + "".join(f"import {m}\n" for m in HARNESS)
            + "from common import load_cell, load_driver, load_metric\n"
              "for w in json.load(open('BENCHMARK.json'))['workloads']:\n"
              "    c = load_cell(w['name']); load_driver(c['config'])\n"
              "    [load_metric(m['name']) for m in c['per_layer']]\n"
              "import ov_plane_tpu_torch.models.manager\n"
              "import ov_plane_tpu_torch.ops.kernels, ov_plane_tpu_torch.native\n"
              "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))\n")
    tops = _loaded(code)
    assert PROGRAM in tops
    assert not tops & set(FORBIDDEN)


def test_the_reference_loads_neither_the_port_nor_jax():
    code = ("import sys, json; sys.path[:0] = ['benchmark']\n"
            "import references.sequence, references.plain_filter, inputs\n"
            "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))\n")
    tops = _loaded(code)
    assert not tops & set(FORBIDDEN + (PROGRAM,))


def test_the_reference_processes_report_what_they_loaded(run_tiny):
    out = run_tiny("ms_pt.room-b512", seconds=1.0)
    assert out["_info"]["reference_loaded"] == []


def test_no_result_without_a_card():
    """On a machine without CUDA the command exits nonzero and prints nothing."""
    import pytest
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "ms_pt.room-b512", "--seed", "1",
                          "--seconds", "1", "--trace", "0"], cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "CUDA" in out.stderr


def test_no_result_in_a_checkout_of_the_benchmark_alone(tmp_path):
    """Where the checkout holds only BENCHMARK.json and the benchmark's files,
    the program is missing: the run fails and prints no result."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark", ignore=shutil.ignore_patterns("__pycache__"))
    code = ("import sys; sys.path[:0] = ['benchmark']\n"
            "sys.argv = ['benchmark/run.py', '--workload', 'ms_pt.room-b512', '--seed', '1', '--seconds', '1']\n"
            "import run, common\n"
            "cell = common.load_cell('ms_pt.room-b512', root=common.ROOT)\n"
            "print(run.run_cell(cell, 1, 1.0, False, 'cpu'))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "ov_plane_tpu_torch" in out.stderr
