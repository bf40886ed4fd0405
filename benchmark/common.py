"""What every part of the benchmark shares: where its files are, how a cell
is read from ``BENCHMARK.json`` and found as data, the streams sampled for
the output check, and the check of the program's configuration."""

from __future__ import annotations

import importlib.util
import json
import random
from pathlib import Path


HERE = Path(__file__).resolve().parent      # benchmark/
ROOT = HERE.parent                           # the checkout
BUILD = ROOT / "build" / "benchmark"         # caches and build outputs, at a fixed path in the checkout
FORBIDDEN = ("jax", "jaxlib", "flax", "ov_plane_tpu")  # top-level names no run may load
PROGRAM = "ov_plane_tpu_torch"


def load_module(path: Path, name: str):
    """Import the Python file ``path`` as a module named ``name``."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def read_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_cell(name: str, root: Path = ROOT) -> dict:
    """One cell of ``<root>/BENCHMARK.json`` with everything it names, found
    by name: the config's file, ``benchmark/traffic/<traffic>.json``, and
    the per-layer metrics that apply to the cell (their readers are
    ``benchmark/metrics/<metric>.py``), and the limits of the output check,
    which the config states."""
    bench = read_json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; have {sorted(cells)}")
    cell = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = read_json(root / configs[cell["config"]]["file"])
    traffic = read_json(root / "benchmark" / "traffic" / f"{cell['traffic']}.json")
    def applies(m):
        return name in m["workloads"] if "workloads" in m else True

    return dict(name=name, cell=cell, config=config, traffic=traffic, limits=config["limits"],
                end_to_end=[m for m in bench["end_to_end"] if applies(m)],
                per_layer=[m for m in bench["per_layer"] if applies(m)], run_seconds=bench["run_seconds"])


def load_driver(config: dict):
    return load_module(HERE / "drivers" / f"{config['driver']}.py", f"bench_driver_{config['driver']}")


def load_metric(name: str, root: Path = ROOT):
    return load_module(root / "benchmark" / "metrics" / f"{name}.py", f"bench_metric_{name.replace('.', '_')}")


def sample_streams(seed: int, batch: int, k: int) -> list[int]:
    """k streams drawn from the seed, one from each of k equal parts of the
    batch (so a fault in any part of it is seen), ascending."""
    rng = random.Random(seed)
    k = min(k, batch)
    edges = [batch * j // k for j in range(k + 1)]
    return [rng.randrange(edges[j], edges[j + 1]) for j in range(k)]


def check_sizes(cfg, sizes: dict):
    """The program's configuration holds the sizes the config file states."""
    for key, want in sizes.items():
        obj = cfg
        for part in key.split("."):
            obj = getattr(obj, part)
        got = list(obj) if isinstance(obj, (list, tuple)) else obj
        if got != want:
            raise RuntimeError(f"the program's {key} is {got!r}, the config file states {want!r}")
