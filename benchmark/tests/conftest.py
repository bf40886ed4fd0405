"""The benchmark's own tests: the harness's modules on the path, and tiny
cells that run the whole harness on the CPU."""

import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
for p in (str(BENCH.parent), str(BENCH)):
    if p not in sys.path:
        sys.path.insert(0, p)

# Tiny forms of the cells for the CPU: (batch, scene frames, warm-up frames).
TINY = {"ms_pt.room-b512": (3, 30, 22)}


def tiny_cell(name: str, batch: int | None = None):
    from common import load_cell

    b, frames, warm = TINY[name]
    cell = load_cell(name)
    cell["traffic"] = dict(cell["traffic"], batch=batch or b, scene_frames=frames, sampled_streams=2)
    cell["config"] = dict(cell["config"], warm_frames=warm)
    return cell


@pytest.fixture
def run_tiny():
    """Run a tiny cell through the whole harness on the CPU."""
    import run as brun

    def go(name: str, seconds: float = 2.0, seed: int = 2**31 + 17, **kw):
        return brun.run_cell(tiny_cell(name, **kw), seed, seconds, False, "cpu")

    return go
