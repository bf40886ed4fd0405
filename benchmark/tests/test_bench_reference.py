"""The reference against tiny CPU runs of the whole harness: a sound run is
correct, with every number well inside its limit."""

import math

import pytest


@pytest.mark.parametrize("name", ["ms_pt.room-b512"])
def test_a_sound_tiny_run_is_correct(run_tiny, name):
    out = run_tiny(name, seconds=2.0)
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    import run as brun

    for c in out["checks"].values():
        assert math.isfinite(c["value"]) and brun.within(c["value"], c["limit"])
    m = out["metrics"]
    assert m["stream_frames_per_s"]["value"] > 0 and m["setup_s"]["value"] > 0
    assert out["_info"]["reference_frames"] >= out["_info"]["frames"]
