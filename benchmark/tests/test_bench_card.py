"""On a card (skips without one): the output check's control and a sound run
of each configuration at a size a test run holds (64 streams, a short
window). The control is the port with TF32 matrix products, the precision
below the configuration's float32; it must come out not correct, and the
same run in float32 correct.

    python3 -m pytest benchmark/tests/test_bench_card.py -m cuda -p no:cacheprovider
"""

import pytest
import torch

CELLS = ["ms_pt.room-b512"]


def _card_cell(name: str):
    from common import load_cell

    cell = load_cell(name)
    cell["traffic"] = dict(cell["traffic"], batch=64)
    return cell


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct_and_the_tf32_control_is_not(card, name):
    import run as brun

    sound = brun.run_cell(_card_cell(name), 2**31 + 101, 10.0, False, "cuda")
    control = brun.run_cell(_card_cell(name), 2**31 + 101, 10.0, False, "cuda", control="tf32")
    assert sound["correct"], sound["checks"]
    assert not control["correct"], control["checks"]
