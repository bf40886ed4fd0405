"""The output check fails a broken timed path: the whole harness on a tiny
cell on the CPU (the look for a card skipped), with the program's step
broken underneath, must come out not correct. One fault each: a step that
returns its state unchanged, half of the batch left out, an answer altered
where it is produced (the filter's position), and the covariance update
left out. No cell crosses chips, so no exchange can be left out."""

import pytest
import torch

CELL = "ms_pt.room-b512"


def _fault(kind: str, batch: int):
    """(new state, out) from (old state, new state, out)."""
    from ov_plane_tpu_torch.state.vio_state import tree_where

    def unchanged(old, new, out):
        return old, out._replace(q=old.imu[:, 0:4].clone(), p=old.imu[:, 4:7].clone())

    def half(old, new, out):
        st = tree_where(torch.arange(batch) >= batch // 2, old, new)
        return st, out._replace(q=st.imu[:, 0:4].clone(), p=st.imu[:, 4:7].clone())

    def altered(old, new, out):
        imu = new.imu.clone()
        imu[:, 4:7] += 0.05          # 5 cm on every stream's position, where the step produces it
        return new.replace(imu=imu), out._replace(p=out.p + 0.05)

    return {"unchanged": unchanged, "half": half, "altered": altered}[kind]


@pytest.mark.parametrize("kind", ["unchanged", "half", "altered"])
def test_sequence_step_fault_is_not_correct(run_tiny, monkeypatch, kind):
    from ov_plane_tpu_torch.models import manager

    real, batch = manager.step, 4
    fault = _fault(kind, batch)

    def broken(eng, state, bank, frame):
        st, bk, out = real(eng, state, bank, frame)
        st, out = fault(state, st, out)
        return st, bk, out

    monkeypatch.setattr(manager, "step", broken)
    out = run_tiny(CELL, seconds=1.0, batch=batch)
    assert not out["correct"], out["checks"]


def test_covariance_update_left_out_is_not_correct(run_tiny, monkeypatch):
    """The hand-written downdate returns the covariance it was given (the
    mean's correction still applied): only the covariance is wrong."""
    from ov_plane_tpu_torch.ops import kernels

    real = kernels.kalman_downdate

    def broken(cov, W, u):
        _, dx = real(cov, W, u)
        return cov.clone(), dx

    monkeypatch.setattr(kernels, "kalman_downdate", broken)
    out = run_tiny(CELL, seconds=1.0)
    assert not out["correct"], out["checks"]
    assert out["checks"]["cov_gap_rel"]["value"] > out["checks"]["cov_gap_rel"]["limit"]
