"""The plain filter of the output check on its own, against the committed
scene's truth and against geometry: no program involved."""

import json

import numpy as np
import pytest

from common import HERE
from references import plain_filter as pf


@pytest.fixture(scope="module")
def scene():
    with np.load(HERE / "data" / "sim_planes_truth.npz") as z:
        return {k: np.asarray(z[k]) for k in z.files}


@pytest.fixture(scope="module")
def opts():
    with open(HERE / "configs" / "ms_pt.json") as f:
        return pf.Options(json.load(f))


def _state(o, q, p, v):
    K, L, P = o.K, o.L, o.P
    return dict(t=0.0, last_dt=0.0, calib_dt=0.0, startup_t=0.0, imu=np.concatenate([q, p, v, np.zeros(6)]),
                imu_fej=np.concatenate([q, p, v, np.zeros(6)]), clones_q=np.tile([0.0, 0, 0, 1], (K, 1)),
                clones_p=np.zeros((K, 3)), clones_q_fej=np.tile([0.0, 0, 0, 1], (K, 1)),
                clones_p_fej=np.zeros((K, 3)), clones_t=np.full(K, -np.inf), slam_p=np.zeros((L, 3)),
                slam_p_fej=np.zeros((L, 3)), slam_id=np.full(L, -1), slam_active=np.zeros(L, bool),
                slam_anchor_slot=np.full(L, -1), plane_cp=np.zeros((P, 3)), cov=np.zeros((o.D, o.D)))


@pytest.mark.parametrize("frame", [1, 40, 150])
def test_noiseless_propagation_follows_the_scene_truth(scene, opts, frame):
    """From the true state at a frame, the true IMU samples carry the mean to
    the next frame's true pose, and the new clone holds it."""
    i = frame - 1
    s = _state(opts, scene["gt_q"][i], scene["gt_p"][i], scene["gt_v"][i])
    s["t"] = float(scene["cam_t_imu"][i])
    k = int(scene["imu_window_start"][frame])
    sl = slice(k, k + 64)
    slot = pf.propagate(s, opts, scene["imu_t"][sl], scene["imu_w_true"][sl], scene["imu_a_true"][sl],
                        float(scene["cam_t"][frame]))
    R = pf.rot(s["imu"][0:4]) @ pf.rot(scene["gt_q"][frame]).T
    assert np.linalg.norm(s["imu"][4:7] - scene["gt_p"][frame]) < 1e-5
    assert np.linalg.norm(s["imu"][7:10] - scene["gt_v"][frame]) < 1e-4
    assert np.arccos(min(1.0, (np.trace(R) - 1) / 2)) < 1e-6
    assert s["clones_t"][slot] == scene["cam_t"][frame] and np.array_equal(s["clones_p"][slot], s["imu"][4:7])
    # The process noise enters the covariance, symmetric and positive.
    assert np.allclose(s["cov"], s["cov"].T) and np.linalg.eigvalsh(s["cov"][:15, :15]).min() > 0


def test_triangulation_recovers_a_point(opts):
    rng = np.random.default_rng(3)
    p_true = np.array([1.0, 2.0, 4.0])
    Rc, pc, uvn = [], [], []
    for k in range(5):
        pos = np.array([0.2 * k, -0.1 * k, 0.0])
        Rc.append(np.eye(3))
        pc.append(pos)
        x = p_true - pos
        uvn.append(x[:2] / x[2] + 1e-9 * rng.standard_normal(2))
    p, ok = pf.triangulate(np.array(uvn), list(range(5)), np.array(Rc), np.array(pc), opts.tri)
    assert ok and np.linalg.norm(p - p_true) < 1e-6


def test_distortion_round_trip_and_jacobian(opts):
    xn = np.array([0.21, -0.13])
    uv, J = pf.distort(xn, opts.zeta)
    assert np.allclose(pf.undistort(uv, opts.zeta), xn, atol=1e-12)
    h = 1e-7
    num = np.stack([(pf.distort(xn + h * e, opts.zeta)[0] - pf.distort(xn - h * e, opts.zeta)[0]) / (2 * h)
                    for e in np.eye(2)], 1)
    assert np.allclose(J, num, rtol=1e-6, atol=1e-4)
