"""Module-by-module parity of the port with the JAX package.

The same numpy inputs (from seeded generators) go through each JAX function,
one stream at a time, and through its port counterpart with a leading stream
dimension B, on the CPU in f64. Tolerance 1e-10 unless a test says
otherwise: both sides run the same arithmetic in f64, so only the order of a
few sums differs. Quantities that depend on the choice of an orthonormal
basis (nullspace projection, thin QR) are compared through invariants
(RᵀR, Rᵀy, yᵀy).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ov_plane_tpu.eval import metrics as j_metrics
from ov_plane_tpu.models import feature_bank as j_fb
from ov_plane_tpu.models import jacobians as j_jac
from ov_plane_tpu.models import manager as j_manager
from ov_plane_tpu.ops import cams as j_cams
from ov_plane_tpu.ops import ekf as j_ekf
from ov_plane_tpu.ops import quat as j_quat
from ov_plane_tpu.ops import triangulation as j_tri
from ov_plane_tpu.parallel import schur as j_schur
from ov_plane_tpu.state import layout as j_layout
from ov_plane_tpu.state import propagator as j_prop
from ov_plane_tpu.state import vio_state as j_vs
from ov_plane_tpu.utils.config import sim_config as j_sim_config
from ov_plane_tpu_torch import convert
from ov_plane_tpu_torch.eval import metrics
from ov_plane_tpu_torch.models import feature_bank as fb
from ov_plane_tpu_torch.models import jacobians as jac
from ov_plane_tpu_torch.models import manager
from ov_plane_tpu_torch.ops import cams, ekf, quat, triangulation
from ov_plane_tpu_torch.parallel import schur
from ov_plane_tpu_torch.state import propagator as prop
from ov_plane_tpu_torch.state.layout import StateLayout
from ov_plane_tpu_torch.utils.config import sim_config

TOL = dict(rtol=1e-10, atol=1e-10)
RADTAN_ZETA = [458.654, 457.296, 367.215, 248.375, -0.28340811, 0.07395907, 0.00019359, 1.76187114e-05]
EQUI_ZETA = [380.0, 381.0, 320.0, 240.0, -0.013, 0.021, -0.0062, 0.0011]
K_CLONES = 6


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def t(a, dtype=torch.float64):
    return torch.as_tensor(np.array(a), dtype=dtype)  # a copy: JAX hands out read-only buffers


def close(port, ref, **tol):
    np.testing.assert_allclose(port.detach().numpy(), np.asarray(ref), **(tol or TOL))


def unit_quats(rng, n):
    q = rng.normal(size=(n, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    return q * np.sign(q[:, 3:4])


def layouts(K=K_CLONES):
    kw = dict(max_clones=K, max_slam=1, max_planes=1, calib_dt=False, calib_pose=False, calib_intr=False)
    return j_layout.StateLayout(**kw), StateLayout(**kw)


def jax_state(rng, jlay, n_clones):
    """A random JAX VioState: unit quaternions, SPD covariance, n_clones live clones."""
    K, D = jlay.max_clones, jlay.dim
    st = j_vs.VioState.create(jlay)
    q = unit_quats(rng, 1 + 2 * K)
    imu = np.concatenate([q[0], rng.normal(size=3), rng.normal(size=3), 1e-3 * rng.normal(size=3),
                          1e-2 * rng.normal(size=3)])
    fej = imu.copy()
    fej[4:10] += 1e-3 * rng.normal(size=6)
    A = rng.normal(size=(D, D))
    cov = 1e-3 * (A @ A.T) / D + 1e-4 * np.eye(D)
    clones_t = np.full(K, -np.inf)
    clones_t[:n_clones] = 0.1 * rng.permutation(n_clones) + 1.0
    q_ic = unit_quats(rng, 1)[0] * np.array([0.05, 0.05, 0.05, 1.0])
    q_ic /= np.linalg.norm(q_ic)
    return st.replace(
        t=jnp.asarray(2.0), imu=jnp.asarray(imu), imu_fej=jnp.asarray(fej), cov=jnp.asarray(cov),
        clones_q=jnp.asarray(q[1:K + 1]), clones_q_fej=jnp.asarray(q[K + 1:]),
        clones_p=jnp.asarray(rng.normal(size=(K, 3))),
        clones_p_fej=jnp.asarray(rng.normal(size=(K, 3))), clones_t=jnp.asarray(clones_t),
        calib_cam=jnp.asarray(np.concatenate([q_ic, 0.02 * rng.normal(size=3)])),
        cam_zeta=jnp.asarray(RADTAN_ZETA),
    )


def state_arrays(st):
    return {f.name: np.asarray(getattr(st, f.name)) for f in dataclasses.fields(st) if f.name != "layout"}


def port_state(jstates, lay):
    return convert.state_from_arrays(convert.stack_streams([state_arrays(s) for s in jstates]), lay)


# --------------------------------------------------------------------------- quat


def test_quat_ops():
    rng = np.random.default_rng(1)
    q, p = unit_quats(rng, 32), unit_quats(rng, 32)
    # Rotation vectors from exactly zero through the θ² guard to large angles.
    w = rng.normal(size=(32, 3)) * np.logspace(-9, 0.4, 32)[:, None]
    w[0] = 0.0
    vm = jax.vmap
    close(quat.quat_multiply(t(q), t(p)), vm(j_quat.quat_multiply)(q, p))
    close(quat.quat_2_rot(t(q)), vm(j_quat.quat_2_rot)(q))
    R = np.asarray(vm(j_quat.quat_2_rot)(q))
    close(quat.rot_2_quat(t(R)), vm(j_quat.rot_2_quat)(R))
    close(quat.skew(t(w)), vm(j_quat.skew)(w))
    close(quat.omega(t(w)), vm(j_quat.omega)(w))
    close(quat.exp_so3(t(w)), vm(j_quat.exp_so3)(w))
    close(quat.jr_so3(t(w)), vm(j_quat.jr_so3)(w))
    Rw = np.asarray(vm(j_quat.exp_so3)(w))
    close(quat.log_so3(t(Rw)), vm(j_quat.log_so3)(Rw), rtol=1e-10, atol=1e-9)
    close(quat.quat_inv(t(q)), vm(j_quat.quat_inv)(q))


# --------------------------------------------------------------------------- cams


@pytest.mark.parametrize("model", [cams.RADTAN, cams.EQUI], ids=["radtan", "equi"])
def test_cams_closed_form_jacobians_and_undistort(model):
    rng = np.random.default_rng(2)
    zeta = np.asarray(RADTAN_ZETA if model == cams.RADTAN else EQUI_ZETA)
    uvn = rng.uniform(-0.6, 0.6, size=(40, 2))
    uvn[0] = 0.0  # the r → 0 limit of the fisheye model
    uvn[1] = [1e-9, -2e-9]
    uv, dz_dzn, dz_dzeta = cams.distort_jacobians(t(uvn), t(zeta), model)
    j_uv, j_dzn, j_dzeta = jax.vmap(lambda x: j_cams.distort_jacobians(x, jnp.asarray(zeta), model))(uvn)
    close(uv, j_uv)
    close(dz_dzn, j_dzn, rtol=1e-10, atol=1e-8)
    close(dz_dzeta, j_dzeta, rtol=1e-10, atol=1e-8)
    close(cams.distort_norm(t(uvn), t(zeta), model), j_uv)
    pix = np.asarray(j_uv) + rng.normal(size=(40, 2))
    und = cams.undistort(t(pix), t(zeta), model)
    close(und, jax.vmap(lambda x: j_cams.undistort(x, jnp.asarray(zeta), model))(pix))
    # Per-stream intrinsics broadcast over observations ([B, 1, 8] with [B, O, 2]).
    und_b = cams.undistort(t(pix).reshape(2, 20, 2), t(zeta).expand(2, 1, 8), model)
    close(und_b.reshape(40, 2), und.numpy())
    pts = np.concatenate([rng.normal(size=(40, 2)), rng.uniform(0.5, 5.0, size=(40, 1))], axis=1)
    for a, b in zip(cams.project(t(pts), t(zeta), model),
                    jax.vmap(lambda x: j_cams.project(x, jnp.asarray(zeta), model))(pts)):
        close(a, b)


# --------------------------------------------------------------------------- ekf


def _spd(rng, B, D):
    A = rng.normal(size=(B, D, D))
    return A @ A.transpose(0, 2, 1) / D + 0.1 * np.eye(D)


def test_kalman_update_and_cov_ops():
    rng = np.random.default_rng(3)
    B, M, D = 3, 17, 24
    cov = _spd(rng, B, D)
    H = rng.normal(size=(B, M, D))
    res = rng.normal(size=(B, M))
    H[:, 5:9] = 0.0  # masked rows: zero H, zero residual, unit noise
    res[:, 5:9] = 0.0
    r_diag = np.ones(M)
    dx, nc, chi2 = ekf.kalman_update(t(cov), t(H), t(res), t(r_diag))
    for b in range(B):
        j_dx, j_nc, j_chi2 = j_ekf.kalman_update(cov[b], H[b], res[b], r_diag)
        close(dx[b], j_dx)
        close(nc[b], j_nc)
        close(chi2[b], j_chi2)
    assert torch.equal(nc, nc.transpose(-1, -2))

    phi = np.eye(15) + 0.1 * rng.normal(size=(B, 15, 15))
    qd = _spd(rng, B, 15) * 1e-3
    pc = ekf.propagate_cov(t(cov), t(phi), t(qd))
    dst = np.array([18, 6, 12])  # clone slots: in range, clear of the IMU block
    zs = ekf.zero_slot(t(cov), torch.as_tensor(dst), 6)
    cb = ekf.clone_block(zs, 0, torch.as_tensor(dst), 6)
    for b in range(B):
        close(pc[b], j_ekf.propagate_cov(cov[b], phi[b], qd[b]))
        j_zs = j_ekf.zero_slot(cov[b], dst[b], 6)
        close(zs[b], j_zs)
        close(cb[b], j_ekf.clone_block(j_zs, 0, dst[b], 6))

    A = rng.normal(size=(B, 3, 3))
    close(ekf.inv3(t(A)), jax.vmap(j_ekf.inv3)(A))


def test_cholesky_failure_routes_like_jax():
    """JAX returns NaN from a failed Cholesky and the code routes on it; the
    port fills NaN where ``cholesky_ex`` reports failure."""
    rng = np.random.default_rng(4)
    S = _spd(rng, 3, 6)
    S[1] = -S[1]
    L = ekf.cholesky_or_nan(t(S))
    assert torch.isnan(L[1]).all() and torch.isfinite(L[[0, 2]]).all()
    close(L[[0, 2]], np.linalg.cholesky(S[[0, 2]]))
    # Information form: a failed factorization gives zero information.
    lam = S.copy()
    eta = rng.normal(size=(3, 6))
    R, y = schur.information_to_compressed(t(lam), t(eta))
    for b in range(3):
        j_R, j_y = j_schur.information_to_compressed(lam[b], eta[b])
        close(R[b], j_R)
        close(y[b], j_y)
    assert torch.equal(R[1], torch.zeros(6, 6)) and torch.equal(y[1], torch.zeros(6))


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
def test_information_to_compressed(dtype):
    rng = np.random.default_rng(5)
    H = rng.normal(size=(2, 50, 12))
    r = rng.normal(size=(2, 50))
    lam, eta = schur.local_information(t(H), t(r))
    lam, eta = lam.to(dtype), eta.to(dtype)
    R, y = schur.information_to_compressed(lam, eta)
    jdt = jnp.float64 if dtype == torch.float64 else jnp.float32
    tol = TOL if dtype == torch.float64 else dict(rtol=2e-5, atol=2e-5)
    for b in range(2):
        j_lam, j_eta = j_schur.local_information(H[b], r[b])
        close(lam[b].double(), j_lam, rtol=1e-6 if dtype == torch.float32 else 1e-10)
        j_R, j_y = j_schur.information_to_compressed(jnp.asarray(lam[b].numpy(), jdt),
                                                     jnp.asarray(eta[b].numpy(), jdt))
        close(R[b], j_R, **tol)
        close(y[b], j_y, **tol)


def test_nullspace_project_and_measurement_compress_invariants():
    rng = np.random.default_rng(6)
    B, M, Dx = 3, 14, 20
    H_f = rng.normal(size=(B, M, 3))
    H_x = rng.normal(size=(B, M, Dx))
    res = rng.normal(size=(B, M))
    H_f[:, 10:], H_x[:, 10:], res[:, 10:] = 0.0, 0.0, 0.0
    H2, r2 = ekf.nullspace_project(t(H_f), t(H_x), t(res))
    assert H2.shape == (B, M - 3, Dx)
    Rc, yc = ekf.measurement_compress(H2, r2)
    for b in range(B):
        j_H2, j_r2 = j_ekf.nullspace_project(H_f[b], H_x[b], res[b])
        j_H2, j_r2 = np.asarray(j_H2), np.asarray(j_r2)
        close(H2[b].T @ H2[b], j_H2.T @ j_H2)
        close(H2[b].T @ r2[b], j_H2.T @ j_r2)
        close(r2[b] @ r2[b], j_r2 @ j_r2)
        # The projected rows are orthogonal to the feature columns.
        assert float(torch.abs(H2[b].T @ H2[b]).max()) > 1.0
        j_R, j_y = j_ekf.measurement_compress(j_H2, j_r2)
        j_R, j_y = np.asarray(j_R), np.asarray(j_y)
        close(Rc[b].T @ Rc[b], j_R.T @ j_R)
        close(Rc[b].T @ yc[b], j_R.T @ j_y)
        close(yc[b] @ yc[b], j_y @ j_y)


def test_apply_dx():
    rng = np.random.default_rng(7)
    jlay, lay = layouts()
    states = [jax_state(rng, jlay, 4) for _ in range(2)]
    dx = 1e-2 * rng.normal(size=(2, lay.dim))
    out = ekf.apply_dx(port_state(states, lay), t(dx))
    for b, s in enumerate(states):
        ref = j_ekf.apply_dx(s, dx[b])
        for name in ("imu", "clones_q", "clones_p", "slam_p", "plane_cp"):
            close(getattr(out, name)[b], getattr(ref, name))


# --------------------------------------------------------------------------- triangulation


def _scene(rng, B, F, K):
    """Clones looking along +z, features 2-6 m ahead; noisy normalized bearings."""
    R = np.asarray(jax.vmap(j_quat.exp_so3)(0.05 * rng.normal(size=(B * K, 3)))).reshape(B, K, 3, 3)
    p_C = np.cumsum(0.15 * rng.normal(size=(B, K, 3)), axis=1)
    pf = np.concatenate([rng.uniform(-1.5, 1.5, size=(B, F, 2)), rng.uniform(2, 6, size=(B, F, 1))], axis=-1)
    pc = np.einsum("bkij,bfkj->bfki", R, pf[:, :, None, :] - p_C[:, None])
    uvn = pc[..., :2] / pc[..., 2:3] + 1e-3 * rng.normal(size=(B, F, K, 2))
    mask = rng.uniform(size=(B, F, K)) < 0.8
    mask[:, 0] = False
    mask[:, 0, 0] = True  # one observation only: not triangulable
    return R, p_C, uvn, mask


@pytest.mark.parametrize("refine", [True, False], ids=["refined", "linear"])
def test_triangulation(refine):
    rng = np.random.default_rng(8)
    B, F, K = 2, 12, 5
    R, p_C, uvn, mask = _scene(rng, B, F, K)
    opts = triangulation.TriangulationOptions(refine=refine)
    p, ok = triangulation.triangulate(t(uvn), torch.as_tensor(mask), t(R), t(p_C), opts)
    j_opts = j_tri.TriangulationOptions(refine=refine)
    assert not ok[:, 0].any() and ok.sum() >= B * (F - 2)
    for b in range(B):
        j_p, j_ok = j_tri.triangulate(uvn[b], mask[b], R[b], p_C[b], j_opts)
        np.testing.assert_array_equal(ok[b].numpy(), np.asarray(j_ok))
        close(p[b], j_p, rtol=1e-10, atol=1e-9)


# --------------------------------------------------------------------------- jacobians


@pytest.mark.parametrize("do_fej", [True, False], ids=["fej", "no_fej"])
def test_feature_jacobian_full(do_fej):
    rng = np.random.default_rng(9)
    jlay, lay = layouts()
    K, D, M = jlay.max_clones, jlay.dim, 4
    states = [jax_state(rng, jlay, 5) for _ in range(2)]
    uv = rng.uniform(100, 600, size=(2, M, K, 2))
    mask = rng.uniform(size=(2, M, K)) < 0.7
    p_f = rng.normal(size=(2, M, 3)) + np.array([0.0, 0.0, 3.0])
    p_fej = p_f + 1e-3 * rng.normal(size=p_f.shape)
    opts = jac.JacobianOptions(cam_model=cams.RADTAN, do_fej=do_fej)
    clones = jac.clone_set_from_state(port_state(states, lay))
    H_x, H_f, res, rmask = jac.feature_jacobian_full(lay, opts, clones, t(uv), torch.as_tensor(mask),
                                                     t(p_f), t(p_fej), 1.0)
    assert H_x.shape == (2, M, 3 * K, D)
    j_opts = j_jac.JacobianOptions(cam_model=j_cams.RADTAN, do_fej=do_fej)
    zero3 = jnp.zeros(3)
    for b, s in enumerate(states):
        j_cl = j_jac.clone_set_from_state(s)
        for m in range(M):
            ref = j_jac.feature_jacobian_full(jlay, j_opts, j_cl, uv[b, m], mask[b, m], p_f[b, m], p_fej[b, m],
                                              zero3, zero3, False, False, 0, 1.0, 0.05)
            for a, r in zip((H_x, H_f, res), ref[:3]):
                close(a[b, m], r, rtol=1e-10, atol=1e-8)
            np.testing.assert_array_equal(rmask[b, m].numpy(), np.asarray(ref[3]))


# --------------------------------------------------------------------------- propagator


@pytest.mark.parametrize("rk4,fej", [(True, True), (False, False)], ids=["rk4_fej", "discrete_std"])
def test_propagate_and_clone_one_window(rk4, fej):
    rng = np.random.default_rng(10)
    jlay, lay = layouts()
    states = [jax_state(rng, jlay, n) for n in (3, K_CLONES - 1)]
    I, dt = 64, 1.0 / 400
    imu_t, imu_w, imu_a, t_new = [], [], [], []
    for b, s in enumerate(states):
        t0 = float(s.t)
        tt = t0 - 3.3 * dt + dt * np.arange(I)
        tt[44 + 5 * b:] = np.inf  # +inf padding past the window's end
        imu_t.append(tt)
        imu_w.append(0.3 * rng.normal(size=(I, 3)))
        imu_a.append(np.array([0.0, 0.0, 9.81]) + rng.normal(size=(I, 3)))
        t_new.append(t0 + 0.1 - 0.004 * b)
    noises = np.array([1.7e-4, 2e-3, 1.9e-5, 3e-3]) ** 2
    gravity = np.array([0.0, 0.0, 9.81])
    j_opts = j_prop.PropagatorOptions(use_rk4=rk4, do_fej=fej)
    out, slot = prop.propagate_and_clone(port_state(states, lay), t(np.stack(imu_t)), t(np.stack(imu_w)),
                                         t(np.stack(imu_a)), t(np.array(t_new)), t(noises), t(gravity),
                                         prop.PropagatorOptions(use_rk4=rk4, do_fej=fej))
    marg = prop.marginalize_oldest_clone(out, K_CLONES - 1)
    for b, s in enumerate(states):
        ref, j_slot = j_prop.propagate_and_clone(s, imu_t[b], imu_w[b], imu_a[b], t_new[b], noises, gravity, j_opts)
        assert int(slot[b]) == int(j_slot)
        for name in ("t", "imu", "imu_fej", "cov", "clones_q", "clones_p", "clones_q_fej", "clones_p_fej",
                     "clones_t"):
            close(getattr(out, name)[b], getattr(ref, name), rtol=1e-10, atol=1e-12)
        j_marg = j_prop.marginalize_oldest_clone(ref, K_CLONES - 1)
        close(marg.cov[b], j_marg.cov, rtol=1e-10, atol=1e-12)
        close(marg.clones_t[b], j_marg.clones_t)


# --------------------------------------------------------------------------- feature bank + triage


def _bank_arrays(bank):
    return {k: np.asarray(v) for k, v in dataclasses.asdict(bank).items()}


def test_feature_bank_ingest_free_and_clear():
    rng = np.random.default_rng(11)
    B, F, K, O = 2, 16, 4, 10
    j_banks = [j_fb.FeatureBank.create(F, K) for _ in range(B)]
    bank = fb.FeatureBank.create(F, K, B, device="cpu")
    for frame in range(8):
        slot = np.array([frame % K, (frame + 1) % K])
        ids = np.stack([rng.choice(30, size=O, replace=False) for _ in range(B)]).astype(np.int32)
        ids[:, -2:] = -1
        uv = rng.normal(size=(B, O, 2))
        uvn = rng.normal(size=(B, O, 2))
        plane = rng.integers(-1, 3, size=(B, O)).astype(np.int32)
        bank = fb.ingest(bank, torch.as_tensor(ids), t(uv), t(uvn), torch.as_tensor(plane),
                         torch.as_tensor(slot))
        j_banks = [j_fb.ingest(j_banks[b], ids[b], uv[b], uvn[b], plane[b], int(slot[b])) for b in range(B)]
        if frame == 5:
            rows = rng.uniform(size=(B, F)) < 0.3
            bank = fb.free_rows(bank, torch.as_tensor(rows))
            j_banks = [j_fb.free_rows(j_banks[b], rows[b]) for b in range(B)]
        if frame == 6:
            bank = fb.clear_clone_column(bank, torch.as_tensor(slot))
            j_banks = [j_fb.clear_clone_column(j_banks[b], int(slot[b])) for b in range(B)]
        for b in range(B):
            ref = _bank_arrays(j_banks[b])
            for name, v in bank.tensors().items():
                np.testing.assert_array_equal(v[b].numpy(), ref[name], err_msg=f"{name} frame {frame}")
    assert int(bank.active.sum()) > F  # the bank filled up and overflowed


def _tie_setup(seed):
    """A bank whose candidates far outnumber the 40-feature cut, with many
    equal track lengths: the selection then rests on the tie order alone."""
    rng = np.random.default_rng(seed)
    F = 96
    j_cfg, cfg = j_sim_config(), sim_config()
    for c in (j_cfg, cfg):
        c.state.max_slam_features = 0
        c.state.use_plane_constraint = False
        c.state.do_calib_camera_pose = False
        c.state.do_calib_camera_intrinsics = False
        c.state.do_calib_camera_timeoffset = False
        c.tpu.max_features = F
        c.tpu.max_planes = 1
    j_eng = j_manager.VioEngine.from_config(j_cfg)
    K = j_eng.layout.max_clones
    st = jax_state(rng, j_eng.layout, K - 1)
    cur = int(np.argmax(np.asarray(st.clones_t)))
    mask = np.zeros((F, K), bool)
    for f in range(F):
        n = rng.integers(2, 5)
        mask[f, rng.choice([k for k in range(K) if k != cur], size=n, replace=False)] = True
    mask[F // 2:, cur] = rng.uniform(size=F - F // 2) < 0.5
    fid = np.arange(F, dtype=np.int32)
    fid[rng.uniform(size=F) < 0.1] = -1
    mask[fid < 0] = False
    jb = j_fb.FeatureBank.create(F, K).replace(fid=jnp.asarray(fid), mask=jnp.asarray(mask))
    return j_eng, cfg, st, jb, cur


@pytest.mark.parametrize("seed", [12, 13])
def test_triage_breaks_ties_towards_the_lower_row(seed):
    j_eng, cfg, st, jb, cur = _tie_setup(seed)
    eng = manager.VioEngine.from_config(cfg, device="cpu")
    j_sel, j_valid, _, _ = j_manager.triage(j_eng, st, jb, cur, True)
    bank = convert.bank_from_arrays(convert.stack_streams([_bank_arrays(jb)]))
    sel, valid = manager.triage(eng, port_state([st], eng.layout), bank, torch.tensor([cur]))
    n_cand = int(np.sum(np.asarray(jb.fid >= 0) & (np.asarray(jb.mask).sum(1) >= 2)
                        & ~np.asarray(jb.mask)[:, cur]))
    assert n_cand > eng.max_msckf_in_update  # the cut is reached ...
    scores = np.asarray(jb.mask).sum(1)[np.asarray(j_sel)]
    assert len(set(scores[:40])) < 40  # ... inside a run of equal scores
    np.testing.assert_array_equal(sel[0].numpy(), np.asarray(j_sel))
    np.testing.assert_array_equal(valid[0].numpy(), np.asarray(j_valid))


# --------------------------------------------------------------------------- metrics


def test_rmse_nees():
    rng = np.random.default_rng(14)
    T = 25
    q_gt, p_gt = unit_quats(rng, T), rng.normal(size=(T, 3))
    q_est = np.asarray(jax.vmap(j_quat.quat_multiply)(
        jax.vmap(lambda w: j_quat.rot_2_quat(j_quat.exp_so3(w)))(0.01 * rng.normal(size=(T, 3))), q_gt))
    p_est = p_gt + 0.05 * rng.normal(size=(T, 3))
    c_th, c_p = rng.uniform(1e-5, 1e-3, size=(T, 3)), rng.uniform(1e-3, 1e-2, size=(T, 3))
    out = metrics.rmse_nees(t(q_est), t(p_est), t(c_th), t(c_p), t(q_gt), t(p_gt))
    ref = j_metrics.rmse_nees(q_est, p_est, c_th, c_p, q_gt, p_gt)
    for k in ref:
        close(out[k], ref[k])
