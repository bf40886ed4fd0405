"""Parity of the port's plane filter stages with the JAX package.

The same numpy inputs (seeded) go through each JAX function, one stream at a
time, and through its port counterpart with a leading stream dimension, on
the CPU in f64 (kernels in their plain versions). Module results agree to
1e-10 unless a test says otherwise. The slice test replays two noisy draws
of the small plane scene of ``tests/test_e2e_planes.py`` through the JAX
``run_sequence`` and the port's B=2 ``run_sequence``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ov_plane_tpu.models import jacobians as j_jac
from ov_plane_tpu.models import plane_init as j_pinit
from ov_plane_tpu.models import plane_msckf as j_pmsckf
from ov_plane_tpu.models.feature_bank import FeatureBank as JBank
from ov_plane_tpu.models.manager import FrameData as JFrame
from ov_plane_tpu.models.manager import VioEngine as JEngine
from ov_plane_tpu.models.manager import init_state_with_gt as j_init
from ov_plane_tpu.models.manager import run_sequence as j_run
from ov_plane_tpu.models.manager import step as j_step
from ov_plane_tpu.ops import ekf as j_ekf
from ov_plane_tpu.ops import planefit as j_pf
from ov_plane_tpu.sim.simulator import NoiseParams as JNoise
from ov_plane_tpu.sim.simulator import apply_noise as j_apply_noise
from ov_plane_tpu.sim.simulator import build_sim
from ov_plane_tpu.state import layout as j_layout
from ov_plane_tpu.state import vio_state as j_vs
from ov_plane_tpu.utils.config import sim_config as j_sim_config
from ov_plane_tpu_torch import convert
from ov_plane_tpu_torch.models import jacobians as jac
from ov_plane_tpu_torch.models import plane_init, plane_msckf
from ov_plane_tpu_torch.models.feature_bank import FeatureBank
from ov_plane_tpu_torch.models.manager import FrameData, VioEngine, init_state_with_gt, run_sequence, step
from ov_plane_tpu_torch.ops import ekf, planefit
from ov_plane_tpu_torch.state.layout import StateLayout
from ov_plane_tpu_torch.utils.config import sim_config

TOL = dict(rtol=1e-10, atol=1e-10)
ZETA = np.array([300.0, 300.0, 320.0, 240.0, 0, 0, 0, 0])
N_FRAMES = 50
SEEDS = (1, 2)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def t(a, dtype=torch.float64):
    a = np.array(a)
    return torch.as_tensor(a) if a.dtype == np.bool_ or np.issubdtype(a.dtype, np.integer) else \
        torch.as_tensor(a, dtype=dtype)


def close(port, ref, **tol):
    np.testing.assert_allclose(port.detach().numpy(), np.asarray(ref), **(tol or TOL))


def layouts(K=6, L=0, P=3):
    kw = dict(max_clones=K, max_slam=L, max_planes=P, calib_dt=False, calib_pose=False, calib_intr=False)
    return j_layout.StateLayout(**kw), StateLayout(**kw)


def arrays(tree):
    return {f.name: np.asarray(getattr(tree, f.name)) for f in dataclasses.fields(tree) if f.name != "layout"}


def port_state(jstates, lay):
    return convert.state_from_arrays(convert.stack_streams([arrays(s) for s in jstates]), lay, device="cpu")


def port_bank(jbanks):
    return convert.bank_from_arrays(convert.stack_streams([arrays(b) for b in jbanks]), device="cpu")


def close_tree(port_tree, jtrees, **tol):
    for k, v in port_tree.tensors().items():
        ref = np.stack([np.asarray(getattr(j, k)) for j in jtrees])
        if v.dtype.is_floating_point:
            close(v, ref, **tol)
        else:
            np.testing.assert_array_equal(v.numpy(), ref, err_msg=k)


# --------------------------------------------------------------------------- planefit


def _plane_scene(rng, n_feat, cp=(0.0, 0.0, 2.0), n_out=0, clones_p=None, K=6, n_clones=5, px=0.3):
    """Clones translating in x/y looking along +z (drawn unless given),
    features on the plane of ``cp`` (the last n_out pushed 0.2 m off it),
    observed with px noise. Returns (clones_p [K, 3], p_true [N, 3],
    uv, uvn [N, K, 2], mask [N, K])."""
    cp = np.asarray(cp, float)
    n, d = cp / np.linalg.norm(cp), np.linalg.norm(cp)
    if clones_p is None:
        clones_p = np.zeros((K, 3))
        clones_p[:n_clones, 0:2] = rng.uniform(-0.1, 1.0, size=(n_clones, 2))
    a = np.cross(n, [1.0, 0.3, 0.1])
    a /= np.linalg.norm(a)
    b = np.cross(n, a)
    p = d * n + rng.uniform(-0.8, 0.8, size=(n_feat, 1)) * a + rng.uniform(-0.8, 0.8, size=(n_feat, 1)) * b
    p[n_feat - n_out:] += 0.2 * n
    uvn = np.zeros((n_feat, K, 2))
    mask = np.zeros((n_feat, K), bool)
    for k in range(n_clones):
        r = p - clones_p[k]
        uvn[:, k] = r[:, 0:2] / r[:, 2:3] + rng.normal(0, px / 300.0, size=(n_feat, 2))
        mask[:, k] = True
    uv = uvn * ZETA[0:2] + ZETA[2:4]
    return clones_p, p, uv, uvn, mask


def test_fit_plane_lsq():
    rng = np.random.default_rng(3)
    pts = rng.normal(size=(6, 16, 3))
    pts[:, :, 2] = 2.0 + 0.05 * pts[:, :, 0] + 0.01 * rng.normal(size=(6, 16))
    mask = rng.uniform(size=(6, 16)) < 0.8
    mask[5, 2:] = False                                      # two points: not ok
    cp, cond, ok = planefit.fit_plane_lsq(t(pts), t(mask))
    jcp, jcond, jok = jax.vmap(j_pf.fit_plane_lsq)(pts, mask)
    close(cp, jcp)
    close(cond, jcond, rtol=1e-8, atol=0)
    np.testing.assert_array_equal(ok.numpy(), np.asarray(jok))
    assert not ok[5]


@pytest.mark.parametrize("case", ["converging", "outliers_reaccepted", "group_fails"])
def test_refine_plane_joint(case):
    rng = np.random.default_rng({"converging": 4, "outliers_reaccepted": 5, "group_fails": 6}[case])
    n_out = {"converging": 0, "outliers_reaccepted": 2, "group_fails": 7}[case]
    opts = j_pf.PlaneRefineOptions(focal=300.0)
    popts = planefit.PlaneRefineOptions(focal=300.0)
    ins, outs = [], []
    for _ in range(2):
        clones_p, p_true, _, uvn, mask = _plane_scene(rng, 14, n_out=n_out)
        feats0 = p_true + 0.01 * rng.normal(size=p_true.shape)
        valid = np.ones(14, bool)
        valid[13] = False
        R = np.broadcast_to(np.eye(3), (6, 3, 3)).copy()
        cp0 = np.array([0.01, -0.02, 1.97])
        ins.append((cp0, feats0, uvn, mask, valid, np.zeros(14, bool), R, clones_p))
        outs.append(j_pf.refine_plane_joint(*ins[-1], opts))
    cp, feats, ok, inl = planefit.refine_plane_joint(*(t(np.stack(x)) for x in zip(*ins)), popts)
    close(cp, np.stack([o[0] for o in outs]))
    close(feats, np.stack([o[1] for o in outs]))
    np.testing.assert_array_equal(ok.numpy(), [bool(o[2]) for o in outs])
    np.testing.assert_array_equal(inl.numpy(), np.stack([np.asarray(o[3]) for o in outs]))
    if case == "converging":
        assert ok.all() and inl[:, :13].all()
    elif case == "outliers_reaccepted":
        assert ok.all() and inl[:, :12].all() and not inl[:, 12:].any()
    else:
        assert not ok.any()


# --------------------------------------------------------------------------- ekf


@pytest.mark.parametrize("rank", ["full", "deficient"])
def test_info_compress_rows(rank):
    rng = np.random.default_rng(7)
    rows, C = (40, 12) if rank == "full" else (7, 12)
    M = rng.normal(size=(3, rows, C)) * np.logspace(-3, 2, C)
    M[:, :, 4] = 0.0                                          # an all-zero (masked) column
    R = ekf.info_compress_rows(t(M))
    jR = np.asarray(jax.vmap(j_ekf.info_compress_rows)(M))
    G = np.einsum("bri,brj->bij", M, M)
    if rank == "full":
        close(R, jR, rtol=1e-9, atol=1e-9)
        close(R.transpose(-1, -2) @ R, G, rtol=1e-9, atol=1e-9)
    else:
        # The jittered factor of a rank-deficient stack is ill-conditioned
        # entry by entry; RᵀR is what the update sees, equal to G up to the
        # jitter on both sides.
        assert torch.isfinite(R).all()
        scale = np.abs(G).max()
        close(R.transpose(-1, -2) @ R, np.einsum("bri,brj->bij", jR, jR), rtol=0, atol=1e-10 * scale)
        close(R.transpose(-1, -2) @ R, G, rtol=0, atol=1e-9 * scale)


def test_info_compress_rows_f32_rank_deficient():
    """A rank-deficient stack in f32 (as every plane stack is) still gets
    finite rows: the factor is formed in f64 and cast back."""
    rng = np.random.default_rng(17)
    A = rng.normal(size=(2, 60, 8)) * np.logspace(-2, 2, 8)
    M = np.concatenate([A, A[..., :3] @ rng.normal(size=(3, 4))], axis=-1)   # 4 dependent columns
    R32 = ekf.info_compress_rows(t(M, torch.float32))
    assert R32.dtype == torch.float32 and torch.isfinite(R32).all()
    M32 = t(M, torch.float32)
    close(R32.double(), ekf.info_compress_rows(M32.double()).float().double(), rtol=0, atol=0)


def test_qr_init_split_and_initialize_invertible():
    rng = np.random.default_rng(8)
    jlay, lay = layouts()
    D = lay.dim
    HL, HR, res = rng.normal(size=(2, 20, 3)), rng.normal(size=(2, 20, D)), rng.normal(size=(2, 20))
    port = ekf.qr_init_split(t(HL), t(HR), t(res))
    for a, b in zip(port, jax.vmap(j_ekf.qr_init_split)(HL, HR, res)):
        close(a, b)

    states = []
    for _ in range(2):
        A = rng.normal(size=(D, D))
        cov = 1e-3 * A @ A.T / D + 1e-4 * np.eye(D)
        cov[lay.plane_base:, :] = 0.0
        cov[:, lay.plane_base:] = 0.0
        states.append(j_vs.VioState.create(jlay).replace(cov=jnp.asarray(cov)))
    slots = np.array([lay.plane_base + 3, lay.plane_base + 6])
    HL_i, HR_i, res_i = port[0], port[1], port[2]
    cov, dx = ekf.initialize_invertible(port_state(states, lay), t(slots), HR_i, HL_i,
                                        torch.full((3,), 5.0, dtype=torch.float64), res_i)
    for b in range(2):
        jc, jdx = j_ekf.initialize_invertible(states[b], int(slots[b]), np.asarray(HR_i[b]), np.asarray(HL_i[b]),
                                              jnp.full((3,), 5.0), np.asarray(res_i[b]))
        close(cov[b], jc)
        close(dx[b], jdx)


# --------------------------------------------------------------------------- jacobians


def _clone_state(rng, jlay, clones_p, cov_scale=1e-4):
    """A JAX state with five live clones at clones_p (identity orientation)."""
    K = jlay.max_clones
    clones_t = np.full(K, -np.inf)
    clones_t[:5] = np.arange(5.0)
    q = np.tile([0.0, 0.0, 0.0, 1.0], (K, 1))
    return j_vs.VioState.create(jlay).replace(
        clones_p=jnp.asarray(clones_p), clones_p_fej=jnp.asarray(clones_p + 1e-3 * rng.normal(size=clones_p.shape)),
        clones_q=jnp.asarray(q), clones_q_fej=jnp.asarray(q), clones_t=jnp.asarray(clones_t),
        cam_zeta=jnp.asarray(ZETA), cov=jnp.asarray(np.eye(jlay.dim) * cov_scale), t=jnp.asarray(4.0),
    )


@pytest.mark.parametrize("in_state", [True, False], ids=["in_state", "out_of_state"])
def test_plane_rows_of_feature_jacobian(in_state):
    rng = np.random.default_rng(9)
    jlay, lay = layouts()
    clones_p, p, uv, _, mask = _plane_scene(rng, 8)
    jst = _clone_state(rng, jlay, clones_p)
    cp = np.array([0.01, 0.02, 1.98])
    cp_fej = cp + 1e-3 * rng.normal(size=3)
    has = np.arange(8) % 4 != 3
    slot = np.arange(8) % 3
    pf_fej = p + 1e-3 * rng.normal(size=p.shape)
    clones = j_jac.clone_set_from_state(jst)
    ref = jax.vmap(lambda u, m, pf, pfj, h, s: j_jac.feature_jacobian_full(
        jlay, j_jac.JacobianOptions(), clones, u, m, pf, pfj, cp, cp_fej, h, jnp.asarray(in_state), s, 1.0, 0.05))(
        uv, mask, p, pf_fej, has, slot)
    st = port_state([jst], lay)
    ones = torch.ones(1, 8, dtype=torch.bool)
    out = jac.feature_jacobian_full(
        lay, jac.JacobianOptions(), jac.clone_set_from_state(st), t(uv)[None], t(mask)[None], t(p)[None],
        t(pf_fej)[None], 1.0, cp=t(cp).expand(1, 8, 3), cp_fej=t(cp_fej).expand(1, 8, 3), has_plane=t(has)[None],
        plane_in_state=ones & in_state, plane_slot=t(slot)[None], sigma_c=0.05)
    for a, b in zip(out[:3], ref[:3]):
        close(a[0], b)
    np.testing.assert_array_equal(out[3][0].numpy(), np.asarray(ref[3]))
    K = lay.max_clones
    assert out[3][0, :, 2 * K:].any() and (out[2][0, :, 2 * K:] != 0).any()


# --------------------------------------------------------------------------- plane_init


def _merge_state(jlay):
    st = j_vs.VioState.create(jlay)
    cps = jnp.asarray([[0.0, 0.0, 2.0], [0.0, 0.01, 2.01], [1.0, 0.0, 0.0]])
    return st.replace(cov=jnp.asarray(np.eye(jlay.dim) * 1e-2), plane_cp=cps, plane_cp_fej=cps,
                      plane_id=jnp.asarray([5, 9, 7], jnp.int32), plane_active=jnp.asarray([True, True, True]))


def test_merge_planes():
    """The cases of tests/test_plane_merge.py, one per stream: both in the
    state, rename only, and the angle gate rejecting."""
    kw = dict(max_clones=3, max_slam=2, max_planes=3, calib_dt=False, calib_pose=False, calib_intr=False)
    jlay, lay = j_layout.StateLayout(**kw), StateLayout(**kw)
    pairs = [([9, -1], [5, -1]), ([7, -1], [42, -1]), ([7, -1], [5, -1])]
    jst = _merge_state(jlay)
    refs = [j_pinit.merge_planes(jst, jnp.asarray(f, jnp.int32), jnp.asarray(i, jnp.int32), 0.1, 1.0, 5.0)
            for f, i in pairs]
    st, n = plane_init.merge_planes(port_state([jst] * 3, lay), t([p[0] for p in pairs]),
                                    t([p[1] for p in pairs]), 0.1, 1.0, 5.0)
    close_tree(st, [r[0] for r in refs])
    np.testing.assert_array_equal(n.numpy(), [int(r[1]) for r in refs])
    assert n.tolist() == [1, 0, 0] and st.plane_id[1, 2] == 42 and not st.plane_active[2, 2]


def test_step_applies_frontend_merges():
    """tests/test_plane_merge.py::test_step_applies_frontend_merges through
    both steps: the merge pair collapses two in-state planes and relabels the
    bank features of the merged-away id."""
    def configure(cfg):
        cfg.state.max_slam_features = 0
        cfg.state.do_calib_camera_pose = False
        cfg.state.do_calib_camera_intrinsics = False
        cfg.state.do_calib_camera_timeoffset = False
        cfg.tpu.max_features = 32
        cfg.tpu.max_obs_per_frame = 16
        cfg.tpu.max_msckf_update = 8
        cfg.tpu.max_imu_per_frame = 16
        return cfg

    cfg = configure(j_sim_config())
    eng = JEngine.from_config(cfg)
    st = j_init(eng, cfg, t0=0.0, q0=jnp.asarray([0.0, 0.0, 0.0, 1.0]), p0=jnp.zeros(3), v0=jnp.zeros(3),
                bg0=jnp.zeros(3), ba0=jnp.zeros(3))
    cps = jnp.zeros((eng.layout.max_planes, 3)).at[0].set(jnp.asarray([0.0, 0.0, 2.0])).at[1].set(
        jnp.asarray([0.0, 0.01, 2.01]))
    st = st.replace(cov=st.cov + 1e-2 * jnp.eye(st.cov.shape[0]), plane_cp=cps, plane_cp_fej=cps,
                    plane_id=st.plane_id.at[0].set(5).at[1].set(9),
                    plane_active=st.plane_active.at[0].set(True).at[1].set(True))
    K = eng.layout.max_clones
    bank = JBank.create(cfg.tpu.max_features, K)
    bank = bank.replace(fid=bank.fid.at[0].set(100).at[1].set(101), planeid=bank.planeid.at[0].set(9).at[1].set(5),
                        mask=bank.mask.at[0, K - 1].set(True).at[1, K - 1].set(True))
    n = cfg.tpu.max_imu_per_frame
    ts = np.linspace(0.0, 0.1, n)
    acc = np.tile([0, 0, cfg.gravity_mag], (n, 1))
    merge = (np.array([9, -1, -1, -1], np.int32), np.array([5, -1, -1, -1], np.int32))
    jframe = JFrame(imu_t=jnp.asarray(ts), imu_w=jnp.zeros((n, 3)), imu_a=jnp.asarray(acc), t_new=jnp.asarray(0.1),
                    obs_id=jnp.full(16, -1, jnp.int32), obs_uv=jnp.zeros((16, 2)), obs_plane=jnp.full(16, -1, jnp.int32),
                    merge_from=jnp.asarray(merge[0]), merge_into=jnp.asarray(merge[1]))
    jst, jbk, jout = j_step(eng, st, bank, jframe)

    peng = VioEngine.from_config(configure(sim_config()), device="cpu")
    frame = FrameData(imu_t=t(ts)[None], imu_w=torch.zeros(1, n, 3, dtype=torch.float64), imu_a=t(acc)[None],
                      t_new=t([0.1]), obs_id=torch.full((1, 16), -1, dtype=torch.int32),
                      obs_uv=torch.zeros(1, 16, 2, dtype=torch.float64),
                      obs_plane=torch.full((1, 16), -1, dtype=torch.int32),
                      merge_from=t(merge[0])[None], merge_into=t(merge[1])[None])
    pst, pbk, pout = step(peng, port_state([st], peng.layout), port_bank([bank]), frame)
    close_tree(pst, [jst])
    close_tree(pbk, [jbk])
    for name in ("n_planes", "n_plane_init", "n_plane_constraints", "n_plane_merges", "n_plane_dropped"):
        assert int(getattr(pout, name)[0]) == int(getattr(jout, name)), name
    assert int(pout.n_plane_merges[0]) == 1 and pbk.planeid[0, :2].tolist() == [5, 5]


def _plane_bank(jlay, rng, groups):
    """A JAX state and bank of feature groups on planes: groups is a list of
    (plane id, n features, cp)."""
    K = jlay.max_clones
    clones_p, *_ = _plane_scene(rng, 1)
    jst = _clone_state(rng, jlay, clones_p)
    F = 48
    uv, uvn = np.zeros((F, K, 2)), np.zeros((F, K, 2))
    mask, pids, fid = np.zeros((F, K), bool), np.full(F, -1, np.int32), np.full(F, -1, np.int32)
    row = 0
    for pid, n, cp in groups:
        _, _, u, un, m = _plane_scene(rng, n, cp=cp, clones_p=clones_p)
        uv[row:row + n], uvn[row:row + n], mask[row:row + n] = u, un, m
        pids[row:row + n] = pid
        fid[row:row + n] = np.arange(row, row + n)
        row += n
    bank = JBank.create(F, K).replace(fid=jnp.asarray(fid), uv=jnp.asarray(uv), uvn=jnp.asarray(uvn),
                                      mask=jnp.asarray(mask), planeid=jnp.asarray(pids))
    return jst, bank, row


def test_marginalize_unseen_planes():
    rng = np.random.default_rng(10)
    jlay, lay = layouts()
    jst, bank, _ = _plane_bank(jlay, rng, [(7, 6, (0, 0, 2.0)), (8, 6, (0.0, 0.3, 2.5))])
    jst = jst.replace(plane_id=jnp.asarray([7, 3, 8], jnp.int32), plane_active=jnp.asarray([True, True, False]),
                      cov=jnp.asarray(np.eye(jlay.dim) * 1e-3 + 1e-4))
    refs = [j_pinit.marginalize_unseen_planes(jst, bank, s) for s in (2, 5)]
    st, n = plane_init.marginalize_unseen_planes(port_state([jst] * 2, lay), port_bank([bank] * 2), t([2, 5]))
    close_tree(st, [r[0] for r in refs])
    np.testing.assert_array_equal(n.numpy(), [int(r[1]) for r in refs])
    assert n.tolist() == [1, 2]


@pytest.mark.parametrize("info", [True, False], ids=["info_form", "qr"])
def test_plane_delayed_init(info):
    jlay, lay = layouts()
    jsts, banks = [], []
    for seed in (11, 12):
        rng = np.random.default_rng(seed)
        jst, bank, _ = _plane_bank(jlay, rng, [(7, 14, (0, 0, 2.0)), (8, 12, (0.0, 0.4, 2.6)), (9, 6, (0, 0, 3.0))])
        jsts.append(jst)
        banks.append(bank)
    jopts = j_pinit.PlaneInitOptions(refine=j_pf.PlaneRefineOptions(focal=300.0), use_info_compression=info)
    popts = plane_init.PlaneInitOptions(refine=planefit.PlaneRefineOptions(focal=300.0), use_info_compression=info)
    refs = [j_pinit.plane_delayed_init(s, b, jopts, 4) for s, b in zip(jsts, banks)]
    st, bk, n = plane_init.plane_delayed_init(port_state(jsts, lay), port_bank(banks), popts, t([4, 4]))
    close_tree(st, [r[0] for r in refs], rtol=1e-9, atol=1e-10)
    close_tree(bk, [r[1] for r in refs])
    np.testing.assert_array_equal(n.numpy(), [int(r[2]) for r in refs])
    assert n.sum() >= 2


# --------------------------------------------------------------------------- plane_msckf


@pytest.mark.parametrize("info,cap,adaptive", [(True, 8, False), (False, 8, False), (True, 1, False), (True, 8, True)],
                         ids=["info_form", "qr", "cap_overflow", "adaptive_sigma_c"])
def test_msckf_plane_update(info, cap, adaptive):
    jlay, lay = layouts()
    jsts, banks, sels = [], [], []
    for seed in (13, 14):
        rng = np.random.default_rng(seed)
        jst, bank, total = _plane_bank(jlay, rng, [(100, 6, (0, 0, 1.5)), (101, 5, (0.0, 0.15, 2.2)),
                                                    (102, 5, (0.2, 0.0, 2.9))])
        jsts.append(jst)
        banks.append(bank)
        sels.append((np.arange(20, dtype=np.int32), np.arange(20) < total))
    jopts = j_pmsckf.PlaneMsckfOptions(base=j_pinit.PlaneInitOptions(
        max_msckf_plane=8, refine=j_pf.PlaneRefineOptions(focal=300.0), use_info_compression=info,
        sigma_c_adaptive=adaptive), max_planes_per_frame=cap)
    popts = plane_msckf.PlaneMsckfOptions(base=plane_init.PlaneInitOptions(
        max_msckf_plane=8, refine=planefit.PlaneRefineOptions(focal=300.0), use_info_compression=info,
        sigma_c_adaptive=adaptive), max_planes_per_frame=cap)
    refs = [j_pmsckf.msckf_plane_update(s, b, jopts, jnp.asarray(i), jnp.asarray(v))
            for s, b, (i, v) in zip(jsts, banks, sels)]
    st, consumed, n_up, n_drop = plane_msckf.msckf_plane_update(
        port_state(jsts, lay), port_bank(banks), popts, t(np.stack([s[0] for s in sels])).long(),
        t(np.stack([s[1] for s in sels])))
    close_tree(st, [r[0] for r in refs])
    np.testing.assert_array_equal(consumed.numpy(), np.stack([np.asarray(r[1]) for r in refs]))
    np.testing.assert_array_equal(n_up.numpy(), [int(r[2]) for r in refs])
    np.testing.assert_array_equal(n_drop.numpy(), [int(r[3]) for r in refs])
    assert n_up.tolist() == ([3, 3] if cap == 8 else [1, 1])
    assert n_drop.tolist() == ([0, 0] if cap == 8 else [2, 2])


# --------------------------------------------------------------------------- the slice


def _configure(cfg):
    """tests/test_e2e_planes.py's plane configuration, with the information form."""
    cfg.state.max_slam_features = 0
    cfg.state.do_calib_camera_pose = False
    cfg.state.do_calib_camera_intrinsics = False
    cfg.state.do_calib_camera_timeoffset = False
    cfg.state.use_plane_constraint = True
    cfg.state.use_plane_slam_feats = True
    cfg.tpu.max_features = 144
    cfg.tpu.max_obs_per_frame = 96
    cfg.tpu.max_msckf_update = 40
    cfg.tpu.use_info_compression = True
    return cfg


@pytest.fixture(scope="module")
def streams():
    cfg = _configure(j_sim_config())
    cfg.sim.traj_duration = 10.0
    cfg.num_pts = 20
    cfg.num_pts_plane = 35
    sim = build_sim(cfg, max_obs=cfg.tpu.max_obs_per_frame)
    noise = JNoise(sigma_w=cfg.imu_noises.sigma_w, sigma_a=cfg.imu_noises.sigma_a,
                   sigma_wb=cfg.imu_noises.sigma_wb, sigma_ab=cfg.imu_noises.sigma_ab,
                   sigma_pix=cfg.msckf_options.sigma_pix, dt_imu=1.0 / cfg.sim.freq_imu)
    cam_fields = ("cam_t", "cam_t_imu", "obs_id", "obs_uv", "obs_uv_true", "obs_plane", "obs_gt_p",
                  "obs_gt_cp", "imu_window_start", "gt_q", "gt_p", "gt_v", "gt_bg_cam", "gt_ba_cam")
    out = []
    for seed in SEEDS:
        s = j_apply_noise(sim, jax.random.PRNGKey(seed), noise)
        out.append(s._replace(**{k: getattr(s, k)[:N_FRAMES + 1] for k in cam_fields}))
    return out


def test_plane_slice_matches_jax_run_sequence(streams):
    cfg = _configure(j_sim_config())
    eng = JEngine.from_config(cfg)
    ref = []
    for sim in streams:
        st = j_init(eng, cfg, t0=sim.cam_t_imu[0], q0=sim.gt_q[0], p0=sim.gt_p[0], v0=sim.gt_v[0],
                    bg0=sim.gt_bg_cam[0], ba0=sim.gt_ba_cam[0])
        ref.append(j_run(eng, st, JBank.create(cfg.tpu.max_features, eng.layout.max_clones), sim,
                         imu_window=cfg.tpu.max_imu_per_frame))

    pcfg = _configure(sim_config())
    peng = VioEngine.from_config(pcfg, device="cpu")
    sim = convert.sim_from_streams([{k: np.asarray(v) for k, v in s._asdict().items()} for s in streams], device="cpu")
    state = init_state_with_gt(peng, pcfg, t0=sim.cam_t_imu[0].expand(2), q0=sim.gt_q[0].expand(2, 4),
                               p0=sim.gt_p[0].expand(2, 3), v0=sim.gt_v[0].expand(2, 3),
                               bg0=sim.gt_bg_cam[:, 0], ba0=sim.gt_ba_cam[:, 0], device="cpu")
    bank = FeatureBank.create(pcfg.tpu.max_features, peng.layout.max_clones, batch=2, device="cpu")
    state, _, outs = run_sequence(peng, state, bank, sim, imu_window=pcfg.tpu.max_imu_per_frame)
    assert outs.p.shape == (2, N_FRAMES, 3)

    for b, (jst, _, r) in enumerate(ref):
        for name in ("n_msckf_used", "n_bank", "n_clones", "n_planes", "n_plane_init", "n_plane_constraints",
                     "n_plane_merges", "n_plane_dropped"):
            np.testing.assert_array_equal(getattr(outs, name)[b].numpy(), np.asarray(getattr(r, name)),
                                          err_msg=name)
        np.testing.assert_allclose(outs.p[b].numpy(), np.asarray(r.p), rtol=0, atol=1e-6)
        np.testing.assert_allclose(outs.v[b].numpy(), np.asarray(r.v), rtol=0, atol=1e-6)
        np.testing.assert_allclose(outs.q[b].numpy(), np.asarray(r.q), rtol=0, atol=1e-7)
        np.testing.assert_allclose(outs.cov_diag_imu[b].numpy(), np.asarray(r.cov_diag_imu), rtol=1e-6, atol=0)
        np.testing.assert_array_equal(state.plane_id[b].numpy(), np.asarray(jst.plane_id))
        np.testing.assert_array_equal(state.plane_active[b].numpy(), np.asarray(jst.plane_active))
        np.testing.assert_allclose(state.plane_cp[b].numpy(), np.asarray(jst.plane_cp), rtol=0, atol=1e-6)
    # The window covers real plane work: in-state planes and constraint updates.
    assert int(outs.n_planes.max()) > 0
    assert int(outs.n_plane_constraints.sum()) > 50
