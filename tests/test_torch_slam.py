"""Parity of the port's SLAM landmarks with the JAX package.

The same seeded numpy inputs go through each JAX function (one stream at a
time, vmapped over points or features) and through its port counterpart
(leading stream dimension), on the CPU in f64, kernels in their plain
versions. Tolerances: representations and their Jacobians 1e-10 (the port's
closed forms against JAX's ``jacfwd``), the Jacobian stacks and the SLAM
stages 1e-9, the refine 1e-8 (ten damped steps whose sums run in another
order: 2.2e-9 m seen), unless a test says otherwise. The window test
replays frames 16-30 of two noisy draws of the committed M-PL scene under
the MS-PL configuration (the first SLAM inits fall at frame 20) from the JAX
state after frame 15.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ov_plane_tpu.models import jacobians as j_jac
from ov_plane_tpu.models import msckf as j_msckf
from ov_plane_tpu.models import slam as j_slam
from ov_plane_tpu.models.feature_bank import FeatureBank as JBank
from ov_plane_tpu.models.manager import VioEngine as JEngine
from ov_plane_tpu.models.manager import init_state_with_gt as j_init
from ov_plane_tpu.models.manager import run_sequence as j_run
from ov_plane_tpu.ops import planefit as j_pf
from ov_plane_tpu.ops import representations as j_reps
from ov_plane_tpu.ops.quat import quat_2_rot as j_quat_2_rot
from ov_plane_tpu.ops.quat import rot_2_quat as j_rot_2_quat
from ov_plane_tpu.sim.simulator import SimData as JSim
from ov_plane_tpu.state import layout as j_layout
from ov_plane_tpu.state import vio_state as j_vs
from ov_plane_tpu.utils.config import sim_config as j_sim_config
from ov_plane_tpu_torch import convert
from ov_plane_tpu_torch.models import jacobians as jac
from ov_plane_tpu_torch.models import msckf, slam
from ov_plane_tpu_torch.models.manager import VioEngine, run_sequence
from ov_plane_tpu_torch.ops import planefit
from ov_plane_tpu_torch.ops import representations as reps
from ov_plane_tpu_torch.sim import simulator
from ov_plane_tpu_torch.state.layout import StateLayout
from ov_plane_tpu_torch.utils.config import ms_pl_config

ZETA = np.array([300.0, 300.0, 320.0, 240.0, 0, 0, 0, 0])
ALL_REPS = list(range(6))
REPS_3DOF = [r for r in ALL_REPS if r != reps.ANCHORED_INVERSE_DEPTH_SINGLE]
ANCHORED_3DOF = [r for r in REPS_3DOF if reps.is_anchored(r)]
NAMES = {v: k for k, v in reps._NAMES.items()}
K, L, P = 6, 5, 2


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def t(a):
    a = np.array(a)
    return torch.as_tensor(a) if a.dtype == np.bool_ or np.issubdtype(a.dtype, np.integer) else \
        torch.as_tensor(a, dtype=torch.float64)


def close(port, ref, tol=1e-9):
    np.testing.assert_allclose(port.detach().numpy(), np.asarray(ref), rtol=tol, atol=tol)


def arrays(tree):
    return {f.name: np.asarray(getattr(tree, f.name)) for f in dataclasses.fields(tree) if f.name != "layout"}


def close_tree(port_tree, jtrees, tol=1e-9):
    for k, v in port_tree.tensors().items():
        ref = np.stack([np.asarray(getattr(j, k)) for j in jtrees])
        if v.dtype.is_floating_point:
            np.testing.assert_allclose(v.numpy(), ref, rtol=tol, atol=tol, err_msg=k)
        else:
            np.testing.assert_array_equal(v.numpy(), ref, err_msg=k)


def rot(rng, scale=1.0):
    """A random rotation matrix (JAX quat_2_rot of a random unit quaternion
    ``scale`` away from identity)."""
    q = np.array([0.0, 0.0, 0.0, 1.0]) + scale * rng.normal(size=4)
    return np.asarray(j_quat_2_rot(jnp.asarray(q / np.linalg.norm(q))))


def anchors(rng, n):
    """n random anchor frames: (numpy fields [n, ...], JAX frames, port frame [n])."""
    f = dict(R_GtoI=np.stack([rot(rng) for _ in range(n)]), p_IinG=rng.normal(size=(n, 3)),
             R_ItoC=np.stack([rot(rng) for _ in range(n)]), p_IinC=0.1 * rng.normal(size=(n, 3)))
    jf = [j_reps.AnchorFrame(**{k: jnp.asarray(v[i]) for k, v in f.items()}) for i in range(n)]
    return jf, reps.AnchorFrame(**{k: t(v) for k, v in f.items()})


def points_in_front(rng, jframes):
    """A global point 1-4 m in front of each anchor camera."""
    p_A = np.concatenate([rng.uniform(-1, 1, size=(len(jframes), 2)), rng.uniform(1, 4, size=(len(jframes), 1))], 1)
    return np.stack([np.asarray(a.point_to_global(jnp.asarray(p))) for a, p in zip(jframes, p_A)])


# --------------------------------------------------------------------------- representations


@pytest.mark.parametrize("rep", ALL_REPS, ids=lambda r: NAMES[r])
def test_representation_round_trip(rep):
    rng = np.random.default_rng(20 + rep)
    jf, pf = anchors(rng, 8)
    p_G = points_in_front(rng, jf)
    anchored = j_reps.is_anchored(rep)
    assert reps.is_anchored(rep) == anchored and reps.dof(rep) == j_reps.dof(rep)
    assert reps.from_name(NAMES[rep].lower()) == rep
    j_par = np.stack([np.asarray(j_reps.global_to_rep(rep, jnp.asarray(p), a if anchored else None))
                      for p, a in zip(p_G, jf)])
    par = reps.global_to_rep(rep, t(p_G), pf if anchored else None)
    close(par, j_par, 1e-12)
    p_base = pf.point_to_anchor(t(p_G)) if anchored else t(p_G)
    close(reps.params_from_point(rep, p_base), j_par, 1e-12)
    bearing = reps.single_depth_bearing(p_base) if rep == reps.ANCHORED_INVERSE_DEPTH_SINGLE else None
    j_back = np.stack([np.asarray(j_reps.rep_to_global(rep, jnp.asarray(x), a if anchored else None,
                                                       None if bearing is None else jnp.asarray(b.numpy())))
                       for x, a, b in zip(j_par, jf, bearing if bearing is not None else [None] * 8)])
    back = reps.rep_to_global(rep, par, pf if anchored else None, bearing)
    close(back, j_back, 1e-12)
    close(back, p_G, 1e-10)
    close(reps.point_from_params(rep, par, bearing), p_base.numpy(), 1e-10)


@pytest.mark.parametrize("fej", [True, False], ids=["fej", "no_fej"])
@pytest.mark.parametrize("rep", ALL_REPS, ids=lambda r: NAMES[r])
def test_rep_jacobians_match_jacfwd(rep, fej):
    rng = np.random.default_rng(40 + rep)
    jf, pf = anchors(rng, 6)
    # FEJ anchors near the current ones, so points stay in front of both.
    jf_fej = [a._replace(R_GtoI=a.R_GtoI @ jnp.asarray(rot(rng, 0.02)), p_IinG=a.p_IinG + 0.01) for a in jf]
    pf_fej = reps.AnchorFrame(*(t(np.stack([np.asarray(getattr(a, k)) for a in jf_fej]))
                                for k in reps.AnchorFrame._fields))
    p_G = points_in_front(rng, jf)
    p_G_fej = p_G + 0.01 * rng.normal(size=p_G.shape)
    out = reps.rep_jacobians(rep, t(p_G), t(p_G_fej), pf, pf_fej, fej=fej, calib_extrinsic=True)
    for i in range(6):
        ref = j_reps.rep_jacobians(rep, jnp.asarray(p_G[i]), jnp.asarray(p_G_fej[i]), jf[i], jf_fej[i], fej=fej,
                                   calib_extrinsic=True)
        for a, b in zip(out, ref):
            close(a[i], b, 1e-10)
    if not reps.is_anchored(rep):
        assert not out.H_anchor.any() and not out.H_calib.any()
    no_cal = reps.rep_jacobians(rep, t(p_G), t(p_G_fej), pf, pf_fej, fej=fej)
    assert not no_cal.H_calib.any()


# --------------------------------------------------------------------------- a state with landmarks


def _layouts():
    kw = dict(max_clones=K, max_slam=L, max_planes=P, calib_dt=False, calib_pose=False, calib_intr=False)
    return j_layout.StateLayout(**kw), StateLayout(**kw)


def _project(R_GtoI, p_IinG, R_ItoC, p_IinC, p):
    p_C = R_ItoC @ (R_GtoI @ (p - p_IinG)) + p_IinC
    return p_C[:2] / p_C[2]


def _scene(seed, rep, plane=False):
    """One stream: a JAX state with 5 live clones (slot 5 free, slot 4 the
    newest, slot 0 the oldest), landmarks in slots 0, 1 and 3 (ids 100-102,
    anchored at clones 0, 2, 0 for anchored reps), plane 7 in the state, and
    a bank holding the tracks of landmarks 100 and 101 (seen at the newest
    clone; 102 has none: lost) and three full-window tracks 200-202 (202
    invalid as a candidate). With ``plane`` the landmark 100 and the track
    200 lie on plane 7."""
    rng = np.random.default_rng(seed)
    jlay, _ = _layouts()
    D = jlay.dim
    R_ItoC, p_IinC = rot(rng, 0.05), 0.05 * rng.normal(size=3)
    Rs = np.stack([rot(rng, 0.05) for _ in range(K)])
    ps = np.concatenate([rng.uniform(-0.5, 0.5, size=(K, 2)), 0.1 * rng.normal(size=(K, 1))], 1)
    clones_t = np.array([0.0, 1.0, 2.0, 3.0, 4.0, -np.inf])
    cp = np.array([0.0, 0.05, 3.0])
    n = cp / np.linalg.norm(cp)

    def pt(on_plane):
        p = np.array([rng.uniform(-0.8, 0.8), rng.uniform(-0.8, 0.8), rng.uniform(2.5, 4.0)])
        if on_plane:
            p = p + (np.linalg.norm(cp) - n @ p) * n
        return p

    truth = {100: pt(plane), 101: pt(False), 102: pt(False), 200: pt(plane), 201: pt(False), 202: pt(False)}
    A = rng.normal(size=(D, D))
    cov = 1e-4 * A @ A.T / D + 1e-5 * np.eye(D)
    for s in (2, 4):                                   # free landmark slots: zero rows and columns
        cov[jlay.slam_base + 3 * s:jlay.slam_base + 3 * s + 3] = 0.0
        cov[:, jlay.slam_base + 3 * s:jlay.slam_base + 3 * s + 3] = 0.0
    cov[jlay.clone_base + 30:jlay.clone_base + 36] = 0.0
    cov[:, jlay.clone_base + 30:jlay.clone_base + 36] = 0.0
    slam_p = np.zeros((L, 3))
    slam_p_fej = np.zeros((L, 3))
    anchor = np.full(L, -1, np.int32)
    active = np.zeros(L, bool)
    sid = np.full(L, -1, np.int32)
    for s, fid, a in ((0, 100, 0), (1, 101, 2), (3, 102, 0)):
        p = truth[fid] + 0.02 * rng.normal(size=3)
        p_fej = p + 0.005 * rng.normal(size=3)
        if j_reps.is_anchored(rep):
            anchor[s] = a
            frame = j_reps.AnchorFrame(jnp.asarray(Rs[a]), jnp.asarray(ps[a]), jnp.asarray(R_ItoC), jnp.asarray(p_IinC))
            p, p_fej = (np.asarray(j_reps.global_to_rep(rep, jnp.asarray(x), frame)) for x in (p, p_fej))
        elif rep != j_reps.GLOBAL_3D:
            p, p_fej = (np.asarray(j_reps.global_to_rep(rep, jnp.asarray(x))) for x in (p, p_fej))
        slam_p[s], slam_p_fej[s], active[s], sid[s] = p, p_fej, True, fid
    q = lambda R: np.asarray(j_rot_2_quat(jnp.asarray(R)))  # noqa: E731
    st = j_vs.VioState.create(jlay).replace(
        clones_q=jnp.asarray(np.stack([q(R) for R in Rs])), clones_p=jnp.asarray(ps),
        clones_q_fej=jnp.asarray(np.stack([q(R @ rot(rng, 0.005)) for R in Rs])),
        clones_p_fej=jnp.asarray(ps + 0.002 * rng.normal(size=ps.shape)),
        clones_t=jnp.asarray(clones_t), t=jnp.asarray(4.0), cam_zeta=jnp.asarray(ZETA),
        calib_cam=jnp.asarray(np.concatenate([q(R_ItoC), p_IinC])), cov=jnp.asarray(cov),
        slam_p=jnp.asarray(slam_p), slam_p_fej=jnp.asarray(slam_p_fej), slam_id=jnp.asarray(sid),
        slam_active=jnp.asarray(active), slam_anchor_slot=jnp.asarray(anchor),
        plane_cp=jnp.asarray(np.stack([cp, [1.0, 0.0, 0.0]])), plane_cp_fej=jnp.asarray(np.stack([cp + 0.01, [1.0, 0.0, 0.0]])),
        plane_id=jnp.asarray(np.array([7, -1], np.int32)), plane_active=jnp.asarray(np.array([True, False])),
    )
    F = 10
    fid = np.full(F, -1, np.int32)
    uv = np.zeros((F, K, 2))
    mask = np.zeros((F, K), bool)
    planeid = np.full(F, -1, np.int32)
    for r, f in enumerate((100, 101, 200, 201, 202)):
        fid[r] = f
        for k in range(5):
            if f < 200 and k < 3:
                continue
            uv[r, k] = _project(Rs[k], ps[k], R_ItoC, p_IinC, truth[f]) + 0.3 / 300.0 * rng.normal(size=2)
            mask[r, k] = True
        planeid[r] = 7 if plane and f in (100, 200) else -1
    uvn = uv.copy()
    uv = uv * ZETA[0:2] + ZETA[2:4]
    bank = JBank.create(F, K).replace(fid=jnp.asarray(fid), uv=jnp.asarray(uv), uvn=jnp.asarray(uvn),
                                      mask=jnp.asarray(mask), planeid=jnp.asarray(planeid))
    return st, bank


def _opts(rep, plane):
    kw = dict(sigma_px=1.0, chi2_multipler=5.0, sigma_c=0.05, use_plane_constraint_slamu=plane,
              use_plane_constraint_slamd=plane, max_init_per_frame=8)
    return (j_slam.SlamOptions(jac=j_jac.JacobianOptions(rep=rep), **kw),
            slam.SlamOptions(jac=jac.JacobianOptions(rep=rep), **kw))


def _port(jstates, jbanks):
    _, lay = _layouts()
    st = convert.state_from_arrays(convert.stack_streams([arrays(s) for s in jstates]), lay, device="cpu")
    return st, convert.bank_from_arrays(convert.stack_streams([arrays(b) for b in jbanks]), device="cpu")


CASES = [(j_reps.GLOBAL_3D, True), (j_reps.GLOBAL_FULL_INVERSE_DEPTH, False), (j_reps.ANCHORED_3D, False),
         (j_reps.ANCHORED_FULL_INVERSE_DEPTH, False), (j_reps.ANCHORED_MSCKF_INVERSE_DEPTH, False)]
CASE_IDS = ["GLOBAL_3D_planes", "GLOBAL_FULL_INVERSE_DEPTH", "ANCHORED_3D", "ANCHORED_FULL_INVERSE_DEPTH",
            "ANCHORED_MSCKF_INVERSE_DEPTH"]


@pytest.mark.parametrize("rep", REPS_3DOF, ids=lambda r: NAMES[r])
def test_feature_jacobian_full_under_each_representation(rep):
    jst, jbank = _scene(60 + rep, rep)
    jlay, lay = _layouts()
    rows = np.array([0, 1, 2, 3])
    aslot = np.array([4, 2, 0, 3], np.int32)
    uv, mask = np.asarray(jbank.uv)[rows], np.asarray(jbank.mask)[rows]
    rng = np.random.default_rng(rep)
    p = np.stack([np.asarray(jst.clones_p)[k] + np.array([0.2, -0.1, 3.0]) + 0.3 * rng.normal(size=3) for k in aslot])
    p_fej = p + 0.01 * rng.normal(size=p.shape)
    p[3] = np.asarray(jst.clones_p)[3]          # at the anchor camera: the degenerate-point guard
    for do_fej in (True, False):
        jopts = j_jac.JacobianOptions(rep=rep, do_fej=do_fej)
        clones = j_jac.clone_set_from_state(jst)
        ref = jax.vmap(lambda u, m, a, b, s: j_jac.feature_jacobian_full(
            jlay, jopts, clones, u, m, a, b, jnp.zeros(3), jnp.zeros(3), False, False, 0, 1.0, 0.05,
            anchor_slot=s))(uv, mask, p, p_fej, aslot)
        st, _ = _port([jst], [jbank])
        out = jac.feature_jacobian_full(lay, jac.JacobianOptions(rep=rep, do_fej=do_fej), jac.clone_set_from_state(st),
                                        t(uv)[None], t(mask)[None], t(p)[None], t(p_fej)[None], 1.0,
                                        anchor_slot=t(aslot)[None])
        for a, b in zip(out[:3], ref[:3]):
            close(a[0], b)
        np.testing.assert_array_equal(out[3][0].numpy(), np.asarray(ref[3]))
        if reps.is_anchored(rep):              # the anchor clone's columns are coupled
            col = lay.clone_base + 6 * int(aslot[1])
            assert out[0][0, 1, 6:2 * K, col:col + 6].abs().sum() > 0


@pytest.mark.parametrize("rep,plane", CASES, ids=CASE_IDS)
def test_slam_delayed_init(rep, plane):
    scenes = [_scene(80 + s, rep, plane) for s in range(2)]
    jopts, opts = _opts(rep, plane)
    cand_idx = np.array([[2, 3, 4, 0, 0, 0, 0, 0], [3, 2, 4, 1, 0, 0, 0, 0]], np.int32)
    cand_valid = np.array([[True, True, False, False, False, False, False, False],
                           [True, True, True, True, False, False, False, False]])
    ref = [j_slam.slam_delayed_init(st, bk, jopts, jnp.asarray(cand_idx[b]), jnp.asarray(cand_valid[b]))
           for b, (st, bk) in enumerate(scenes)]
    st, bk = _port(*zip(*scenes))
    st2, bk2, n = slam.slam_delayed_init(st, bk, opts, t(cand_idx).long(), t(cand_valid))
    close_tree(st2, [r[0] for r in ref])
    close_tree(bk2, [r[1] for r in ref])
    np.testing.assert_array_equal(n.numpy(), [int(r[2]) for r in ref])
    # Two free slots: two inits each, in slots 2 then 4; the third candidate finds none.
    assert n.tolist() == [2, 2] and st2.slam_active.all()
    if reps.is_anchored(rep):
        assert (st2.slam_anchor_slot[:, [2, 4]] == 4).all()


@pytest.mark.parametrize("rep,plane", CASES, ids=CASE_IDS)
def test_slam_update(rep, plane):
    scenes = [_scene(100 + s, rep, plane) for s in range(2)]
    jopts, opts = _opts(rep, plane)
    ref = [j_slam.slam_update(st, bk, jopts, 4) for st, bk in scenes]
    st, bk = _port(*zip(*scenes))
    st2, n = slam.slam_update(st, bk, opts, torch.tensor([4, 4]))
    close_tree(st2, [r[0] for r in ref])
    np.testing.assert_array_equal(n.numpy(), [int(r[1]) for r in ref])
    assert n.tolist() == [2, 2]


def test_marginalize_lost_slam():
    scenes = [_scene(120 + s, j_reps.ANCHORED_MSCKF_INVERSE_DEPTH) for s in range(2)]
    ref = [j_slam.marginalize_lost_slam(st, bk) for st, bk in scenes]
    st, bk = _port(*zip(*scenes))
    st2, n = slam.marginalize_lost_slam(st, bk)
    close_tree(st2, [r[0] for r in ref], tol=0)
    np.testing.assert_array_equal(n.numpy(), [int(r[1]) for r in ref])
    assert n.tolist() == [1, 1] and not st2.slam_active[:, 3].any() and (st2.slam_anchor_slot[:, 3] == -1).all()


@pytest.mark.parametrize("do_fej", [True, False], ids=["fej", "no_fej"])
@pytest.mark.parametrize("rep", ANCHORED_3DOF, ids=lambda r: NAMES[r])
def test_change_anchors(rep, do_fej):
    scenes = [_scene(140 + s, rep) for s in range(2)]
    ref = [j_slam.change_anchors(st, rep, do_fej, jnp.int32(0), jnp.int32(4)) for st, _ in scenes]
    st, _ = _port(*zip(*scenes))
    st2, n = slam.change_anchors(st, rep, do_fej, torch.tensor([0, 0]), torch.tensor([4, 4]))
    close_tree(st2, [r[0] for r in ref])
    np.testing.assert_array_equal(n.numpy(), [int(r[1]) for r in ref])
    # Landmarks 0 and 3 were anchored at clone 0; both move to clone 4, and
    # their global points stay where they were.
    assert n.tolist() == [2, 2] and st2.slam_anchor_slot[:, [0, 3]].eq(4).all()
    before, _ = slam._slam_point_global(st, rep)
    after, _ = slam._slam_point_global(st2, rep)
    close(after, before.numpy(), 1e-10)


@pytest.mark.parametrize("rep", [j_reps.GLOBAL_FULL_INVERSE_DEPTH, j_reps.ANCHORED_MSCKF_INVERSE_DEPTH],
                         ids=lambda r: NAMES[r])
def test_msckf_update_under_a_representation(rep):
    """MSCKF features in another representation anchor at their newest
    observing clone (the full-window tracks 200-202 of the scene)."""
    scenes = [_scene(170 + s, rep) for s in range(2)]
    kw = dict(sigma_px=1.0, chi2_multipler=5.0)
    jopts = j_msckf.MsckfOptions(jac=j_jac.JacobianOptions(rep=rep), **kw)
    rows = np.array([2, 3, 4])
    ref = []
    for st, bk in scenes:
        m = np.asarray(bk.mask)[rows]
        z3, zb, zi = np.zeros((3, 3)), np.zeros(3, bool), np.zeros(3, np.int32)
        ref.append(j_msckf.msckf_update(st, jopts, np.asarray(bk.uv)[rows], np.asarray(bk.uvn)[rows], m,
                                        z3, z3, zb, zb, zi))
    st, bk = _port(*zip(*scenes))
    out = msckf.msckf_update(st, msckf.MsckfOptions(jac=jac.JacobianOptions(rep=rep), **kw), bk.uv[:, rows],
                             bk.uvn[:, rows], bk.mask[:, rows])
    close_tree(out[0], [r[0] for r in ref])
    for a, b in zip(out[1:], zip(*[r[1:] for r in ref])):
        close(a, np.stack([np.asarray(x) for x in b]))
    assert out[1].all()


def test_refine_point_on_plane():
    rng = np.random.default_rng(160)
    jst, jbank = _scene(160, j_reps.GLOBAL_3D, plane=True)
    clones = j_jac.clone_set_from_state(jst)
    R_GtoC, p_CinG = np.asarray(clones.R_GtoC), np.asarray(clones.p_CinG)
    cp = np.asarray(jst.plane_cp)[0]
    uvn, mask = np.asarray(jbank.uvn)[:5], np.asarray(jbank.mask)[:5]
    p0 = np.stack([np.array([0.0, 0.0, 3.0]) + 0.3 * rng.normal(size=3) for _ in range(5)])
    kw = dict(iters=10, lam_init=1e-4, sigma_px=1.0, sigma_c=0.05, focal=300.0)
    ref = jax.vmap(lambda p, u, m: j_pf.refine_point_on_plane(p, cp, u, m, R_GtoC, p_CinG,
                                                              j_pf.PlaneRefineOptions(**kw)))(p0, uvn, mask)
    out = planefit.refine_point_on_plane(t(p0), t(cp).expand(5, 3), t(uvn), t(mask), t(R_GtoC).expand(5, K, 3, 3),
                                         t(p_CinG).expand(5, K, 3), planefit.PlaneRefineOptions(**kw))
    close(out, ref, 1e-8)
    assert np.abs(out.numpy() - p0).max() > 1e-3          # the refine moved the points


# --------------------------------------------------------------------------- the MS-PL window

START, N_WINDOW = 15, 15


def _jax_config(cfg):
    jc = j_sim_config()
    for sec in ("state", "tpu", "msckf_options", "slam_options"):
        for k, v in vars(getattr(cfg, sec)).items():
            setattr(getattr(jc, sec), k, v)
    return jc


def _jax_sim(truth, sim, b, lo, hi):
    n = np.asarray
    O = truth.obs_id.shape[1]
    cam = dict(cam_t=n(truth.cam_t), cam_t_imu=n(truth.cam_t_imu), obs_id=n(truth.obs_id), obs_uv=n(sim.obs_uv[b]),
               obs_uv_true=n(truth.obs_uv_true), obs_plane=n(truth.obs_plane),
               imu_window_start=n(truth.imu_window_start).astype(np.int32), gt_q=n(truth.gt_q), gt_p=n(truth.gt_p),
               gt_v=n(truth.gt_v), gt_bg_cam=n(sim.gt_bg_cam[b]), gt_ba_cam=n(sim.gt_ba_cam[b]))
    return JSim(imu_t=n(truth.imu_t), imu_w=n(sim.imu_w[b]), imu_a=n(sim.imu_a[b]), imu_w_true=n(truth.imu_w_true),
                imu_a_true=n(truth.imu_a_true), gt_bg=n(sim.gt_bg[b]), gt_ba=n(sim.gt_ba[b]),
                obs_gt_p=np.zeros((hi - lo, O, 3)), obs_gt_cp=np.zeros((hi - lo, O, 3)), feat_p=np.zeros((1, 3)),
                feat_plane=np.zeros(1, np.int32), plane_cp=n(truth.plane_cp), **{k: v[lo:hi] for k, v in cam.items()})


def test_ms_pl_window_matches_jax_run_sequence():
    cfg = ms_pl_config()
    truth = simulator.load_scene(simulator.PLANE_SCENE_PATH, device="cpu")
    sim = simulator.apply_noise(truth, simulator.noise_params(cfg), 2, torch.Generator().manual_seed(3))
    jc = _jax_config(cfg)
    jeng = JEngine.from_config(jc)
    eng = VioEngine.from_config(cfg, device="cpu")
    assert eng.layout.dim == jeng.layout.dim == 147
    W = cfg.tpu.max_imu_per_frame
    starts, refs = [], []
    for b in range(2):
        # Frames 1..15, then 16..30: two scans of one length (one compile).
        s0 = _jax_sim(truth, sim, b, 0, START + 1)
        st = j_init(jeng, jc, t0=s0.cam_t_imu[0], q0=s0.gt_q[0], p0=s0.gt_p[0], v0=s0.gt_v[0], bg0=s0.gt_bg_cam[0],
                    ba0=s0.gt_ba_cam[0])
        st, bk, _ = j_run(jeng, st, JBank.create(jc.tpu.max_features, jeng.layout.max_clones), s0, imu_window=W)
        starts.append((st, bk))
        refs.append(j_run(jeng, st, bk, _jax_sim(truth, sim, b, START, START + N_WINDOW + 1), imu_window=W))
    state = convert.state_from_arrays(convert.stack_streams([arrays(s) for s, _ in starts]), eng.layout, device="cpu")
    bank = convert.bank_from_arrays(convert.stack_streams([arrays(k) for _, k in starts]), device="cpu")
    state, bank, outs = run_sequence(eng, state, bank, sim, imu_window=W, n_frames=N_WINDOW, start=START + 1)
    for b, (jst, _, r) in enumerate(refs):
        for name in ("n_msckf_used", "n_bank", "n_clones", "n_slam", "n_slam_init", "n_planes", "n_plane_init",
                     "n_plane_constraints", "n_plane_merges", "n_plane_dropped"):
            np.testing.assert_array_equal(getattr(outs, name)[b].numpy(), np.asarray(getattr(r, name)), err_msg=name)
        np.testing.assert_allclose(outs.p[b].numpy(), np.asarray(r.p), rtol=0, atol=1e-7)
        np.testing.assert_allclose(outs.q[b].numpy(), np.asarray(r.q), rtol=0, atol=1e-8)
        np.testing.assert_array_equal(state.slam_id[b].numpy(), np.asarray(jst.slam_id))
        np.testing.assert_allclose(state.slam_p[b].numpy(), np.asarray(jst.slam_p), rtol=0, atol=1e-6)
    # The window holds the first SLAM inits and landmark updates.
    assert int(outs.n_slam_init[:, :4].sum()) == 0 and int(outs.n_slam_init.sum()) >= 8
    assert int(outs.n_slam.min(dim=1).values.min()) == 0 and int(outs.n_slam[:, -1].min()) >= 8
    assert int(outs.n_slam_update.sum()) > 20
