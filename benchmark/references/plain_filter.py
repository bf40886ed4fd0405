"""A plain filter step of one stream in NumPy float64: the reference that the
output check holds the port's ``models.manager.step`` to.

It is written from the semantics of the upstream MSCKF with SLAM points
(OpenVINS ``Propagator``, ``UpdaterMSCKF``, ``UpdaterSLAM``, ``StateHelper``,
``VioManager::do_feature_propagate_update``) as a dense, unmasked, one-stream
computation: no batch dimension, no slots chosen by selects, no fixed-size
masking. Where the port fixes a convention that the upstream leaves open
(its row order in the track table, its tie-breaks, its fixed five
Levenberg-Marquardt rounds of triangulation), this file states the
convention and follows it, so that the same inputs give the same answers.

State conventions (JPL, Trawny): q = [x, y, z, w] is R_GtoI; the error state
is [δθ, δp, δv, δbg, δba | clones (δθ, δp) per slot | SLAM points (δp) per
slot | plane slots (unused here)], laid out in fixed slots.

A stream's state is a dict of numpy arrays with the names of the program's
``VioState`` and ``FeatureBank`` fields (``bank_`` prefix for the latter).
"""

from __future__ import annotations

import math

import numpy as np
from scipy.stats import chi2 as _chi2

I3 = np.eye(3)


# --------------------------------------------------------------------------- rotations (JPL)

def skew(w):
    return np.array([[0.0, -w[2], w[1]], [w[2], 0.0, -w[0]], [-w[1], w[0], 0.0]])


def rot(q):
    """R_GtoL of the JPL quaternion q."""
    qv, w = q[:3], q[3]
    return (2.0 * w * w - 1.0) * I3 - 2.0 * w * skew(qv) + 2.0 * np.outer(qv, qv)


def qmul(q, p):
    """JPL product q ⊗ p, normalized."""
    qv, q4 = q[:3], q[3]
    m = np.zeros((4, 4))
    m[:3, :3] = q4 * I3 - skew(qv)
    m[:3, 3] = qv
    m[3, :3] = -qv
    m[3, 3] = q4
    r = m @ p
    return r / np.linalg.norm(r)


def omega(w):
    m = np.zeros((4, 4))
    m[:3, :3] = -skew(w)
    m[:3, 3] = w
    m[3, :3] = -w
    return m


def jr_so3(w):
    """Right Jacobian of SO(3)."""
    th2 = float(w @ w)
    W = skew(w)
    if th2 < 1e-14:
        b, c = 0.5 - th2 / 24.0, 1.0 / 6.0 - th2 / 120.0
    else:
        th = math.sqrt(th2)
        b, c = (1.0 - math.cos(th)) / th2, (th - math.sin(th)) / (th2 * th)
    return I3 - b * W + c * (W @ W)


def boxplus(q, dth):
    """q ← quat([δθ/2, 1]) ⊗ q (the JPL error convention)."""
    dq = np.concatenate([0.5 * dth, [1.0]])
    return qmul(dq / np.linalg.norm(dq), q)


# --------------------------------------------------------------------------- camera (radial-tangential)

def distort(xn, zeta):
    """Normalized point -> (pixel [2], d pixel / d normalized [2, 2])."""
    fx, fy, cx, cy, k1, k2, p1, p2 = zeta
    x, y = xn
    r2 = x * x + y * y
    rad = 1.0 + k1 * r2 + k2 * r2 * r2
    xd = x * rad + 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
    yd = y * rad + p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
    drad = k1 + 2.0 * k2 * r2
    J = np.array([[rad + 2.0 * x * x * drad + 2.0 * p1 * y + 6.0 * p2 * x, 2.0 * x * y * drad + 2.0 * p1 * x + 2.0 * p2 * y],
                  [2.0 * x * y * drad + 2.0 * p1 * x + 2.0 * p2 * y, rad + 2.0 * y * y * drad + 6.0 * p1 * y + 2.0 * p2 * x]])
    return np.array([fx * xd + cx, fy * yd + cy]), J * np.array([[fx], [fy]])


def undistort(uv, zeta, iters: int = 30):
    """Pixel -> normalized point, by Newton's method on :func:`distort`."""
    x = np.array([(uv[0] - zeta[2]) / zeta[0], (uv[1] - zeta[3]) / zeta[1]])
    for _ in range(iters):
        f, J = distort(x, zeta)
        x = x - np.linalg.solve(J, f - uv)
    return x


# --------------------------------------------------------------------------- the configuration

class Options:
    """What the reference reads of the configuration (the benchmark's config
    file states each value; nothing is taken from the program)."""

    def __init__(self, c: dict):
        f = c["filter"]
        self.K = f["max_clone_size"] + 1                # clone slots: one transient beyond the window
        self.max_clone_size = f["max_clone_size"]
        self.L = max(f["max_slam"], 1)
        self.max_slam = f["max_slam"]
        self.P = f["plane_slots"]
        self.D = 15 + 6 * self.K + 3 * self.L + 3 * self.P
        self.clone_base = 15
        self.slam_base = 15 + 6 * self.K
        self.max_msckf = f["max_msckf_in_update"]
        self.max_slam_init = f["max_slam_init_per_frame"]
        self.min_clones = min(self.max_clone_size, 5)
        self.slam_delay = f["dt_slam_delay"]
        self.sigma_px_msckf = f["msckf_sigma_px"]
        self.sigma_px_slam = f["slam_sigma_px"]
        self.chi2_msckf = f["msckf_chi2_multiplier"]
        self.chi2_slam = f["slam_chi2_multiplier"]
        self.tri = f["triangulation"]
        n = c["imu_noise"]
        self.noise = np.array([n["sigma_w"] ** 2, n["sigma_a"] ** 2, n["sigma_wb"] ** 2, n["sigma_ab"] ** 2])
        self.gravity = np.array([0.0, 0.0, c["gravity_mag"]])
        self.zeta = np.asarray(c["camera"]["intrinsics"], np.float64)


def chi2_095(dof: int) -> float:
    return float(_chi2.ppf(0.95, max(int(dof), 1)))


# --------------------------------------------------------------------------- propagation

def _rk4(q0, p0, v0, dt, w1, a1, w2, a2, g):
    """RK4 of (q, p, v) over one interval, the rates and forces linear in time."""
    w_al, a_jk = (w2 - w1) / dt, (a2 - a1) / dt

    def qdot(dq, w):
        return 0.5 * omega(w) @ dq

    def vdot(dq, a):
        return rot(qmul(dq, q0)).T @ a - g

    dq0 = np.array([0.0, 0.0, 0.0, 1.0])
    wm, am = w1 + 0.5 * w_al * dt, a1 + 0.5 * a_jk * dt
    k1q, k1p, k1v = qdot(dq0, w1) * dt, v0 * dt, vdot(dq0, a1) * dt
    dq1 = dq0 + 0.5 * k1q
    dq1 /= np.linalg.norm(dq1)
    v1 = v0 + 0.5 * k1v
    k2q, k2p, k2v = qdot(dq1, wm) * dt, v1 * dt, vdot(dq1, am) * dt
    dq2 = dq0 + 0.5 * k2q
    dq2 /= np.linalg.norm(dq2)
    v2 = v0 + 0.5 * k2v
    k3q, k3p, k3v = qdot(dq2, wm) * dt, v2 * dt, vdot(dq2, am) * dt
    dq3 = dq0 + k3q
    dq3 /= np.linalg.norm(dq3)
    v3 = v0 + k3v
    k4q, k4p, k4v = qdot(dq3, w2) * dt, v3 * dt, vdot(dq3, a2) * dt
    dq = dq0 + (k1q + 2 * k2q + 2 * k3q + k4q) / 6.0
    dq /= np.linalg.norm(dq)
    return (qmul(dq, q0), p0 + (k1p + 2 * k2p + 2 * k3p + k4p) / 6.0,
            v0 + (k1v + 2 * k2v + 2 * k3v + k4v) / 6.0)


def _phi_g(fej, q1, p1, v1, dt, w, g):
    """First-estimate state transition Φ [15, 15] and noise Jacobian G [15, 12]."""
    RfT = rot(fej[0:4]).T
    pf, vf = fej[4:7], fej[7:10]
    dR = rot(q1) @ RfT
    thb = -dR @ jr_so3(-w * dt) * dt
    F = np.eye(15)
    G = np.zeros((15, 12))
    F[0:3, 0:3] = dR
    F[0:3, 9:12] = thb
    F[3:6, 0:3] = -skew(p1 - pf - vf * dt + 0.5 * g * dt * dt) @ RfT
    F[3:6, 6:9] = I3 * dt
    F[3:6, 12:15] = -0.5 * RfT * dt * dt
    F[6:9, 0:3] = -skew(v1 - vf + g * dt) @ RfT
    F[6:9, 12:15] = -RfT * dt
    G[0:3, 0:3] = thb
    G[3:6, 3:6] = -0.5 * RfT * dt * dt
    G[6:9, 3:6] = -RfT * dt
    G[9:12, 6:9] = I3
    G[12:15, 9:12] = I3
    return F, G


def propagate(s: dict, o: Options, imu_t, imu_w, imu_a, t_new):
    """Mean and covariance from the state's time to t_new over the IMU
    samples (each sample pair clipped to the interval, its end points
    interpolated), then a stochastic clone of the new pose into the first
    free clone slot. Returns the new clone's slot."""
    t0, t1 = s["t"] + s["last_dt"], t_new + s["calib_dt"]
    imu, fej = s["imu"].copy(), s["imu_fej"].copy()
    phi, qd = np.eye(15), np.zeros((15, 15))

    def lerp(t, ta, tb, va, vb):
        lam = (t - ta) / (tb - ta) if tb > ta else 0.0
        return (1 - lam) * va + lam * vb

    for n in range(len(imu_t) - 1):
        tar, tbr = imu_t[n], imu_t[n + 1]
        ta, tb = min(max(tar, t0), t1), min(max(tbr, t0), t1)
        dt = tb - ta
        if not (dt > 0 and math.isfinite(dt)):
            continue
        w1 = lerp(ta, tar, tbr, imu_w[n], imu_w[n + 1]) - imu[10:13]
        a1 = lerp(ta, tar, tbr, imu_a[n], imu_a[n + 1]) - imu[13:16]
        w2 = lerp(tb, tar, tbr, imu_w[n], imu_w[n + 1]) - imu[10:13]
        a2 = lerp(tb, tar, tbr, imu_a[n], imu_a[n + 1]) - imu[13:16]
        q1, p1, v1 = _rk4(imu[0:4], imu[4:7], imu[7:10], dt, w1, a1, w2, a2, o.gravity)
        F, G = _phi_g(fej, q1, p1, v1, dt, w1, o.gravity)
        qc = np.concatenate([np.full(3, o.noise[0] / dt), np.full(3, o.noise[1] / dt),
                             np.full(3, o.noise[2] * dt), np.full(3, o.noise[3] * dt)])
        Qd = G @ (qc[:, None] * G.T)
        new = np.concatenate([q1, p1, v1, imu[10:16]])
        phi = F @ phi
        qd = F @ qd @ F.T + 0.5 * (Qd + Qd.T)
        imu, fej = new, new.copy()
    P = s["cov"]
    PI = P[:, :15] @ phi.T                       # [D, 15]
    P[:, :15] = PI
    P[:15, :] = PI.T
    blk = phi @ PI[:15] + qd
    P[:15, :15] = 0.5 * (blk + blk.T)
    # Clone: the first free slot (free slots hold -inf times).
    slot = int(np.argmin(s["clones_t"]))
    c = o.clone_base + 6 * slot
    P[c:c + 6, :] = 0.0
    P[:, c:c + 6] = 0.0
    P[c:c + 6, :] = P[0:6, :]
    P[:, c:c + 6] = P[:, 0:6]
    P[c:c + 6, c:c + 6] = P[0:6, 0:6]
    s.update(t=t_new, last_dt=s["calib_dt"], imu=imu, imu_fej=fej)
    s["clones_q"][slot], s["clones_p"][slot] = imu[0:4], imu[4:7]
    s["clones_q_fej"][slot], s["clones_p_fej"][slot] = fej[0:4], fej[4:7]
    s["clones_t"][slot] = t_new
    return slot


# --------------------------------------------------------------------------- the track table

def ingest(s: dict, o: Options, ids, uv, slot: int):
    """One frame's observations into the track table at clone slot ``slot``.

    Convention of the port's table: tracks live in rows; a row whose only
    observations were at the recycled slot is freed first; a known id
    updates its row; the r-th new id takes the r-th free row (ascending);
    ids beyond the free rows are dropped."""
    fid, mask = s["bank_fid"], s["bank_mask"]
    mask[:, slot] = False
    gone = ~mask.any(axis=1) & (fid >= 0) & ~s["bank_is_slam"]
    fid[gone] = -1
    s["bank_planeid"][gone] = -1
    row_of = {int(f): r for r, f in enumerate(fid) if f >= 0}
    free = [r for r in range(len(fid)) if fid[r] < 0]
    hit = {}
    for j, (i, x) in enumerate(zip(ids, uv)):
        if i < 0 or not np.isfinite(x).all():
            continue
        r = row_of.get(int(i))
        if r is None:
            if not free:
                continue
            r = free.pop(0)
            row_of[int(i)] = r
            fid[r] = i
        hit.setdefault(r, j)
    s["bank_uv"][:, slot] = 0.0
    for r, j in hit.items():
        mask[r, slot] = True
        s["bank_uv"][r, slot] = uv[j]


def alive_clones(s):
    return np.isfinite(s["clones_t"])


def oldest_clone(s):
    t = np.where(alive_clones(s), s["clones_t"], np.inf)
    return int(np.argmin(t))


def top_rows(score, k):
    """The k rows of largest integer score, ties to the lower row (the port's
    order), with their scores."""
    order = sorted(range(len(score)), key=lambda r: (-score[r], r))[:k]
    return order, [score[r] for r in order]


# --------------------------------------------------------------------------- triangulation

def triangulate(uvn, obs, Rc, pc, t: dict):
    """A point seen at normalized coordinates uvn [n, 2] from cameras
    (R_GtoC [n, 3, 3], p_CinG [n, 3]): the midpoint of the bearings, then
    five Levenberg-Marquardt rounds on the reprojection (the port's count).
    Returns (p [3], ok)."""
    if len(obs) < 2:
        return np.ones(3), False
    A, b = np.zeros((3, 3)), np.zeros(3)
    for k in range(len(obs)):
        bg = Rc[k].T @ np.array([uvn[k, 0], uvn[k, 1], 1.0])
        bg /= np.linalg.norm(bg)
        Pk = I3 - np.outer(bg, bg)
        A += Pk
        b += Pk @ pc[k]
    p = np.linalg.solve(A, b)
    ev = np.linalg.eigvalsh(A)
    e0 = ev[0] if abs(ev[0]) >= 1e-12 else 1e-12
    cond = ev[2] / e0

    def depths(x):
        return np.array([Rc[k][2] @ (x - pc[k]) for k in range(len(obs))])

    dep = depths(p)
    ok = cond <= t["max_cond"] and ((dep > t["min_dist"]) & (dep < t["max_dist"])).all() and np.isfinite(p).all()
    if not ok:
        p = np.ones(3)

    def resid(x):
        r, J = [], []
        for k in range(len(obs)):
            pC = Rc[k] @ (x - pc[k])
            z = pC[2] if abs(pC[2]) >= 1e-6 else 1e-6
            r.append(uvn[k] - pC[:2] / z)
            dz = np.array([[1.0 / z, 0.0, -pC[0] / z ** 2], [0.0, 1.0 / z, -pC[1] / z ** 2]])
            J.append(-dz @ Rc[k])
        return np.concatenate(r), np.concatenate(J)

    lam = t["init_lambda"]
    r, _ = resid(p)
    c = r @ r
    x = p
    for _ in range(t["max_runs"]):
        r, J = resid(x)
        JtJ = J.T @ J
        A2 = JtJ + lam * np.diag(np.diag(JtJ))
        xn = x - np.linalg.solve(A2, J.T @ r)
        rn, _ = resid(xn)
        cn = rn @ rn
        if cn < c:
            x, c, lam = xn, cn, max(lam / t["lambda_mult"], 1e-12)
        else:
            lam = min(lam * t["lambda_mult"], t["max_lambda"])
    dep = depths(x)
    if ((dep > t["min_dist"]) & (dep < t["max_dist"])).all() and np.isfinite(x).all():
        return x, ok
    return p, False


# --------------------------------------------------------------------------- measurement models

def cameras(s, slots, fej=False):
    """(R_GtoC, p_CinG) of clone slots (the camera is the IMU: identity extrinsics)."""
    q, p = (s["clones_q_fej"], s["clones_p_fej"]) if fej else (s["clones_q"], s["clones_p"])
    return np.stack([rot(q[k]) for k in slots]), np.stack([p[k] for k in slots])


def point_rows(s, o: Options, slots, uv, p_f, p_fej, sigma_px):
    """Whitened reprojection rows of one point seen at clone slots: (H_x [2n, D]
    at the clones' columns, H_f [2n, 3], r [2n]). Jacobians at the first
    estimates (clone FEJ poses, the point's FEJ value), the residual and the
    distortion Jacobian at the current estimate."""
    n = len(slots)
    Hx, Hf, r = np.zeros((2 * n, o.D)), np.zeros((2 * n, 3)), np.zeros(2 * n)
    for j, k in enumerate(slots):
        R, pI = rot(s["clones_q"][k]), s["clones_p"][k]
        pC = R @ (p_f - pI)
        z = pC[2] if abs(pC[2]) >= 1e-6 else 1e-6
        uvd, dzn = distort(pC[:2] / z, o.zeta)
        Rj, pIj = rot(s["clones_q_fej"][k]), s["clones_p_fej"][k]
        pCj = Rj @ (p_fej - pIj)
        zj = pCj[2] if abs(pCj[2]) >= 1e-6 else 1e-6
        dproj = np.array([[1.0 / zj, 0.0, -pCj[0] / zj ** 2], [0.0, 1.0 / zj, -pCj[1] / zj ** 2]])
        dz_dpc = dzn @ dproj
        c = o.clone_base + 6 * k
        Hx[2 * j:2 * j + 2, c:c + 3] = dz_dpc @ skew(pCj) / sigma_px
        Hx[2 * j:2 * j + 2, c + 3:c + 6] = -dz_dpc @ Rj / sigma_px
        Hf[2 * j:2 * j + 2] = dz_dpc @ Rj / sigma_px
        r[2 * j:2 * j + 2] = (uv[j] - uvd) / sigma_px
    return Hx, Hf, r


def left_null(Hf):
    """An orthonormal basis of the left nullspace of Hf [m, 3] ([m, m-3])."""
    Q, _ = np.linalg.qr(Hf, mode="complete")
    return Q[:, Hf.shape[1]:]


def innovation_chi2(P, H, r):
    S = H @ P @ H.T + np.eye(len(r))
    try:
        L = np.linalg.cholesky(0.5 * (S + S.T))
    except np.linalg.LinAlgError:
        return math.nan
    u = np.linalg.solve(L, r)
    return float(u @ u)


def ekf_update(s: dict, o: Options, H, r):
    """The EKF update with unit measurement noise: P ← P − PHᵀS⁻¹HP, the
    correction box-plussed onto every mean (FEJ values untouched)."""
    if H.shape[0] > o.D:                          # the same information in D rows
        Q, R = np.linalg.qr(H)
        H, r = R, Q.T @ r
    P = s["cov"]
    PHt = P @ H.T
    S = H @ PHt + np.eye(len(r))
    K = np.linalg.solve(0.5 * (S + S.T), PHt.T).T
    dx = K @ r
    Pn = P - K @ PHt.T
    s["cov"] = 0.5 * (Pn + Pn.T)
    s["imu"][0:4] = boxplus(s["imu"][0:4], dx[0:3])
    s["imu"][4:16] += dx[3:15]
    for k in range(o.K):
        c = o.clone_base + 6 * k
        s["clones_q"][k] = boxplus(s["clones_q"][k], dx[c:c + 3])
        s["clones_p"][k] += dx[c + 3:c + 6]
    s["slam_p"] += dx[o.slam_base:o.slam_base + 3 * o.L].reshape(o.L, 3)
    s["plane_cp"] += dx[o.slam_base + 3 * o.L:].reshape(o.P, 3)


def zero_block(P, c, n):
    P[c:c + n, :] = 0.0
    P[:, c:c + n] = 0.0


# --------------------------------------------------------------------------- the frame step

def track_obs(s, row):
    """Clone slots (ascending) that observe a table row, among live clones."""
    return [k for k in range(s["bank_mask"].shape[1]) if s["bank_mask"][row, k] and np.isfinite(s["clones_t"][k])]


def uvn_of(s, o: Options, row, slots):
    return np.stack([undistort(s["bank_uv"][row, k], o.zeta) for k in slots])


def msckf_update(s: dict, o: Options, rows):
    """Triangulate each selected track, project its rows onto the left
    nullspace of its point Jacobian, χ²-gate it, and update with the rows
    of every track that passes. Returns the rows that passed."""
    stacks, used = [], []
    for row in rows:
        slots = track_obs(s, row)
        if len(slots) < 2:
            continue
        Rc, pc = cameras(s, slots)
        p_f, ok = triangulate(uvn_of(s, o, row, slots), slots, Rc, pc, o.tri)
        if not ok:
            continue
        Hx, Hf, r = point_rows(s, o, slots, s["bank_uv"][row, slots], p_f, p_f, o.sigma_px_msckf)
        N = left_null(Hf)
        H2, r2 = N.T @ Hx, N.T @ r
        c2 = innovation_chi2(s["cov"], H2, r2)
        if not c2 <= o.chi2_msckf * chi2_095(2 * len(slots) - 3):
            continue
        stacks.append((H2, r2))
        used.append(row)
    if stacks:
        ekf_update(s, o, np.concatenate([h for h, _ in stacks]), np.concatenate([x for _, x in stacks]))
    return used


def slam_update(s: dict, o: Options, cur: int):
    """Every landmark whose track is seen in this frame, with its newest
    observation: two rows on the landmark and this frame's clone, χ²-gated
    per landmark, one update. Returns the number updated."""
    fid = s["bank_fid"]
    Hs, rs = [], []
    for l in range(o.L):
        if not s["slam_active"][l]:
            continue
        rows = np.flatnonzero((fid == s["slam_id"][l]) & (fid >= 0))
        if not len(rows) or not s["bank_mask"][rows[0], cur]:
            continue
        row = rows[0]
        Hx, Hf, r = point_rows(s, o, [cur], s["bank_uv"][row, [cur]], s["slam_p"][l], s["slam_p_fej"][l],
                               o.sigma_px_slam)
        c = o.slam_base + 3 * l
        Hx[:, c:c + 3] += Hf
        if innovation_chi2(s["cov"], Hx, r) <= o.chi2_slam * chi2_095(2):
            Hs.append(Hx)
            rs.append(r)
    if Hs:
        ekf_update(s, o, np.concatenate(Hs), np.concatenate(rs))
    return len(Hs)


def slam_init(s: dict, o: Options, cand_rows):
    """Delayed initialization of promoted tracks, one after the other: each
    triangulated against the clones as they stand when the stage starts,
    its system split by QR into the three rows that fix the point and the
    rest; χ²-gated on the rest; the point written into the first free slot
    with its covariance (StateHelper::initialize_invertible) and the rest
    applied as an update. Returns the number initialized."""
    pre = []
    for row in cand_rows:
        slots = track_obs(s, row)
        Rc, pc = cameras(s, slots) if len(slots) >= 2 else (None, None)
        pre.append((row, slots) + (triangulate(uvn_of(s, o, row, slots), slots, Rc, pc, o.tri)
                                   if len(slots) >= 2 else (None, False)))
    n = 0
    for row, slots, p_f, ok in pre:
        free = np.flatnonzero(~s["slam_active"])
        if not ok or not len(free) or len(slots) < 2:
            continue
        Hx, Hf, r = point_rows(s, o, slots, s["bank_uv"][row, slots], p_f, p_f, o.sigma_px_slam)
        Q, R = np.linalg.qr(Hf, mode="complete")
        HL, HRi, ri = R[:3], Q[:, :3].T @ Hx, Q[:, :3].T @ r
        HRu, ru = Q[:, 3:].T @ Hx, Q[:, 3:].T @ r
        c2 = innovation_chi2(s["cov"], HRu, ru)
        if not (c2 <= o.chi2_slam * chi2_095(2 * len(slots)) and (np.abs(np.diag(HL)) > 1e-8).all()):
            continue
        l = int(free[0])
        c = o.slam_base + 3 * l
        P = s["cov"]
        HLi = np.linalg.inv(HL)
        Ma = P @ HRi.T
        M = HRi @ Ma + np.eye(3)
        zero_block(P, c, 3)
        cross = -(Ma @ HLi.T)
        P[:, c:c + 3] = cross
        P[c:c + 3, :] = cross.T
        P[c:c + 3, c:c + 3] = HLi @ M @ HLi.T
        p0 = p_f + HLi @ ri
        s["slam_p"][l], s["slam_p_fej"][l] = p0, p0.copy()
        s["slam_id"][l], s["slam_active"][l], s["slam_anchor_slot"][l] = s["bank_fid"][row], True, -1
        ekf_update(s, o, HRu, ru)
        s["bank_is_slam"][row] = True
        s["bank_slam_slot"][row] = l
        n += 1
    return n


def step(s: dict, o: Options, imu_t, imu_w, imu_a, t_new, ids, uv):
    """One camera frame of one stream (do_feature_propagate_update without
    the plane stages): propagate and clone, take in the frame's tracks, pick
    the tracks for the update, drop lost landmarks, update with the MSCKF
    tracks, update and initialize landmarks, free the used tracks and
    marginalize the oldest clone. ``s`` is changed in place; returns the
    frame's counters."""
    cur = propagate(s, o, imu_t, imu_w, imu_a, t_new)
    ingest(s, o, ids, uv, cur)
    fid, mask, is_slam = s["bank_fid"], s["bank_mask"], s["bank_is_slam"]
    nobs = mask.sum(axis=1)
    alive = alive_clones(s)
    n_clones = int(alive.sum())
    active = (fid >= 0) & ~is_slam
    lost = active & ~mask[:, cur]
    full = n_clones > o.max_clone_size
    marg = active & mask[:, oldest_clone(s)] & full
    cand = (lost | marg) & (nobs >= 2)
    can_update = n_clones >= o.min_clones
    allow_slam = can_update and (s["t"] - s["startup_t"]) >= o.slam_delay

    # Promotion to SLAM: tracks that span the window at the marginalization
    # boundary, the longest first, within the free landmark budget.
    slam_rows = []
    if o.max_slam > 0:
        score = np.where(marg & (nobs > o.max_clone_size) & allow_slam, nobs, -1)
        rows, sc = top_rows(score, o.max_slam_init)
        cap = o.max_slam - int(s["slam_active"].sum())
        slam_rows = [r for i, (r, v) in enumerate(zip(rows, sc)) if v > 0 and i < cap]
        cand[slam_rows] = False
    rows, sc = top_rows(np.where(cand, nobs, -1), o.max_msckf)
    sel = [r for r, v in zip(rows, sc) if v >= 2] if can_update else []
    if not can_update:
        slam_rows = []

    n_slam_update = n_slam_init = 0
    if o.max_slam > 0:
        have = set(int(f) for f in fid[fid >= 0])
        for l in range(o.L):
            if s["slam_active"][l] and int(s["slam_id"][l]) not in have:
                zero_block(s["cov"], o.slam_base + 3 * l, 3)
                s["slam_active"][l], s["slam_id"][l], s["slam_anchor_slot"][l] = False, -1, -1
    used = msckf_update(s, o, sel)
    if o.max_slam > 0:
        if can_update:
            n_slam_update = slam_update(s, o, cur)
        n_slam_init = slam_init(s, o, slam_rows)

    marg_slot = oldest_clone(s)
    for r in sel:                                  # every selected track is used up
        fid[r], s["bank_planeid"][r], is_slam[r], s["bank_slam_slot"][r] = -1, -1, False, -1
        mask[r] = False
    if full:
        zero_block(s["cov"], o.clone_base + 6 * marg_slot, 6)
        s["clones_t"][marg_slot] = -np.inf
        mask[:, marg_slot] = False
        gone = ~mask.any(axis=1) & (fid >= 0) & ~is_slam
        fid[gone] = -1
        s["bank_planeid"][gone] = -1
    s["has_moved"] = True
    return dict(n_msckf_used=len(used), n_slam=int(s["slam_active"].sum()), n_slam_init=n_slam_init,
                n_slam_update=n_slam_update, n_clones=int(np.isfinite(s["clones_t"]).sum()),
                n_bank=int((fid >= 0).sum()))
