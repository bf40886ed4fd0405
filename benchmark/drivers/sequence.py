"""Filter cells on simulated measurements: B Monte-Carlo streams of a
committed scene through the port's ``models.manager.step``, frame by frame,
as ``models.manager.run_sequence`` steps them. No images: the frontend is
bypassed.

Set-up draws the streams' IMU and pixel noise from the seed, casts them to
the config's type, and steps the config's warm-up frames; the window steps
the following frames. Where the scene ends inside the window, the streams
start it again from a fresh state (a new episode, not compared).

For the output check the run keeps, for a few streams drawn from the seed,
the program's whole filter state (means, covariance, track table) before
the first frame and after every frame of the first episode: device copies
of those rows, read back once the window has closed. The reference
(``references/sequence.py``) steps each of those frames again from the
program's state before it and is compared with the program's state after
it (:func:`compare`).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from common import check_sizes, sample_streams

COUNTERS = ("n_msckf_used", "n_slam", "n_slam_init", "n_slam_update", "n_clones", "n_bank")
STATE = ("t", "last_dt", "calib_dt", "startup_t", "imu", "imu_fej", "clones_q", "clones_p", "clones_q_fej",
         "clones_p_fej", "clones_t", "slam_p", "slam_p_fej", "slam_id", "slam_active", "slam_anchor_slot",
         "plane_cp", "cov")
BANK = ("fid", "uv", "mask", "planeid", "is_slam", "slam_slot")


def program_config(config: dict):
    """The program's configuration of this config file: the named
    configuration with the file's overrides, held to the file's sizes."""
    from ov_plane_tpu_torch.utils import config as pconfig

    cfg = getattr(pconfig, config["program_config"])()
    for key, value in config.get("program_overrides", {}).items():
        obj = cfg
        parts = key.split(".")
        for p in parts[:-1]:
            obj = getattr(obj, p)
        setattr(obj, parts[-1], value)
    check_sizes(cfg, config["sizes"])
    return cfg


class Run:
    def __init__(self, config: dict, traffic: dict, seed: int, device):
        from ov_plane_tpu_torch.models.manager import VioEngine

        from inputs import noisy_scene

        self.config, self.traffic, self.seed, self.device = config, traffic, seed, torch.device(device)
        self.B = traffic["batch"]
        self.cfg = program_config(config)
        self.eng = VioEngine.from_config(self.cfg, device=device)
        if self.eng.layout.dim != config["state_dim"]:
            raise RuntimeError(f"the program's state has {self.eng.layout.dim} dimensions, the config states "
                               f"{config['state_dim']}")
        self.dtype = dt = getattr(torch, config["dtype"])
        sc = noisy_scene(config, self.B, seed, device)
        # The program's inputs, in its type; the reference gets the same values in float64.
        self.sim = {k: (v.to(dt) if v.is_floating_point() else v) for k, v in sc.items()
                    if isinstance(v, torch.Tensor)}
        self.starts = np.asarray(sc["imu_window_start"])
        self.n_frames = min(self.sim["cam_t"].shape[0], 1 + traffic.get("scene_frames", self.sim["cam_t"].shape[0]))
        self.W = self.cfg.tpu.max_imu_per_frame
        self.sample = sample_streams(seed, self.B, traffic["sampled_streams"])
        self._S = torch.tensor(self.sample, device=self.device)
        self.episode = 0
        self.snaps: list[dict] = []
        self.counters: list[torch.Tensor] = []
        del sc
        self._new_episode()

    def _new_episode(self):
        from ov_plane_tpu_torch.models.feature_bank import FeatureBank
        from ov_plane_tpu_torch.models.manager import init_state_with_gt

        s, B = self.sim, self.B
        self.st = init_state_with_gt(self.eng, self.cfg, t0=s["cam_t_imu"][0].expand(B), q0=s["gt_q"][0].expand(B, 4),
                                     p0=s["gt_p"][0].expand(B, 3), v0=s["gt_v"][0].expand(B, 3),
                                     bg0=s["gt_bg_cam"][:, 0], ba0=s["gt_ba_cam"][:, 0], dtype=self.dtype,
                                     device=self.device)
        self.bank = FeatureBank.create(self.cfg.tpu.max_features, self.eng.layout.max_clones, B, self.dtype,
                                       self.device)
        self.frame = 1
        self.episode += 1
        if self.episode == 1:
            self._snapshot()

    def _snapshot(self):
        """The sampled streams' rows of the state and the track table (device copies)."""
        S = self._S
        snap = {k: getattr(self.st, k).index_select(0, S) for k in STATE}
        snap.update({"bank_" + k: getattr(self.bank, k).index_select(0, S) for k in BANK})
        self.snaps.append(snap)

    def _frame(self, i: int):
        from ov_plane_tpu_torch.models import manager

        s, B, W = self.sim, self.B, self.W
        k = self._window_start(i)
        return manager.FrameData(
            imu_t=s["imu_t"][k:k + W].expand(B, W), imu_w=s["imu_w"][:, k:k + W], imu_a=s["imu_a"][:, k:k + W],
            t_new=s["cam_t"][i].expand(B), obs_id=s["obs_id"][i].expand(B, -1), obs_uv=s["obs_uv"][:, i],
            obs_plane=s["obs_plane"][i].expand(B, -1))

    def _window_start(self, i: int) -> int:
        return int(min(max(int(self.starts[i]), 0), self.sim["imu_t"].shape[-1] - self.W))

    def step(self):
        """One frame of every stream, as ``run_sequence`` builds it."""
        from ov_plane_tpu_torch.models import manager

        if self.frame == self.n_frames:
            self._new_episode()
        i = self.frame
        self.frame += 1
        self.st, self.bank, out = manager.step(self.eng, self.st, self.bank, self._frame(i))
        if self.episode == 1 and len(self.snaps) <= self.config["compared_frames"]:
            self._snapshot()
            self.counters.append(torch.stack([getattr(out, c).index_select(0, self._S).to(torch.int64)
                                              for c in COUNTERS], 1))

    def recorded(self) -> dict:
        """The snapshots and counters on the host: snaps[f][field] [b, ...]
        (f = 0 before the first frame), counters [b, n, 6]."""
        snaps = [{k: v.cpu().numpy() for k, v in sn.items()} for sn in self.snaps]
        return dict(snaps=snaps, counters=torch.stack(self.counters, 1).cpu().numpy())

    def truncate(self, rec: dict, n: int) -> dict:
        rec["snaps"] = rec["snaps"][:n + 1]
        rec["counters"] = rec["counters"][:, :n]
        return rec

    def reference_frames(self) -> int:
        return len(self.counters)

    def reference_job(self, rec: dict, n_frames: int) -> tuple:
        """One job per sampled stream: the config file, the stream's inputs of
        frames 1..n (float64 images of what the program got) and the
        program's state before each of them."""
        s = self.sim
        jobs = []
        ids = s["obs_id"][1:n_frames + 1].cpu().numpy()
        cam_t = s["cam_t"][1:n_frames + 1].double().cpu().numpy()
        wins = [self._window_start(i) for i in range(1, n_frames + 1)]
        imu_t = torch.stack([s["imu_t"][k:k + self.W] for k in wins]).double().cpu().numpy()
        for j, b in enumerate(self.sample):
            imu_w = torch.stack([s["imu_w"][b, k:k + self.W] for k in wins]).double().cpu().numpy()
            imu_a = torch.stack([s["imu_a"][b, k:k + self.W] for k in wins]).double().cpu().numpy()
            uv = s["obs_uv"][b, 1:n_frames + 1].double().cpu().numpy()
            inputs = dict(imu_t=imu_t, imu_w=imu_w, imu_a=imu_a, cam_t=cam_t, obs_id=ids, obs_uv=uv,
                          truth0=dict(t=float(s["cam_t_imu"][0]), q=s["gt_q"][0].double().cpu().numpy(),
                                      p=s["gt_p"][0].double().cpu().numpy(), v=s["gt_v"][0].double().cpu().numpy(),
                                      bg=s["gt_bg_cam"][b, 0].double().cpu().numpy(),
                                      ba=s["gt_ba_cam"][b, 0].double().cpu().numpy()))
            pre = [{k: np.asarray(v[j], np.float64) if v.dtype.kind == "f" else np.array(v[j])
                    for k, v in sn.items()} for sn in rec["snaps"][:n_frames]]
            jobs.append((self.config, inputs, pre))
        return "sequence", jobs

    def free(self):
        for name in ("st", "bank", "sim", "eng", "_S", "snaps", "counters"):
            if hasattr(self, name):
                delattr(self, name)


def _state_delta(a: dict, b: dict, lay: dict):
    """Error-state difference a ⊖ b of two states of one stream over the
    parts alive in both (IMU, live clones, active landmarks), as (index in
    the error state, difference) arrays."""
    idx, d = [], []

    def dtheta(qa, qb):
        E = _rot(qa) @ _rot(qb).T
        return 0.5 * np.array([E[2, 1] - E[1, 2], E[0, 2] - E[2, 0], E[1, 0] - E[0, 1]])

    idx += list(range(0, 3))
    d += list(dtheta(a["imu"][0:4], b["imu"][0:4]))
    idx += list(range(3, 15))
    d += list(a["imu"][4:16] - b["imu"][4:16])
    live = np.isfinite(a["clones_t"]) & np.isfinite(b["clones_t"])
    for k in np.flatnonzero(live):
        c = lay["clone_base"] + 6 * k
        idx += list(range(c, c + 6))
        d += list(dtheta(a["clones_q"][k], b["clones_q"][k])) + list(a["clones_p"][k] - b["clones_p"][k])
    act = a["slam_active"] & b["slam_active"]
    for l in np.flatnonzero(act):
        c = lay["slam_base"] + 3 * l
        idx += list(range(c, c + 3))
        d += list(a["slam_p"][l] - b["slam_p"][l])
    return np.array(idx, int), np.array(d)


def _rot(q):
    qv, w = q[:3], q[3]
    n = math.sqrt(float(q @ q))
    qv, w = qv / n, w / n
    S = np.array([[0.0, -qv[2], qv[1]], [qv[2], 0.0, -qv[0]], [-qv[1], qv[0], 0.0]])
    return (2 * w * w - 1) * np.eye(3) - 2 * w * S + 2 * np.outer(qv, qv)


def _structure(s: dict) -> tuple:
    return (tuple(s["bank_fid"]), s["bank_mask"].tobytes(), tuple(s["bank_is_slam"]), tuple(s["slam_active"]),
            tuple(s["slam_id"]), tuple(np.isfinite(s["clones_t"])))


def _finite(s: dict) -> bool:
    return all(np.isfinite(s[k]).all() for k in ("imu", "cov", "clones_q", "clones_p", "slam_p"))


def compare(rec: dict, ref: list[dict], limits: dict, detail: dict | None = None) -> list[tuple]:
    """The sampled streams' states after each frame against the reference's
    step from the program's state before it: (name, value, limit) per number.

    * ``start_mismatch``: entries of the program's first state that differ
      from the truth the run started it from and the stated prior (the
      reference's own start);
    * ``track_input_mismatch``: observations in the program's track table
      that differ from the frame's input observation of that id;
    * ``decision_mismatch_pct``: % of stream-frames on which the two sides
      decided differently: a counter differs (MSCKF tracks used, landmarks,
      landmark inits and updates, clones, tracks), or the track table, the
      live landmarks or the live clones do, or the reference could take no
      step from the program's state;
    * ``state_gap_sigma``: over the other stream-frames, the largest
      error-state gap of the means (IMU, clones, landmarks) in standard
      deviations of the reference's posterior; inf where a program state is
      not finite;
    * ``cov_gap_rel``: over the same stream-frames, the largest covariance
      gap |ΔP_ij| / sqrt(P_ii P_jj).

    ``detail``, where given, gets each stream-frame's (frame, state gap,
    covariance gap, decided alike)."""
    gap = covg = 0.0
    n_sf = differ = start = track = 0
    for j, r in enumerate(ref):
        start += r["start_mismatch"]
        track += r["track_input_mismatch"]
        lay = r["layout"]
        for f, (want, wcnt) in enumerate(zip(r["post"], r["counters"])):
            got = {k: v[j] for k, v in rec["snaps"][f + 1].items()}
            n_sf += 1
            if not _finite(got):
                gap = covg = math.inf
            alike = want is not None and _structure(got) == _structure(want) and all(
                int(rec["counters"][j, f, c]) == wcnt[name] for c, name in enumerate(COUNTERS))
            if not alike:
                differ += 1
                if detail is not None:
                    detail.setdefault("frames", []).append((j, f + 1, None, None, False))
                continue
            idx, d = _state_delta(got, want, lay)
            P = want["cov"]
            g = np.abs(d) / np.sqrt(np.maximum(np.diag(P)[idx], 1e-300))
            g = float(g.max()) if np.isfinite(g).all() else math.inf
            Pw = P[np.ix_(idx, idx)]
            rel = np.abs(got["cov"][np.ix_(idx, idx)] - Pw) / np.sqrt(np.outer(np.diag(Pw), np.diag(Pw)) + 1e-300)
            c = float(rel.max()) if np.isfinite(rel).all() else math.inf
            gap, covg = max(gap, g), max(covg, c)
            if detail is not None:
                detail.setdefault("frames", []).append((j, f + 1, g, c, True))
    vals = dict(start_mismatch=start, track_input_mismatch=track, decision_mismatch_pct=100.0 * differ / max(n_sf, 1),
                state_gap_sigma=gap, cov_gap_rel=covg)
    return [(k, v, limits[k]) for k, v in vals.items()]
