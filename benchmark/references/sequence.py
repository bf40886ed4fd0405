"""The reference of a filter cell on simulated measurements, for one sampled
stream: each compared frame stepped by the plain filter
(``references/plain_filter.py``, NumPy float64) from the program's state
before it, on the frame's inputs; and the two things such a step takes on
trust checked by themselves: the program's first state against the truth
the run started it from, and the observations in the program's track table
against the inputs."""

from __future__ import annotations

import copy

import numpy as np

from references import plain_filter as pf


def _start_mismatch(s: dict, o: pf.Options, truth: dict, prior: dict) -> int:
    """Entries of the first state that differ from the truth and the stated
    prior (compared in the program's type: both sides hold its roundings)."""
    f32 = np.float32
    want_imu = np.concatenate([truth[k] for k in ("q", "p", "v", "bg", "ba")]).astype(f32)
    sig = [prior["ori"]] * 3 + [prior["pos"]] * 3 + [prior["vel"]] * 3 + [prior["bg"]] * 3 + [prior["ba"]] * 3
    P = np.zeros((o.D, o.D), f32)
    P[range(15), range(15)] = (np.array(sig) ** 2).astype(f32)
    n = int((s["imu"].astype(f32) != want_imu).sum() + (s["imu_fej"].astype(f32) != want_imu).sum())
    n += int((s["cov"].astype(f32) != P).sum())
    n += int(f32(s["t"]) != f32(truth["t"])) + int(f32(s["startup_t"]) != f32(truth["t"]))
    n += int(np.isfinite(s["clones_t"]).sum() + s["slam_active"].sum() + (s["bank_fid"] >= 0).sum())
    return n


def _track_mismatch(s: dict, frame_of: dict, inputs: dict) -> int:
    """Observations in the track table that are not the input observation
    of their id in the frame of their clone."""
    n = 0
    for k in np.flatnonzero(np.isfinite(s["clones_t"])):
        i = frame_of.get(np.float32(s["clones_t"][k]))
        for r in np.flatnonzero(s["bank_mask"][:, k]):
            if i is None:
                n += 1
                continue
            hit = np.flatnonzero(inputs["obs_id"][i] == s["bank_fid"][r])
            n += int(not len(hit) or not np.array_equal(s["bank_uv"][r, k], inputs["obs_uv"][i, hit[0]]))
    return n


def _plain(sn: dict) -> dict:
    out = {}
    for k, v in sn.items():
        v = np.array(v)
        out[k] = float(v) if v.ndim == 0 and v.dtype.kind == "f" else v
    return out


def run(config: dict, inputs: dict, pre: list) -> dict:
    """pre[f]: the program's state of this stream before frame f + 1 (numpy,
    floats as float64). Returns the reference's state after each frame, its
    counters (None for a frame whose step could not be taken), the layout,
    and the two mismatch counts."""
    o = pf.Options(config)
    frame_of = {np.float32(t): i for i, t in enumerate(inputs["cam_t"])}
    start = _start_mismatch(_plain(pre[0]), o, inputs["truth0"], config["prior_sigma"])
    track = sum(_track_mismatch(_plain(sn), frame_of, inputs) for sn in pre)
    post, counters = [], []
    for f, sn in enumerate(pre):
        s = copy.deepcopy(_plain(sn))
        try:
            c = pf.step(s, o, inputs["imu_t"][f], inputs["imu_w"][f], inputs["imu_a"][f], float(inputs["cam_t"][f]),
                        inputs["obs_id"][f], inputs["obs_uv"][f])
        except (np.linalg.LinAlgError, ValueError, FloatingPointError):
            s, c = None, None           # no step from this state (a program state that is not finite)
        post.append(s)
        counters.append(c)
    return dict(post=post, counters=counters, start_mismatch=start, track_input_mismatch=track,
                layout=dict(clone_base=o.clone_base, slam_base=o.slam_base))
