"""Static error-state layout for the EKF covariance (own copy of
``ov_plane_tpu/state/layout.py``).

The covariance of each stream is one fixed ``[D, D]`` block whose layout
never changes:

    [ imu(15) | dt(0|1) | cam_pose(0|6) | cam_intr(0|8) | clones(6K) | slam(3L) | planes(3P) ]

with fixed capacities K/L/P from the config. Slots are *recycled*:
marginalization zeroes a slot's rows/columns, delayed initialization writes
a fresh block into a free slot, and which slots are alive is carried in the
``VioState`` masks and timestamps. Fixed shapes keep every per-stream
decision a select, so a step never waits on the host.

Calibration blocks are allocated only when the corresponding ``do_calib_*``
flag is on (``calib_dt/calib_pose/calib_intr``); the uncalibrated error
state is D = 15 + 6K + 3L + 3P (93 for the slice configuration).

Error-state conventions match the reference (JPL, Trawny): pose error is
[δθ(3), δp(3)]; IMU block order [δθ, δp, δv, δbg, δba] (Propagator.cpp:369-373).
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class StateLayout:
    """Hashable static layout (engines built from it are cache keys)."""

    max_clones: int = 11
    max_slam: int = 25
    max_planes: int = 8
    # Calibration error-state blocks present? (match the do_calib_* config
    # flags; defaults keep the historical full layout).
    calib_dt: bool = True
    calib_pose: bool = True
    calib_intr: bool = True

    # -- index anchors ------------------------------------------------------
    IMU_TH: int = 0
    IMU_P: int = 3
    IMU_V: int = 6
    IMU_BG: int = 9
    IMU_BA: int = 12
    IMU_SIZE: int = 15

    @property
    def dt_idx(self) -> int:
        """Start of the time-offset column (valid only if calib_dt)."""
        return self.IMU_SIZE

    @property
    def cam_pose_idx(self) -> int:
        return self.IMU_SIZE + (1 if self.calib_dt else 0)

    @property
    def cam_intr_idx(self) -> int:
        return self.cam_pose_idx + (6 if self.calib_pose else 0)

    @property
    def clone_base(self) -> int:
        return self.cam_intr_idx + (8 if self.calib_intr else 0)

    def clone_idx(self, i: int) -> int:
        """Start column of clone slot i (6 wide: [δθ, δp])."""
        return self.clone_base + 6 * i

    @property
    def slam_base(self) -> int:
        return self.clone_base + 6 * self.max_clones

    def slam_idx(self, j: int) -> int:
        return self.slam_base + 3 * j

    @property
    def plane_base(self) -> int:
        return self.slam_base + 3 * self.max_slam

    def plane_idx(self, k: int) -> int:
        return self.plane_base + 3 * k

    @property
    def dim(self) -> int:
        return self.plane_base + 3 * self.max_planes
