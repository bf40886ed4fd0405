"""A copy of ``ov_plane_tpu/frontend/plane_track_batch.py`` (host numpy; the native
Delaunay comes from ``ov_plane_tpu_torch.native``). Times quoted below were
measured by the JAX package on its own host, not by the port.

Cross-stream batched host plane detector.

``PlaneTracker.update`` (``ov_plane_tpu/frontend/plane_track.py``, which
the port does not copy) is one stream's per-frame Delaunay
clustering — already vectorized *within* the frame, but at B=32 replay
streams the per-call python/numpy overhead (dozens of small GIL-holding array
ops + the python merge loop) costs ~2.5 ms/stream, and a thread pool cannot
scale it past ~79 ms/frame (measured round 4 on the device-resident bench:
host plane detection was the throughput wall at B=32).

Streams are independent, so every vectorized stage batches across them:
this class holds B trackers' state as stacked ``[B, cap, ...]`` arrays and
runs each stage as ONE numpy call over all streams — triangle gating/normals
``[B, T, ...]``, a single flat-key ring-buffer write for every stream's
normal histories, ``[B, N, N]`` pairwise matching — leaving only the
inherently sequential per-stream pieces (the C Delaunay call, which releases
the GIL and runs on a thread pool, and the ~N-iteration plane-merge loop) at
python level.

Semantics are EXACTLY ``PlaneTracker.update`` per stream — asserted
element-for-element against the JAX package's ``PlaneTracker`` in
tests/test_torch_frontend.py (at B = 1 too: the port's driver uses this
class for every batch size). Reference:
TrackPlane.cpp:580-1121 (perform_plane_detection_monocular).
"""

from __future__ import annotations

from typing import Dict, List, Set

import numpy as np

from ov_plane_tpu_torch import native
from ov_plane_tpu_torch.utils.config import TrackPlaneOptions


class PlaneTrackerBatch:
    def __init__(self, B: int, opts: TrackPlaneOptions = None, capacity: int = 512,
                 pool=None):
        self.opts = opts or TrackPlaneOptions()
        self.B = B
        self.capacity = capacity
        cap, H = capacity, max(self.opts.max_norm_count, 1)
        self._ids = np.full((B, cap), -1, np.int64)
        self._hist = np.zeros((B, cap, H, 3))
        self._hist_cnt = np.zeros((B, cap), np.int32)
        self._hist_ptr = np.zeros((B, cap), np.int32)
        self._plane = np.full((B, cap), -1, np.int64)
        self.curr_plane_id = np.zeros(B, np.int64)
        self.plane_to_oldplanes: List[Dict[int, Set[int]]] = [{} for _ in range(B)]
        self.last_timing: Dict = {}
        self._pool = pool            # optional ThreadPoolExecutor for delaunay

    # ------------------------------------------------------------------
    def feat_to_plane(self, s: int) -> Dict[int, int]:
        rows = np.nonzero((self._ids[s] >= 0) & (self._plane[s] >= 0))[0]
        return {int(self._ids[s, r]): int(self._plane[s, r]) for r in rows}

    def _rows_for(self, s: int, ids: np.ndarray) -> np.ndarray:
        """Per-stream id→row mapping with allocation (≡ PlaneTracker._rows_for)."""
        rows = np.full(len(ids), -1, np.int64)
        live = self._ids[s] >= 0
        order = np.argsort(self._ids[s][live])
        live_ids = self._ids[s][live][order]
        live_rows = np.nonzero(live)[0][order]
        pos = np.searchsorted(live_ids, ids)
        pos_ok = pos < len(live_ids)
        hit = np.zeros(len(ids), bool)
        hit[pos_ok] = live_ids[pos[pos_ok]] == ids[pos_ok]
        rows[hit] = live_rows[pos[hit]]
        need = np.nonzero(~hit)[0]
        free = np.nonzero(~live)[0]
        n = min(len(need), len(free))
        if n:
            r = free[:n]
            rows[need[:n]] = r
            self._ids[s, r] = ids[need[:n]]
            self._hist_cnt[s, r] = 0
            self._hist_ptr[s, r] = 0
            self._plane[s, r] = -1
        return rows

    def _avg_all(self):
        """Batched avg_norm over every stream's rows ([B, cap, 3], [B, cap])."""
        H = self._hist.shape[2]
        cnt = self._hist_cnt
        m = np.arange(H)[None, None, :] < cnt[:, :, None]
        s = np.sum(np.where(m[..., None], self._hist, 0.0), axis=2)
        n = np.linalg.norm(s, axis=2)
        ok = (n > 0) & (cnt >= 2)
        sbar = s / np.maximum(n, 1e-18)[..., None]
        cosang = np.clip(np.einsum("brhk,brk->brh", self._hist, sbar), -1.0, 1.0)
        degs = np.where(m, np.degrees(np.arccos(cosang)), 0.0)
        var = np.sum(degs**2, axis=2) / np.maximum(cnt - 1, 1)
        dmax = np.max(np.where(m, degs, -np.inf), axis=2, initial=-np.inf)
        ok &= (np.sqrt(var) <= self.opts.max_norm_avg_var) & (dmax <= self.opts.max_norm_avg_max)
        return np.where(ok[..., None], sbar, 0.0), ok

    # ------------------------------------------------------------------
    def update_batch(self, ids, uv, p_FinG, valid3d, R_GtoC, p_CinG):
        """One frame of plane detection for all B streams.

        ids [B, N] int; uv [B, N, 2]; p_FinG [B, N, 3]; valid3d [B, N] bool;
        R_GtoC [B, 3, 3]; p_CinG [B, 3]. Returns a list of B
        (feat_to_plane dict, plane_to_oldplanes dict-of-sets) pairs.
        """
        import time as _time

        B, cap = self.B, self.capacity
        ids = np.asarray(ids)
        uv = np.asarray(uv, float)
        p3 = np.asarray(p_FinG, float)
        valid3d = np.asarray(valid3d, bool)
        R_GtoC = np.asarray(R_GtoC, float)
        p_CinG = np.asarray(p_CinG, float)
        N = ids.shape[1]
        keep = (ids >= 0) & valid3d                      # [B, N]

        # ---- per-stream compaction + row allocation (sequential state) ----
        t0 = _time.perf_counter()
        sub_idx = [np.nonzero(keep[s])[0] for s in range(B)]
        Ns = np.array([len(ix) for ix in sub_idx])
        run = np.nonzero(Ns >= 3)[0]
        Nmax = int(Ns.max()) if len(run) else 0
        # Slot-aligned padded views [B, Nmax].
        sub_ids = np.full((B, max(Nmax, 1)), -1, np.int64)
        sub_uv = np.zeros((B, max(Nmax, 1), 2))
        sub_p = np.zeros((B, max(Nmax, 1), 3))
        rows = np.full((B, max(Nmax, 1)), -1, np.int64)
        smask = np.zeros((B, max(Nmax, 1)), bool)
        for s in run:
            # Streams with < 3 valid tracks take the serial tracker's early
            # return: no compaction, no row allocation (prune-only below).
            k = Ns[s]
            sub_ids[s, :k] = ids[s, sub_idx[s]]
            sub_uv[s, :k] = uv[s, sub_idx[s]]
            sub_p[s, :k] = p3[s, sub_idx[s]]
            smask[s, :k] = True
            rows[s, :k] = self._rows_for(s, sub_ids[s, :k])
        row_ok = (rows >= 0) & smask

        # ---- Delaunay per stream (C call releases the GIL; thread pool) ---
        def _tri(s):
            if s not in set(run):
                return np.zeros((0, 3), np.int64)
            return np.asarray(native.delaunay(sub_uv[s, :Ns[s]]), np.int64).reshape(-1, 3)

        if self._pool is not None and len(run) > 1:
            tris_l = list(self._pool.map(_tri, range(B)))
        else:
            tris_l = [_tri(s) for s in range(B)]
        Tmax = max((len(t) for t in tris_l), default=0)
        t1 = _time.perf_counter()

        merges_events: List[List] = [[] for _ in range(B)]
        if Tmax > 0:
            tris = np.zeros((B, Tmax, 3), np.int64)
            tmask = np.zeros((B, Tmax), bool)
            for s, t in enumerate(tris_l):
                if len(t):
                    tris[s, :len(t)] = t
                    tmask[s, :len(t)] = True

            a, b, c = tris[..., 0], tris[..., 1], tris[..., 2]
            # Adjacency [B, Nmax, Nmax] — built before the edge gate.
            adj = np.zeros((B, sub_ids.shape[1], sub_ids.shape[1]), bool)
            bi = np.repeat(np.arange(B)[:, None], Tmax, axis=1)
            for x, y in ((a, b), (b, a), (a, c), (c, a), (b, c), (c, b)):
                adj[bi[tmask], x[tmask], y[tmask]] = True

            ga = np.take_along_axis(sub_uv, a[..., None], axis=1)
            gb = np.take_along_axis(sub_uv, b[..., None], axis=1)
            gc = np.take_along_axis(sub_uv, c[..., None], axis=1)
            e01 = np.linalg.norm(ga - gb, axis=2)
            e12 = np.linalg.norm(gb - gc, axis=2)
            e20 = np.linalg.norm(gc - ga, axis=2)
            edge_ok = np.maximum(np.maximum(e01, e12), e20) <= self.opts.max_tri_side_px

            pa = np.take_along_axis(sub_p, a[..., None], axis=1)
            pb = np.take_along_axis(sub_p, b[..., None], axis=1)
            pc = np.take_along_axis(sub_p, c[..., None], axis=1)
            d1 = pb - pa
            d2 = pc - pa
            n1 = np.linalg.norm(d1, axis=2)
            n2 = np.linalg.norm(d2, axis=2)
            len_ok = (n1 > 0) & (n2 > 0)
            with np.errstate(all="ignore"):
                nrm = np.cross(d1 / np.maximum(n1, 1e-300)[..., None],
                               d2 / np.maximum(n2, 1e-300)[..., None])
            nn = np.linalg.norm(nrm, axis=2)
            tri_ok = tmask & edge_ok & len_ok & (nn > 0)
            nrm = nrm / np.maximum(nn, 1e-300)[..., None]
            # Sign: positive distance from the camera.
            p_FinC = np.einsum("bij,btj->bti", R_GtoC, pa - p_CinG[:, None, :])
            sgn = np.einsum("bti,bti->bt", np.einsum("btj,bij->bti", nrm, R_GtoC), p_FinC)
            nrm = np.where((sgn < 0)[..., None], -nrm, nrm)

            # ---- ring-buffer append, ONE flat-key pass over all streams ---
            v_rows_all = np.take_along_axis(rows, tris.reshape(B, -1), axis=1)  # [B, 3T]
            okv = np.repeat(tri_ok, 3, axis=1) & (v_rows_all >= 0)
            bsel, vsel = np.nonzero(okv)
            if len(bsel):
                v_norms = np.repeat(nrm, 3, axis=1)[bsel, vsel]     # [K, 3]
                flat = bsel * cap + v_rows_all[bsel, vsel]          # stream*cap+row
                order = np.argsort(flat, kind="stable")
                flat, v_norms = flat[order], v_norms[order]
                uniq, start, cnts = np.unique(flat, return_index=True,
                                              return_counts=True)
                offs = np.arange(len(flat)) - np.repeat(start, cnts)
                Hn = self._hist.shape[2]
                fb, fr = flat // cap, flat % cap
                wr = (self._hist_ptr[fb, fr] + offs) % Hn
                self._hist[fb, fr, wr] = v_norms
                ub, ur = uniq // cap, uniq % cap
                self._hist_ptr[ub, ur] = (self._hist_ptr[ub, ur] + cnts) % Hn
                self._hist_cnt[ub, ur] = np.minimum(self._hist_cnt[ub, ur] + cnts, Hn)

            # ---- pairwise matching (batched) + per-stream merge loop ------
            avg, avg_ok = self._avg_all()                           # [B,cap,3]
            rsafe = np.maximum(rows, 0)
            gavg = np.take_along_axis(avg, rsafe[..., None], axis=1)
            sub_avg = np.where(row_ok[..., None], gavg, 0.0)
            g_ok = np.take_along_axis(avg_ok, rsafe, axis=1)
            g_cnt = np.take_along_axis(self._hist_cnt, rsafe, axis=1)
            sub_ok = row_ok & g_ok & (g_cnt >= self.opts.min_norms)
            sub_d = np.einsum("bni,bni->bn", sub_p, sub_avg)
            px_d = np.linalg.norm(sub_uv[:, :, None, :] - sub_uv[:, None, :, :], axis=3)
            cosang = np.clip(np.einsum("bni,bmi->bnm", sub_avg, sub_avg), -1.0, 1.0)
            ang = np.degrees(np.arccos(cosang))
            z_d = np.abs(np.einsum("bmi,bni->bnm", sub_p, sub_avg) - sub_d[..., None])
            pair_ok = (sub_ok[:, None, :] & (px_d <= self.opts.max_pairwise_px)
                       & (ang < self.opts.max_norm_deg)
                       & (z_d < self.opts.max_dist_between_z) & adj)
            ii = np.arange(pair_ok.shape[1])
            pair_ok[:, ii, ii] = False

            for s in run:
                self._merge_stream(s, Ns[s], sub_ids[s], rows[s], sub_ok[s],
                                   pair_ok[s])
        t2 = _time.perf_counter()

        # ---- z-test filter + prune (per stream; tiny loops) --------------
        out = []
        k_nn = self.opts.filter_num_feat
        for s in range(B):
            if Ns[s] >= 3:
                plane_of = self._plane[s]
                rs = rows[s, :Ns[s]]
                sub_pid = np.where(rs >= 0, plane_of[np.maximum(rs, 0)], -1)
                for p in np.unique(sub_pid[sub_pid >= 0]):
                    members = np.nonzero((sub_pid == p) & (rs >= 0))[0]
                    if len(members) <= k_nn:
                        continue
                    pts = sub_p[s, members]
                    dmat = np.linalg.norm(pts[:, None, :] - pts[None, :, :], axis=2)
                    part = np.partition(dmat, kth=min(k_nn, len(members) - 1), axis=1)
                    avg_d = part[:, 1:k_nn + 1].mean(axis=1)
                    mu = avg_d.mean()
                    sd = np.sqrt(np.sum((avg_d - mu) ** 2) / (len(members) - 1))
                    if sd <= 0:
                        continue
                    bad = np.abs(avg_d - mu) / sd > self.opts.filter_z_thresh
                    plane_of[rs[members[bad]]] = -1
                self._prune(s, sub_ids[s, :Ns[s]])
            else:
                self._prune(s, ids[s][ids[s] >= 0])
            out.append((self.feat_to_plane(s),
                        {k2: set(v) for k2, v in self.plane_to_oldplanes[s].items()}))
        self.last_timing = {"delaunay": t1 - t0, "matching": t2 - t1,
                            "posttotal": _time.perf_counter() - t2}
        return out

    # ------------------------------------------------------------------
    def _merge_stream(self, s, n, sub_ids, rows, sub_ok, pair_ok):
        """≡ PlaneTracker.update's merge loop for stream s (ascending feature
        id ≡ the reference's std::map iteration)."""
        plane_of = self._plane[s]
        done = np.zeros(pair_ok.shape[0], bool)
        order = np.argsort(sub_ids[:n], kind="stable")
        p2o = self.plane_to_oldplanes[s]
        for k in order:
            if not sub_ok[k]:
                continue
            if not self.opts.check_old_feats and plane_of[rows[k]] >= 0:
                continue
            m = pair_ok[k] & ~done
            matches = np.nonzero(m)[0]
            if not len(matches):
                continue
            pids = plane_of[rows[matches]]
            pids = pids[pids >= 0]
            own = plane_of[rows[k]]
            cand = list(pids) + ([own] if own >= 0 else [])
            if cand:
                min_pid = int(min(cand))
                for old in {int(p) for p in cand if int(p) != min_pid}:
                    plane_of[plane_of == old] = min_pid
                    st = p2o.setdefault(min_pid, set())
                    st.add(old)
                    if old in p2o:
                        st.update(p2o.pop(old))
                plane_of[rows[matches]] = min_pid
                plane_of[rows[k]] = min_pid
                done[k] = True
            else:
                self.curr_plane_id[s] += 1
                plane_of[rows[matches]] = self.curr_plane_id[s]
                plane_of[rows[k]] = self.curr_plane_id[s]

    def _prune(self, s, active_ids):
        active_ids = np.asarray(active_ids, np.int64)
        live = self._ids[s] >= 0
        is_active = live & np.isin(self._ids[s], active_ids)
        self._plane[s][~is_active] = -1
        pl = self._plane[s]
        pids, cnts = np.unique(pl[pl >= 0], return_counts=True)
        weak = pids[cnts <= 3]
        if len(weak):
            pl[np.isin(pl, weak)] = -1
        keep_planes = set(int(p) for p in np.unique(pl[pl >= 0]))
        self.plane_to_oldplanes[s] = {
            p: st for p, st in self.plane_to_oldplanes[s].items() if p in keep_planes
        }
        drop = live & ~is_active & (pl < 0)
        self._ids[s][drop] = -1
        self._hist_cnt[s][drop] = 0
        self._hist_ptr[s][drop] = 0
