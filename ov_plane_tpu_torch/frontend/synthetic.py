"""Synthetic camera frames of the simulator's room, rendered on the device.

Counterpart of ``render_frame_textured`` in ``ov_plane_tpu/frontend/
synthetic.py`` with ``blobs=False``, as the vision bench calls it: every
pixel's ray is cast against the room's planes, and the nearest hit gets
world-anchored procedural texture (three octaves of value noise, band-limited
by their on-screen cell size, plus sparse speckle dots). The numpy original
loops over planes and octaves on the host; here the same per-pixel math runs
as tensor operations on the image's device, in float64. The integer hashes
of the texture stay int64, as there. The blob overlay (``render_frame``)
belongs to the simulator's port (ROADMAP item 9c).
"""

from __future__ import annotations

import functools

import torch

from ov_plane_tpu_torch.ops import cams


@functools.lru_cache(maxsize=4)
def _pixel_bearings(zeta: tuple, wh: tuple, model: int, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """[H, W, 3] camera-frame bearings (x, y, 1) of every pixel through the
    full distortion model (Newton undistort). Pixel [v, u]'s centre is AT
    distorted image coordinate (u, v), the convention of the tracker and the
    measurement model."""
    w, h = wh
    vv, uu = torch.meshgrid(torch.arange(h, dtype=dtype, device=device),
                            torch.arange(w, dtype=dtype, device=device), indexing="ij")
    uv = torch.stack([uu, vv], dim=-1)
    uvn = cams.undistort(uv, torch.tensor(zeta, dtype=dtype, device=device), model)
    return torch.cat([uvn, torch.ones_like(uvn[..., :1])], dim=-1)


def _hash01(ix: torch.Tensor, iy: torch.Tensor, salt: int) -> torch.Tensor:
    """Integer lattice hash in [0, 1] (int64 arithmetic, as the numpy original)."""
    n = (ix.to(torch.int64) * 374761393 + iy.to(torch.int64) * 668265263 + salt * 1442695041) & 0x7FFFFFFF
    n = ((n ^ (n >> 13)) * 1274126177) & 0x7FFFFFFF
    return (n & 0xFFFF).to(torch.float64) / 65535.0


def _tiles(x0: torch.Tensor, y0: torch.Tensor):
    """The distinct lattice tiles among the integral coordinates (x0, y0)
    [N], as (tx, ty) [U] in their dtype, and each entry's index [N] into
    them: a hash of a tile is then drawn once per tile and gathered, the
    same values as drawn per pixel."""
    ix, iy = x0.to(torch.int64), y0.to(torch.int64)
    x_min, y_min = ix.min(), iy.min()
    span = iy.max() - y_min + 1
    tiles, inv = torch.unique((ix - x_min) * span + (iy - y_min), return_inverse=True)
    return (tiles // span + x_min).to(x0.dtype), (tiles % span + y_min).to(x0.dtype), inv


def _value_noise(s: torch.Tensor, t: torch.Tensor, cell: float, seed: int) -> torch.Tensor:
    """Smooth 2D value noise at world coords (s, t), one octave."""
    x = s / cell
    y = t / cell
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = x - x0
    fy = y - y0
    fx = fx * fx * (3 - 2 * fx)   # smoothstep
    fy = fy * fy * (3 - 2 * fy)
    tx, ty, inv = _tiles(x0, y0)
    v00 = _hash01(tx, ty, seed)[inv]
    v10 = _hash01(tx + 1, ty, seed)[inv]
    v01 = _hash01(tx, ty + 1, seed)[inv]
    v11 = _hash01(tx + 1, ty + 1, seed)[inv]
    return v00 * (1 - fx) * (1 - fy) + v10 * fx * (1 - fy) + v01 * (1 - fx) * fy + v11 * fx * fy


def _speckle(s: torch.Tensor, t: torch.Tensor, cell: float, seed: int, px_per_m: torch.Tensor,
             r_lo: float = 0.05, r_hi: float = 0.15) -> torch.Tensor:
    """World-anchored sparse speckle: at most one soft dot per cell×cell tile
    (present with p≈0.6) at a hash-jittered position, with a hash-drawn radius
    and signed contrast, faded out where its screen radius nears a pixel.
    Returns the additive intensity term."""
    def hashk(ix, iy, k):
        return _hash01(ix, iy, seed * 31 + k)

    x = s / cell
    y = t / cell
    x0, y0 = torch.floor(x), torch.floor(y)
    tx, ty, inv = _tiles(x0, y0)
    # A dot can spill into neighbour tiles: visit the 3×3 tile neighbourhood.
    # Its centre lies 0.15-0.85 into its tile and its radius is at most r_hi
    # cells, so it reaches r_hi − 0.15 cells into a neighbour: a neighbour is
    # visited at the pixels within that reach only (elsewhere its term is
    # exactly zero). Each tile's dot is drawn once and gathered to its pixels.
    reach = r_hi - 0.15 + 1e-6
    fx, fy = x - x0, y - y0
    near_x = {-1: fx < reach, 1: fx > 1.0 - reach}
    near_y = {-1: fy < reach, 1: fy > 1.0 - reach}

    def term(dx, dy, sel):
        k, xs, ys, ppm = (inv, x, y, px_per_m) if sel is None else (inv[sel], x[sel], y[sel], px_per_m[sel])
        ix = tx + dx
        iy = ty + dy
        present = (hashk(ix, iy, 0) < 0.6)[k]
        cx = (ix + 0.15 + 0.7 * hashk(ix, iy, 1))[k]
        cy = (iy + 0.15 + 0.7 * hashk(ix, iy, 2))[k]
        r = (r_lo + (r_hi - r_lo) * hashk(ix, iy, 3))[k]     # radius in cells
        amp = torch.where(hashk(ix, iy, 4) < 0.5, -0.35, 0.35)[k]
        d2 = (xs - cx) ** 2 + (ys - cy) ** 2
        e = torch.clamp((r - torch.sqrt(d2)) / (0.3 * r + 1e-9), 0.0, 1.0)
        r_px = r * cell * ppm
        w_o = torch.clamp((r_px - 1.0) / 1.5, 0.0, 1.0)
        return torch.where(present, amp * e * e * (3 - 2 * e) * w_o, 0.0)

    out = torch.zeros_like(s)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if dx == 0 and dy == 0:
                out = out + term(0, 0, None)
                continue
            mask = near_x[dx] if dy == 0 else near_y[dy] if dx == 0 else near_x[dx] & near_y[dy]
            sel = mask.nonzero(as_tuple=True)[0]
            out[sel] = out[sel] + term(dx, dy, sel)
    return out


def render_frame_textured(plane_corners, plane_normal, plane_d, R_GtoI, p_IinG, R_ItoC, p_IinC, zeta, wh,
                          model=cams.RADTAN, texture_cell: float = 0.22, seed: int = 0,
                          speckle_cells: tuple = (0.15,)) -> torch.Tensor:
    """[H, W] float32 image in [0, 1] of the cuboid room from the camera pose
    (R_GtoI, p_IinG) with extrinsics (R_ItoC, p_IinC) and intrinsics zeta:
    the JAX function with ``blobs=False`` (its other arguments serve the
    blob overlay).

    plane_corners [P, 4, 3] (tl, tr, bl, br), plane_normal [P, 3], plane_d
    [P] with n·x = d: tensors on the device to render on. Each entry of
    ``speckle_cells`` is a speckle layer: a cell size (dot radii 0.05-0.15
    of the cell) or a tuple (cell, r_lo, r_hi)."""
    f64 = torch.float64
    dev = plane_corners.device
    t64 = lambda a: torch.as_tensor(a, dtype=f64, device=dev)  # noqa: E731
    corners, normal, d = t64(plane_corners), t64(plane_normal), t64(plane_d)
    R_GtoI, p_IinG, R_ItoC, p_IinC = t64(R_GtoI), t64(p_IinG), t64(R_ItoC), t64(p_IinC)
    zeta_t = tuple(float(z) for z in (zeta.tolist() if hasattr(zeta, "tolist") else zeta))
    w, h = wh
    bear_c = _pixel_bearings(zeta_t, (int(w), int(h)), int(model), f64, dev)       # [H, W, 3]
    R_GtoC = R_ItoC @ R_GtoI
    c_G = p_IinG - R_GtoC.T @ p_IinC                                                 # camera centre
    dir_G = bear_c @ R_GtoC                                                          # [H, W, 3]

    tl = corners[:, 0]
    e1 = corners[:, 1] - tl                                                          # tl→tr
    e2 = corners[:, 2] - tl                                                          # tl→bl
    l1 = torch.linalg.vector_norm(e1, dim=1)
    l2 = torch.linalg.vector_norm(e2, dim=1)
    e1u = e1 / l1[:, None]
    e2u = e2 / l2[:, None]
    f_px = 0.5 * (zeta_t[0] + zeta_t[1])

    best_t = torch.full((int(h), int(w)), float("inf"), dtype=f64, device=dev)
    tex = torch.full((int(h), int(w)), 0.35, dtype=torch.float32, device=dev)
    for p in range(corners.shape[0]):
        n = normal[p]
        denom = dir_G @ n
        denom = torch.where(torch.abs(denom) < 1e-9, 1e-9, denom)
        t_hit = (d[p] - c_G @ n) / denom
        rel = c_G + t_hit[..., None] * dir_G - tl[p]
        s_c = rel @ e1u[p]
        t_c = rel @ e2u[p]
        hit = ((t_hit > 0.05) & (s_c >= 0) & (s_c <= l1[p]) & (t_c >= 0) & (t_c <= l2[p]) & (t_hit < best_t))
        # The texture is computed at the hit pixels only (one read of the
        # device per plane, outside any filter step); a plane out of view is
        # skipped, as in the numpy original.
        sel = hit.nonzero(as_tuple=True)
        if sel[0].numel() == 0:
            continue
        t_hit, s_c, t_c = t_hit[sel], s_c[sel], t_c[sel]
        # Three octaves, each faded out as its on-screen cell nears the pixel pitch.
        cell_px_1 = texture_cell * f_px / torch.clamp(t_hit, min=0.05)
        octs = None
        wsum = torch.zeros_like(t_hit)
        for scale_o, amp_o, ds in ((1.0, 0.5, 0), (0.31, 0.3, 7), (0.093, 0.2, 11)):
            w_o = amp_o * torch.clamp((cell_px_1 * scale_o - 2.0) / 3.0, 0.0, 1.0)
            o = w_o * _value_noise(s_c, t_c, texture_cell * scale_o, seed + 13 * p + ds)
            octs = o if octs is None else octs + o
            wsum = wsum + w_o
        val = 0.18 + 0.55 * octs / torch.clamp(wsum, min=1e-6)
        px_per_m = f_px / torch.clamp(t_hit, min=0.05)
        for si, sc in enumerate(speckle_cells):
            cell_s, r_lo, r_hi = sc if isinstance(sc, (tuple, list)) else (sc, 0.05, 0.15)
            val = val + _speckle(s_c, t_c, cell_s, seed + 29 * p + 5 + 17 * si, px_per_m, r_lo=r_lo, r_hi=r_hi)
        best_t[sel] = t_hit
        tex[sel] = torch.clamp(val, 0.02, 1.0).to(torch.float32)
    return torch.clamp(tex, 0.0, 1.0)
