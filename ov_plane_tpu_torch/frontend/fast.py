"""FAST corner detection with grid selection over a leading stream dimension.

Counterpart of ``ov_plane_tpu/frontend/fast.py`` (the reference's FAST +
Grider_FAST, TrackPlane.cpp:1173-1297): the segment test runs on the 16
ring-shifted images, the score is the summed absolute difference to the
centre, and the grid keeps the strongest pixel of each free cell. Ties go
to the lower index everywhere, as ``jnp.argmax`` and ``jax.lax.top_k`` break
them: equal scores are common on 8-bit images.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

# Bresenham circle of radius 3 (OpenCV FAST-16 ring), (dy, dx).
_RING = (
    (-3, 0), (-3, 1), (-2, 2), (-1, 3), (0, 3), (1, 3), (2, 2), (3, 1),
    (3, 0), (3, -1), (2, -2), (1, -3), (0, -3), (-1, -3), (-2, -2), (-3, -1),
)


class FastOptions(NamedTuple):
    threshold: float = 15.0 / 255.0   # intensity threshold (images in [0,1])
    arc: int = 9                      # FAST-9
    grid_x: int = 20
    grid_y: int = 20
    max_features: int = 250


def _arc_bits(bits: torch.Tensor, arc: int) -> torch.Tensor:
    """True where the 16-bit ring mask holds a circular run of ``arc`` set bits."""
    run = bits | (bits << 16)                  # the ring twice: wrapped runs become plain runs
    doubled = run
    for j in range(1, arc):
        run = run & (doubled >> j)
    return (run & 0xFFFF) != 0


def fast_score_map(img: torch.Tensor, opts: FastOptions) -> torch.Tensor:
    """Per-pixel FAST corner score of [B, H, W] images (0 where not a corner).

    The score sums the 16 ring differences in ring order."""
    H, W = img.shape[-2:]
    x = F.pad(img[:, None], (3, 3, 3, 3), mode="replicate")[:, 0]
    hi = img + opts.threshold
    lo = img - opts.threshold
    brighter = torch.zeros(img.shape, dtype=torch.int64, device=img.device)
    darker = torch.zeros_like(brighter)
    score = None
    for k, (dy, dx) in enumerate(_RING):
        r = x[:, 3 + dy:3 + dy + H, 3 + dx:3 + dx + W]
        brighter |= (r > hi).to(torch.int64) << k
        darker |= (r < lo).to(torch.int64) << k
        d = torch.abs(r - img)
        score = d if score is None else score + d
    is_corner = _arc_bits(brighter, opts.arc) | _arc_bits(darker, opts.arc)
    yy = torch.arange(H, device=img.device)[:, None]
    xx = torch.arange(W, device=img.device)[None, :]
    inside = (yy >= 4) & (yy < H - 4) & (xx >= 4) & (xx < W - 4)
    return torch.where(is_corner & inside, score, torch.zeros_like(score))


def detect_grid(img: torch.Tensor, occupied_uv: torch.Tensor, occupied_mask: torch.Tensor,
                opts: FastOptions, h: int, w: int):
    """Up to max_features corners, one per grid cell, away from the occupied
    cells (existing tracks), strongest first.

    img [B, h, w]; occupied_uv [B, O, 2]; occupied_mask [B, O].
    Returns (uv [B, k, 2], valid [B, k]), k = min(max_features, cells)."""
    B = img.shape[0]
    score = fast_score_map(img, opts)
    gx, gy = opts.grid_x, opts.grid_y
    cw, ch = w / gx, h / gy
    occ_cx = torch.clamp((occupied_uv[..., 0] / cw).to(torch.int64), 0, gx - 1)
    occ_cy = torch.clamp((occupied_uv[..., 1] / ch).to(torch.int64), 0, gy - 1)
    occ = torch.zeros(B, gy * gx, dtype=torch.int32, device=img.device)
    occ = occ.scatter_reduce(1, occ_cy * gx + occ_cx, occupied_mask.to(torch.int32), reduce="amax")
    occ_cell = occ > 0                                                          # [B, gy*gx]

    # Per-cell argmax (the image cropped to whole cells).
    cellH, cellW = h // gy, w // gx
    s = score[:, :cellH * gy, :cellW * gx].reshape(B, gy, cellH, gx, cellW).permute(0, 1, 3, 2, 4)
    s = s.reshape(B, gy * gx, cellH * cellW)
    best = torch.argmax(s, dim=-1)                                              # first maximum
    best_score = s.gather(-1, best[..., None])[..., 0]
    cells = torch.arange(gy * gx, device=img.device)
    u = ((cells % gx) * cellW + best % cellW).to(score.dtype)
    v = ((cells // gx) * cellH + best // cellW).to(score.dtype)

    cand = torch.where(occ_cell | (best_score <= 0), torch.full_like(best_score, -1.0), best_score)
    k = min(opts.max_features, gy * gx)
    # Descending and stable: equal scores keep the lower cell first (top_k order).
    order_scores, order = torch.sort(cand, dim=-1, descending=True, stable=True)
    order_scores, order = order_scores[:, :k], order[:, :k]
    uv = torch.stack([u.gather(-1, order), v.gather(-1, order)], dim=-1)
    return uv, order_scores > 0
