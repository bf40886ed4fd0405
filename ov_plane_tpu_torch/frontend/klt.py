"""Pyramidal Lucas-Kanade feature tracking over a leading stream dimension.

Counterpart of ``ov_plane_tpu/frontend/klt.py`` (the reference's
``calcOpticalFlowPyrLK`` use, TrackPlane.cpp:1299-1357). Images are
[B, H, W] floats in [0, 1]; points [B, N, 2] pixels (x, y).

Patch sampling is one gather of each patch's (2w+2)² support from the
edge-padded image, then a bilinear blend. Two samplers:

* ``'slice'`` and ``'mm'``: the exact bilinear blend in the image's type
  (the JAX ``_bilinear_patch``; its ``'mm'`` one-hot GEMM form computes the
  same function);
* ``'mm_bf16'``: the roundings of the JAX bf16 one-hot GEMMs
  (``klt.py:135-210``) reproduced on the gathered support: the image and
  the weights rounded to bf16, ``1 − f`` taken in bf16, the two taps of each
  row blend summed in f32 and rounded to bf16, then the two taps of the
  column blend summed in f32.

Gather indices are clipped into the padded image as the JAX package clips
them, so every index is in range by construction.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F


class KltOptions(NamedTuple):
    levels: int = 4
    window: int = 10          # half-window (patch = (2w+1)²)
    iters: int = 15
    min_eig: float = 1e-4     # G conditioning gate
    fb_thresh: float = 1.5    # forward-backward px gate (at level 0)
    max_err: float = 0.20     # mean abs photometric residual gate
    fb_check: bool = True
    sampler: str = "slice"    # 'slice', 'mm' (both exact) or 'mm_bf16'


SAMPLERS = ("slice", "mm", "mm_bf16")


def _pad_replicate(img: torch.Tensor, p: int) -> torch.Tensor:
    """Edge-replicate pad of [B, H, W] by p on every side."""
    return F.pad(img[:, None], (p, p, p, p), mode="replicate")[:, 0]


def pyr_down(img: torch.Tensor) -> torch.Tensor:
    """5-tap Gaussian blur + 2x decimation (cv::pyrDown equivalent), as
    shifted-slice sums: rows first, then columns."""
    k = (1.0 / 16.0, 4.0 / 16.0, 6.0 / 16.0, 4.0 / 16.0, 1.0 / 16.0)
    x = _pad_replicate(img, 2)
    x = k[0] * x[..., :-4] + k[1] * x[..., 1:-3] + k[2] * x[..., 2:-2] + k[3] * x[..., 3:-1] + k[4] * x[..., 4:]
    x = (k[0] * x[..., :-4, :] + k[1] * x[..., 1:-3, :] + k[2] * x[..., 2:-2, :] + k[3] * x[..., 3:-1, :]
         + k[4] * x[..., 4:, :])
    return x[..., ::2, ::2]


def build_pyramid(img: torch.Tensor, levels: int) -> list[torch.Tensor]:
    """[B, H, W] -> the list of [B, H/2^l, W/2^l] levels."""
    pyr = [img]
    for _ in range(levels - 1):
        pyr.append(pyr_down(pyr[-1]))
    return pyr


def scharr_gradients(img: torch.Tensor):
    """3×3 Scharr x/y gradients (normalized by 32) of an edge-padded image."""
    x = _pad_replicate(img, 1)
    H, W = img.shape[-2:]

    def at(dy, dx):
        return x[..., dy:dy + H, dx:dx + W]

    a, c = 3.0 / 32.0, 10.0 / 32.0
    gx = (-a * at(0, 0) + a * at(0, 2) - c * at(1, 0) + c * at(1, 2) - a * at(2, 0) + a * at(2, 2))
    gy = (-a * at(0, 0) - c * at(0, 1) - a * at(0, 2) + a * at(2, 0) + c * at(2, 1) + a * at(2, 2))
    return gx, gy


def pad_edge(img: torch.Tensor, w: int) -> torch.Tensor:
    """Edge-replicate pad by w+1 so every patch support stays in bounds."""
    return _pad_replicate(img, w + 1)


class PreparedPyramid(NamedTuple):
    """Edge-padded pyramid levels [B, Hp, Wp] and their padded Scharr
    gradients, computed once per frame and reused as the template side of
    the next frame's track call."""

    padded: tuple
    grads: tuple   # per level (gx_padded, gy_padded)


def prepare_pyramid(pyr, window: int) -> PreparedPyramid:
    return PreparedPyramid(tuple(pad_edge(img, window) for img in pyr),
                           tuple(tuple(pad_edge(g, window) for g in scharr_gradients(img)) for img in pyr))


def _floor_index(x: torch.Tensor) -> torch.Tensor:
    """int64 floor of x, with NaN taken as 0 and magnitudes capped (the
    index is clipped into the image afterwards, as the JAX package clips)."""
    return torch.nan_to_num(torch.floor(x), nan=0.0).clamp(-1e9, 1e9).to(torch.int64)


def sample_patches(padded: torch.Tensor, centers: torch.Tensor, w: int, sampler: str) -> torch.Tensor:
    """Bilinear [2w+1]² patches at fractional centers.

    padded [B, C, Hp, Wp] (levels padded by ``pad_edge``); centers [B, N, 2].
    Returns [B, C, N, P, P] in the padded images' type (float32 for
    ``'mm_bf16'``)."""
    B, C, Hp, Wp = padded.shape
    N = centers.shape[1]
    P = 2 * w + 1
    S = P + 1
    x, y = centers[..., 0], centers[..., 1]
    x0, y0 = torch.floor(x), torch.floor(y)
    # Original pixel (r, c) lives at padded[r + w + 1, c + w + 1]; the support
    # starts at original (y0 - w, x0 - w) -> padded (y0 + 1, x0 + 1).
    xi = torch.clamp(_floor_index(x) + 1, 0, Wp - S)
    yi = torch.clamp(_floor_index(y) + 1, 0, Hp - S)
    ar = torch.arange(S, device=padded.device)
    idx = (yi[..., None, None] + ar[:, None]) * Wp + (xi[..., None, None] + ar[None, :])     # [B, N, S, S]
    raw = padded.reshape(B, C, Hp * Wp).gather(2, idx.reshape(B, 1, N * S * S).expand(B, C, N * S * S))
    raw = raw.reshape(B, C, N, S, S)
    if sampler == "mm_bf16":
        bf = torch.bfloat16
        img = raw.to(bf).float()
        fx = (x - x0).to(bf)[:, None, :, None, None]
        fy = (y - y0).to(bf)[:, None, :, None, None]
        rows = (1.0 - fy).float() * img[..., :-1, :] + fy.float() * img[..., 1:, :]       # [B, C, N, P, S]
        rows = rows.to(bf).float()
        return (1.0 - fx).float() * rows[..., :-1] + fx.float() * rows[..., 1:]
    if sampler not in ("slice", "mm"):
        raise NotImplementedError(f"KLT sampler {sampler!r} is not ported (the rowmm* variants are a "
                                  "later item of ROADMAP.md)")
    fx = (x - x0).to(raw.dtype)[:, None, :, None, None]
    fy = (y - y0).to(raw.dtype)[:, None, :, None, None]
    a, b = raw[..., :-1, :-1], raw[..., :-1, 1:]
    c, d = raw[..., 1:, :-1], raw[..., 1:, 1:]
    return a * (1 - fx) * (1 - fy) + b * fx * (1 - fy) + c * (1 - fx) * fy + d * fx * fy


def track_level(img0, gx0, gy0, img1, pts0, guess, opts: KltOptions):
    """All features of all streams at one pyramid level: (flow, ok, err).

    A patch below the min-eig gate keeps its incoming guess; a divergent
    Newton step (non-finite, or longer than the patch) halts that feature's
    iteration (``active`` is a mask: every feature runs ``opts.iters``
    iterations)."""
    w = opts.window
    tpl = sample_patches(torch.stack([img0, gx0, gy0], dim=1), pts0, w, opts.sampler)
    t_patch, gx_p, gy_p = tpl[:, 0], tpl[:, 1], tpl[:, 2]            # [B, N, P, P]
    gxx = (gx_p * gx_p).sum(dim=(-2, -1))
    gxy = (gx_p * gy_p).sum(dim=(-2, -1))
    gyy = (gy_p * gy_p).sum(dim=(-2, -1))
    det = gxx * gyy - gxy * gxy
    min_eig = 0.5 * (gxx + gyy - torch.sqrt((gxx - gyy) ** 2 + 4 * gxy**2))
    n_px = (2 * w + 1) ** 2
    ok = min_eig / n_px > opts.min_eig
    det_s = torch.where(torch.abs(det) < 1e-12, torch.full_like(det, 1e-12), det)
    max_step2 = float(2 * w + 1) ** 2
    img1s = img1[:, None]
    flow, active = guess, ok
    for _ in range(opts.iters):
        cur = sample_patches(img1s, pts0 + flow, w, opts.sampler)[:, 0]
        di = cur - t_patch
        bx = (di * gx_p).sum(dim=(-2, -1))
        by = (di * gy_p).sum(dim=(-2, -1))
        delta = torch.stack([(gyy * bx - gxy * by) / det_s, (-gxy * bx + gxx * by) / det_s], dim=-1)
        step_ok = torch.isfinite(delta).all(dim=-1) & ((delta * delta).sum(dim=-1) <= max_step2)
        active = active & step_ok
        flow = torch.where(active[..., None], flow - delta, flow)
    final = sample_patches(img1s, pts0 + flow, w, opts.sampler)[:, 0]
    err = torch.abs(final - t_patch).mean(dim=(-2, -1))
    return flow, ok, err


def _run(prep_a: PreparedPyramid, prep_b: PreparedPyramid, pts, flow, opts: KltOptions):
    ok = err = None
    for lvl in range(len(prep_a.padded) - 1, -1, -1):
        scale = 2.0**lvl
        gx0, gy0 = prep_a.grads[lvl]
        f_l, ok, err = track_level(prep_a.padded[lvl], gx0, gy0, prep_b.padded[lvl], pts / scale,
                                   flow / scale, opts)
        flow = f_l * scale
    # Validity gates on the finest level only (calcOpticalFlowPyrLK semantics).
    return pts + flow, ok, err


def track(prep0: PreparedPyramid, prep1: PreparedPyramid, pts0: torch.Tensor, mask: torch.Tensor,
          opts: KltOptions, init_flow: torch.Tensor | None = None):
    """Track pts0 [B, N, 2] from pyramid 0 to pyramid 1 (both prepared).
    Returns (pts1 [B, N, 2], ok [B, N]). ``init_flow`` [B, N, 2] is a
    per-feature flow prior (the gyro-predicted motion)."""
    w = opts.window
    if init_flow is None:
        init_flow = torch.zeros_like(pts0)
    p1, ok_f, err_f = _run(prep0, prep1, pts0, init_flow, opts)
    H = prep0.padded[0].shape[-2] - 2 * (w + 1)
    W = prep0.padded[0].shape[-1] - 2 * (w + 1)
    in_bounds = (p1[..., 0] >= 1) & (p1[..., 0] < W - 1) & (p1[..., 1] >= 1) & (p1[..., 1] < H - 1)
    ok = mask & ok_f & (err_f < opts.max_err) & in_bounds
    if opts.fb_check:
        p_back, ok_b, _ = _run(prep1, prep0, p1, -init_flow, opts)
        fb = torch.sqrt(((p_back - pts0) ** 2).sum(dim=-1))
        ok = ok & ok_b & (fb < opts.fb_thresh)
    return p1, ok
