"""Image preprocessing: global histogram equalization and CLAHE.

Counterpart of ``ov_plane_tpu/frontend/imageproc.py`` over a leading stream
dimension: images are [B, H, W] floats in [0, 1]. The histograms and the
equalization tables are float32 whatever the image's type, as in the JAX
package; CLAHE interpolates between the tile tables in float32 too (its
weights are made in float64 and rounded, as JAX's weakly typed weights are)
and casts back to the image's type.
"""

from __future__ import annotations

import torch

NONE = 0
HISTOGRAM = 1
CLAHE = 2


def _cdf_map(hist: torch.Tensor, clip_limit: float | None = None) -> torch.Tensor:
    """Histograms [..., bins] -> equalization tables [..., bins] in [0, 1]."""
    if clip_limit is not None:
        excess = torch.clamp(hist - clip_limit, min=0.0).sum(dim=-1, keepdim=True)
        hist = torch.clamp(hist, max=clip_limit) + excess / hist.shape[-1]
    cdf = torch.cumsum(hist, dim=-1)
    total = torch.clamp(cdf[..., -1:], min=1.0)
    first = torch.argmax((hist > 0).to(torch.int32), dim=-1, keepdim=True)
    cdf_min = cdf.gather(-1, first)
    return torch.clamp((cdf - cdf_min) / torch.clamp(total - cdf_min, min=1.0), 0.0, 1.0)


def _quantize(img: torch.Tensor, bins: int) -> torch.Tensor:
    return torch.clamp((img * (bins - 1)).to(torch.int64), 0, bins - 1)


def equalize_hist(img: torch.Tensor, bins: int = 256) -> torch.Tensor:
    """Global histogram equalization (cv::equalizeHist equivalent); float32 out."""
    B = img.shape[0]
    q = _quantize(img, bins).reshape(B, -1)
    hist = torch.zeros(B, bins, dtype=torch.float32, device=img.device)
    hist.scatter_add_(1, q, torch.ones_like(q, dtype=torch.float32))
    lut = _cdf_map(hist)
    return lut.gather(1, q).reshape(img.shape)


def clahe(img: torch.Tensor, tiles: int = 8, bins: int = 64, clip: float = 4.0) -> torch.Tensor:
    """Clip-limited adaptive histogram equalization (cv::CLAHE equivalent):
    per-tile clipped equalization tables, interpolated bilinearly per pixel
    between the four surrounding tile centres. Pixels beyond the tile grid
    keep their value."""
    B, H, W = img.shape
    th, tw = H // tiles, W // tiles
    Hc, Wc = th * tiles, tw * tiles
    dev = img.device
    q = _quantize(img[:, :Hc, :Wc], bins)                                   # [B, Hc, Wc]
    tq = q.reshape(B, tiles, th, tiles, tw).permute(0, 1, 3, 2, 4).reshape(B, tiles * tiles, th * tw)
    hists = torch.zeros(B, tiles * tiles, bins, dtype=torch.float32, device=dev)
    hists.scatter_add_(2, tq, torch.ones_like(tq, dtype=torch.float32))
    luts = _cdf_map(hists, clip * (th * tw) / bins).reshape(B, tiles * tiles * bins)

    f64 = torch.float64
    yy = (torch.arange(Hc, dtype=f64, device=dev) + 0.5) / th - 0.5
    xx = (torch.arange(Wc, dtype=f64, device=dev) + 0.5) / tw - 0.5
    y0 = torch.clamp(torch.floor(yy).to(torch.int64), 0, tiles - 1)
    x0 = torch.clamp(torch.floor(xx).to(torch.int64), 0, tiles - 1)
    y1 = torch.clamp(y0 + 1, 0, tiles - 1)
    x1 = torch.clamp(x0 + 1, 0, tiles - 1)
    fy = torch.clamp(yy - y0, 0.0, 1.0)[:, None]
    fx = torch.clamp(xx - x0, 0.0, 1.0)[None, :]
    f32 = torch.float32
    wy0, wy1, wx0, wx1 = (1 - fy).to(f32), fy.to(f32), (1 - fx).to(f32), fx.to(f32)

    def sample(ty, tx):
        idx = ((ty[:, None] * tiles + tx[None, :]) * bins)[None] + q        # [B, Hc, Wc]
        return luts.gather(1, idx.reshape(B, -1)).reshape(B, Hc, Wc)

    out = (sample(y0, x0) * wy0 * wx0 + sample(y0, x1) * wy0 * wx1
           + sample(y1, x0) * wy1 * wx0 + sample(y1, x1) * wy1 * wx1)
    res = img.clone()
    res[:, :Hc, :Wc] = out.to(img.dtype)
    return res


def preprocess(img: torch.Tensor, method: int) -> torch.Tensor:
    if method == HISTOGRAM:
        return equalize_hist(img)
    if method == CLAHE:
        return clahe(img)
    return img
