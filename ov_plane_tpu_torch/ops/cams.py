"""Camera projection/distortion models: radtan and equidistant fisheye.

Counterpart of ``ov_plane_tpu/ops/cams.py``. A camera is its parameter vector
``zeta = [fx, fy, cx, cy, d0..d3]`` plus a static model tag. The JAX package
takes the distortion Jacobians from ``jax.jacfwd``; here they are written in
closed form. Every function broadcasts over leading dimensions: ``uv_norm``
is ``[..., 2]`` and ``zeta`` is ``[..., 8]`` with broadcastable leading dims.
"""

from __future__ import annotations

import torch

RADTAN = 0
EQUI = 1


def _equi_terms(x, y, zeta):
    r = torch.sqrt(x * x + y * y)
    small = r < 1e-8
    r_s = torch.where(small, torch.ones_like(r), r)
    theta = torch.atan(r_s)
    t2 = theta * theta
    k1, k2, k3, k4 = zeta[..., 4], zeta[..., 5], zeta[..., 6], zeta[..., 7]
    poly = 1.0 + k1 * t2 + k2 * t2**2 + k3 * t2**3 + k4 * t2**4
    theta_d = theta * poly
    scale = torch.where(small, torch.ones_like(r), theta_d / r_s)
    return r_s, small, theta, t2, theta_d, scale


def distort_norm(uv_norm: torch.Tensor, zeta: torch.Tensor, model: int) -> torch.Tensor:
    """Normalized coordinates -> distorted pixels. [..., 2], [..., 8] -> [..., 2]."""
    x, y = uv_norm[..., 0], uv_norm[..., 1]
    fx, fy, cx, cy = zeta[..., 0], zeta[..., 1], zeta[..., 2], zeta[..., 3]
    if model == RADTAN:
        k1, k2, p1, p2 = zeta[..., 4], zeta[..., 5], zeta[..., 6], zeta[..., 7]
        r2 = x * x + y * y
        radial = 1.0 + k1 * r2 + k2 * r2 * r2
        xd = x * radial + 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
        yd = y * radial + p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
    elif model == EQUI:
        scale = _equi_terms(x, y, zeta)[-1]
        xd, yd = x * scale, y * scale
    else:
        raise ValueError(f"unknown camera model {model}")
    return torch.stack([fx * xd + cx, fy * yd + cy], dim=-1)


def distort_jacobians(uv_norm: torch.Tensor, zeta: torch.Tensor, model: int):
    """Return (uv_dist [..., 2], d uv/d uv_norm [..., 2, 2], d uv/d zeta [..., 2, 8])."""
    x, y = uv_norm[..., 0], uv_norm[..., 1]
    x, y = torch.broadcast_tensors(x, y, zeta[..., 0])[:2]
    fx, fy = zeta[..., 0].expand_as(x), zeta[..., 1].expand_as(x)
    one, zero = torch.ones_like(x), torch.zeros_like(x)
    if model == RADTAN:
        k1, k2, p1, p2 = zeta[..., 4], zeta[..., 5], zeta[..., 6], zeta[..., 7]
        r2 = x * x + y * y
        radial = 1.0 + k1 * r2 + k2 * r2 * r2
        xd = x * radial + 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
        yd = y * radial + p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
        drad = k1 + 2.0 * k2 * r2                      # d radial / d r2
        dxd_dx = radial + 2.0 * x * x * drad + 2.0 * p1 * y + 6.0 * p2 * x
        dxd_dy = 2.0 * x * y * drad + 2.0 * p1 * x + 2.0 * p2 * y
        dyd_dx = 2.0 * x * y * drad + 2.0 * p1 * x + 2.0 * p2 * y
        dyd_dy = radial + 2.0 * y * y * drad + 6.0 * p1 * y + 2.0 * p2 * x
        du_dd = [fx * x * r2, fx * x * r2 * r2, fx * 2.0 * x * y, fx * (r2 + 2.0 * x * x)]
        dv_dd = [fy * y * r2, fy * y * r2 * r2, fy * (r2 + 2.0 * y * y), fy * 2.0 * x * y]
    elif model == EQUI:
        r_s, small, theta, t2, theta_d, scale = _equi_terms(x, y, zeta)
        k1, k2, k3, k4 = zeta[..., 4], zeta[..., 5], zeta[..., 6], zeta[..., 7]
        dthd_dr = (1.0 + 3.0 * k1 * t2 + 5.0 * k2 * t2**2 + 7.0 * k3 * t2**3
                   + 9.0 * k4 * t2**4) / (1.0 + r_s * r_s)
        ds_dr = torch.where(small, zero, (dthd_dr * r_s - theta_d) / (r_s * r_s))
        g = ds_dr / r_s                                 # d scale/dx = g·x
        xd, yd = x * scale, y * scale
        dxd_dx = scale + x * x * g
        dxd_dy = x * y * g
        dyd_dx = x * y * g
        dyd_dy = scale + y * y * g
        base = torch.where(small, zero, theta / r_s)
        pw = [base * t2, base * t2**2, base * t2**3, base * t2**4]
        du_dd = [fx * x * p for p in pw]
        dv_dd = [fy * y * p for p in pw]
    else:
        raise ValueError(f"unknown camera model {model}")
    uv = torch.stack([fx * xd + zeta[..., 2], fy * yd + zeta[..., 3]], dim=-1)
    dz_dzn = torch.stack([
        torch.stack([fx * dxd_dx, fx * dxd_dy], dim=-1),
        torch.stack([fy * dyd_dx, fy * dyd_dy], dim=-1),
    ], dim=-2)
    dz_dzeta = torch.stack([
        torch.stack([xd, zero, one, zero, *du_dd], dim=-1),
        torch.stack([zero, yd, zero, one, *dv_dd], dim=-1),
    ], dim=-2)
    return uv, dz_dzn, dz_dzeta


def undistort(uv_dist: torch.Tensor, zeta: torch.Tensor, model: int, iters: int = 20) -> torch.Tensor:
    """Distorted pixels -> normalized coordinates by fixed-iteration Newton."""
    fx, fy, cx, cy = zeta[..., 0], zeta[..., 1], zeta[..., 2], zeta[..., 3]
    x = torch.stack([(uv_dist[..., 0] - cx) / fx, (uv_dist[..., 1] - cy) / fy], dim=-1)
    for _ in range(iters):
        uv, J, _ = distort_jacobians(x, zeta, model)
        f = uv - uv_dist
        det = J[..., 0, 0] * J[..., 1, 1] - J[..., 0, 1] * J[..., 1, 0]
        det = torch.where(torch.abs(det) < 1e-12, torch.full_like(det, 1e-12), det)
        dx = torch.stack([
            (J[..., 1, 1] * f[..., 0] - J[..., 0, 1] * f[..., 1]) / det,
            (-J[..., 1, 0] * f[..., 0] + J[..., 0, 0] * f[..., 1]) / det,
        ], dim=-1)
        x = x - dx
    return x


def project(p_FinC: torch.Tensor, zeta: torch.Tensor, model: int):
    """Project camera-frame points [..., 3]: (uv_dist, uv_norm, depth)."""
    depth = p_FinC[..., 2]
    z_safe = torch.where(torch.abs(depth) < 1e-8, torch.full_like(depth, 1e-8), depth)
    uv_norm = p_FinC[..., :2] / z_safe[..., None]
    return distort_norm(uv_norm, zeta, model), uv_norm, depth
