"""Wire-dtype / patch-sampler guard: a copy of
``ov_plane_tpu/frontend/wire_guard.py``.

The fused vision path has two quantized modes: the ``u8`` image wire (a
quarter of the f32 upload) and the ``mm_bf16`` KLT sampler (bf16 patch
roundings). The JAX package measured that a scene whose tracking signal
lies below one 8-bit step diverges under 8-bit quantization wherever it
happens, and that bf16 patch rounding (≤ 2^-8 relative) is at or below the
quantization floor of an 8-bit source. Hence the guard is exact:

    quantized modes  ⟺  the source image is already 8-bit-representable.

An 8-bit camera's frames pass bit-exactly and get the quantized modes;
float imagery with sub-quantum signal keeps the exact f32 path.
"""

from __future__ import annotations

import numpy as np

# Tolerance on |img*255 - round(img*255)|: u8-derived floats round-trip to
# ~1e-7 (one f32 rounding of k/255); anything real stays far below 1e-3.
U8_LATTICE_TOL = 1e-3


def u8_representable(img, tol: float = U8_LATTICE_TOL) -> bool:
    """True iff every pixel of ``img`` (float in [0,1] or uint8) lies on the
    8-bit lattice k/255 — i.e. u8 quantization of this image is LOSSLESS."""
    img = np.asarray(img)
    if img.dtype == np.uint8:
        return True
    x = img.astype(np.float32, copy=False) * np.float32(255.0)
    if x.size == 0:
        return True
    if float(x.min()) < -tol or float(x.max()) > 255.0 + tol:
        return False
    return float(np.abs(x - np.rint(x)).max()) <= tol


def resolve_wire_and_sampler(img, wire_req: str, sampler_req: str):
    """Resolve 'auto' wire/sampler requests against the first image (batch:
    [B, H, W] — ALL streams must pass for the batch to take a quantized mode;
    one compiled program serves the whole batch).

    Returns (wire, sampler, info_dict). Non-'auto' requests pass through
    unchanged (explicit user/env choice wins — including explicitly unsafe
    ones, which is what the round-3 measurements needed).
    """
    need = (wire_req == "auto") or (sampler_req == "auto")
    lossless = u8_representable(img) if need else None
    wire = wire_req if wire_req != "auto" else ("u8" if lossless else "f32")
    sampler = sampler_req if sampler_req != "auto" else ("mm_bf16" if lossless else "mm")
    info = {
        "u8_lossless": lossless,
        "wire": wire,
        "sampler": sampler,
        "reason": (
            None if not need else
            "source on the 8-bit lattice: u8 wire is bit-lossless; bf16 patch "
            "rounding is below the source's own quantization floor" if lossless else
            "float source with sub-8-bit signal: quantized modes would destroy "
            "information the exact path preserves (and no 8-bit camera could "
            "capture) — staying f32/'mm'"),
    }
    return wire, sampler, info
