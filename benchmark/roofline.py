"""The yardstick of the two hand-written kernels' roofline shares: the
published peaks of the card and the bytes and operations each call's
shapes need (the arithmetic of the port's card smoke test, copied).

A call's least time is the larger of its bytes over the memory bandwidth
and its operations over the peak rate of its type; the share is the sum of
the calls' least times over the device time of every kernel the calls
launched."""

from __future__ import annotations

# Published dense peaks (NVIDIA H100 data sheets): memory bytes/s and FLOP/s
# by element size. float32 outside the tensor cores (TF32 is off); float64 on
# the tensor cores (DMMA), the rate the port's float64 kernels use.
PEAKS = {"SXM": (3.35e12, {4: 67e12, 8: 67e12}),
         "PCIe": (2.0e12, {4: 51e12, 8: 51e12}),
         "NVL": (3.9e12, {4: 60e12, 8: 60e12})}


def card_peaks(name: str):
    """(memory bytes/s, {element bytes: FLOP/s}) of the card ``name``."""
    for key in ("PCIe", "NVL"):
        if key in name:
            return PEAKS[key]
    return PEAKS["SXM"]


def gram_work(B: int, M: int, D: int, size: int) -> tuple[int, int]:
    """(bytes, FLOP) of (HᵀH, Hᵀr) for H [B, M, D], r [B, M]: H and r read
    once, Λ and η written once; the upper triangle and the folded column."""
    return size * (B * M * D + B * M + B * D * D + B * D), 2 * B * M * (D * (D + 1) // 2 + D)


def downdate_work(B: int, M: int, D: int, size: int) -> tuple[int, int]:
    """(bytes, FLOP) of (P − WᵀW, Wᵀu) for P [B, D, D], W [B, M, D], u [B, M]:
    P, W, u read once, P' and dx written once."""
    return size * (2 * B * D * D + B * M * D + B * M + B * D), 2 * B * M * (D * (D + 1) // 2 + D)


WORK = {"gram_reduce": gram_work, "kalman_downdate": downdate_work}


def least_seconds(kernel: str, shape: tuple, size: int, card: str) -> float:
    bw, rates = card_peaks(card)
    nbytes, flops = WORK[kernel](*shape, size)
    return max(nbytes / bw, flops / rates[size])


def roofline_pct(kernel: str, calls: list[tuple[tuple, int]], device_s: float, card: str) -> float | None:
    """Share (%) of the least time of ``calls`` [(shape (B, M, D), element
    bytes)] in ``device_s``, the device time of their kernels; None when
    there were no calls or no device time."""
    if not calls or device_s <= 0:
        return None
    return 100.0 * sum(least_seconds(kernel, shape, size, card) for shape, size in calls) / device_s
