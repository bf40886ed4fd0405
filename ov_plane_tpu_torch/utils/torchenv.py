"""Device selection and numeric policy for the port's entry points."""

from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """Return ``device`` as a ``torch.device`` and pin true-f32 matmuls.

    A CUDA device must exist: asking for one on a machine without CUDA raises
    instead of falling back, so a CPU run happens only when the caller asks
    for ``device="cpu"``. TF32 stays off on both matmul paths: the EKF
    diverges with reduced-precision products (the JAX package measured this
    with bf16x3 on its accelerator).
    """
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available; pass device='cpu' to run on the CPU")
        if dev.index is None:  # "cuda" names the current card, as tensors report it
            dev = torch.device("cuda", torch.cuda.current_device())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    return dev
