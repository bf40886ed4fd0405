"""PyTorch/CUDA port of the ov_plane_tpu visual-inertial filter.

The package mirrors the module layout of ``ov_plane_tpu`` and imports none of
it. Every function takes tensors with a leading stream dimension ``[B, ...]``
where the JAX package relies on ``vmap``. The two dense reductions of the
update (``ops/kernels.py``) are CUDA kernels on the card and plain PyTorch on
CPU tensors.

Ported so far: the batched MSCKF filter with CP planes on simulator
measurements (``models.manager.VioEngine`` + ``step`` / ``run_sequence``)
and the main path, the fused vision step over camera frames
(``frontend.fused.FusedVisionDriver``).
"""

__version__ = "0.1.0"
