"""Tensor math of the filter and the hand-written CUDA kernels."""
