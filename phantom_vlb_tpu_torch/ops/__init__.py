"""Attention, weight-mask ops and the CUDA kernels' wrappers."""
