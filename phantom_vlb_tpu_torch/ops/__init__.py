"""Attention, the fused LoRA dropout matmul, weight-mask ops and the CUDA kernels' wrappers."""
