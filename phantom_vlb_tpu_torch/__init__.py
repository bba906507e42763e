"""PyTorch + CUDA port of :mod:`phantom_vlb_tpu` for NVIDIA Hopper (H100).

The JAX package stays the reference; this package mirrors its module paths
(``models/mistral.py`` here is the counterpart of
``phantom_vlb_tpu/models/mistral.py``) and imports nothing from it. It covers
the frozen-baseline serving forward (raw frames through the frozen CLIP
ViT-L/14-336 tower and STC connector, or cached video tokens, + text ids ->
32-layer Mistral-7B -> HRF head -> predictions, masked MSE and streaming
Pearson), the training step in both regimes (the head alone, or head +
LoRA adapters; AdamW on the cosine schedule with clipping), and the trainer
users run (``vlb-train-torch``: config composition over ``configs/``, the
native lazy-load loader, validation with the per-ROI Pearson in
metrics.csv, best and last checkpoints, resume, early stopping, the
NaN-streak abort, the adapters export, HF safetensors weights), and the
stages around it (``vlb-predict-torch``, the frozen baseline's feature
cache, the vision-token cache, ``vlb-brainmaps-torch``). Attention
and the fused adapter-dropout matmul run through hand-written CUDA kernels
(``csrc/``) on the card, and through their plain PyTorch versions on CPU
tensors.

Entry points default to ``device="cuda"`` and raise when no card is present;
pass ``device="cpu"`` to run on the CPU.
"""

from phantom_vlb_tpu_torch.version import __version__

__all__ = ["__version__"]
