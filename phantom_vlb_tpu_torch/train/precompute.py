"""Feature cache: the frozen backbone once per sample, then the head alone over the cache.

Counterpart of ``phantom_vlb_tpu/train/precompute.py`` (:43-177). In the
frozen-baseline regime the backbone's hidden states never change, so each
sample runs through it once and only the positions that can carry a nonzero
HRF weight are kept::

  support = [vision segment: pad_left .. pad_left + num_vis_tokens)
             (weights: vis_weights repeated tokens_per_frame times)] +
            [language window: lang_start .. lang_start + onsets_width)
             (weights: lang_weights, zero from diag_len on)]

K = num_vis_tokens + onsets_width positions (1247 at the production
geometry, 10.2 MB a sample in f16). The head over the cache computes what it
computes over the whole sequence: zero-weight positions add nothing to the
HRF pooling and its first LayerNorm acts per token.

The cache's layout is the JAX package's: per sample a group ``{i}`` with
``{i}_features`` (K, E) f16 holding bf16-rounded values, ``{i}_weights``
(K,) f32 and ``{i}_timeseries`` (P,) f32, and a root ``dset_len`` = [n].
Where it is kept is the caller's choice: a path (an HDF5 file, through
``h5py``) or any store with h5py's ``create_group`` / ``create_dataset`` /
``__getitem__`` / ``__contains__``, such as ``data/schemas.py``'s ``MemoryStore``.
"""

from __future__ import annotations

import contextlib
from pathlib import Path
from typing import Iterable, Iterator, Mapping

import numpy as np
import torch
from torch import nn

from phantom_vlb_tpu_torch.core.geometry import VLBGeometry
from phantom_vlb_tpu_torch.data.loader import batch_fields
from phantom_vlb_tpu_torch.data.schemas import open_h5
from phantom_vlb_tpu_torch.models.videollama2 import VideoLLaMA2VLB
from phantom_vlb_tpu_torch.ops.weight_mask import JOINER_POST, JOINER_PRE

__all__ = ["support_gather", "build_feature_cache", "cache_present", "CachedFeatureLoader",
           "head_forward"]


def support_gather(hidden: torch.Tensor, padvals: torch.Tensor, vis_weights: torch.Tensor,
                   lang_weights: torch.Tensor, geom: VLBGeometry) -> tuple[torch.Tensor, torch.Tensor]:
    """(hidden (B, S, E), mask inputs) -> (features (B, K, E), weights (B, K) f32).

    K = num_vis_tokens + onsets_width, laid out [vision support, language
    window]; an index gather, so the features are hidden's own values.
    """
    b, s, e = hidden.shape
    V, W, tpf = geom.num_vis_tokens, geom.onsets_width, geom.tokens_per_frame
    padvals = padvals.long()
    pad_len, inst_len, diag_len = padvals[:, 0:1], padvals[:, 1:2], padvals[:, 2:3]
    trial_len = V + JOINER_PRE + inst_len + diag_len + JOINER_POST + pad_len
    pad_left = geom.feature_len - trial_len                              # (B, 1)
    lang_start = pad_left + V + JOINER_PRE + inst_len                    # (B, 1)

    vis_pos = pad_left + torch.arange(V, device=hidden.device)[None, :]
    lang_idx = torch.arange(W, device=hidden.device)[None, :]
    # The language window may run past the sequence for large diag/pad
    # combinations; those positions carry zero weight, so clamp.
    pos = torch.cat([vis_pos, lang_start + lang_idx], dim=1).clamp(0, s - 1)
    features = torch.gather(hidden, 1, pos[..., None].expand(b, V + W, e))

    vis_w = vis_weights.float().repeat_interleave(tpf, dim=1)           # (B, V)
    lang_w = torch.where(lang_idx < diag_len, lang_weights.float(), 0.0)
    return features, torch.cat([vis_w, lang_w], dim=1)


def _host(x) -> np.ndarray:
    return torch.as_tensor(x).cpu().numpy()


def build_feature_cache(model: VideoLLaMA2VLB, loader: Iterable, store) -> int:
    """Sweep ``loader`` through ``model``'s frozen backbone (no gradient
    recorded) into ``store`` (a path, written through h5py, or a store);
    returns the number of samples cached (the valid rows)."""
    if isinstance(store, (str, Path)):
        with open_h5(store, "w") as f:
            return build_feature_cache(model, loader, f)
    device = next(model.parameters()).device
    geom = model.cfg.geometry
    idx = 0
    for batch in loader:
        arrays = batch_fields(batch)
        dev = {k: torch.as_tensor(arrays[k]).to(device)
               for k in ("language", "vision", "padvals", "vis_weights", "lang_weights")}
        with torch.no_grad():
            hidden, _ = model.backbone(dev["language"], dev["vision"])
            feats, weights = support_gather(hidden, dev["padvals"], dev["vis_weights"],
                                            dev["lang_weights"], geom)
            feats = _host(feats.to(torch.bfloat16).to(torch.float16))
        weights = _host(weights)
        ts = _host(arrays["timeseries"]).astype(np.float32)
        row_mask = _host(arrays["row_mask"])
        for row in range(feats.shape[0]):
            if row_mask[row] <= 0:
                continue
            g = store.create_group(f"{idx}")
            g.create_dataset(f"{idx}_features", data=feats[row])
            g.create_dataset(f"{idx}_weights", data=weights[row])
            g.create_dataset(f"{idx}_timeseries", data=ts[row])
            idx += 1
    store.create_dataset("dset_len", data=[idx])
    return idx


def cache_present(store) -> bool:
    """Whether ``store`` (a path or a store) holds a finished cache."""
    if isinstance(store, (str, Path)):
        return Path(store).exists()
    return "dset_len" in store


class CachedFeatureLoader:
    """Fixed-shape batches over a feature cache (a path or a store), as
    dicts of numpy arrays: ``hidden`` (B, K, E) f32, ``weights``,
    ``timeseries`` and ``row_mask``. Shuffles with ``default_rng(seed +
    epoch)``; a partial last batch repeats its last row."""

    def __init__(self, source, batch_size: int, shuffle: bool = True, seed: int = 0):
        self.source = source
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self._epoch = 0
        with self._open() as f:
            self.length = int(np.asarray(f["dset_len"])[0])

    def _open(self):
        if isinstance(self.source, (str, Path)):
            return open_h5(self.source)
        return contextlib.nullcontext(self.source)          # the caller's store stays open

    def __len__(self) -> int:
        return (self.length + self.batch_size - 1) // self.batch_size

    def __iter__(self) -> Iterator[dict[str, np.ndarray]]:
        idx = np.arange(self.length)
        if self.shuffle:
            np.random.default_rng(self.seed + self._epoch).shuffle(idx)
        self._epoch += 1
        with self._open() as f:
            for i in range(0, self.length, self.batch_size):
                rows = idx[i:i + self.batch_size]
                pad = self.batch_size - len(rows)

                def stack(field: str) -> np.ndarray:
                    arr = np.stack([np.asarray(f[f"{j}"][f"{j}_{field}"]) for j in rows])
                    return np.concatenate([arr, np.repeat(arr[-1:], pad, 0)]) if pad else arr

                yield {
                    "hidden": stack("features").astype(np.float32),
                    "weights": stack("weights"),
                    "timeseries": stack("timeseries"),
                    "row_mask": np.concatenate([np.ones(len(rows), np.float32),
                                                np.zeros(pad, np.float32)]),
                }


def head_forward(model: nn.Module, batch: Mapping[str, torch.Tensor], seed: int | None = None):
    """The trainer's forward over cached batches: ``model.head`` (a
    :class:`~phantom_vlb_tpu_torch.models.heads.BrainReadoutHead`) on
    (hidden, weights) -> (predictions, l2 penalty)."""
    return model.head(batch["hidden"], batch["weights"], seed)
