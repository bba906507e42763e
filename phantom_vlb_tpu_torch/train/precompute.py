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

Under a mesh of processes (``core/mesh.py``) each rank runs the backbone
over its rows of each batch and the rows are gathered in order, so the
cache is the one-process cache (rank 0 writes a file; a store is filled
on every rank), and :class:`CachedFeatureLoader` gives each rank its rows
of each global batch, as the sharded loader does.
"""

from __future__ import annotations

import contextlib
from pathlib import Path
from typing import Iterable, Iterator, Mapping

import numpy as np
import torch
from torch import nn

from phantom_vlb_tpu_torch.core.distributed import barrier
from phantom_vlb_tpu_torch.core.geometry import VLBGeometry
from phantom_vlb_tpu_torch.core.mesh import MeshEnv
from phantom_vlb_tpu_torch.data.loader import batch_fields
from phantom_vlb_tpu_torch.data.schemas import open_h5
from phantom_vlb_tpu_torch.models.videollama2 import VideoLLaMA2VLB
from phantom_vlb_tpu_torch.ops.weight_mask import JOINER_POST, JOINER_PRE

__all__ = ["support_gather", "build_feature_cache", "cache_present", "CachedFeatureLoader",
           "HeadOnly", "head_forward"]


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


def build_feature_cache(model: VideoLLaMA2VLB, loader: Iterable, store, mesh: MeshEnv | None = None) -> int:
    """Sweep ``loader`` through ``model``'s frozen backbone (no gradient
    recorded) into ``store`` (a path, written through h5py, or a store);
    returns the number of samples cached (the valid rows).

    Under a sharded ``mesh`` the loader yields this rank's rows of each
    global batch (``MeshEnv.local_rows``): each rank runs the backbone over
    its rows, and the rows are gathered in the global batch's order, so the
    store holds every valid row once, in the one-process order. A file is
    written by rank 0 alone (the ranks meet at a barrier after); a store is
    filled whole on every rank."""
    if isinstance(store, (str, Path)):
        if mesh is None or mesh.is_writer:
            with open_h5(store, "w") as f:
                n = build_feature_cache(model, loader, f, mesh)
        else:
            n = build_feature_cache(model, loader, None, mesh)
        barrier()
        return n
    device = next(model.parameters()).device
    geom = model.cfg.geometry
    sharded = mesh is not None and mesh.sharded
    idx = 0
    for batch in loader:
        arrays = batch_fields(batch)
        dev = {k: torch.as_tensor(arrays[k]).to(device)
               for k in ("language", "vision", "padvals", "vis_weights", "lang_weights")}
        with torch.no_grad():
            hidden, _ = model.backbone(dev["language"], dev["vision"])
            feats, weights = support_gather(hidden, dev["padvals"], dev["vis_weights"],
                                            dev["lang_weights"], geom)
            feats = feats.to(torch.bfloat16).to(torch.float16)
        ts = torch.as_tensor(arrays["timeseries"]).to(torch.float32)
        row_mask = torch.as_tensor(arrays["row_mask"])
        if sharded:
            feats, weights = mesh.gather_rows(feats), mesh.gather_rows(weights)
            ts, row_mask = (mesh.gather_rows(t.to(device)) for t in (ts, row_mask))
        if store is None:
            idx += int((row_mask > 0).sum())
            continue
        feats, weights, ts, row_mask = (_host(t) for t in (feats, weights, ts, row_mask))
        for row in range(feats.shape[0]):
            if row_mask[row] <= 0:
                continue
            g = store.create_group(f"{idx}")
            g.create_dataset(f"{idx}_features", data=feats[row])
            g.create_dataset(f"{idx}_weights", data=weights[row])
            g.create_dataset(f"{idx}_timeseries", data=ts[row])
            idx += 1
    if store is not None:
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
    epoch)``; a partial last batch repeats its last row. With a ``mesh``,
    each batch is this rank's rows of the global batch of ``batch_size``
    (``mesh.local_rows``, which raises unless the mesh's batch axes divide
    it), and only those rows are read."""

    def __init__(self, source, batch_size: int, shuffle: bool = True, seed: int = 0,
                 mesh: MeshEnv | None = None):
        self.source = source
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.rows = slice(0, batch_size) if mesh is None else mesh.local_rows(batch_size)
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
                real = idx[i:i + self.batch_size]
                pad = self.batch_size - len(real)
                # The global batch, padded with its last row, then this rank's rows of it.
                rows = np.concatenate([real, np.repeat(real[-1:], pad)])[self.rows]
                mask = np.concatenate([np.ones(len(real), np.float32), np.zeros(pad, np.float32)])[self.rows]

                def stack(field: str) -> np.ndarray:
                    return np.stack([np.asarray(f[f"{j}"][f"{j}_{field}"]) for j in rows])

                yield {
                    "hidden": stack("features").astype(np.float32),
                    "weights": stack("weights"),
                    "timeseries": stack("timeseries"),
                    "row_mask": mask,
                }


class HeadOnly(nn.Module):
    """The head alone, as the cached trainer trains it: its tensors keep
    the whole model's names (``head.*``), and it is a module with a
    forward, which FSDP2 takes as the root of a sharded model."""

    def __init__(self, head: nn.Module):
        super().__init__()
        self.head = head

    def forward(self, hidden: torch.Tensor, weights: torch.Tensor, seed: int | None = None,
                rows: tuple[int, int] | None = None):
        return self.head(hidden, weights, seed, rows)


def head_forward(model: nn.Module, batch: Mapping[str, torch.Tensor], seed: int | None = None,
                 rows: tuple[int, int] | None = None):
    """The trainer's forward over cached batches: ``model`` (a
    :class:`HeadOnly`) on (hidden, weights) -> (predictions, l2 penalty);
    ``rows`` the global batch rows this batch holds (the head's dropout
    mask). Any module whose ``head`` is a
    :class:`~phantom_vlb_tpu_torch.models.heads.BrainReadoutHead` will do
    outside a sharded trainer."""
    if isinstance(model, HeadOnly):
        return model(batch["hidden"], batch["weights"], seed, rows)
    return model.head(batch["hidden"], batch["weights"], seed, rows)
