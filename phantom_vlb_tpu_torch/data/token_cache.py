"""Vision-token cache: the frozen CLIP + STC forward once per clip.

Counterpart of ``phantom_vlb_tpu/data/token_cache.py`` (:52-245). Both
regimes of record freeze the vision tower and the connector, so a clip's
(num_vis_tokens, hidden) video tokens are a function of its frames alone.
They are computed once per dataset into an HDF5 sidecar, bf16 kept as its
uint16 bit patterns (lossless), and the loader reads tokens in place of
frames; epochs then skip ``encode_video``.

The sidecar's layout is the JAX package's: a root dataset ``tokens`` (N, V,
E) uint16 chunked per sample, and the attribute ``fingerprint``, which keys
it to the dataset and the weights: the files' names, sample counts, sizes,
mtimes and a crc32 of each file's ``dset_len`` and first and last clips
(which catches an mtime-preserving copy of regenerated features), the token
geometry, and :func:`weights_digest` of the tower's and the connector's
tensors. A stale sidecar is rebuilt. (The digest is the port's own, so a
sidecar built by the JAX package reads here but is rebuilt by
:func:`build_token_cache`.)

``h5py`` is imported where a file is opened.
"""

from __future__ import annotations

import hashlib
import json
import threading
import zlib
from pathlib import Path
from typing import Callable, Mapping, Sequence

import numpy as np
import torch

from phantom_vlb_tpu_torch.data.loader import LazyDataset
from phantom_vlb_tpu_torch.data.schemas import LazySample, import_h5py, open_h5
from phantom_vlb_tpu_torch.models.videollama2 import VISION_PREFIXES, VideoLLaMA2VLB

__all__ = ["weights_digest", "dataset_fingerprint", "encode_tokens", "build_token_cache",
           "TokenCachedDataset", "attach_token_cache"]

_OTHER_FIELDS = tuple(f for f in LazySample.FIELDS if f != "vision")


def weights_digest(state_dict: Mapping[str, torch.Tensor]) -> str:
    """Content digest of the vision tower's and the connector's tensors in
    a state dict: per tensor its name, shape, dtype and two f32 moments
    (sum, abs-sum), computed where the tensors are, hashed in name order."""
    names = sorted(k for k in state_dict if k.startswith(VISION_PREFIXES))
    moments = torch.stack([
        torch.stack([state_dict[k].float().sum(), state_dict[k].float().abs().sum()]) for k in names
    ]).tolist() if names else []
    entries = [[k, list(state_dict[k].shape), str(state_dict[k].dtype), s, a]
               for k, (s, a) in zip(names, moments)]
    return hashlib.sha256(json.dumps(entries, sort_keys=True).encode()).hexdigest()[:16]


def _content_crc(path) -> int:
    """crc32 of ``dset_len`` and the first and last samples' vision bytes."""
    with open_h5(path) as f:
        n = int(np.asarray(f["dset_len"])[0])
        crc = zlib.crc32(str(n).encode())
        for idx in sorted({0, max(n - 1, 0)}):
            vision = np.ascontiguousarray(f[f"{idx}/{idx}_vision"][...])
            crc = zlib.crc32(vision.tobytes(), crc)
    return crc


def _file_stats(paths: Sequence[str]) -> list[list]:
    out = []
    for p in paths:
        st = Path(p).stat()
        out.append([Path(p).name, int(st.st_size), int(st.st_mtime_ns), _content_crc(p)])
    return out


def dataset_fingerprint(dataset: LazyDataset, num_vis_tokens: int, hidden_size: int,
                        weights: str = "") -> str:
    """The key of a sidecar over the lazy-load files of ``dataset`` (a
    dataset over stores has no files to key it by, and raises)."""
    if len(dataset.paths) != len(dataset.sources):
        raise ValueError("the vision-token cache is keyed by lazy-load files; the dataset reads stores")
    payload = json.dumps(
        {
            "paths": [Path(p).name for p in dataset.paths],
            "stats": _file_stats(dataset.paths),
            "ranges": dataset.ranges,
            "tokens": [num_vis_tokens, hidden_size],
            "weights": weights,
        },
        sort_keys=True,
    )
    return hashlib.sha256(payload.encode()).hexdigest()[:16]


def encode_tokens(model: VideoLLaMA2VLB, dataset, out, *, batch_size: int = 6,
                  log: Callable[[str], None] | None = None) -> None:
    """Sweep ``dataset`` (any indexable of samples with ``vision`` frames)
    through ``model.encode_video`` in batches of ``batch_size`` (the last
    padded with its last clip) and write each clip's bf16 tokens, as uint16
    bits, to ``out[i]`` (an h5py dataset or an array of (N, V, E) uint16)."""
    device = next(model.parameters()).device
    n = len(dataset)
    for start in range(0, n, batch_size):
        rows = list(range(start, min(start + batch_size, n)))
        pixels = torch.stack([torch.as_tensor(dataset[i].vision, dtype=torch.float32).to(device)
                              for i in rows])
        if len(rows) < batch_size:                       # pad to the batch shape
            pixels = torch.cat([pixels, pixels[-1:].expand(batch_size - len(rows), *pixels.shape[1:])])
        toks = model.encode_video(pixels).to(torch.bfloat16)[:len(rows)]
        out[rows[0]:rows[-1] + 1] = toks.view(torch.int16).cpu().numpy().view(np.uint16)
        if log and (start // batch_size) % 50 == 0:
            log(f"token cache: {rows[-1] + 1}/{n}")


def build_token_cache(model: VideoLLaMA2VLB, dataset: LazyDataset, path: str | Path, *,
                      batch_size: int = 6, log: Callable[[str], None] | None = None) -> Path:
    """Write the sidecar of ``dataset`` at ``path`` (through ``path``'s
    ``.building`` twin, renamed when whole); returns ``path``. A sidecar
    whose fingerprint matches is kept as it is; another is rebuilt."""
    h5py = import_h5py("the vision-token cache")
    path = Path(path)
    cfg = model.cfg
    v_tokens, hidden = cfg.geometry.num_vis_tokens, cfg.mistral.hidden_size
    fp = dataset_fingerprint(dataset, v_tokens, hidden, weights=weights_digest(model.state_dict()))
    if path.exists():
        with h5py.File(path, "r") as f:
            if f.attrs.get("fingerprint") == fp:
                return path
        path.unlink()                                    # stale: rebuild

    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(".building")
    with h5py.File(tmp, "w") as f:
        out = f.create_dataset("tokens", shape=(len(dataset), v_tokens, hidden), dtype=np.uint16,
                               chunks=(1, v_tokens, hidden))
        encode_tokens(model, dataset, out, batch_size=batch_size, log=log)
        f.attrs["fingerprint"] = fp
    tmp.rename(path)
    return path


class TokenCachedDataset:
    """A view of ``base`` whose samples' ``vision`` is the cached (V, E)
    tokens, a bf16 tensor. ``tokens``: a sidecar's path (opened once per
    thread) or an array of (N, V, E) uint16. The frames of a
    :class:`LazyDataset` are not read."""

    def __init__(self, base, tokens):
        self.base = base
        self.tokens = tokens
        self._local = threading.local()

    def __len__(self) -> int:
        return len(self.base)

    def _tokens(self):
        if not isinstance(self.tokens, (str, Path)):
            return self.tokens
        if not hasattr(self._local, "f"):
            self._local.f = open_h5(self.tokens)
        return self._local.f["tokens"]

    def __getitem__(self, idx: int) -> LazySample:
        if isinstance(self.base, LazyDataset):
            fields = self.base.read(idx, _OTHER_FIELDS)
        else:
            sample = self.base[idx]
            fields = {f: getattr(sample, f) for f in _OTHER_FIELDS}
        bits = np.ascontiguousarray(self._tokens()[idx], dtype=np.uint16)
        return LazySample(vision=torch.from_numpy(bits.view(np.int16)).view(torch.bfloat16), **fields)


def attach_token_cache(model: VideoLLaMA2VLB, loaders, cache_dir: str | Path, *,
                       batch_size: int = 6, log: Callable[[str], None] | None = None) -> None:
    """Build the sidecar of each loader's dataset under ``cache_dir`` and
    swap a :class:`TokenCachedDataset` in for it. ``loaders``: the native
    :class:`~phantom_vlb_tpu_torch.data.loader.BatchLoader` over a
    :class:`LazyDataset`."""
    cache_dir = Path(cache_dir)
    for loader in loaders:
        base = getattr(loader, "dataset", None)
        if isinstance(base, TokenCachedDataset):         # already attached
            continue
        if not isinstance(base, LazyDataset):
            raise ValueError("the vision-token cache needs the native loaders over lazy-load files")
        fp_name = dataset_fingerprint(base, 0, 0)[:8]
        path = build_token_cache(model, base, cache_dir / f"vision_tokens_{fp_name}.h5",
                                 batch_size=batch_size, log=log)
        loader.dataset = TokenCachedDataset(base, path)
