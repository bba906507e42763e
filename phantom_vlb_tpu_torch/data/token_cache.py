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
:func:`build_token_cache`.) A sidecar may also live in an in-memory store
(``MemoryStore``, where no ``h5py`` is installed): ``tokens`` and
``fingerprint`` as items, over lazy-load files or stores.

Under a mesh of processes (``core/mesh.py``) each rank encodes its rows of
each batch and the rows are gathered in sample order; rank 0 alone writes a
file, which every rank then attaches, while an in-memory store is filled
whole on every rank. The digest is of whole tensors, so a sidecar built by
N processes carries the one-process fingerprint and each finds the
other's.

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

from phantom_vlb_tpu_torch.core.distributed import barrier, broadcast_object
from phantom_vlb_tpu_torch.core.mesh import MeshEnv
from phantom_vlb_tpu_torch.data.loader import LazyDataset, RankRows
from phantom_vlb_tpu_torch.data.schemas import LazySample, import_h5py, is_path, lazyload_len, open_h5, opened
from phantom_vlb_tpu_torch.models.lora import CODES_DTYPE
from phantom_vlb_tpu_torch.models.videollama2 import VISION_PREFIXES, VideoLLaMA2VLB

__all__ = ["weights_digest", "dataset_fingerprint", "encode_tokens", "build_token_cache",
           "TokenCachedDataset", "attach_token_cache"]

_OTHER_FIELDS = tuple(f for f in LazySample.FIELDS if f != "vision")


def _whole(t: torch.Tensor) -> torch.Tensor:
    """A tensor as one process holds it: an FSDP2 ``DTensor`` gathered whole
    (a collective: every rank digests the same names in the same order),
    and a sharded int8 base's codes, which ride as float8 bytes, as int8."""
    t = t.full_tensor() if hasattr(t, "full_tensor") else t
    return t.view(torch.int8) if t.dtype == CODES_DTYPE else t


_BITS = {1: torch.int8, 2: torch.int16, 4: torch.int32, 8: torch.int64}


def _moments(t: torch.Tensor) -> torch.Tensor:
    """Two integer moments of a tensor's bit patterns, on its device: their
    sum and their sum weighted by position (mod 65521, plus 1), in int64.
    Integer sums are exact (a wrap is modulo 2^64) and so do not depend on
    the order of summation: the same tensor gives the same moments on any
    number of threads or ranks."""
    bits = t.contiguous().view(_BITS[t.element_size()]).flatten().to(torch.int64)
    weight = torch.arange(bits.numel(), device=bits.device) % 65521 + 1
    return torch.stack([bits.sum(), (bits * weight).sum()])


def weights_digest(state_dict: Mapping[str, torch.Tensor]) -> str:
    """Content digest of the vision tower's and the connector's tensors in
    a state dict: per tensor its name, shape, dtype and two exact moments
    of its bits (:func:`_moments`) of the whole tensor, computed where the
    tensors are, hashed in name order; a sharded model's digest is its
    one-process one."""
    names = sorted(k for k in state_dict if k.startswith(VISION_PREFIXES))
    whole = {k: _whole(state_dict[k]) for k in names}
    moments = torch.stack([_moments(whole[k]).cpu() for k in names]).tolist() if names else []
    entries = [[k, list(whole[k].shape), str(whole[k].dtype), s, a]
               for k, (s, a) in zip(names, moments)]
    return hashlib.sha256(json.dumps(entries, sort_keys=True).encode()).hexdigest()[:16]


def _content_crc(source) -> int:
    """crc32 of ``dset_len`` and the first and last samples' vision bytes."""
    with opened(source) as f:
        n = int(np.asarray(f["dset_len"])[0])
        crc = zlib.crc32(str(n).encode())
        for idx in sorted({0, max(n - 1, 0)}):
            vision = np.ascontiguousarray(f[f"{idx}"][f"{idx}_vision"][...])
            crc = zlib.crc32(vision.tobytes(), crc)
    return crc


def _file_stats(sources: Sequence) -> list[list]:
    """Per source: a file's name, size, mtime and content crc; an in-memory
    store's place in the dataset, sample count and content crc."""
    out = []
    for i, p in enumerate(sources):
        if is_path(p):
            st = Path(p).stat()
            out.append([Path(p).name, int(st.st_size), int(st.st_mtime_ns), _content_crc(p)])
        else:
            out.append([f"store{i}", lazyload_len(p), 0, _content_crc(p)])
    return out


def dataset_fingerprint(dataset: LazyDataset, num_vis_tokens: int, hidden_size: int,
                        weights: str = "") -> str:
    """The key of a sidecar over the lazy-load files of ``dataset`` (the
    reference's); over in-memory stores (which live no longer than the
    process) each store stands in by its place, sample count and content
    crc."""
    payload = json.dumps(
        {
            "paths": [Path(p).name if is_path(p) else f"store{i}" for i, p in enumerate(dataset.sources)],
            "stats": _file_stats(dataset.sources),
            "ranges": dataset.ranges,
            "tokens": [num_vis_tokens, hidden_size],
            "weights": weights,
        },
        sort_keys=True,
    )
    return hashlib.sha256(payload.encode()).hexdigest()[:16]


def encode_tokens(model: VideoLLaMA2VLB, dataset, out, *, batch_size: int = 6,
                  log: Callable[[str], None] | None = None, mesh: MeshEnv | None = None) -> None:
    """Sweep ``dataset`` (any indexable of samples with ``vision`` frames)
    through ``model.encode_video`` in batches of ``batch_size`` (the last
    padded with its last clip) and write each clip's bf16 tokens, as uint16
    bits, to ``out[i]`` (an h5py dataset or an array of (N, V, E) uint16;
    None writes nothing).

    Under a sharded ``mesh`` each rank encodes only its rows of each batch
    (``mesh.local_rows``; a rank whose rows are all past the end repeats the
    last clip, so every rank runs every batch) and the ranks' rows are
    gathered in sample order, so every rank's ``out`` gets every clip."""
    device = next(model.parameters()).device
    sharded = mesh is not None and mesh.sharded
    mine = mesh.local_rows(batch_size) if sharded else slice(0, batch_size)
    local = mine.stop - mine.start
    n = len(dataset)
    for start in range(0, n, batch_size):
        rows = list(range(start, min(start + batch_size, n)))
        take = rows[mine] or rows[-1:]
        pixels = torch.stack([torch.as_tensor(dataset[i].vision, dtype=torch.float32).to(device)
                              for i in take])
        if len(take) < local:                            # pad to the batch shape
            pixels = torch.cat([pixels, pixels[-1:].expand(local - len(take), *pixels.shape[1:])])
        toks = model.encode_video(pixels).to(torch.bfloat16)
        if sharded:
            toks = mesh.gather_rows(toks)                # real rows first: they are a prefix
        if out is not None:
            out[rows[0]:rows[-1] + 1] = toks[:len(rows)].view(torch.int16).cpu().numpy().view(np.uint16)
        if log and (start // batch_size) % 50 == 0:
            log(f"token cache: {rows[-1] + 1}/{n}")


def build_token_cache(model: VideoLLaMA2VLB, dataset: LazyDataset, path, *,
                      batch_size: int = 6, log: Callable[[str], None] | None = None,
                      mesh: MeshEnv | None = None):
    """Write the sidecar of ``dataset`` at ``path`` (through ``path``'s
    ``.building`` twin, renamed when whole); returns ``path``. A sidecar
    whose fingerprint matches is kept as it is; another is rebuilt.
    ``path`` may be an in-memory store (``data/schemas.py``'s
    ``MemoryStore``) instead: it then holds ``tokens`` and ``fingerprint``.
    A dataset of in-memory stores takes only such a sidecar: a file
    outlives the stores its key describes.

    Under a sharded ``mesh`` every rank encodes its rows (:func:`encode_tokens`);
    for a file, rank 0 alone decides whether to build and writes, and the
    ranks meet at a barrier after; an in-memory store is filled on every
    rank, whole."""
    if is_path(path) and not all(is_path(src) for src in dataset.sources):
        raise ValueError("a sidecar file is keyed by lazy-load files; a dataset of in-memory stores takes "
                         "an in-memory sidecar (a MemoryStore)")
    cfg = model.cfg
    v_tokens, hidden = cfg.geometry.num_vis_tokens, cfg.mistral.hidden_size
    fp = dataset_fingerprint(dataset, v_tokens, hidden, weights=weights_digest(model.state_dict()))
    shape = (len(dataset), v_tokens, hidden)
    if not is_path(path):
        if path.get("fingerprint") != fp:
            tokens = np.empty(shape, np.uint16)
            encode_tokens(model, dataset, tokens, batch_size=batch_size, log=log, mesh=mesh)
            path["tokens"], path["fingerprint"] = tokens, fp
        return path
    path = Path(path)
    writer = mesh is None or mesh.is_writer
    kept = False
    if writer and path.exists():
        with open_h5(path) as f:
            kept = f.attrs.get("fingerprint") == fp
        if not kept:
            path.unlink()                                # stale: rebuild
    if broadcast_object(kept):
        return path
    if not writer:
        encode_tokens(model, dataset, None, batch_size=batch_size, mesh=mesh)
        barrier()
        return path
    h5py = import_h5py("the vision-token cache")
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(".building")
    with h5py.File(tmp, "w") as f:
        out = f.create_dataset("tokens", shape=shape, dtype=np.uint16, chunks=(1, v_tokens, hidden))
        encode_tokens(model, dataset, out, batch_size=batch_size, log=log, mesh=mesh)
        f.attrs["fingerprint"] = fp
    tmp.rename(path)
    barrier()
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


def attach_token_cache(model: VideoLLaMA2VLB, loaders, cache_dir, *,
                       batch_size: int = 6, log: Callable[[str], None] | None = None,
                       mesh: MeshEnv | None = None) -> None:
    """Build the sidecar of each loader's dataset under ``cache_dir`` and
    swap a :class:`TokenCachedDataset` in for it. ``loaders``: the native
    :class:`~phantom_vlb_tpu_torch.data.loader.BatchLoader` over a
    :class:`LazyDataset` (or a :class:`RankRows` over one). ``cache_dir``:
    a directory, or an in-memory store (``MemoryStore``) that holds each
    sidecar as a group of the file's name. ``mesh`` as for
    :func:`build_token_cache`: every rank attaches the sidecar rank 0 wrote,
    or its own whole copy of an in-memory one."""
    for loader in loaders:
        loader = loader.loader if isinstance(loader, RankRows) else loader
        base = getattr(loader, "dataset", None)
        if isinstance(base, TokenCachedDataset):         # already attached
            continue
        if not isinstance(base, LazyDataset):
            raise ValueError("the vision-token cache needs the native loaders over lazy-load files")
        name = f"vision_tokens_{dataset_fingerprint(base, 0, 0)[:8]}"
        if is_path(cache_dir):
            path = build_token_cache(model, base, Path(cache_dir) / f"{name}.h5", batch_size=batch_size,
                                     log=log, mesh=mesh)
            loader.dataset = TokenCachedDataset(base, path)
        else:
            store = build_token_cache(model, base, cache_dir.require_group(name), batch_size=batch_size,
                                      log=log, mesh=mesh)
            loader.dataset = TokenCachedDataset(base, store["tokens"])
