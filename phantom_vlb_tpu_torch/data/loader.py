"""Host data pipeline: lazy HDF5 reading, the train/val split, batching, prefetch.

Counterpart of ``phantom_vlb_tpu/data/loader.py``, with the same outputs
byte for byte:

- :func:`expand_lazyload_glob` expands ``$SCRATCH_PATH`` and the ``s*``
  wildcard per season; per-season lists are sorted, then concatenated;
- :func:`split_train_val`: validation is one file chosen by
  ``np.random.RandomState(random_state).choice``, training the rest;
- :class:`LazyDataset` opens its files lazily per thread, so prefetch
  threads never share an h5py handle; it also reads open stores, such as
  the in-memory ones the builder writes;
- :class:`Batch` is a fixed-shape numpy batch (a field that the samples
  hold as tensors, such as cached video tokens, stays a tensor); a partial
  last batch repeats its last row and ``row_mask`` marks the real rows;
- :class:`BatchLoader` shuffles with ``default_rng(seed + epoch)`` and
  collates ahead of the step on a bounded pool of threads, in order. Given
  a mesh (``core/mesh.py``) it yields this rank's rows of each global
  batch, the block ``MeshEnv.local_rows`` names: every rank draws the same
  global order, the last global batch is padded to ``batch_size`` before
  the split, and a rank reads only the samples of its own rows (a rank
  whose rows are all padding reads the sample they repeat).

The trainer moves each batch to the device (``train/loop.py``).
"""

from __future__ import annotations

import dataclasses
import glob as globlib
import os
import queue
import threading
from pathlib import Path
from typing import Iterator

import numpy as np
import torch

from phantom_vlb_tpu_torch.data.schemas import LazySample, is_path, lazyload_len, open_h5

__all__ = ["LazyDataset", "Batch", "batch_fields", "BatchLoader", "RankRows", "expand_lazyload_glob",
           "split_train_val"]


def expand_lazyload_glob(pattern: str, seasons: list[str]) -> list[str]:
    """Expand a ``.../friends_llFile_{subject}_s*_n*.h5`` pattern per season."""
    f_list: list[str] = []
    for s in seasons:
        pat = pattern
        if "$SCRATCH_PATH" in pat:
            pat = pat.replace("$SCRATCH_PATH", os.environ["SCRATCH_PATH"])
        pat = pat.replace("s*", f"{s}")
        f_list += sorted(globlib.glob(pat))
    return f_list


def split_train_val(files: list[str], random_state: int) -> tuple[list[str], list[str]]:
    """val = 1 RandomState-chosen file, train = the rest."""
    r = np.random.RandomState(random_state)
    val_file = r.choice(files, 1).tolist()
    train_files = [x for x in files if x not in val_file]
    return train_files, val_file


class LazyDataset:
    """Concatenated view over lazy-load files with thread-local handles, or
    over open stores (``data/schemas.py``, e.g. ``MemoryStore``s the builder
    wrote), which every thread reads as they are."""

    def __init__(self, sources: list):
        if not sources:
            raise ValueError("no lazy-load files given")
        self.sources = [str(Path(s)) if is_path(s) else s for s in sources]
        self.paths = [s for s in self.sources if isinstance(s, str)]
        self._local = threading.local()
        self.ranges: list[tuple[int, int]] = []
        self.length = 0
        for s in self.sources:
            n = lazyload_len(s)
            self.ranges.append((self.length, self.length + n))
            self.length += n

    def _files(self) -> list:
        if not hasattr(self._local, "files"):
            self._local.files = [open_h5(s) if isinstance(s, str) else s for s in self.sources]
        return self._local.files

    def close(self) -> None:
        """Close this thread's handles (other threads' close when collected)."""
        for s, f in zip(self.sources, getattr(self._local, "files", [])):
            if isinstance(s, str):
                f.close()
        if hasattr(self._local, "files"):
            del self._local.files

    def __len__(self) -> int:
        return self.length

    def _locate(self, idx: int) -> tuple[int, int]:
        for i, (lo, hi) in enumerate(self.ranges):
            if lo <= idx < hi:
                return i, idx - lo
        raise IndexError(idx)

    def read(self, idx: int, fields=LazySample.FIELDS) -> dict[str, np.ndarray]:
        """The named fields of sample ``idx``; the others are not read."""
        i, local_idx = self._locate(idx)
        g = self._files()[i][f"{local_idx}"]
        return {field: np.asarray(g[f"{local_idx}_{field}"]) for field in fields}

    def __getitem__(self, idx: int) -> LazySample:
        return LazySample(**self.read(idx))


@dataclasses.dataclass
class Batch:
    """Fixed-shape host batch. ``row_mask`` marks real (non-padding) rows."""

    timeseries: np.ndarray    # (B, num_parcels) f32
    vision: np.ndarray        # (B, F, 3, H, W) f32, or (B, V, E) bf16 cached tokens
    language: np.ndarray      # (B, L) i32
    vis_weights: np.ndarray   # (B, D) f32
    lang_weights: np.ndarray  # (B, W) f32
    padvals: np.ndarray       # (B, 3) i32
    row_mask: np.ndarray      # (B,) f32

    def as_dict(self) -> dict[str, np.ndarray]:
        return dataclasses.asdict(self)


def batch_fields(batch) -> dict:
    """A loader's batch as a dict of its fields: those of a batch with an
    ``as_dict`` (a :class:`Batch`), or the mapping's (e.g. ready batches of
    tensors)."""
    return batch.as_dict() if hasattr(batch, "as_dict") else dict(batch)


def _collate(samples: list[LazySample], batch_size: int, n_real: int | None = None) -> Batch:
    """``samples`` stacked and padded to ``batch_size`` by repeating the
    last; the first ``n_real`` (default: all) rows are marked real."""
    pad = batch_size - len(samples)
    n = len(samples) if n_real is None else n_real

    def stack(field: str, dtype=None):
        """The field's values stacked, cast to ``dtype`` (None: kept)."""
        values = [getattr(s, field) for s in samples]
        if isinstance(values[0], torch.Tensor):          # e.g. cached bf16 video tokens
            arr = torch.stack(values)
            return torch.cat([arr, arr[-1:].expand(pad, *arr.shape[1:])]) if pad else arr
        arr = np.stack([np.asarray(v) for v in values])
        arr = arr if dtype is None else arr.astype(dtype)
        if pad:
            arr = np.concatenate([arr, np.repeat(arr[-1:], pad, axis=0)], axis=0)
        return arr

    return Batch(
        timeseries=stack("timeseries", np.float32),
        vision=stack("vision"),
        language=stack("language", np.int32),
        vis_weights=stack("vis_weights", np.float32),
        lang_weights=stack("lang_weights", np.float32),
        padvals=stack("padvals", np.int32),
        row_mask=np.concatenate([np.ones(n, np.float32), np.zeros(batch_size - n, np.float32)]),
    )


class BatchLoader:
    """Shuffling, prefetching batch iterator over a :class:`LazyDataset`;
    with a ``mesh``, over this rank's rows (``mesh.local_rows``, which
    raises unless the mesh's batch axes divide ``batch_size``) of each
    global batch of ``batch_size``."""

    def __init__(
        self,
        dataset: LazyDataset,
        batch_size: int,
        shuffle: bool = True,
        seed: int = 0,
        drop_last: bool = False,
        prefetch: int = 4,
        num_threads: int = 4,
        mesh=None,
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.prefetch = prefetch
        self.num_threads = max(1, num_threads)
        self.rows = slice(0, batch_size) if mesh is None else mesh.local_rows(batch_size)
        self.local_batch_size = self.rows.stop - self.rows.start
        self._epoch = 0

    def __len__(self) -> int:
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def _batch_indices(self) -> list[np.ndarray]:
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            np.random.default_rng(self.seed + self._epoch).shuffle(idx)
        n_full = len(idx) // self.batch_size
        batches = [idx[i * self.batch_size:(i + 1) * self.batch_size] for i in range(n_full)]
        rem = idx[n_full * self.batch_size:]
        if len(rem) and not self.drop_last:
            batches.append(rem)
        return batches

    def _rank_rows(self, indices: np.ndarray) -> tuple[np.ndarray, int]:
        """(samples to read, how many of them are real rows) for this rank's
        block of a global batch padded to ``batch_size``."""
        lo, hi = self.rows.start, min(self.rows.stop, len(indices))
        if hi > lo:
            return indices[lo:hi], hi - lo
        return indices[-1:], 0                   # every row padding: the sample they repeat

    def _read(self, indices: np.ndarray) -> Batch:
        rows, n_real = self._rank_rows(indices)
        return _collate([self.dataset[int(i)] for i in rows], self.local_batch_size, n_real)

    def __iter__(self) -> Iterator[Batch]:
        batches = self._batch_indices()
        self._epoch += 1
        if self.prefetch <= 0:
            for b in batches:
                yield self._read(b)
            return
        yield from self._prefetch_iter(batches)

    def _prefetch_iter(self, batches: list[np.ndarray]) -> Iterator[Batch]:
        """Ordered multi-threaded prefetch with a bounded number in flight."""
        results: dict[int, Batch] = {}
        errors: list[BaseException] = []
        results_lock = threading.Condition()
        task_q: queue.Queue = queue.Queue()
        stop = threading.Event()
        inflight = threading.Semaphore(self.prefetch + self.num_threads)

        for item in enumerate(batches):
            task_q.put(item)
        for _ in range(self.num_threads):
            task_q.put(None)

        # A worker takes its slot before it takes a batch, so every batch
        # taken holds a slot: the batches the consumer waits for are never
        # starved of one by later batches (taking the batch first let a
        # worker hold batch 0 without a slot while others filled them all).
        def worker():
            while not stop.is_set():
                inflight.acquire()
                if stop.is_set():
                    return
                item = task_q.get()
                if item is None:
                    inflight.release()
                    return
                bi, indices = item
                try:
                    batch = self._read(indices)
                except BaseException as e:                  # handed to the consumer
                    with results_lock:
                        errors.append(e)
                        results_lock.notify_all()
                    return
                with results_lock:
                    results[bi] = batch
                    results_lock.notify_all()

        threads = [threading.Thread(target=worker, daemon=True) for _ in range(self.num_threads)]
        for t in threads:
            t.start()
        try:
            for bi in range(len(batches)):
                with results_lock:
                    while bi not in results and not errors:
                        results_lock.wait(timeout=60.0)
                    if errors:
                        raise errors[0]
                    batch = results.pop(bi)
                inflight.release()
                yield batch
        finally:
            stop.set()
            for _ in threads:
                inflight.release()


class RankRows:
    """A loader of global batches seen by one rank of a mesh: each batch's
    fields cut to the rows ``mesh.local_rows`` gives that rank."""

    def __init__(self, loader, mesh):
        self.loader, self.mesh = loader, mesh

    def __len__(self) -> int:
        return len(self.loader)

    def __iter__(self):
        for batch in self.loader:
            fields = batch_fields(batch)
            rows = self.mesh.local_rows(len(fields["row_mask"]))
            yield {k: v[rows] for k, v in fields.items()}
