"""The ``datamodule.loader=grain`` input pipeline, on ``torch.utils.data``.

Counterpart of ``phantom_vlb_tpu/data/grain_loader.py``, which drives the
lazy-load files through Google Grain; the card's machine has no ``grain``,
so this module reproduces what that pipeline yields, batch for batch and
byte for byte, over a ``torch.utils.data.DataLoader``:

- the order: grain 0.2.15's ``IndexSampler(shuffle=True, seed=s)`` reads
  record ``index_shuffle(i, max_index=n - 1, seed=s, rounds=4)`` at step i
  (``ShuffleMapDataset._shuffled_index``), and the JAX loader passes ``s =
  seed + epoch``. :func:`index_shuffle` is that permutation in numpy: a
  Simon cipher on the smallest even number of bits, at least 16, that
  holds ``max_index`` (``ceil(log2(max_index))``), whose round keys are
  ``std::seed_seq({seed})``'s first ``rounds`` words, cycle-walked until the
  result is at most ``max_index``;
- each sample's fields as numpy arrays in the JAX source's dtypes, with
  ``row_mask`` 1, stacked; the last batch padded with zero rows
  (``row_mask`` 0) to ``batch_size`` (JAX ``grain_loader.py:103-152``).

Under a mesh each rank reads only its rows of each global batch
(``mesh.local_rows``): the rows of the JAX loader's batch.

``worker_count`` worker processes read the samples (0: in this process).
They start with the ``spawn`` method: the trainer has the card up and runs
threads (the native loader's prefetch, NCCL's watchdog) by the time a
loader is iterated, and a forked child would inherit that CUDA context and
any lock those threads held; a spawned worker is a fresh interpreter that
imports this module and reads files, and never touches CUDA. It costs each
worker an interpreter start, once, as the workers persist across epochs.
Each opens its own file handles (the dataset is pickled without them); an
in-memory store is pickled whole into each worker.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from phantom_vlb_tpu_torch.data.loader import LazyDataset
from phantom_vlb_tpu_torch.data.schemas import LazySample

__all__ = ["index_shuffle", "epoch_order", "GrainBatchLoader"]

_U32 = 0xFFFFFFFF
_MIN_BLOCK_BITS = 16
_TABLE_BITS = 20
_DTYPES = {
    "timeseries": np.float32,
    "vision": np.float32,
    "language": np.int32,
    "vis_weights": np.float32,
    "lang_weights": np.float32,
    "padvals": np.int32,
}


def _seed_seq(seed: int, n: int) -> list[int]:
    """The first ``n`` words of C++'s ``std::seed_seq{seed}.generate``
    ([rand.util.seedseq]), all arithmetic mod 2^32."""
    b = [0x8B8B8B8B] * n
    t = 11 if n >= 623 else 7 if n >= 68 else 5 if n >= 39 else 3 if n >= 7 else (n - 1) // 2
    p = (n - t) // 2
    q = p + t
    m = max(2, n)                                    # max(number of seeds + 1, n)

    def tw(x):
        return x ^ (x >> 27)

    for k in range(m):
        r1 = 1664525 * tw(b[k % n] ^ b[(k + p) % n] ^ b[(k - 1) % n]) & _U32
        r2 = (r1 + (1 if k == 0 else k % n + seed if k == 1 else k % n)) & _U32
        b[(k + p) % n] = (b[(k + p) % n] + r1) & _U32
        b[(k + q) % n] = (b[(k + q) % n] + r2) & _U32
        b[k % n] = r2
    for k in range(m, m + n):
        r3 = 1566083941 * tw((b[k % n] + b[(k + p) % n] + b[(k - 1) % n]) & _U32) & _U32
        r4 = (r3 - k % n) & _U32
        b[(k + p) % n] ^= r3
        b[(k + q) % n] ^= r4
        b[k % n] = r4
    return b


def _simon(x: np.ndarray, w: int, keys: list) -> np.ndarray:
    """One encryption of each 2w-bit value of ``x`` by the Simon rounds."""
    mask = np.uint64((1 << w) - 1)

    def rotl(v, r):
        return ((v << np.uint64(r)) | (v >> np.uint64(w - r))) & mask

    def f(v):
        return (rotl(v, 1) & rotl(v, 8)) ^ rotl(v, 2)

    left, right = (x >> np.uint64(w)) & mask, x & mask
    for i in range(0, len(keys), 2):
        left = left ^ f(right) ^ keys[i]
        right = right ^ f(left) ^ keys[i + 1]
    return (left << np.uint64(w)) | right


def index_shuffle(index, max_index: int, seed: int, rounds: int = 4) -> np.ndarray:
    """Where ``index`` (an int or an array of them, in [0, max_index]) lands
    in grain's pseudorandom permutation of [0, max_index] for ``seed``."""
    index = np.asarray(index, dtype=np.uint64)
    if max_index == 0:
        return np.zeros_like(index)
    bits = math.ceil(math.log2(max_index))
    w = max(bits + bits % 2, _MIN_BLOCK_BITS) // 2
    keys = [np.uint64(k & ((1 << w) - 1)) for k in _seed_seq(seed & _U32, rounds)]
    top = np.uint64(max_index)
    if 2 * w <= _TABLE_BITS:
        # A small range walks long cycles (~2^2w / max_index steps): encrypt
        # the whole block once, then jump pointers. jump[y] is the first
        # value at most max_index on y's cycle after y, or a value past
        # which every one so far was larger; each round doubles the reach.
        jump = _simon(np.arange(1 << (2 * w), dtype=np.uint64), w, keys)
        while (jump[: max_index + 1] > top).any():
            jump = np.where(jump > top, jump[jump], jump)
        # An index of 2w + 1 bits (max_index = 2^2w) enters the cipher cut
        # to its low 2w bits, as in grain.
        return jump[index & np.uint64((1 << (2 * w)) - 1)]
    out = _simon(index, w, keys)
    far = out > top
    while far.any():                                 # cycle-walk into the range
        out[far] = _simon(out[far], w, keys)
        far = out > top
    return out


def epoch_order(n: int, seed: int, shuffle: bool) -> np.ndarray:
    """The sample indices one epoch of the JAX loader reads, in order."""
    steps = np.arange(n, dtype=np.uint64)
    if not shuffle:
        return steps.astype(np.int64)
    return index_shuffle(steps, n - 1, seed % 2**32).astype(np.int64)


class _Samples(torch.utils.data.Dataset):
    """One sample's fields as the JAX source gives them, keyed by (index,
    real): a row that is not real (padding) is all zeros."""

    def __init__(self, sources: list):
        self.sources = list(sources)
        self._dataset = None                         # opened in each process

    def _ds(self) -> LazyDataset:
        if self._dataset is None:
            self._dataset = LazyDataset(self.sources)
        return self._dataset

    def __len__(self) -> int:
        return len(self._ds())

    def __getitem__(self, key) -> dict:
        idx, real = key
        sample = self._ds()[int(idx)]
        item = {f: np.asarray(getattr(sample, f), _DTYPES[f]) for f in LazySample.FIELDS}
        if not real:
            item = {f: np.zeros_like(v) for f, v in item.items()}
        item["row_mask"] = np.float32(1.0 if real else 0.0)
        return item

    def __getstate__(self):
        return {"sources": self.sources, "_dataset": None}


class _Batches:
    """The batches of (index, real) keys for this rank's rows of epoch
    ``epoch``."""

    def __init__(self, n: int, batch_size: int, rows: slice, shuffle: bool, seed: int):
        self.n, self.batch_size, self.rows = n, batch_size, rows
        self.shuffle, self.seed, self.epoch = shuffle, seed, 0

    def __len__(self) -> int:
        return -(-self.n // self.batch_size)

    def __iter__(self):
        order = epoch_order(self.n, self.seed + self.epoch, self.shuffle)
        for start in range(0, self.n, self.batch_size):
            glob = order[start:start + self.batch_size]
            mine = [(int(i), True) for i in glob[self.rows]]
            # Rows past the end of the last batch: zeros (read from a real
            # sample for their shapes).
            mine += [(int(glob[-1]), False)] * (self.rows.stop - self.rows.start - len(mine))
            yield mine


def _stack(items: list[dict]) -> dict:
    """The items' fields stacked, keys sorted (as grain's batches hold them)."""
    return {k: np.stack([it[k] for it in items]) for k in sorted(items[0])}


class GrainBatchLoader:
    """Trainer-compatible batches of ``datamodule.loader=grain``: dicts of
    numpy arrays with ``row_mask``, the last one zero-padded to
    ``batch_size``; reshuffled each epoch (``seed + epoch``), as the JAX
    loader. ``sources`` are lazy-load files or open stores."""

    def __init__(self, sources: list, batch_size: int, seed: int = 0, shuffle: bool = True,
                 worker_count: int = 0, mesh=None):
        self.batch_size = int(batch_size)
        self._samples = _Samples(sources)
        rows = slice(0, self.batch_size) if mesh is None else mesh.local_rows(self.batch_size)
        self._batches = _Batches(len(self._samples), self.batch_size, rows, shuffle, seed)
        self._loader = torch.utils.data.DataLoader(
            self._samples, batch_sampler=self._batches, collate_fn=_stack,
            num_workers=int(worker_count),
            multiprocessing_context="spawn" if worker_count else None,
            persistent_workers=bool(worker_count))
        self._epoch = 0

    def __len__(self) -> int:
        return len(self._batches)

    def __iter__(self):
        self._batches.epoch, self._epoch = self._epoch, self._epoch + 1
        yield from self._loader
