"""Port parity: the lazy-load reader and the native loader against the JAX package.

Synthetic lazy-load files are written with the JAX package's own writer
(``LazyloadWriter``); the glob expansion, the one-file val split, the batch
order and every array of every batch (dtype and bytes) must equal the JAX
``BatchLoader``'s, with shuffle on and off, a partial last batch, and 0 or
2 prefetch threads, over two epochs (the shuffle reseeds per epoch).
Without h5py the dataset raises an ImportError that names it.
"""

import sys
import threading
import time

import numpy as np
import pytest

from phantom_vlb_tpu.data import loader as jloader
from phantom_vlb_tpu.data.schemas import LazySample as JLazySample
from phantom_vlb_tpu.data.schemas import LazyloadWriter
from phantom_vlb_tpu.data.synthetic import TEST_GEOMETRY as G
from phantom_vlb_tpu_torch.data import loader as tloader
from phantom_vlb_tpu_torch.data import schemas as tschemas

SIZES = {"s1": [5, 4], "s2": [7]}      # samples per file, by season


def _sample(rng):
    return JLazySample(
        timeseries=rng.standard_normal(G.num_parcels).astype(np.float32),
        vision=rng.standard_normal((G.num_frames, 3, G.image_size, G.image_size)).astype(np.float32),
        vis_weights=rng.uniform(0, 1, G.num_ds_frames),
        language=rng.integers(0, 1000, G.max_lang_tokens),
        lang_weights=rng.uniform(0, 1, G.onsets_width),
        padvals=rng.integers(0, 5, 3),
    )


@pytest.fixture(scope="module")
def lazy_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("lazy")
    rng = np.random.default_rng(0)
    for season, sizes in SIZES.items():
        for n, size in enumerate(sizes):
            w = LazyloadWriter(root / f"friends_llFile_sub-01_{season}_n{n}.h5")
            w.append_many([_sample(rng) for _ in range(size)])
            w.finalize()
    return root


def _files(lazy_dir, monkeypatch, mod):
    monkeypatch.setenv("SCRATCH_PATH", str(lazy_dir))
    return mod.expand_lazyload_glob("$SCRATCH_PATH/friends_llFile_sub-01_s*_n*.h5", ["s2", "s1"])


def test_glob_split_and_reads_match_jax(lazy_dir, monkeypatch):
    files = _files(lazy_dir, monkeypatch, tloader)
    assert files == _files(lazy_dir, monkeypatch, jloader) and len(files) == 3
    for seed in (0, 1, 1234):
        assert tloader.split_train_val(files, seed) == jloader.split_train_val(files, seed)
    ds_t, ds_j = tloader.LazyDataset(files), jloader.LazyDataset(files)
    assert len(ds_t) == len(ds_j) == 16 and ds_t.ranges == ds_j.ranges
    assert tschemas.lazyload_len(files[0]) == 7
    for i in (0, 6, 7, 15):
        a, b = ds_t[i], ds_j[i]
        for field in tschemas.LazySample.FIELDS:
            x, y = getattr(a, field), getattr(b, field)
            assert x.dtype == y.dtype and np.array_equal(x, y), (i, field)
    with tschemas.open_h5(files[1]) as f:
        s = tschemas.read_lazy_sample(f, 3)
    assert np.array_equal(s.vision, ds_j[10].vision)
    ds_t.close()


@pytest.mark.parametrize("threads", [0, 2])
@pytest.mark.parametrize("shuffle", [True, False])
def test_batches_match_jax_byte_for_byte(lazy_dir, monkeypatch, shuffle, threads):
    files = _files(lazy_dir, monkeypatch, tloader)
    kw = dict(batch_size=3, shuffle=shuffle, seed=7, prefetch=threads, num_threads=max(threads, 1))
    lt = tloader.BatchLoader(tloader.LazyDataset(files), **kw)
    lj = jloader.BatchLoader(jloader.LazyDataset(files), **kw)
    assert len(lt) == len(lj) == 6
    for _ in range(2):
        bt, bj = list(lt), list(lj)
        assert len(bt) == len(bj) == 6
        for a, b in zip(bt, bj):
            da, db = a.as_dict(), b.as_dict()
            assert list(da) == list(db)
            for k in da:
                assert da[k].dtype == db[k].dtype and da[k].tobytes() == db[k].tobytes(), k
        assert bt[-1].row_mask.tolist() == [1.0, 0.0, 0.0]      # 16 = 5 x 3 + 1


def test_without_h5py_the_dataset_names_it(lazy_dir, monkeypatch):
    files = _files(lazy_dir, monkeypatch, tloader)
    monkeypatch.setitem(sys.modules, "h5py", None)
    with pytest.raises(ImportError, match="h5py"):
        tloader.LazyDataset(files)


_SEMAPHORE = threading.Semaphore          # the real one, before a test patches it


class _LateFirstSlot:
    """A semaphore whose first acquire waits before taking its slot: the
    worker that calls it first is overtaken by the others."""

    def __init__(self, value):
        self._sem = _SEMAPHORE(value)
        self._lock = threading.Lock()
        self._first = True

    def acquire(self, *args, **kwargs):
        with self._lock:
            late, self._first = self._first, False
        if late:
            time.sleep(0.5)
        return self._sem.acquire(*args, **kwargs)

    def release(self, n=1):
        self._sem.release(n)


def test_prefetch_never_starves_the_batch_awaited(lazy_dir, monkeypatch):
    """A worker overtaken between taking a batch and taking its slot must not
    leave the consumer waiting for that batch while the others fill every
    slot (a deadlock the loader had: it took the batch first)."""
    files = _files(lazy_dir, monkeypatch, tloader)
    monkeypatch.setattr(tloader.threading, "Semaphore", _LateFirstSlot)
    loader = tloader.BatchLoader(tloader.LazyDataset(files), batch_size=1, shuffle=False, prefetch=1,
                                 num_threads=2)
    got = []
    consumer = threading.Thread(target=lambda: got.extend(loader), daemon=True)
    consumer.start()
    consumer.join(timeout=30)
    assert not consumer.is_alive(), "the prefetching loader deadlocked"
    want = tloader.BatchLoader(tloader.LazyDataset(files), batch_size=1, shuffle=False, prefetch=0)
    assert [b.timeseries.tobytes() for b in got] == [b.timeseries.tobytes() for b in want]
