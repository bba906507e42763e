"""Port parity: ``datamodule.loader=grain`` against the JAX package's Grain pipeline.

The numpy ``index_shuffle`` equals grain's own (the C++ one grain 0.2.15's
``IndexSampler`` shuffles with) over a sweep of lengths, seeds and rounds.
Over lazy-load files written by the JAX package's writer, the port's
``GrainBatchLoader`` yields the JAX ``GrainBatchLoader``'s batches, every
array's dtype and bytes, for 2 epochs (the order reseeds per epoch), with
shuffle on and off, a zero-padded last batch, in this process and in 2
worker processes; under a mesh of 2 ranks each rank gets its rows of the
JAX batches. ``build_loaders`` routes ``loader=grain`` to it, and
``vlb-train-torch`` trains through it.
"""

import glob
from pathlib import Path

import numpy as np
import pytest
from grain._src.python.experimental.index_shuffle.python import index_shuffle_module as grain_shuffle

from phantom_vlb_tpu.core.config import load_config as jload_config
from phantom_vlb_tpu.data import grain_loader as jgrain
from phantom_vlb_tpu.data.schemas import LazySample as JLazySample
from phantom_vlb_tpu.data.schemas import LazyloadWriter
from phantom_vlb_tpu.data.synthetic import TEST_GEOMETRY as G
from phantom_vlb_tpu.train.builder import build_loaders as jbuild_loaders
from phantom_vlb_tpu_torch.cli.train import main
from phantom_vlb_tpu_torch.core.config import load_config
from phantom_vlb_tpu_torch.data.grain_loader import GrainBatchLoader, index_shuffle
from phantom_vlb_tpu_torch.train.builder import build_loaders

CONFIGS = Path(__file__).resolve().parents[1] / "configs"
SIZES = {"s1": [5, 4], "s2": [7]}      # samples per file, by season
MAX_INDICES = [0, 1, 2, 3, 6, 7, 15, 16, 17, 100, 1000, 65535, 65536, 65537, 2**20 + 3, 2**33 + 7]


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
def files(tmp_path_factory):
    root = tmp_path_factory.mktemp("lazy")
    rng = np.random.default_rng(0)
    out = []
    for season, sizes in SIZES.items():
        for n, size in enumerate(sizes):
            path = root / f"friends_llFile_sub-01_{season}_n{n}.h5"
            w = LazyloadWriter(path)
            w.append_many([_sample(rng) for _ in range(size)])
            w.finalize()
            out.append(str(path))
    return out


@pytest.mark.parametrize("max_index", MAX_INDICES)
def test_index_shuffle_is_grains(max_index):
    steps = np.unique(np.r_[np.arange(min(max_index + 1, 300)), max_index,
                           np.random.default_rng(max_index).integers(0, max_index + 1, 50)])
    for seed in (0, 7, 2**32 - 1):
        for rounds in (4, 8):
            want = [grain_shuffle.index_shuffle(int(i), max_index=max_index, seed=seed, rounds=rounds)
                    for i in steps]
            assert index_shuffle(steps, max_index, seed, rounds).tolist() == want, (seed, rounds)
    if max_index < 300:                  # a permutation of [0, max_index]
        assert sorted(index_shuffle(np.arange(max_index + 1), max_index, 3).tolist()) == \
            list(range(max_index + 1))


def _same(got: list, want: list) -> None:
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert list(a) == list(b)
        for k in b:
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
            assert a[k].tobytes() == b[k].tobytes(), k


@pytest.mark.parametrize("workers", [0, 2])
@pytest.mark.parametrize("shuffle", [True, False])
def test_batches_match_jax_byte_for_byte(files, shuffle, workers):
    lt = GrainBatchLoader(files, batch_size=3, seed=7, shuffle=shuffle, worker_count=workers)
    lj = jgrain.GrainBatchLoader(files, batch_size=3, seed=7, shuffle=shuffle)
    assert len(lt) == len(lj) == 6
    epochs = [(list(lt), list(lj)) for _ in range(2)]
    for got, want in epochs:
        _same(got, want)
        assert want[-1]["row_mask"].tolist() == [1.0, 0.0, 0.0]
    if shuffle:                          # reseeded per epoch
        assert [b["language"].tobytes() for b in epochs[0][1]] != [b["language"].tobytes() for b in epochs[1][1]]


class _Ranks:
    """A mesh's rows of a global batch for one of ``n`` ranks."""

    def __init__(self, rank, n):
        self.rank, self.n = rank, n

    def local_rows(self, batch_size):
        per = batch_size // self.n
        return slice(self.rank * per, (self.rank + 1) * per)


def test_ranks_read_their_rows_of_the_jax_batches(files):
    want = list(jgrain.GrainBatchLoader(files, batch_size=4, seed=3))
    for rank in (0, 1):
        got = list(GrainBatchLoader(files, batch_size=4, seed=3, mesh=_Ranks(rank, 2)))
        rows = slice(2 * rank, 2 * rank + 2)
        _same(got, [{k: v[rows] for k, v in b.items()} for b in want])


def _pattern(files):
    return f"{Path(files[0]).parent}/friends_llFile_sub-01_s*_n*.h5"


def test_build_loaders_routes_grain(files):
    overrides = ["experiment=vlb_friends_lora", "subject=sub-01", "datamodule.loader=grain",
                 f"datamodule.lazyload_path={_pattern(files)}", "datamodule.seasons=[s1,s2]",
                 "datamodule.batch_size=3", "datamodule.num_workers=0"]
    tt, tv, names = build_loaders(load_config(CONFIGS, "base", overrides).datamodule)
    jt, jv, jnames = jbuild_loaders(jload_config(CONFIGS, "base", overrides).datamodule)
    assert isinstance(tt, GrainBatchLoader) and isinstance(jt, jgrain.GrainBatchLoader)
    assert names == jnames
    _same(list(tt), list(jt))
    _same(list(tv), list(jv))


def test_train_cli_trains_through_grain(files, tmp_path):
    out = tmp_path / "results"
    assert main([
        "experiment=vlb_friends_lora", "subject=sub-01", "datamodule.loader=grain",
        f"datamodule.lazyload_path={_pattern(files)}", "datamodule.seasons=[s1,s2]",
        "datamodule.batch_size=4", "datamodule.num_workers=0", "model.preset=tiny", "model.lora_r=4",
        "model.lora_alpha=8", "model.lora_dropout=0.0", "trainer.max_epochs=1",
        "trainer.val_check_interval=0.5", "trainer.log_every_n_steps=1", "optim.t_max=100",
        f"output_dir={out}", "run_name=grain", "mesh.fsdp=1", "--device", "cpu",
    ]) == 0
    (csv_path,) = glob.glob(str(out / "grain" / "*" / "metrics.csv"))
    assert len(Path(csv_path).read_text().splitlines()) > 1
    assert (out / "last").exists()
