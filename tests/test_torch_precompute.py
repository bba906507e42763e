"""Port parity: the feature cache of the frozen baseline (``train/precompute.py``)
and ``vlb-train-torch model.cache_features=true`` against the JAX package.

Lazy-load files from the JAX package's own stages; the tiny VLB in f32 on
the CPU, the port's weights carried from the JAX model's by
``from_flax_params``. Tolerances:
- ``support_gather``: bit-equal (an index gather, the same weights);
- the cached features: within one bf16 ulp of the cache's largest
  magnitude; the two backbones' f32 hidden states differ in their last
  bits, which can move a value across a bf16 rounding boundary (the
  weights and targets are bit-equal);
- each package's ``CachedFeatureLoader`` gives the same batches from either
  file, bit for bit;
- the head over the cache against the full forward: 2e-2, the JAX test's
  (``tests/test_precompute.py:110``), for the f16 cache's rounding;
- the CLI: over the JAX run's own caches (reused, as they are present) the
  CSV's losses within ``(1 + 1e-5)**10 - 1`` relative and the per-ROI r
  within 1e-4, the bounds of ``tests/test_torch_trainer.py``; over the
  port's own caches, within 1e-3 relative and 1e-3 absolute, the
  features' bf16 flips on top.
"""

import csv
import glob
import shutil
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from phantom_vlb_tpu.data.lazyload_build import LazyloadBuildConfig, build_lazyload_dsets
from phantom_vlb_tpu.data.loader import BatchLoader as JBatchLoader
from phantom_vlb_tpu.data.loader import LazyDataset as JLazyDataset
from phantom_vlb_tpu.data.synthetic import TEST_GEOMETRY, write_synthetic_bold_file, write_synthetic_features_file
from phantom_vlb_tpu.models.videollama2 import VideoLLaMA2VLB as JVLB
from phantom_vlb_tpu.models.videollama2 import VLBConfig as JVLBConfig
from phantom_vlb_tpu.train import precompute as jpre
from phantom_vlb_tpu_torch.data.loader import BatchLoader, LazyDataset
from phantom_vlb_tpu_torch.data.schemas import MemoryStore
from phantom_vlb_tpu_torch.models import videollama2 as tv
from phantom_vlb_tpu_torch.models.convert import from_flax_params
from phantom_vlb_tpu_torch.train import precompute as tpre
from test_torch_trainer import STEPS_TOL

G = TEST_GEOMETRY
BATCH = 4
N = 15                       # the samples of the two episodes the window and delay leave
CONFIGS = Path(__file__).resolve().parents[1] / "configs"


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    root = tmp_path_factory.mktemp("port_cache")
    eps = {"s01e01a": 10, "s01e01b": 9}
    write_synthetic_features_file(root / "f.h5", eps, G, seed=0)
    write_synthetic_bold_file(root / "b.h5", eps, G, seed=1)
    (root / "lazy").mkdir()
    paths = build_lazyload_dsets(LazyloadBuildConfig(
        str(root / "f.h5"), str(root / "b.h5"), str(root / "lazy"), "sub-01", "s1", 1, G))
    jmodel = JVLB(JVLBConfig.tiny(dropout_rate=0.0))
    jloader = JBatchLoader(JLazyDataset(paths), batch_size=BATCH, shuffle=False, prefetch=0)
    b0 = next(iter(jloader))
    params = jmodel.init(jax.random.key(0), *(jnp.asarray(a) for a in (
        b0.language, b0.vision, b0.padvals, b0.vis_weights, b0.lang_weights)))["params"]
    port = tv.VideoLLaMA2VLB.from_state_dict(tv.VLBConfig.tiny(dropout_rate=0.0), from_flax_params(params))
    loader = BatchLoader(LazyDataset(paths), batch_size=BATCH, shuffle=False, prefetch=0)
    jpath, tpath = root / "jax_cache.h5", root / "port_cache.h5"
    n_jax = jpre.build_feature_cache(jmodel, params, jloader, jpath, G)
    n_port = tpre.build_feature_cache(port, loader, tpath)
    return dict(root=root, paths=paths, jmodel=jmodel, params=params, port=port, loader=loader,
                jpath=jpath, tpath=tpath, n=(n_jax, n_port))


def test_support_gather_is_bit_equal(setup):
    rng = np.random.default_rng(3)
    b = next(iter(setup["loader"]))
    hidden = rng.standard_normal((BATCH, G.feature_len, 64)).astype(np.float32)
    args = (b.padvals, b.vis_weights, b.lang_weights)
    jf, jw = jpre.support_gather(jnp.asarray(hidden), *(jnp.asarray(a) for a in args), G)
    tf, tw = tpre.support_gather(torch.from_numpy(hidden), *(torch.from_numpy(a) for a in args), G)
    assert tf.shape == (BATCH, G.num_vis_tokens + G.onsets_width, 64)
    np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
    np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))


def _read(path):
    import h5py

    with h5py.File(path, "r") as f:
        n = int(f["dset_len"][0])
        return n, {key: np.stack([f[f"{i}"][f"{i}_{key}"][...] for i in range(n)])
                   for key in ("features", "weights", "timeseries")}


def test_feature_cache_matches_jax(setup):
    assert setup["n"][0] == setup["n"][1] == len(setup["loader"].dataset) == N
    nj, want = _read(setup["jpath"])
    nt, got = _read(setup["tpath"])
    assert nj == nt
    assert got["features"].dtype == want["features"].dtype == np.float16
    assert got["features"].shape == (N, G.num_vis_tokens + G.onsets_width, 64)
    big = float(np.abs(want["features"]).max())
    ulp = 2.0 ** (np.floor(np.log2(big)) - 7)                  # bf16 keeps 8 significant bits
    assert np.abs(got["features"].astype(np.float64) - want["features"]).max() <= ulp
    for key in ("weights", "timeseries"):
        np.testing.assert_array_equal(got[key], want[key])


@pytest.mark.parametrize("source", ["jax_cache", "port_cache"])
def test_cached_loaders_read_either_file_alike(setup, source):
    path = setup["jpath"] if source == "jax_cache" else setup["tpath"]
    jbatches = list(jpre.CachedFeatureLoader(path, BATCH, shuffle=True, seed=5))
    tbatches = list(tpre.CachedFeatureLoader(path, BATCH, shuffle=True, seed=5))
    assert len(jbatches) == len(tbatches) == 4                       # 15 = 3 x 4 + 3
    for jb, tb in zip(jbatches, tbatches):
        assert list(tb) == list(jb)
        for key in jb:
            assert tb[key].dtype == jb[key].dtype and tb[key].tobytes() == jb[key].tobytes(), key
    assert tbatches[-1]["row_mask"].tolist() == [1.0, 1.0, 1.0, 0.0]


def test_cached_head_matches_the_full_forward(setup):
    """The head over the cache (an in-memory store) against the full
    forward, and the store's cache equal to the file's."""
    port, loader = setup["port"], setup["loader"]
    store = MemoryStore()
    assert not tpre.cache_present(store)
    assert tpre.build_feature_cache(port, loader, store) == N and tpre.cache_present(store)
    _, from_file = _read(setup["tpath"])
    np.testing.assert_array_equal(np.stack([store[f"{i}"][f"{i}_features"] for i in range(N)]),
                                  from_file["features"])
    model = torch.nn.ModuleDict({"head": port.head})
    cached = []
    for cb in tpre.CachedFeatureLoader(store, BATCH, shuffle=False):
        with torch.no_grad():
            pred, _ = tpre.head_forward(model, {k: torch.from_numpy(v) for k, v in cb.items()})
        cached.append(pred.numpy()[cb["row_mask"] > 0])
    full = []
    for b in loader:
        with torch.no_grad():
            pred, _ = port(*(torch.from_numpy(a) for a in (
                b.language, b.vision, b.padvals, b.vis_weights, b.lang_weights)))
        full.append(pred.numpy()[b.row_mask > 0])
    np.testing.assert_allclose(np.concatenate(cached), np.concatenate(full), atol=2e-2, rtol=2e-2)


# ---------------------------------------------------------------------------
# vlb-train-torch model.cache_features=true against vlb-train

def _cli_args(pattern, out):
    """``tests/test_cli_e2e.py::test_cached_baseline_training``'s arguments,
    without the head's dropout (the two packages draw other masks)."""
    return ["experiment=vlb_friends_baseline", "subject=sub-01", f"datamodule.lazyload_path={pattern}",
            "datamodule.seasons=[s1]", "datamodule.batch_size=4", "model.preset=tiny",
            "model.cache_features=true", "model.dropout_rate=0.0", "trainer.max_epochs=2",
            "trainer.val_check_interval=0.5", "trainer.log_every_n_steps=2", "optim.t_max=100",
            f"output_dir={out}", "run_name=cached"]


def _csv(out):
    (path,) = glob.glob(str(out / "cached" / "*" / "metrics.csv"))
    with open(path, newline="") as f:
        return list(csv.DictReader(f))


def _compare_csv(got, want, loss_tol, corr_tol):
    assert [(r["epoch"], r["step"]) for r in got] == [(r["epoch"], r["step"]) for r in want]
    assert sum(bool(r["val/brain_loss"]) for r in got) >= 2
    for g, w in zip(got, want):
        for key, value in w.items():
            if not value or key in ("epoch", "step", "train/steps_per_sec"):
                continue
            tol = corr_tol if "corr" in key else loss_tol * abs(float(value))
            assert abs(float(g[key]) - float(value)) <= tol, (key, g[key], value)


@pytest.fixture(scope="module")
def cached_runs(tmp_path_factory, monkeypatch_module):
    from phantom_vlb_tpu.cli.build_lazyload import main as build_lazyload
    from phantom_vlb_tpu.cli.train import main as jmain
    from phantom_vlb_tpu.core.config import load_config as jload
    from phantom_vlb_tpu.train import builder as jbuilder
    from phantom_vlb_tpu_torch.cli.train import main as tmain
    from phantom_vlb_tpu_torch.train import builder as tbuilder

    root = tmp_path_factory.mktemp("port_cached_cli")
    eps = {"s01e01a": 9, "s01e01b": 8, "s01e02a": 8}
    write_synthetic_features_file(root / "features_s1.h5", eps, G, seed=0)
    write_synthetic_bold_file(root / "bold.h5", eps, G, seed=1)
    (root / "lazy").mkdir()
    assert build_lazyload([
        "--features_path", str(root / "features_s1.h5"), "--timeseries_path", str(root / "bold.h5"),
        "--lazyload_path", str(root / "lazy"), "--subject", "sub-01", "--season", "s1",
        "--n_split", "2", "--window", str(G.window), "--delay", str(G.delay)]) == 0
    pattern = str(root / "lazy" / "friends_llFile_sub-01_s*_n*.h5")

    assert jmain(_cli_args(pattern, root / "jax")) == 0
    # The weights the JAX builder made (init_model_params from random_state),
    # carried into the port's builder.
    config = jload(str(CONFIGS), "base", _cli_args(pattern, root / "jax"))
    jmodel = JVLB(jbuilder.build_model_config(config.model))
    params = jbuilder.init_model_params(jmodel, G, jmodel.config.mistral.vocab_size,
                                        int(config.random_state))
    sd = from_flax_params(params)
    monkeypatch_module.setattr(tbuilder, "init_params",
                               lambda cfg, device, generator: {k: t.clone() for k, t in sd.items()})

    (root / "port_on_jax_caches").mkdir()
    for split in ("train", "val"):
        shutil.copy(root / "jax" / f"feature_cache_{split}.h5", root / "port_on_jax_caches")
    assert tmain([*_cli_args(pattern, root / "port_on_jax_caches"), "--device", "cpu"]) == 0
    assert tmain([*_cli_args(pattern, root / "port"), "--device", "cpu"]) == 0
    return root


@pytest.fixture(scope="module")
def monkeypatch_module():
    mp = pytest.MonkeyPatch()
    yield mp
    mp.undo()


def test_cached_training_over_the_jax_caches(cached_runs):
    root = cached_runs
    _compare_csv(_csv(root / "port_on_jax_caches"), _csv(root / "jax"), STEPS_TOL, 1e-4)
    saved = torch.load(root / "port_on_jax_caches" / "last" / "state.pt", weights_only=True)["params"]
    assert saved and all(k.startswith("head.") for k in saved)


def test_cached_training_builds_caches_like_jax(cached_runs):
    root = cached_runs
    for split in ("train", "val"):
        nj, want = _read(root / "jax" / f"feature_cache_{split}.h5")
        nt, got = _read(root / "port" / f"feature_cache_{split}.h5")
        assert nj == nt
        ulp = 2.0 ** (np.floor(np.log2(float(np.abs(want["features"]).max()))) - 7)
        assert np.abs(got["features"].astype(np.float64) - want["features"]).max() <= ulp
    _compare_csv(_csv(root / "port"), _csv(root / "jax"), 1e-3, 1e-3)


def test_cached_training_refuses_the_lora_regime(tmp_path):
    from phantom_vlb_tpu_torch.core.config import load_config
    from phantom_vlb_tpu_torch.train.builder import build_cached_trainer

    config = load_config(CONFIGS, "base", ["experiment=vlb_friends_lora", "subject=sub-01",
                                           "model.preset=tiny", f"output_dir={tmp_path}"])
    with pytest.raises(ValueError, match="frozen-baseline"):
        build_cached_trainer(config, "cpu", loaders=([], []))

