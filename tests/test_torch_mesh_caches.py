"""The two caches under a mesh of processes (gloo ranks of the CPU), against
one process and the JAX package.

Each rank is a process of ``tests/torch_ranks.py``; lazy-load files come
from the JAX package's own stages and the tiny VLB runs in f32 with the JAX
model's weights (``from_flax_params``).

- The vision-token cache (``data/token_cache.py``) on 2 and 4 ranks, into a
  file rank 0 writes and into in-memory stores filled on every rank: the
  tokens the same bits on every rank and in both, and each within one bf16
  ulp of the one-process sidecar's (a rank runs the f32 tower on 2 or 1
  rows where one process runs it on 4, and the CPU's products then sum in
  another order, which can move a value across a bf16 rounding boundary;
  at most 0.1% of them), the fingerprint the one-process one (the weights
  digest is of whole tensors and exact, the same under FSDP2's ``DTensor``
  shards and on any number of threads), a sidecar built by the ranks
  found and kept by one process and one built by one process kept by the
  ranks, a rank whose rows of the last batch are all padding, and the
  tokens within one bf16 ulp of JAX's ``build_token_cache`` (the bound of
  ``tests/test_torch_token_cache.py``: the towers' f32 tokens differ in
  their last bits); ``vlb-train-torch ... datamodule.vision_token_cache``
  on 2 ranks against one process.
- The feature cache (``train/precompute.py``) on 2 ranks: the store the
  same bits on both ranks, its weights and targets the one-process store's
  bit for bit and its features within one bf16 ulp of the cache's largest
  magnitude (the bound of ``tests/test_torch_precompute.py``, for the same
  reason as the tokens': the backbone on 2 rows, not 4), each rank's cached
  batches its rows of the one-process batches over that store; then
  ``vlb-train-torch model.cache_features=true`` on 2 ranks: its caches the
  one-process run's and ``vlb-train``'s within that bound, its CSV the one-process CSV within
  1e-5 relative (f32; the ranks sum their rows apart, as in
  ``tests/test_torch_sharded.py``) and ``vlb-train``'s within the bounds of
  ``tests/test_torch_precompute.py`` over the port's own caches (1e-3).
"""

import csv
import glob
from pathlib import Path

import h5py
import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from phantom_vlb_tpu.data import token_cache as jtc
from phantom_vlb_tpu.data.lazyload_build import LazyloadBuildConfig, build_lazyload_dsets
from phantom_vlb_tpu.data.loader import LazyDataset as JLazyDataset
from phantom_vlb_tpu.data.synthetic import TEST_GEOMETRY, write_synthetic_bold_file, write_synthetic_features_file
from phantom_vlb_tpu.models.videollama2 import VideoLLaMA2VLB as JVLB
from phantom_vlb_tpu.models.videollama2 import VLBConfig as JVLBConfig
from phantom_vlb_tpu_torch.data import token_cache as ttc
from phantom_vlb_tpu_torch.data.loader import BatchLoader, LazyDataset
from phantom_vlb_tpu_torch.data.schemas import MemoryStore
from phantom_vlb_tpu_torch.models import videollama2 as tv
from phantom_vlb_tpu_torch.models.convert import from_flax_params
from phantom_vlb_tpu_torch.train import precompute as tpre
from torch_ranks import make_model, run_ranks

G = TEST_GEOMETRY
BATCH = 4                    # 2 rows a rank on 2 ranks, 1 on 4
CSV_TOL = 1e-5
CONFIGS = Path(__file__).resolve().parents[1] / "configs"


def _bf16(bits: np.ndarray) -> np.ndarray:
    return bits.view(ml_dtypes.bfloat16).astype(np.float64)


def _within_a_bf16_ulp(got_bits, want_bits):
    a, b = _bf16(np.asarray(got_bits)), _bf16(np.asarray(want_bits))
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(b), 2.0 ** -126))) - 7)
    assert (np.abs(a - b) <= ulp).all()


@pytest.fixture(scope="module")
def lora_setup(tmp_path_factory):
    """Lazy-load files (15 samples: the last batch of 4 holds 3), the tiny
    LoRA VLB's JAX weights, the port's state dict of them and JAX's sidecar."""
    root = tmp_path_factory.mktemp("mesh_tokcache")
    eps = {"s01e01a": 8, "s01e01b": 7}
    write_synthetic_features_file(root / "f.h5", eps, G, seed=0)
    write_synthetic_bold_file(root / "b.h5", eps, G, seed=1)
    (root / "lazy").mkdir()
    paths = build_lazyload_dsets(LazyloadBuildConfig(
        str(root / "f.h5"), str(root / "b.h5"), str(root / "lazy"), "sub-01", "s1", 1, G))
    jmodel = JVLB(JVLBConfig.tiny(use_lora=True))
    s = JLazyDataset(paths)[0]
    params = jmodel.init(jax.random.key(0), s.language[None], jnp.asarray(s.vision[None], jnp.float32),
                         s.padvals[None], s.vis_weights[None], s.lang_weights[None])["params"]
    jpath = jtc.build_token_cache(jmodel, params, JLazyDataset(paths), root / "jax_tok.h5", batch_size=BATCH)
    with h5py.File(jpath, "r") as f:
        jax_tokens = f["tokens"][...]
    cfg = tv.VLBConfig.tiny(use_lora=True)
    sd = from_flax_params(params)
    one_dir = root / "one"
    port = make_model(cfg, sd)
    one_path = ttc.build_token_cache(port, LazyDataset(paths), one_dir / "tok.h5", batch_size=BATCH)
    name = f"vision_tokens_{ttc.dataset_fingerprint(LazyDataset(paths), 0, 0)[:8]}.h5"
    (one_dir / "tok.h5").rename(one_dir / name)
    with h5py.File(one_dir / name, "r") as f:
        one_tokens, one_fp = f["tokens"][...], f.attrs["fingerprint"]
    return dict(root=root, paths=paths, cfg=cfg, sd=sd, port=port, jax_tokens=jax_tokens,
                one_dir=one_dir, name=name, one_tokens=one_tokens, one_fp=one_fp, n=len(LazyDataset(paths)))


@pytest.mark.parametrize("world", [2, 4])
def test_token_cache_on_ranks_is_the_one_process_sidecar(lora_setup, world, tmp_path):
    su = lora_setup
    assert su["n"] % BATCH == 3              # the last batch: on 4 ranks rank 3 holds no real row
    file_dir, mem = tmp_path / "ranks", None
    ranks = run_ranks("many", world, tmp_path / "launch", jobs=[
        ("token_cache", dict(sd=su["sd"], cfg=su["cfg"], paths=su["paths"], cache_dir=str(file_dir),
                             batch_size=BATCH)),
        ("token_cache", dict(sd=su["sd"], cfg=su["cfg"], paths=su["paths"], cache_dir=mem, batch_size=BATCH))])
    per = BATCH // world
    real_last = su["n"] % BATCH or BATCH
    _within_a_bf16_ulp(ranks[0][0]["tokens"], su["one_tokens"])
    assert np.mean(ranks[0][0]["tokens"] != su["one_tokens"]) <= 1e-3
    for rank, (in_file, in_memory) in enumerate(ranks):
        for res in (in_file, in_memory):
            assert res["name"] == su["name"][:-len(".h5")]
            assert res["fingerprint"] == su["one_fp"]
            np.testing.assert_array_equal(res["tokens"], ranks[0][0]["tokens"])
            assert res["digest"] == res["sharded_digest"] == ttc.weights_digest(su["port"].state_dict())
            assert res["dtensors"] > 0
            assert res["last_rows"] == max(0, min(per, real_last - rank * per))
            # The rank's rows of its last batch read their cached tokens.
            first = (su["n"] // BATCH) * BATCH + min(rank * per, real_last - 1)
            assert torch.equal(res["last_vision"][0], torch.from_numpy(res["tokens"][first].view(np.int16)))
        assert in_file["before"] == {}
    assert any(r[0]["last_rows"] == 0 for r in ranks) == (world == 4)
    _within_a_bf16_ulp(ranks[0][0]["tokens"], su["jax_tokens"])
    # Found both ways: one process keeps the ranks' sidecar ...
    sidecar = file_dir / su["name"]
    mtime = sidecar.stat().st_mtime_ns
    assert ranks[0][0]["after"] == {su["name"]: mtime}
    assert ttc.build_token_cache(su["port"], LazyDataset(su["paths"]), sidecar, batch_size=BATCH) == sidecar
    assert sidecar.stat().st_mtime_ns == mtime
    # ... and the ranks keep one process's.
    one = su["one_dir"] / su["name"]
    mtime = one.stat().st_mtime_ns
    kept = run_ranks("token_cache", world, tmp_path / "launch2", sd=su["sd"], cfg=su["cfg"], paths=su["paths"],
                     cache_dir=str(su["one_dir"]), batch_size=BATCH)
    for res in kept:
        assert res["before"][su["name"]] == res["after"][su["name"]] == mtime
        np.testing.assert_array_equal(res["tokens"], su["one_tokens"])


def test_trainer_cli_with_the_token_cache_on_two_ranks(lora_setup, tmp_path):
    """``vlb-train-torch ... datamodule.vision_token_cache=DIR`` on 2 ranks
    (``mesh.fsdp=-1``): the sidecars one process builds, and its CSV."""
    su = lora_setup
    (tmp_path / "lazy").mkdir()
    build_lazyload_dsets(LazyloadBuildConfig(str(su["root"] / "f.h5"), str(su["root"] / "b.h5"),
                                             str(tmp_path / "lazy"), "sub-01", "s1", 2, G))
    pattern = str(tmp_path / "lazy" / "friends_llFile_sub-01_s*_n*.h5")

    def argv(name):
        return ["experiment=vlb_friends_lora", "subject=sub-01", f"datamodule.lazyload_path={pattern}",
                "datamodule.seasons=[s1]", f"datamodule.batch_size={BATCH}", "model.preset=tiny",
                "model.lora_r=4", "model.lora_alpha=8", "model.lora_dropout=0.1", "trainer.max_epochs=1",
                "trainer.log_every_n_steps=1", "trainer.val_check_interval=0.5", "optim.t_max=100",
                f"output_dir={tmp_path / name}", "run_name=tok",
                f"datamodule.vision_token_cache={tmp_path / name / 'tok'}", "--device", "cpu"]

    run_ranks("cli", 2, tmp_path / "launch", argv=argv("two"))
    from phantom_vlb_tpu_torch.cli.train import main

    assert main(argv("one")) == 0
    sidecars = sorted(p.name for p in (tmp_path / "one" / "tok").glob("vision_tokens_*.h5"))
    assert len(sidecars) == 2 and sidecars == sorted(p.name for p in (tmp_path / "two" / "tok").glob("*.h5"))
    for name in sidecars:
        with h5py.File(tmp_path / "one" / "tok" / name, "r") as a, h5py.File(tmp_path / "two" / "tok" / name) as b:
            assert a.attrs["fingerprint"] == b.attrs["fingerprint"]
            np.testing.assert_array_equal(a["tokens"][...], b["tokens"][...])
    _compare_csv(_csv(tmp_path / "two", "tok"), _csv(tmp_path / "one", "tok"), CSV_TOL, CSV_TOL)


# ---------------------------------------------------------------------------
# The feature cache.

@pytest.fixture(scope="module")
def baseline_setup(tmp_path_factory):
    root = tmp_path_factory.mktemp("mesh_featcache")
    eps = {"s01e01a": 10, "s01e01b": 9}
    write_synthetic_features_file(root / "f.h5", eps, G, seed=0)
    write_synthetic_bold_file(root / "b.h5", eps, G, seed=1)
    (root / "lazy").mkdir()
    paths = build_lazyload_dsets(LazyloadBuildConfig(
        str(root / "f.h5"), str(root / "b.h5"), str(root / "lazy"), "sub-01", "s1", 1, G))
    cfg = tv.VLBConfig.tiny(dropout_rate=0.0)
    jmodel = JVLB(JVLBConfig.tiny(dropout_rate=0.0))
    s = JLazyDataset(paths)[0]
    params = jmodel.init(jax.random.key(0), s.language[None], jnp.asarray(s.vision[None], jnp.float32),
                         s.padvals[None], s.vis_weights[None], s.lang_weights[None])["params"]
    return dict(root=root, paths=paths, cfg=cfg, sd=from_flax_params(params))


def test_feature_cache_on_two_ranks_is_the_one_process_store(baseline_setup, tmp_path):
    su = baseline_setup
    one = MemoryStore()
    n = tpre.build_feature_cache(make_model(su["cfg"], su["sd"]),
                                 BatchLoader(LazyDataset(su["paths"]), BATCH, shuffle=False, prefetch=0), one)
    assert n % BATCH == 3                                    # the last batch: 2 real rows on rank 0, 1 on rank 1
    want_batches = list(tpre.CachedFeatureLoader(one, BATCH, shuffle=True, seed=5))
    ranks = run_ranks("feature_cache", 2, tmp_path, sd=su["sd"], cfg=su["cfg"], paths=su["paths"],
                      batch_size=BATCH)
    feats = np.stack([one[f"{i}"][f"{i}_features"] for i in range(n)]).astype(np.float64)
    ulp = 2.0 ** (np.floor(np.log2(float(np.abs(feats).max()))) - 7)
    whole = ranks[0]["store"]
    for rank, res in enumerate(ranks):
        assert res["n"] == n and res["last_rows"] == (2 if rank == 0 else 1)
        assert res["store"].keys() == one.keys()
        np.testing.assert_array_equal(res["store"]["dset_len"], one["dset_len"])
        for i in range(n):
            for field, want in one[f"{i}"].items():
                got = res["store"][f"{i}"][field]
                assert got.dtype == want.dtype and got.tobytes() == whole[f"{i}"][field].tobytes(), (i, field)
                if field.endswith("features"):
                    assert np.abs(got.astype(np.float64) - want).max() <= ulp, i
                else:
                    assert got.tobytes() == want.tobytes(), (i, field)
        # Each rank's cached batches: its rows of the one-process batches over the same store.
        mine = list(tpre.CachedFeatureLoader(_store(whole), BATCH, shuffle=True, seed=5))
        assert len(res["batches"]) == len(mine) == len(want_batches)
        rows = slice(2 * rank, 2 * rank + 2)
        for got, want in zip(res["batches"], mine):
            for key, value in want.items():
                assert got[key].tobytes() == value[rows].tobytes(), key


def _store(tree: dict) -> MemoryStore:
    out = MemoryStore()
    for key, value in tree.items():
        out[key] = _store(value) if isinstance(value, dict) else value
    return out


def _cli_args(pattern, out):
    """``tests/test_torch_precompute.py``'s cached-baseline arguments."""
    return ["experiment=vlb_friends_baseline", "subject=sub-01", f"datamodule.lazyload_path={pattern}",
            "datamodule.seasons=[s1]", f"datamodule.batch_size={BATCH}", "model.preset=tiny",
            "model.cache_features=true", "model.dropout_rate=0.0", "trainer.max_epochs=2",
            "trainer.val_check_interval=0.5", "trainer.log_every_n_steps=2", "optim.t_max=100",
            f"output_dir={out}", "run_name=cached"]


def _csv(out, run="cached"):
    (path,) = glob.glob(str(out / run / "*" / "metrics.csv"))
    with open(path, newline="") as f:
        return list(csv.DictReader(f))


def _compare_csv(got, want, loss_tol, corr_tol):
    assert [(r["epoch"], r["step"]) for r in got] == [(r["epoch"], r["step"]) for r in want]
    assert sum(bool(r["val/brain_loss"]) for r in got) >= 2
    for g, w in zip(got, want):
        for key, value in w.items():
            if not value or key in ("epoch", "step", "train/steps_per_sec"):
                assert (g[key] == "") == (value == ""), key
                continue
            tol = corr_tol if "corr" in key else loss_tol * abs(float(value))
            assert abs(float(g[key]) - float(value)) <= tol, (key, g[key], value)


def _read_cache(path):
    with h5py.File(path, "r") as f:
        n = int(f["dset_len"][0])
        return n, {key: np.stack([f[f"{i}"][f"{i}_{key}"][...] for i in range(n)])
                   for key in ("features", "weights", "timeseries")}


def test_cached_training_cli_on_two_ranks(tmp_path, monkeypatch):
    """``vlb-train-torch model.cache_features=true`` on 2 ranks against one
    process and ``vlb-train``, on the JAX builder's weights."""
    from phantom_vlb_tpu.cli.build_lazyload import main as build_lazyload
    from phantom_vlb_tpu.cli.train import main as jmain
    from phantom_vlb_tpu.core.config import load_config as jload
    from phantom_vlb_tpu.train import builder as jbuilder
    from phantom_vlb_tpu_torch.cli.train import main as tmain
    from phantom_vlb_tpu_torch.train import builder as tbuilder

    eps = {"s01e01a": 9, "s01e01b": 8, "s01e02a": 8}
    write_synthetic_features_file(tmp_path / "features_s1.h5", eps, G, seed=0)
    write_synthetic_bold_file(tmp_path / "bold.h5", eps, G, seed=1)
    (tmp_path / "lazy").mkdir()
    assert build_lazyload([
        "--features_path", str(tmp_path / "features_s1.h5"), "--timeseries_path", str(tmp_path / "bold.h5"),
        "--lazyload_path", str(tmp_path / "lazy"), "--subject", "sub-01", "--season", "s1",
        "--n_split", "2", "--window", str(G.window), "--delay", str(G.delay)]) == 0
    pattern = str(tmp_path / "lazy" / "friends_llFile_sub-01_s*_n*.h5")
    assert jmain(_cli_args(pattern, tmp_path / "jax")) == 0
    config = jload(str(CONFIGS), "base", _cli_args(pattern, tmp_path / "jax"))
    jmodel = JVLB(jbuilder.build_model_config(config.model))
    sd = from_flax_params(jbuilder.init_model_params(jmodel, G, jmodel.config.mistral.vocab_size,
                                                     int(config.random_state)))
    run_ranks("cli", 2, tmp_path / "launch", argv=[*_cli_args(pattern, tmp_path / "two"), "--device", "cpu"],
              sd=sd)
    monkeypatch.setattr(tbuilder, "init_params", lambda cfg, device, generator: {k: t.clone() for k, t in sd.items()})
    assert tmain([*_cli_args(pattern, tmp_path / "one"), "--device", "cpu"]) == 0

    for split in ("train", "val"):
        n1, one = _read_cache(tmp_path / "one" / f"feature_cache_{split}.h5")
        n2, two = _read_cache(tmp_path / "two" / f"feature_cache_{split}.h5")
        nj, want = _read_cache(tmp_path / "jax" / f"feature_cache_{split}.h5")
        assert n1 == n2 == nj
        for key in ("weights", "timeseries"):
            assert one[key].tobytes() == two[key].tobytes(), (split, key)
        ulp = 2.0 ** (np.floor(np.log2(float(np.abs(want["features"]).max()))) - 7)
        for ref in (one, want):
            assert np.abs(two["features"].astype(np.float64) - ref["features"]).max() <= ulp, split
    got = _csv(tmp_path / "two")
    _compare_csv(got, _csv(tmp_path / "one"), CSV_TOL, CSV_TOL)
    _compare_csv(got, _csv(tmp_path / "jax"), 1e-3, 1e-3)
    saved = [torch.load(tmp_path / run / "last" / "state.pt", weights_only=True)["params"] for run in ("one", "two")]
    assert saved[0].keys() == saved[1].keys() and all(k.startswith("head.") for k in saved[0])
    for key, want in saved[0].items():
        np.testing.assert_allclose(saved[1][key].numpy(), want.numpy(), rtol=0, atol=1e-6, err_msg=key)
