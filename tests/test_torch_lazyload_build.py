"""Port: stage 2 (the lazy-load builder) and the layouts' write side against
the JAX package.

The synthetic features and BOLD files, and every lazy-load file built from
them, byte-equal to the JAX package's; the same build into in-memory
stores holds the same arrays, and the port's loader reads those stores as
it reads the files (equal batches); each sample's rows against the source
rows they came from; ``infer_geometry`` as the JAX package's, and its
refusal of a window that does not divide the frames.
"""

import dataclasses

import numpy as np
import pytest

from phantom_vlb_tpu.data import lazyload_build as jbuild
from phantom_vlb_tpu.data import synthetic as jsynth
from phantom_vlb_tpu_torch.data import lazyload_build as build
from phantom_vlb_tpu_torch.data import synthetic as synth
from phantom_vlb_tpu_torch.data.hrf import get_hrf_weights
from phantom_vlb_tpu_torch.data.loader import BatchLoader, LazyDataset
from phantom_vlb_tpu_torch.data.schemas import (
    LazySample,
    MemoryStore,
    bold_episode_keys,
    iter_lazy_samples,
    lazyload_len,
    read_feature_episode,
    validate_features_file,
    validate_lazyload_file,
)

EPISODES = {"s01e01a": 12, "s01e01b": 10, "s01e02a": 11, "s01e02b": 9}
GEOM = synth.TEST_GEOMETRY


def _jgeom():
    return jsynth.TEST_GEOMETRY


@pytest.fixture(scope="module")
def stages(tmp_path_factory):
    root = tmp_path_factory.mktemp("stages")
    for pkg, tag in ((synth, "port"), (jsynth, "jax")):
        geom = GEOM if pkg is synth else _jgeom()
        pkg.write_synthetic_features_file(root / f"features_{tag}.h5", EPISODES, geom, seed=0)
        pkg.write_synthetic_bold_file(root / f"bold_{tag}.h5", EPISODES, geom, seed=1)
    return root


def test_synthetic_files_byte_equal(stages):
    for stem in ("features", "bold"):
        assert (stages / f"{stem}_port.h5").read_bytes() == (stages / f"{stem}_jax.h5").read_bytes()
    assert validate_features_file(stages / "features_port.h5", GEOM) == sorted(EPISODES)
    keys = bold_episode_keys(stages / "bold_port.h5")
    assert keys["s01e01b"] == ("ses-002", "ses-002_task-s01e01b") and set(keys) == set(EPISODES)


@pytest.mark.parametrize("n_split", [1, 2, 3, 5])
def test_lazyload_files_byte_equal(stages, tmp_path, n_split):
    """Every split file byte-equal to the JAX builder's (with 5 splits for 4
    episodes one file holds none and is only its dset_len)."""
    kw = dict(subject="sub-01", season="s1", n_split=n_split)
    (tmp_path / "port").mkdir()
    (tmp_path / "jax").mkdir()
    paths = build.build_lazyload_dsets(build.LazyloadBuildConfig(
        str(stages / "features_port.h5"), str(stages / "bold_port.h5"), str(tmp_path / "port"),
        geometry=GEOM, **kw))
    jpaths = jbuild.build_lazyload_dsets(jbuild.LazyloadBuildConfig(
        str(stages / "features_port.h5"), str(stages / "bold_port.h5"), str(tmp_path / "jax"),
        geometry=_jgeom(), **kw))
    assert [p.rsplit("/", 1)[1] for p in paths] == [p.rsplit("/", 1)[1] for p in jpaths]
    assert paths[0].endswith(build.lazyload_filename("sub-01", "s1", 0))
    for p, jp in zip(paths, jpaths):
        with open(p, "rb") as a, open(jp, "rb") as b:
            assert a.read() == b.read(), p
    total = sum(lazyload_len(p) for p in paths)
    assert total == sum(n - GEOM.bold_offset for n in EPISODES.values())
    for p in paths:
        validate_lazyload_file(p, GEOM)


@pytest.fixture(scope="module")
def built(stages, tmp_path_factory):
    """The same build into files and into in-memory stores (features and
    BOLD read from stores too)."""
    out = stages / "lazy"
    out.mkdir()
    kw = dict(subject="sub-01", season="s1", n_split=2, geometry=GEOM)
    paths = build.build_lazyload_dsets(build.LazyloadBuildConfig(
        str(stages / "features_port.h5"), str(stages / "bold_port.h5"), str(out), **kw))
    features, bold, container = MemoryStore(), MemoryStore(), MemoryStore()
    synth.write_synthetic_features_file(features, EPISODES, GEOM, seed=0)
    synth.write_synthetic_bold_file(bold, EPISODES, GEOM, seed=1)
    stores = build.build_lazyload_dsets(build.LazyloadBuildConfig(features, bold, container, **kw))
    assert list(container) == [p.rsplit("/", 1)[1] for p in paths]
    return paths, stores, features, bold


def test_stores_hold_the_files_arrays(built):
    paths, stores, features, _ = built
    for p, store in zip(paths, stores):
        assert lazyload_len(store) == lazyload_len(p) and validate_lazyload_file(store, GEOM) > 0
        for a, b in zip(iter_lazy_samples(p), iter_lazy_samples(store)):
            for field in LazySample.FIELDS:
                x, y = getattr(a, field), getattr(b, field)
                assert x.dtype == y.dtype
                np.testing.assert_array_equal(x, y)
    files = paths[0].rsplit("/", 2)[0]
    for ep in EPISODES:            # the features store holds the features file's arrays
        a, b = read_feature_episode(features, ep), read_feature_episode(f"{files}/features_port.h5", ep)
        for x, y in zip(dataclasses.astuple(a), dataclasses.astuple(b)):
            np.testing.assert_array_equal(x, y)


def test_alignment_against_source(built):
    """Each sample's rows are its episode's rows past the offsets, bit-equal;
    vis_weights the geometry's, lang_weights the HRF of its onsets."""
    _, stores, features, bold = built
    keys = bold_episode_keys(bold)
    vis = get_hrf_weights(GEOM.vision_onset_deltas())
    episodes = sorted(EPISODES)
    split_of = np.floor(np.arange(len(episodes)) / (len(episodes) / 2)).astype(int)
    for i, store in enumerate(stores):
        idx = 0
        for ep in [e for e, s in zip(episodes, split_of) if s == i]:
            src = read_feature_episode(features, ep)
            ses, run = keys[ep]
            ts = np.asarray(bold[ses][run])
            onsets = GEOM.target_tr_onsets(len(ts) - GEOM.bold_offset)
            for n in range(EPISODES[ep] - GEOM.bold_offset):
                g = store[f"{idx}"]
                row = GEOM.window_offset + n
                np.testing.assert_array_equal(g[f"{idx}_vision"], src.video_features[row])
                np.testing.assert_array_equal(g[f"{idx}_language"], src.transcript_features[row])
                np.testing.assert_array_equal(g[f"{idx}_padvals"], src.masking_params[row])
                np.testing.assert_array_equal(g[f"{idx}_timeseries"], ts[GEOM.bold_offset + n])
                np.testing.assert_array_equal(g[f"{idx}_vis_weights"], vis)
                diag = int(src.masking_params[row][2])
                want = src.transcript_onsets[row].copy()
                want[:diag] = get_hrf_weights(onsets[n] - want[:diag])
                np.testing.assert_array_equal(g[f"{idx}_lang_weights"], want)
                idx += 1
        assert idx == lazyload_len(store)


@pytest.mark.parametrize("prefetch", [0, 2])
def test_loader_reads_stores_as_files(built, prefetch):
    paths, stores, _, _ = built
    from_files = BatchLoader(LazyDataset(paths), batch_size=3, seed=5, prefetch=prefetch, num_threads=2)
    from_stores = BatchLoader(LazyDataset(stores), batch_size=3, seed=5, prefetch=prefetch, num_threads=2)
    assert len(from_files) == len(from_stores)
    for a, b in zip(from_files, from_stores):
        for field, x in a.as_dict().items():
            y = getattr(b, field)
            assert x.dtype == y.dtype and x.shape == y.shape
            np.testing.assert_array_equal(x, y)


def test_token_cache_refuses_a_dataset_of_stores(built, tmp_path):
    """A sidecar file is keyed by lazy-load files: over in-memory stores
    the token cache refuses a file, and takes an in-memory sidecar (a
    ``MemoryStore``) keyed by each store's place, count and content."""
    from phantom_vlb_tpu_torch.data import token_cache as ttc
    from phantom_vlb_tpu_torch.models import videollama2 as tv
    from phantom_vlb_tpu_torch.models.convert import init_params

    ds = LazyDataset(built[1])
    cfg = tv.VLBConfig.tiny()
    model = tv.VideoLLaMA2VLB.from_state_dict(cfg, init_params(cfg, device="cpu"))
    with pytest.raises(ValueError, match="stores"):
        ttc.build_token_cache(model, ds, tmp_path / "tok.h5", batch_size=3)
    assert not list(tmp_path.iterdir())
    assert ttc.dataset_fingerprint(ds, 27, 64) == ttc.dataset_fingerprint(LazyDataset(built[1]), 27, 64)
    side = ttc.build_token_cache(model, ds, MemoryStore(), batch_size=3)
    assert side["tokens"].shape == (len(ds), cfg.geometry.num_vis_tokens, cfg.mistral.hidden_size)


def test_infer_geometry_matches_jax_and_rejects_a_bad_window(stages, built):
    got = build.infer_geometry(str(stages / "features_port.h5"), window=GEOM.window, delay=GEOM.delay)
    want = jbuild.infer_geometry(str(stages / "features_port.h5"), window=GEOM.window, delay=GEOM.delay)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert dataclasses.replace(got, num_parcels=GEOM.num_parcels) == GEOM
    assert build.infer_geometry(built[2], window=GEOM.window, delay=GEOM.delay) == got   # a store
    with pytest.raises(AssertionError):
        jbuild.infer_geometry(str(stages / "features_port.h5"), window=3)   # 4 frames % 3 != 0
    with pytest.raises(ValueError, match="not divisible by window=3"):
        build.infer_geometry(str(stages / "features_port.h5"), window=3)


def test_schemas_raise_on_wrong_shapes(stages):
    ep = read_feature_episode(stages / "features_port.h5", "s01e01a")
    ep.validate(GEOM)
    with pytest.raises(ValueError, match="video_features"):
        dataclasses.replace(ep, video_features=ep.video_features[..., :28]).validate(GEOM)
    with pytest.raises(ValueError, match="transcript_onsets"):
        ep.validate(dataclasses.replace(GEOM, onsets_width=8))
