"""Port: stage 1 (extraction) against the JAX package.

``extract_episode`` from ``read_tsv`` tables against the JAX package's from
pandas DataFrames (bit-equal; the device preprocessor run on the CPU within
1e-4 of the JAX package's device path); the serial ``extract_features``
file byte-equal to the JAX package's for the same season; the pooled run
(``jobs=2``, merged in completion order) dataset-equal to the serial one
(values, dtype, shape, chunks, gzip-4) with a stale part file replaced;
resume; a failing worker that leaves completed episodes committed.
"""

import h5py
import numpy as np
import pandas as pd
import pytest

from phantom_vlb_tpu.data import extract as jextract
from phantom_vlb_tpu.data import text as jtext
from phantom_vlb_tpu.data import video as jvideo
from phantom_vlb_tpu.ops.preprocess import DevicePreprocessor as JDevicePreprocessor
from phantom_vlb_tpu_torch.core.geometry import VLBGeometry
from phantom_vlb_tpu_torch.data import extract, text, video
from phantom_vlb_tpu_torch.data.schemas import (
    FeatureEpisode,
    list_feature_episodes,
    read_feature_episode,
    validate_features_file,
)
from phantom_vlb_tpu_torch.ops.preprocess import DevicePreprocessor
from test_extract import EXTRACT_GEOMETRY, _season_fixture, _seg_df, _transcript_df

GEOM = VLBGeometry(**{f: getattr(EXTRACT_GEOMETRY, f) for f in (
    "tr", "frames_per_tr", "window", "delay", "model_max_length", "image_size", "patch_size",
    "onsets_width", "num_parcels")})
EPISODES = ["s01e01a", "s01e01b", "s01e01c"]
N_TR = 6


def _tables(tmp_path, n_tr):
    _transcript_df(n_tr, EXTRACT_GEOMETRY).to_csv(tmp_path / "t.tsv", sep="\t", index=False)
    _seg_df(n_tr, EXTRACT_GEOMETRY).to_csv(tmp_path / "s.tsv", sep="\t", index=False)
    return ((text.read_tsv(tmp_path / "t.tsv"), text.read_tsv(tmp_path / "s.tsv")),
            (pd.read_csv(tmp_path / "t.tsv", sep="\t"), pd.read_csv(tmp_path / "s.tsv", sep="\t")))


def _frames(n_tr, seed=1):
    n = int(n_tr * GEOM.tr * 30) + 30
    return np.random.default_rng(seed).integers(0, 255, (n, 48, 64, 3), dtype=np.uint8)


@pytest.mark.parametrize("tok_name", ["WordPieceTestTokenizer", "SentencePieceTestTokenizer"])
@pytest.mark.parametrize("mode", ["batched", "per_tr"])
def test_extract_episode_bit_equal(tmp_path, tok_name, mode):
    (t, s), (tdf, sdf) = _tables(tmp_path, 8)
    frames = _frames(8)
    got = extract.extract_episode(t, s, video.ArrayVideoSource(frames, 30.0), GEOM,
                                  getattr(text, tok_name)(), video_mode=mode)
    want = jextract.extract_episode(tdf, sdf, jvideo.ArrayVideoSource(frames, 30.0), EXTRACT_GEOMETRY,
                                    getattr(jtext, tok_name)(), video_mode=mode)
    got.validate(GEOM)
    for field in FeatureEpisode.FIELDS:
        g, w = getattr(got, field), getattr(want, field)
        assert g.dtype == w.dtype and g.shape == w.shape, field
        np.testing.assert_array_equal(g, w, err_msg=field)


def test_extract_episode_with_the_device_preprocessor(tmp_path):
    (t, s), (tdf, sdf) = _tables(tmp_path, 6)
    frames = _frames(6, seed=2)
    got = extract.extract_episode(t, s, video.ArrayVideoSource(frames, 30.0), GEOM,
                                  text.SentencePieceTestTokenizer(),
                                  preprocess_batch=DevicePreprocessor(GEOM.image_size, device="cpu"))
    want = jextract.extract_episode(tdf, sdf, jvideo.ArrayVideoSource(frames, 30.0), EXTRACT_GEOMETRY,
                                    jtext.SentencePieceTestTokenizer(),
                                    preprocess_batch=JDevicePreprocessor(EXTRACT_GEOMETRY.image_size))
    np.testing.assert_array_equal(got.transcript_features, want.transcript_features)
    np.testing.assert_allclose(got.video_features, want.video_features, atol=1e-4, rtol=0)


def _configs(root, name):
    dirs = [str(root / d) for d in ("transcripts", "segs", "videos")]
    return (extract.ExtractConfig(*dirs, str(root / f"{name}.h5"), GEOM),
            jextract.ExtractConfig(*dirs, str(root / f"{name}_jax.h5"), EXTRACT_GEOMETRY))


def test_serial_features_file_byte_equal(tmp_path):
    frames = _season_fixture(tmp_path, EPISODES, N_TR, EXTRACT_GEOMETRY)
    cfg, jcfg = _configs(tmp_path, "serial")
    assert extract.get_input_paths(cfg) == jextract.get_input_paths(jcfg)
    opened = []

    def open_video(path):
        opened.append(path)
        return video.ArrayVideoSource(frames, 30.0)

    tok = text.WordPieceTestTokenizer()
    assert extract.extract_features(cfg, tok, open_video) == EPISODES
    assert jextract.extract_features(jcfg, jtext.WordPieceTestTokenizer(),
                                     lambda p: jvideo.ArrayVideoSource(frames, 30.0)) == EPISODES
    assert (tmp_path / "serial.h5").read_bytes() == (tmp_path / "serial_jax.h5").read_bytes()
    assert validate_features_file(tmp_path / "serial.h5", GEOM) == EPISODES
    # Resume: a second run opens no video and writes nothing.
    opened.clear()
    before = (tmp_path / "serial.h5").read_bytes()
    assert extract.extract_features(cfg, tok, open_video) == [] and opened == []
    assert (tmp_path / "serial.h5").read_bytes() == before


def _dataset_equal(a_path, b_path, episodes):
    with h5py.File(a_path, "r") as a, h5py.File(b_path, "r") as b:
        assert sorted(a.keys()) == sorted(b.keys()) == sorted(episodes)
        for ep in episodes:
            assert sorted(a[ep].keys()) == sorted(b[ep].keys()) == sorted(FeatureEpisode.FIELDS)
            for field in FeatureEpisode.FIELDS:
                x, y = a[ep][field], b[ep][field]
                assert (x.dtype, x.shape, x.chunks, x.compression, x.compression_opts) == (
                    y.dtype, y.shape, y.chunks, "gzip", 4), (ep, field)
                np.testing.assert_array_equal(x[...], y[...])


def test_pooled_extraction_dataset_equal_and_resumes(tmp_path):
    frames = _season_fixture(tmp_path, EPISODES, N_TR, EXTRACT_GEOMETRY)
    tok = text.WordPieceTestTokenizer()
    open_video = lambda path: video.ArrayVideoSource(frames, 30.0)  # noqa: E731
    serial, _ = _configs(tmp_path, "serial")
    pooled, _ = _configs(tmp_path, "pooled")
    # A stale part file from a killed run is replaced, not merged.
    (tmp_path / "pooled.h5.part-s01e01b.h5").write_bytes(b"garbage")
    assert extract.extract_features(serial, tok, open_video) == EPISODES
    assert extract.extract_features(pooled, tok, open_video, jobs=2) == EPISODES
    _dataset_equal(tmp_path / "pooled.h5", tmp_path / "serial.h5", EPISODES)
    assert not list(tmp_path.glob("pooled.h5.part-*"))
    # Drop one episode: the pooled rerun restores only it.
    with h5py.File(tmp_path / "pooled.h5", "a") as f:
        del f["s01e01b"]
    assert extract.extract_features(pooled, tok, open_video, jobs=2) == ["s01e01b"]
    _dataset_equal(tmp_path / "pooled.h5", tmp_path / "serial.h5", EPISODES)


def test_failing_worker_commits_completed_episodes(tmp_path):
    eps = EPISODES[:2]
    frames = _season_fixture(tmp_path, eps, N_TR, EXTRACT_GEOMETRY)
    cfg, _ = _configs(tmp_path, "out")
    tok = text.WordPieceTestTokenizer()

    def open_video(path):
        if "s01e01b" in path:
            raise RuntimeError("corrupt mkv")
        return video.ArrayVideoSource(frames, 30.0)

    with pytest.raises(RuntimeError, match="s01e01b"):
        extract.extract_features(cfg, tok, open_video, jobs=2)
    assert list_feature_episodes(tmp_path / "out.h5") == ["s01e01a"]
    ok = lambda path: video.ArrayVideoSource(frames, 30.0)  # noqa: E731
    assert extract.extract_features(cfg, tok, ok, jobs=2) == ["s01e01b"]
    np.testing.assert_array_equal(read_feature_episode(tmp_path / "out.h5", "s01e01b").video_features,
                                  read_feature_episode(tmp_path / "out.h5", "s01e01a").video_features)


def test_list_feature_episodes_creates_the_file(tmp_path):
    """Resume depends on it: a missing features file is created empty, as
    the JAX package creates it (byte-equal)."""
    assert list_feature_episodes(tmp_path / "a.h5") == []
    from phantom_vlb_tpu.data.schemas import list_feature_episodes as jlist

    assert jlist(tmp_path / "b.h5") == []
    assert (tmp_path / "a.h5").read_bytes() == (tmp_path / "b.h5").read_bytes()
