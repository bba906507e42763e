"""Port: the video stage against the JAX package.

Window arithmetic and the host (PIL) preprocessing path bit-equal, whole
episodes through ``extract_video_features`` (host path, one thread and a
pool; and the device preprocessor run on the CPU against the JAX package's
device path within 1e-4), and the native libav decoder: videos written by
either package's ``write_test_video`` decode to the same frames through
either reader.
"""

import numpy as np
import pytest
import torch

from phantom_vlb_tpu.core.geometry import VLBGeometry as JGeometry
from phantom_vlb_tpu.data import video as jvideo
from phantom_vlb_tpu.data import video_reader as jreader
from phantom_vlb_tpu.ops.preprocess import DevicePreprocessor as JDevicePreprocessor
from phantom_vlb_tpu.ops.preprocess import device_preprocess
from phantom_vlb_tpu_torch.core.geometry import VLBGeometry
from phantom_vlb_tpu_torch.data import video, video_reader
from phantom_vlb_tpu_torch.ops.preprocess import DevicePreprocessor

GEOM = dict(tr=1.49, frames_per_tr=2, window=2, delay=1, model_max_length=64, image_size=56,
            patch_size=14, onsets_width=16, num_parcels=8)
DEVICE_TOL = 1e-4          # tests/test_torch_vision_vlb.py's bound for preprocess


def test_window_arithmetic_matches_jax():
    for duration in (3.0, 17.2, 60.0, 1.49 * 40):
        assert video.tr_end_times(duration, 1.49) == jvideo.tr_end_times(duration, 1.49)
    for n, k in ((100, 12), (7, 12), (40, 4), (1, 3)):
        assert video.frame_sample(n, k) == jvideo.frame_sample(n, k)
    for fps in (23.976, 29.97, 30.0):
        for end in (1.49, 2.98, 5.96, 44.7):
            for window, fpt in ((3, 4), (2, 2)):
                args = (end, window, fps, 2000, 1.49, fpt)
                assert video.tr_window_indices(*args) == jvideo.tr_window_indices(*args)
    np.testing.assert_array_equal(video.CLIP_MEAN, jvideo.CLIP_MEAN)
    np.testing.assert_array_equal(video.CLIP_STD, jvideo.CLIP_STD)


@pytest.mark.parametrize("h,w,size", [(48, 64, 56), (64, 48, 56), (56, 56, 56), (90, 160, 336)])
def test_host_preprocess_bit_equal(h, w, size):
    frames = np.random.default_rng(h + w).integers(0, 256, (3, h, w, 3), dtype=np.uint8)
    fill = (1, 2, 3)
    np.testing.assert_array_equal(video.expand2square(frames[0], fill), jvideo.expand2square(frames[0], fill))
    got = video.host_preprocess(list(frames), size)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, jvideo.host_preprocess(list(frames), size))


def _source(module, n, h=48, w=64, fps=30.0, seed=0):
    frames = np.random.default_rng(seed).integers(0, 256, (n, h, w, 3), dtype=np.uint8)
    return module.ArrayVideoSource(frames, fps)


def test_extract_video_chunk_matches_jax():
    g, jg = VLBGeometry(**GEOM), JGeometry(**GEOM)
    for end in (g.tr, 2 * g.tr, 5 * g.tr):   # the first window pads with black frames
        got = video.extract_video_chunk(_source(video, 300), end, g)
        np.testing.assert_array_equal(got, jvideo.extract_video_chunk(_source(jvideo, 300), end, jg))


@pytest.mark.parametrize("threads,chunk_tr", [(0, 32), (2, 3)])
def test_extract_video_features_host_bit_equal(threads, chunk_tr):
    g, jg = VLBGeometry(**GEOM), JGeometry(**GEOM)
    n = int(9 * g.tr * 30) + 17
    got = video.extract_video_features(_source(video, n), g, chunk_tr=chunk_tr, num_threads=threads)
    want = jvideo.extract_video_features(_source(jvideo, n), jg, chunk_tr=chunk_tr, num_threads=threads)
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    # The same as the per-TR loop, TR by TR.
    per_tr = [video.extract_video_chunk(_source(video, n), t, g)
              for t in video.tr_end_times(n / 30.0, g.tr)]
    np.testing.assert_array_equal(got, np.stack(per_tr))


@pytest.mark.parametrize("h,w", [(48, 64), (80, 45), (56, 56)])
def test_device_preprocessor_on_the_cpu_matches_jax(h, w):
    frames = np.random.default_rng(h * w).integers(0, 256, (5, h, w, 3), dtype=np.uint8)
    pre = DevicePreprocessor(56, device="cpu")
    got = pre(list(frames))
    assert isinstance(got, np.ndarray) and got.dtype == np.float32 and got.shape == (5, 3, 56, 56)
    np.testing.assert_allclose(got, device_preprocess(frames, 56), atol=DEVICE_TOL, rtol=0)
    np.testing.assert_array_equal(got, pre(frames))             # an array or a list of frames


def test_extract_video_features_through_the_device_preprocessor():
    """A whole episode with the device preprocessor (run on the CPU here)
    against the JAX package's device path."""
    g, jg = VLBGeometry(**GEOM), JGeometry(**GEOM)
    n = int(6 * g.tr * 30) + 5
    got = video.extract_video_features(_source(video, n), g,
                                       preprocess_batch=DevicePreprocessor(g.image_size, device="cpu"))
    want = jvideo.extract_video_features(_source(jvideo, n), jg,
                                         preprocess_batch=JDevicePreprocessor(jg.image_size))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=DEVICE_TOL, rtol=0)


def test_device_preprocessor_needs_a_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        DevicePreprocessor(56)


@pytest.fixture(scope="module")
def videos(tmp_path_factory):
    """Both packages' test videos. The JAX reader loads the library the
    port built from the same source with the same flags, so no ``make``
    runs in ``native/decode`` while other test files may be running it."""
    root = tmp_path_factory.mktemp("native")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jreader, "ensure_built", video_reader.ensure_built)
        video_reader.write_test_video(root / "port.mkv", 64, 48, 90, 29.97)
        jreader.write_test_video(root / "jax.mkv", 64, 48, 90, 29.97)
        yield root


@pytest.mark.parametrize("name", ["port", "jax"])
def test_native_decoder_frames_match_jax(videos, name):
    """Either package's test video decodes to the same frames through either
    reader, in order, out of order (a reopen past the cache) and by
    windows."""
    path = videos / f"{name}.mkv"
    src, ref = video_reader.NativeVideoSource(path, cache_size=8), jreader.NativeVideoSource(path, cache_size=8)
    try:
        assert (src.fps, src.num_frames) == (ref.fps, ref.num_frames) and src.num_frames == 90
        for idx in ([0, 1, 2], [40, 41, 60], [3, 89], [5]):
            np.testing.assert_array_equal(src.get_batch(idx), ref.get_batch(idx))
        g = VLBGeometry(**GEOM)
        np.testing.assert_array_equal(video.extract_video_features(src, g),
                                      jvideo.extract_video_features(ref, JGeometry(**GEOM)))
    finally:
        src.close()
        ref.close()
    assert video_reader.NativeVideoSource(path, exact_count=False).num_frames > 0


def test_native_decoder_build_is_keyed_by_source():
    lib = video_reader.ensure_built()
    assert lib.exists() and lib.parent == video_reader.BUILD_DIR
    assert lib.name.startswith("vlb_decode-") and lib == video_reader._library()
