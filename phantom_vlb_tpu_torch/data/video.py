"""Video frame sampling and CLIP preprocessing for feature extraction.

Counterpart of ``phantom_vlb_tpu/data/video.py``: the same frame indices
and, on the host path, the same preprocessed bytes.

- TR window geometry: for each TR-end time ``t`` the window covers
  ``[max(0, t - window*tr), t]``; frame bounds are ``f_start =
  max(int(start*fps) - 1, 0)`` and ``f_end = min(int(end*fps) - 1,
  n_frames - 1)``; ``num_frames = round((end-start)/tr) * frames_per_tr``
  uniform-sampled indices; short head-of-episode windows are padded to
  ``window*frames_per_tr`` with black frames.
- ``frame_sample`` uniform mode (VideoLLaMA2 mm_utils): ``seg_size =
  (duration - 1) / num_frames``; index ``i`` samples ``int(seg_size / 2) +
  round(seg_size * i)``.
- ``expand2square`` pads to square with the CLIP pixel-mean fill colour,
  then the CLIP processor resizes to 336x336 (PIL bicubic) and normalises.

The host path (numpy and PIL, imported where a frame is resized) is the
byte-parity reference; ``ops/preprocess.py``'s ``DevicePreprocessor`` runs
the pad, resize and normalise on the card instead, passed as
``preprocess_batch``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Protocol, Sequence

import numpy as np

from phantom_vlb_tpu_torch.core.geometry import VLBGeometry

__all__ = [
    "CLIP_MEAN",
    "CLIP_STD",
    "VideoSource",
    "ArrayVideoSource",
    "tr_end_times",
    "frame_sample",
    "tr_window_indices",
    "expand2square",
    "clip_preprocess",
    "host_preprocess",
    "extract_video_features",
    "extract_video_chunk",
]

# OpenAI CLIP normalization constants (the vision tower's processor).
CLIP_MEAN = np.array([0.48145466, 0.4578275, 0.40821073], np.float32)
CLIP_STD = np.array([0.26862954, 0.26130258, 0.27577711], np.float32)


class VideoSource(Protocol):
    """Minimal decoder interface (decord ``VideoReader`` equivalent)."""

    @property
    def fps(self) -> float: ...
    @property
    def num_frames(self) -> int: ...
    def get_batch(self, indices: Sequence[int]) -> np.ndarray:
        """(N, H, W, 3) uint8 RGB frames."""
        ...


@dataclasses.dataclass
class ArrayVideoSource:
    """In-memory source for tests / synthetic data."""

    frames: np.ndarray  # (N, H, W, 3) uint8
    _fps: float = 29.97

    @property
    def fps(self) -> float:
        return self._fps

    @property
    def num_frames(self) -> int:
        return len(self.frames)

    def get_batch(self, indices):
        return self.frames[np.asarray(indices, int)]


def tr_end_times(duration: float, tr: float) -> list[float]:
    """TR-end timestamps (extractfeatures.py:314-317)."""
    return (np.array(range(1, math.ceil(duration / tr))) * tr).tolist()


def frame_sample(duration: int, num_frames: int) -> list[int]:
    """VideoLLaMA2 uniform frame sampling."""
    seg_size = float(duration - 1) / num_frames
    return [int(seg_size / 2) + int(np.round(seg_size * idx)) for idx in range(num_frames)]


def tr_window_indices(
    end_time: float,
    win_dur: int,
    fps: float,
    num_frames_of_video: int,
    tr: float,
    frames_per_tr: int,
) -> list[int]:
    """Absolute frame indices sampled for one TR window."""
    start_time = max(0, end_time - tr * win_dur)
    f_start = max(int(start_time * fps) - 1, 0)
    f_end = min(int(end_time * fps) - 1, num_frames_of_video - 1)
    all_frame_indices = list(range(f_start, f_end + 1))
    duration = len(all_frame_indices)
    num_frames = round((end_time - start_time) / tr) * frames_per_tr
    return [all_frame_indices[i] for i in frame_sample(duration, num_frames)]


def expand2square(img: np.ndarray, fill: tuple[int, int, int]) -> np.ndarray:
    """Pad an (H, W, 3) uint8 image to square, centered, with fill color."""
    h, w = img.shape[:2]
    if h == w:
        return img
    side = max(h, w)
    out = np.empty((side, side, 3), img.dtype)
    out[:] = np.asarray(fill, img.dtype)
    if w > h:
        top = (side - h) // 2
        out[top : top + h, :] = img
    else:
        left = (side - w) // 2
        out[:, left : left + w] = img
    return out


def _resize_bilinear(img: np.ndarray, size: int) -> np.ndarray:
    """Bicubic resize via PIL (as the HF CLIP image processor resizes); PIL
    is imported here."""
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError("the host preprocessing path needs PIL (Pillow), which is not installed; "
                          "pass a DevicePreprocessor as preprocess_batch instead") from e

    return np.asarray(
        Image.fromarray(img).resize((size, size), Image.BICUBIC), np.uint8
    )


def clip_preprocess(images: Sequence[np.ndarray], image_size: int) -> np.ndarray:
    """(T, 3, H, W) float32 normalized frames (HF CLIPImageProcessor path).

    rescale 1/255 -> resize (bicubic, as HF CLIP) -> normalize; inputs are
    already square (expand2square), so resize+center-crop == direct resize.
    The normalize/transpose runs vectorized over the whole batch (one fused
    numpy pass; the reference normalizes per frame inside the processor).
    """
    resized = np.stack([
        img if img.shape[0] == image_size else _resize_bilinear(img, image_size)
        for img in images
    ])
    scale = (1.0 / (255.0 * CLIP_STD)).astype(np.float32)
    bias = (-CLIP_MEAN / CLIP_STD).astype(np.float32)
    out = resized.astype(np.float32) * scale + bias
    return np.ascontiguousarray(out.transpose(0, 3, 1, 2))


def extract_video_features(
    source: VideoSource,
    geometry: VLBGeometry,
    preprocess_batch=None,
    chunk_tr: int = 32,
    num_threads: int = 0,
) -> np.ndarray:
    """Whole-episode video features: (n_TR, num_frames, 3, S, S) float32.

    Byte-identical to mapping :func:`extract_video_chunk` over all TRs, but:
    - frames shared by overlapping TR windows are preprocessed ONCE
      (the reference re-preprocesses every occurrence — ~3x the work at
      window=3);
    - preprocessing runs in batches of ``chunk_tr`` windows (one device call
      per chunk with a ``DevicePreprocessor``; a thread pool on the host path);
    - head-of-episode black padding is preprocessed once and reused.
    """
    import concurrent.futures as cf

    g = geometry
    duration = source.num_frames / source.fps
    tr_list = tr_end_times(duration, g.tr)
    n_tr = len(tr_list)

    if preprocess_batch is None:
        if num_threads <= 1:
            def preprocess_batch(frames):  # noqa: F811
                # Sub-batches keep the normalize temporaries cache-resident
                # (large batches cost ~2x per frame on small-cache hosts).
                parts = [
                    host_preprocess(list(frames[i : i + 16]), g.image_size)
                    for i in range(0, len(frames), 16)
                ]
                return parts[0] if len(parts) == 1 else np.concatenate(parts)
        else:
            pool = cf.ThreadPoolExecutor(max_workers=num_threads)

            def preprocess_batch(frames):  # noqa: F811
                chunk = max(1, math.ceil(len(frames) / num_threads))
                parts = [frames[i : i + chunk] for i in range(0, len(frames), chunk)]
                outs = list(pool.map(lambda p: host_preprocess(list(p), g.image_size), parts))
                return np.concatenate(outs) if len(outs) > 1 else outs[0]

    out = np.empty((n_tr, g.num_frames, 3, g.image_size, g.image_size), np.float32)
    black_processed = None

    for start in range(0, n_tr, chunk_tr):
        trs = tr_list[start : start + chunk_tr]
        windows = [
            tr_window_indices(t, g.window, source.fps, source.num_frames,
                              g.tr, g.frames_per_tr)
            for t in trs
        ]
        unique = sorted({i for w in windows for i in w})
        frames = source.get_batch(unique)
        processed = np.asarray(preprocess_batch(frames), np.float32)
        index = {fi: k for k, fi in enumerate(unique)}

        if black_processed is None and any(len(w) < g.num_frames for w in windows):
            black = np.zeros_like(frames[0])
            black_processed = np.asarray(preprocess_batch(black[None]), np.float32)[0]

        # Single vectorized gather per chunk; slot len(processed) = black pad.
        if black_processed is not None:
            table = np.concatenate([processed, black_processed[None]])
        else:
            table = processed
        idx = np.full((len(windows), g.num_frames), len(processed), np.int64)
        for row, w in enumerate(windows):
            idx[row, : len(w)] = [index[fi] for fi in w]
        # Gather straight into the output slice: `table[idx]` would build a
        # ~0.5 GB temporary per chunk that glibc maps and unmaps each
        # iteration, paying first-touch page faults every chunk.
        np.take(table, idx, axis=0, out=out[start : start + len(windows)],
                mode="clip")
    return out


def host_preprocess(frames: Sequence[np.ndarray], image_size: int) -> np.ndarray:
    """Default host path: expand2square + CLIP preprocess (byte-parity)."""
    fill = tuple(int(x * 255) for x in CLIP_MEAN)
    images = [expand2square(f, fill) for f in frames]
    return clip_preprocess(images, image_size)


def extract_video_chunk(
    source: VideoSource,
    end_time: float,
    geometry: VLBGeometry,
    preprocessor=None,
) -> np.ndarray:
    """One TR's (num_frames, 3, H, W) tensor (extractfeatures.py:320-349).

    ``preprocessor(frames) -> (T, 3, S, S)`` is pluggable: the default is the
    host parity path; pass ``ops.preprocess.DevicePreprocessor`` to run the
    pad/resize/normalize on the card.
    """
    g = geometry
    indices = tr_window_indices(
        end_time, g.window, source.fps, source.num_frames, g.tr, g.frames_per_tr
    )
    frames = [f for f in source.get_batch(indices)]
    # Head-of-episode windows: pad with black frames to the full window.
    fill_shape = frames[-1].shape
    while len(frames) < g.num_frames:
        frames.append(np.zeros(fill_shape, np.uint8))
    if preprocessor is None:
        return host_preprocess(frames, g.image_size)
    return np.asarray(preprocessor(frames))
