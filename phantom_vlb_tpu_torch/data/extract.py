"""Stage 1, feature extraction: transcripts + video -> a per-season features file.

Counterpart of ``phantom_vlb_tpu/data/extract.py`` (:47-255): input
triplets are matched as ``friends_*.tsv`` transcripts + ``friends_*.mkv``
videos + ``*_manualseg.tsv`` scene files; episode-level resume skips
episodes already in the output file; per episode the text loop writes
``transcript_features`` / ``transcript_onsets`` / ``masking_params`` and
the video loop writes ``video_features`` (gzip-4). The TSVs are read by
``data/text.py``'s ``read_tsv`` (the ``csv`` module, typed as pandas
types them), and the serial run's file is byte-equal to the JAX
package's.

The video decoder is ``data/video_reader.py``'s native libav reader. Frames
are preprocessed on the host (PIL) unless ``extract_episode`` is given a
``preprocess_batch``, such as ``ops/preprocess.py``'s
``DevicePreprocessor``, which runs it on the card.
"""

from __future__ import annotations

import dataclasses
import glob as globlib
import os
from pathlib import Path
from typing import Callable

import numpy as np

from phantom_vlb_tpu_torch.core.geometry import VLBGeometry
from phantom_vlb_tpu_torch.data.schemas import (
    FeatureEpisode,
    import_h5py,
    list_feature_episodes,
    write_feature_episode,
)
from phantom_vlb_tpu_torch.data.text import (
    TokenizerProtocol,
    TranscriptProcessor,
    default_chat_template,
    get_scene_onsets,
    read_tsv,
)
from phantom_vlb_tpu_torch.data.video import (
    VideoSource,
    extract_video_chunk,
    extract_video_features,
    tr_end_times,
)

__all__ = ["ExtractConfig", "get_input_paths", "extract_episode", "extract_features"]


@dataclasses.dataclass
class ExtractConfig:
    input_transcript_path: str
    input_seg_path: str
    input_video_path: str
    lazy_load_path: str              # output features .h5 (reference arg name)
    geometry: VLBGeometry = dataclasses.field(default_factory=VLBGeometry)
    # 'batched': unique-frame dedup + chunked preprocess (least work);
    # 'per_tr': the reference's loop shape, small recycled buffers (fastest
    # on hosts with lazily backed memory). Outputs are byte-identical.
    video_mode: str = "batched"


def get_input_paths(config: ExtractConfig) -> dict[str, dict[str, str]]:
    """Episode -> {transcript, seg, video} path triplets."""
    transcript_path = str(Path(config.input_transcript_path).resolve())
    segmentation_path = str(Path(config.input_seg_path).resolve())
    video_path = str(Path(config.input_video_path).resolve())

    input_paths: dict[str, dict[str, str]] = {}
    for tr_file in sorted(globlib.glob(f"{transcript_path}/friends_*.tsv")):
        ep_num = os.path.basename(tr_file).split("_")[-1].split(".")[0]
        v_path = f"{video_path}/friends_{ep_num}.mkv"
        # Scene files use unpadded season numbers (s01 -> s1).
        s_path = (f"{segmentation_path}/friends_{ep_num}_manualseg.tsv").replace(
            "s0", "s"
        )
        if Path(v_path).exists() and Path(s_path).exists():
            input_paths[ep_num] = {
                "transcript": tr_file,
                "seg": s_path,
                "video": v_path,
            }
    return input_paths


def extract_episode(
    transcript,
    seg,
    video_source: VideoSource,
    geometry: VLBGeometry,
    tokenizer: TokenizerProtocol,
    chat_template: Callable[[str, str], str] = default_chat_template,
    preprocess_batch=None,
    video_mode: str = "batched",
) -> FeatureEpisode:
    """Full single-episode extraction (text + video) from the transcript and
    scene tables (column -> cells, as ``read_tsv`` gives them).

    ``preprocess_batch`` selects the frame-preprocessing backend: None = the
    host path (byte parity); ``ops.preprocess.DevicePreprocessor`` = pad,
    resize and normalise on the card (``video_mode='batched'`` only).
    """
    processor = TranscriptProcessor(tokenizer, geometry, chat_template)
    scene_onsets = get_scene_onsets(seg)
    tokens, onsets, maskvals = processor.process_episode(transcript, scene_onsets)

    if video_mode == "per_tr":
        duration = video_source.num_frames / video_source.fps
        video = np.stack([
            extract_video_chunk(video_source, t, geometry)
            for t in tr_end_times(duration, geometry.tr)
        ])
    else:
        video = extract_video_features(
            video_source, geometry, preprocess_batch=preprocess_batch
        )
    return FeatureEpisode(
        transcript_features=tokens,
        transcript_onsets=onsets,
        masking_params=maskvals,
        video_features=video,
    )


def _extract_one(
    ep_num: str,
    paths: dict[str, str],
    config: ExtractConfig,
    tokenizer: TokenizerProtocol,
    open_video: Callable[[str], VideoSource],
    chat_template: Callable[[str, str], str],
) -> FeatureEpisode:
    """One episode end to end (the unit of both the serial loop and the pool)."""
    transcript = read_tsv(paths["transcript"])
    seg = read_tsv(paths["seg"])
    source = open_video(paths["video"])
    try:
        return extract_episode(
            transcript, seg, source, config.geometry, tokenizer,
            chat_template, video_mode=config.video_mode,
        )
    finally:
        close = getattr(source, "close", None)
        if close:
            close()


def extract_features(
    config: ExtractConfig,
    tokenizer: TokenizerProtocol,
    open_video: Callable[[str], VideoSource],
    chat_template: Callable[[str, str], str] = default_chat_template,
    progress: Callable[[str], None] = lambda s: None,
    jobs: int = 1,
) -> list[str]:
    """Season-level extraction with episode resume; returns episodes written.

    ``jobs > 1`` runs a fork-based process pool over episodes (the
    reference budgets 32 CPUs for its decoder). Episodes are independent
    and the HDF5 episode group is the write unit, so each worker writes an
    isolated ``<out>.part-<ep>.h5`` and the parent merges completed groups
    (chunk-preserving H5Ocopy — no recompression) as workers finish.
    Resume semantics are identical to the serial path: only episodes
    already in the MAIN output file are skipped; stale part files from a
    killed run are deleted and recomputed.
    """
    out_path = str(Path(config.lazy_load_path).resolve())
    done = set(list_feature_episodes(out_path))
    inputs = get_input_paths(config)
    todo = [ep for ep in inputs if ep not in done]

    if jobs <= 1 or len(todo) <= 1:
        written: list[str] = []
        for ep_num in todo:
            progress(f"extracting {ep_num}")
            episode = _extract_one(
                ep_num, inputs[ep_num], config, tokenizer,
                open_video, chat_template,
            )
            write_feature_episode(out_path, ep_num, episode)
            written.append(ep_num)
        return written

    return _extract_features_pooled(
        out_path, todo, inputs, config, tokenizer, open_video,
        chat_template, progress, jobs,
    )


def _part_path(out_path: str, ep_num: str) -> str:
    return f"{out_path}.part-{ep_num}.h5"


def _merge_part(out_path: str, part: str, ep_num: str) -> None:
    """Move the worker's episode group into the main file (raw-chunk copy)."""
    h5py = import_h5py("merging an extraction worker's part file")
    with h5py.File(part, "r") as src, h5py.File(out_path, "a") as dst:
        if ep_num in dst:  # crashed mid-merge last run; keep the complete one
            del dst[ep_num]
        src.copy(src[ep_num], dst, name=ep_num)
    os.unlink(part)


def _extract_features_pooled(
    out_path, todo, inputs, config, tokenizer, open_video,
    chat_template, progress, jobs,
) -> list[str]:
    import multiprocessing as mp

    # fork: workers inherit the (unpicklable) tokenizer, chat-template and
    # video-opener closures through the address space, as the JAX package's
    # pool does; nothing is pickled.
    ctx = mp.get_context("fork")

    def worker(ep_num: str) -> None:
        part = _part_path(out_path, ep_num)
        if os.path.exists(part):  # stale from a killed run — recompute
            os.unlink(part)
        episode = _extract_one(
            ep_num, inputs[ep_num], config, tokenizer, open_video,
            chat_template,
        )
        write_feature_episode(part, ep_num, episode)

    pending = list(todo)
    running: dict = {}   # Process -> ep_num
    written: list[str] = []
    failed: list[tuple[str, int]] = []
    try:
        while pending or running:
            while pending and len(running) < jobs:
                ep_num = pending.pop(0)
                progress(f"extracting {ep_num}")
                p = ctx.Process(target=worker, args=(ep_num,), daemon=True)
                p.start()
                running[p] = ep_num
            for p in list(running):
                p.join(timeout=0.2)
                if p.exitcode is None:
                    continue
                ep_num = running.pop(p)
                if p.exitcode == 0:
                    _merge_part(out_path, _part_path(out_path, ep_num), ep_num)
                    written.append(ep_num)
                    progress(f"done {ep_num}")
                else:
                    failed.append((ep_num, p.exitcode))
    finally:
        for p in running:  # interrupted: don't leave orphans
            p.terminate()
    if failed:
        raise RuntimeError(
            f"extraction failed for {failed}; completed episodes are "
            "committed — rerun to resume"
        )
    return sorted(written)
