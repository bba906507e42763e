"""vlb-extract-torch: stage 1 of the port, per-season feature extraction.

Usage (the arguments of ``vlb-extract``)::

    vlb-extract-torch --input_transcript_path TSVS --input_seg_path SCENE_TSVS \
        --input_video_path MKVS --lazy_load_path features_s1.h5 --model_path TOKENIZER_DIR

It reads each episode's transcript and scene TSVs (the ``csv`` module),
decodes its video with the native libav reader, tokenizes with the HF fast
tokenizer under ``--model_path`` (``transformers``, local files only) and
writes the season's features file (``h5py``). Like ``vlb-extract``, it
runs on the host and has no device flag: frames are preprocessed with PIL,
and that file is byte-equal to ``vlb-extract``'s. The card's preprocessor
is reached through ``data/extract.py``'s ``extract_episode(preprocess_batch=
ops.preprocess.DevicePreprocessor(...))``.
"""

from __future__ import annotations

import argparse
import sys

from phantom_vlb_tpu_torch.core.geometry import VLBGeometry


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--input_transcript_path", required=True)
    p.add_argument("--input_seg_path", required=True)
    p.add_argument("--input_video_path", required=True)
    p.add_argument("--lazy_load_path", required=True,
                   help="output features .h5 (reference arg name)")
    p.add_argument("--model_path", default="DAMO-NLP-SG/VideoLLaMA2-7B",
                   help="local tokenizer path (HF layout)")
    p.add_argument("--model_max_length", type=int, default=2048)
    p.add_argument("--frames_per_tr", type=int, default=4)
    p.add_argument("--tr", type=float, default=1.49)
    p.add_argument("--window_duration", type=int, default=3)
    p.add_argument("--video_mode", choices=("batched", "per_tr"), default="batched",
                   help="frame pipeline: 'batched' dedups shared frames (least work); 'per_tr' uses "
                        "small recycled buffers (fastest on lazy-memory hosts); outputs identical")
    p.add_argument("--jobs", type=int, default=1,
                   help="episode-parallel worker processes (the reference budgets 32 CPUs for its "
                        "decoder)")
    args = p.parse_args(argv)

    geometry = VLBGeometry(
        tr=args.tr,
        frames_per_tr=args.frames_per_tr,
        window=args.window_duration,
        model_max_length=args.model_max_length,
    )
    geometry.validate()

    try:
        from transformers import AutoTokenizer
    except ImportError as e:
        raise ImportError("vlb-extract-torch loads its tokenizer with transformers, which is not "
                          "installed") from e

    tokenizer = AutoTokenizer.from_pretrained(args.model_path, use_fast=True, local_files_only=True)
    if tokenizer.pad_token is None:
        tokenizer.pad_token = tokenizer.unk_token

    def chat_template(system_content: str, user_content: str) -> str:
        messages = [
            {"role": "system", "content": system_content},
            {"role": "user", "content": user_content},
        ]
        return tokenizer.apply_chat_template(messages, tokenize=False, add_generation_prompt=False)

    # Fail loudly if this tokenizer/template pair breaks the +2/+4 joiner
    # accounting the training weight mask hard-codes: silently mis-aligned
    # masking_params would corrupt every HRF language weight downstream.
    from phantom_vlb_tpu_torch.data.text import validate_joiner_counts

    validate_joiner_counts(tokenizer, chat_template)

    from phantom_vlb_tpu_torch.data.extract import ExtractConfig, extract_features
    from phantom_vlb_tpu_torch.data.video_reader import NativeVideoSource

    config = ExtractConfig(
        input_transcript_path=args.input_transcript_path,
        input_seg_path=args.input_seg_path,
        input_video_path=args.input_video_path,
        lazy_load_path=args.lazy_load_path,
        geometry=geometry,
        video_mode=args.video_mode,
    )
    written = extract_features(config, tokenizer, NativeVideoSource, chat_template,
                               progress=lambda s: print(s, flush=True), jobs=args.jobs)
    print(f"extracted {len(written)} episodes")
    return 0


if __name__ == "__main__":
    sys.exit(main())
