"""Port: the first two stages' CLIs against the JAX package's, and the port
alone from a season's raw inputs to a training step.

A tiny season (two episodes: transcript and scene TSVs, MPEG-4 videos
written by ``write_test_video``, a BOLD file, a local HF tokenizer
directory) goes through ``vlb-extract-torch`` and ``vlb-extract`` (the
features files byte-equal), then ``vlb-build-lazyload-torch`` and
``vlb-build-lazyload`` (every lazy-load file byte-equal).

The extract CLI fixes the frames at 336 px, as ``vlb-extract`` does, and
the tiny model reads 56 px frames and 38 text ids, so the chain through the
port alone calls the CLI's body (``extract_features`` with the native
decoder and the HF tokenizer, its chat template rendering only the user
turn so the prompt fits 38 ids with the mask's +2/+4 joiners) at the tiny
model's geometry, then ``vlb-build-lazyload-torch`` and ``vlb-train-torch``
for one step on the CPU.
"""

import csv
import glob

import numpy as np
import pytest

from phantom_vlb_tpu.cli.build_lazyload import main as jbuild_main
from phantom_vlb_tpu.cli.extract import main as jextract_main
from phantom_vlb_tpu.data import video_reader as jreader
from phantom_vlb_tpu_torch.cli.build_lazyload import main as build_main
from phantom_vlb_tpu_torch.cli.extract import main as extract_main
from phantom_vlb_tpu_torch.cli.train import main as train_main
from phantom_vlb_tpu_torch.data.extract import ExtractConfig, extract_features
from phantom_vlb_tpu_torch.data.hf_tokenizer import build_llama_fast_tokenizer, hf_chat_template
from phantom_vlb_tpu_torch.data.schemas import validate_features_file, validate_lazyload_file
from phantom_vlb_tpu_torch.data.synthetic import TEST_GEOMETRY, write_synthetic_bold_file
from phantom_vlb_tpu_torch.data.text import validate_joiner_counts
from phantom_vlb_tpu_torch.data.video_reader import NativeVideoSource, ensure_built, write_test_video

EPISODES = {"s01e01a": 7, "s01e01b": 6}
FPS = 29.97
WORDS = ["hey", "oh", "okay", "Ross", "Rachel", "pivot", "couch", "coffee", "know", "really"]
USER_ONLY = ("{% for m in messages %}{% if m['role'] == 'user' %}{{ m['content'] }} [/INST]"
             "{% endif %}{% endfor %}")


@pytest.fixture(scope="module")
def season(tmp_path_factory):
    root = tmp_path_factory.mktemp("season")
    for sub in ("transcripts", "segs", "videos"):
        (root / sub).mkdir()
    rng = np.random.default_rng(0)
    tr = TEST_GEOMETRY.tr
    for ep, n_tr in EPISODES.items():
        with open(root / "transcripts" / f"friends_{ep}.tsv", "w", newline="") as f:
            w = csv.writer(f, delimiter="\t", lineterminator="\n")
            w.writerow(["text_per_tr", "words_per_tr", "onsets_per_tr"])
            for i in range(n_tr):
                if i % 3 == 1:
                    w.writerow(["", "", ""])
                    continue
                words = [str(x) for x in rng.choice(WORDS, size=int(rng.integers(1, 4)))]
                onsets = sorted(round(i * tr + float(x), 3) for x in rng.uniform(0, tr, len(words)))
                w.writerow([" ".join(words) + " ", str(words), str(onsets)])
        with open(root / "segs" / f"friends_{ep.replace('s0', 's')}_manualseg.tsv", "w", newline="") as f:
            w = csv.writer(f, delimiter="\t", lineterminator="\n")
            w.writerow(["scene", "onset"])
            w.writerows([[1, 0.0], [2, round(n_tr * tr / 2, 3)], [3, round(n_tr * tr * 0.8, 3)]])
        write_test_video(root / "videos" / f"friends_{ep}.mkv", 64, 48, int(n_tr * tr * FPS) + 5, FPS)
    write_synthetic_bold_file(root / "bold_sub-01.h5", EPISODES, TEST_GEOMETRY, seed=1)
    build_llama_fast_tokenizer().save_pretrained(root / "tokenizer")
    return root


def _extract_args(root, out):
    return ["--input_transcript_path", str(root / "transcripts"), "--input_seg_path", str(root / "segs"),
            "--input_video_path", str(root / "videos"), "--lazy_load_path", str(out),
            "--model_path", str(root / "tokenizer"), "--frames_per_tr", "1", "--window_duration", "2",
            "--model_max_length", "567"]


def _build_args(root, features, out):
    return ["--features_path", str(features), "--timeseries_path", str(root / "bold_sub-01.h5"),
            "--lazyload_path", str(out), "--subject", "sub-01", "--season", "s1", "--n_split", "2",
            "--window", "2", "--delay", "1"]


def test_cli_outputs_byte_equal_to_jax(season, tmp_path, monkeypatch):
    # The JAX CLI's reader loads the library the port built from the same
    # source and flags: no `make` in native/decode, which other test files
    # may be running.
    monkeypatch.setattr(jreader, "ensure_built", ensure_built)
    assert extract_main(_extract_args(season, tmp_path / "features.h5")) == 0
    assert jextract_main(_extract_args(season, tmp_path / "features_jax.h5")) == 0
    assert (tmp_path / "features.h5").read_bytes() == (tmp_path / "features_jax.h5").read_bytes()
    (tmp_path / "lazy").mkdir()
    (tmp_path / "lazy_jax").mkdir()
    assert build_main(_build_args(season, tmp_path / "features.h5", tmp_path / "lazy")) == 0
    assert jbuild_main(_build_args(season, tmp_path / "features.h5", tmp_path / "lazy_jax")) == 0
    names = sorted(p.name for p in (tmp_path / "lazy").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "lazy_jax").iterdir()) and len(names) == 2
    for name in names:
        assert (tmp_path / "lazy" / name).read_bytes() == (tmp_path / "lazy_jax" / name).read_bytes()
    # A rerun resumes: nothing is extracted again.
    assert extract_main(_extract_args(season, tmp_path / "features.h5")) == 0
    assert (tmp_path / "features.h5").read_bytes() == (tmp_path / "features_jax.h5").read_bytes()


def test_the_port_alone_from_raw_inputs_to_a_training_step(season, tmp_path):
    tok = build_llama_fast_tokenizer(USER_ONLY)
    template = hf_chat_template(tok)
    validate_joiner_counts(tok, template)
    config = ExtractConfig(str(season / "transcripts"), str(season / "segs"), str(season / "videos"),
                           str(tmp_path / "features_s1.h5"), TEST_GEOMETRY)
    assert extract_features(config, tok, NativeVideoSource, template) == sorted(EPISODES)
    assert validate_features_file(tmp_path / "features_s1.h5", TEST_GEOMETRY) == sorted(EPISODES)
    (tmp_path / "lazy").mkdir()
    args = _build_args(season, tmp_path / "features_s1.h5", tmp_path / "lazy")
    assert build_main(args) == 0
    files = sorted(glob.glob(str(tmp_path / "lazy" / "*.h5")))
    assert [validate_lazyload_file(f, TEST_GEOMETRY) for f in files] == [
        n - TEST_GEOMETRY.bold_offset for n in EPISODES.values()]
    out = tmp_path / "results"
    assert train_main([
        "experiment=vlb_friends_lora", "subject=sub-01",
        f"datamodule.lazyload_path={tmp_path / 'lazy' / 'friends_llFile_sub-01_s*_n*.h5'}",
        "datamodule.seasons=[s1]", "datamodule.batch_size=5", "datamodule.num_workers=2",
        "model.preset=tiny", "model.lora_r=4", "model.lora_alpha=8", "model.lora_dropout=0.0",
        "trainer.max_epochs=1", "trainer.log_every_n_steps=1", "optim.t_max=100",
        f"output_dir={out}", "run_name=stages", "mesh.fsdp=1", "--device", "cpu",
    ]) == 0
    (metrics,) = glob.glob(str(out / "stages" / "*" / "metrics.csv"))
    with open(metrics, newline="") as f:
        rows = list(csv.DictReader(f))
    train_rows = [r for r in rows if r.get("train/brain_loss")]
    val_rows = [r for r in rows if r.get("val/brain_loss")]
    assert len(train_rows) == 1 and np.isfinite(float(train_rows[0]["train/brain_loss"]))
    assert val_rows and np.isfinite(float(val_rows[-1]["val/brain_loss"]))
