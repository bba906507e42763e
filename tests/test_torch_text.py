"""Port: the geometry's offsets, the HRF weights and the transcript stage
against the JAX package, bit for bit.

The JAX package reads its TSVs with pandas; the port reads them with the
``csv`` module (``read_tsv``), and its cells are held to pandas' on the
cells where a plain reader would differ: pandas' NA strings, its
17-digit float converter (which differs from ``float()`` in the last bit
for long strings), and a scene onset where that bit moves a scene
boundary. The rows, onsets and masking parameters of whole episodes are
held to the JAX package's with both test tokenizers and the local HF fast
tokenizer.
"""

import csv
import dataclasses
import math
import random

import numpy as np
import pandas as pd
import pytest
from threadpoolctl import threadpool_limits

from phantom_vlb_tpu.core.geometry import VLBGeometry as JGeometry
from phantom_vlb_tpu.data import hrf as jhrf
from phantom_vlb_tpu.data import text as jtext
from phantom_vlb_tpu.data.hf_tokenizer import build_llama_fast_tokenizer as jbuild_hf
from phantom_vlb_tpu.data.hf_tokenizer import hf_chat_template as jhf_template
from phantom_vlb_tpu_torch.core.geometry import VLBGeometry
from phantom_vlb_tpu_torch.data import hrf, text
from phantom_vlb_tpu_torch.data.hf_tokenizer import build_llama_fast_tokenizer, hf_chat_template

# The extraction tests' geometry: TEST_GEOMETRY's frames with a text budget
# that holds the real prompt.
GEOM_ARGS = dict(tr=1.49, frames_per_tr=2, window=2, delay=1, model_max_length=256, image_size=56,
                 patch_size=14, onsets_width=16, num_parcels=8)
# A scene onset whose pandas parse (1.4974391500080635) lies one ulp under
# float()'s (1.4974391500080637); with tr = float()'s value the scene test
# at TR 1 (1 * tr > onset) is true for pandas' value and false for float()'s.
LONG_ONSET = "1.4974391500080636083"


@pytest.mark.parametrize("geom", [GEOM_ARGS, {}], ids=["extract", "reference"])
def test_geometry_offsets_match_jax(geom):
    g, j = VLBGeometry(**geom), JGeometry(**geom)
    assert (g.window_offset, g.bold_offset, g.abs_tr_delay) == (j.window_offset, j.bold_offset, j.abs_tr_delay)
    np.testing.assert_array_equal(g.target_tr_onsets(17), j.target_tr_onsets(17))
    np.testing.assert_array_equal(g.vision_onset_deltas(), j.vision_onset_deltas())


def test_hrf_weights_bit_equal():
    """The reference convolves in full with ``np.convolve``: tens of
    thousands of BLAS dots of up to 32k points for a small time_diff, which
    OpenBLAS spreads over its threads. Under the suite's parallel workers
    those threads fight for the cores and the test took minutes, so both
    sides run with one BLAS thread (the port reads only the entries its
    interpolation needs, by the same dots)."""
    diffs = np.concatenate([VLBGeometry().vision_onset_deltas(), np.linspace(0.05, 30.0, 97),
                            np.random.default_rng(0).uniform(0.1, 12.0, 40)])
    frames = np.arange(0.0, 20.0, 1.49)
    with threadpool_limits(limits=1, user_api="blas"):
        np.testing.assert_array_equal(hrf.get_hrf_weights(diffs), jhrf.get_hrf_weights(diffs))
        np.testing.assert_array_equal(hrf.glover_hrf(1.49), jhrf.glover_hrf(1.49))
        np.testing.assert_array_equal(hrf.compute_glover_regressor(frames, onset=2.0),
                                      jhrf.compute_glover_regressor(frames, onset=2.0))


def _tokenizers():
    return {
        "wordpiece": (text.WordPieceTestTokenizer(), jtext.WordPieceTestTokenizer(),
                      text.default_chat_template, jtext.default_chat_template),
        "sentencepiece": (text.SentencePieceTestTokenizer(), jtext.SentencePieceTestTokenizer(),
                          text.default_chat_template, jtext.default_chat_template),
    }


@pytest.fixture(scope="module")
def hf_pair():
    port, ref = build_llama_fast_tokenizer(), jbuild_hf()
    return port, ref, hf_chat_template(port), jhf_template(ref)


def _pair(name, hf_pair):
    return hf_pair if name == "hf" else _tokenizers()[name]


TOKENIZERS = ["wordpiece", "sentencepiece", "hf"]


@pytest.mark.parametrize("name", TOKENIZERS)
def test_tokenizers_and_joiner_counts_match_jax(name, hf_pair):
    tok, jtok, tmpl, jtmpl = _pair(name, hf_pair)
    for s in ("Hey, how you doin'?", "\nHere are the words spoken in the video: oh", " [/INST]", ""):
        assert tok.tokenize(s) == jtok.tokenize(s)
        assert tok.encode(s, add_special_tokens=True) == jtok.encode(s, add_special_tokens=True)
    assert text.derive_joiner_counts(tok, tmpl) == jtext.derive_joiner_counts(jtok, jtmpl)
    if name != "wordpiece":           # the Llama-convention tokenizers give the mask's +2/+4
        text.validate_joiner_counts(tok, tmpl)
    else:
        with pytest.raises(ValueError, match="joiner"):
            text.validate_joiner_counts(tok, tmpl)


@pytest.mark.parametrize("name", TOKENIZERS)
@pytest.mark.parametrize("case", ["dialogue", "truncated_scene", "no_dialogue"])
def test_prep_text_matches_jax(name, case, hf_pair):
    tok, jtok, tmpl, jtmpl = _pair(name, hf_pair)
    scene = {"dialogue": "earlier words here", "truncated_scene": " ".join(["couch coffee pivot"] * 120),
             "no_dialogue": ""}[case]
    words = [[], []] if case == "no_dialogue" else [["hey", "Ross"], ["pivot!", "okay"]]
    onsets = [[], []] if case == "no_dialogue" else [[0.25, 0.5], [1.75, 2.0]]
    seg = "".join(" ".join(w) + " " for w in words if w)
    args = (scene, seg, words, onsets)
    got = text.prep_text(*args, tok, 230, tmpl)
    want = jtext.prep_text(*args, jtok, 230, jtmpl)
    assert dataclasses.astuple(got) == dataclasses.astuple(want)


def _write_tsv(path, header, rows):
    with open(path, "w", newline="") as f:
        w = csv.writer(f, delimiter="\t", lineterminator="\n")
        w.writerow(header)
        w.writerows(rows)


def _transcript_rows(n_tr, tr, rng):
    """TRs with dialogue, and silent TRs in each NA spelling pandas knows."""
    na = ["", "NA", "nan", "None", "N/A", "NULL"]
    vocab = ["hey", "oh", "okay", "Ross", "Rachel", "pivot", "couch", "coffee", "know", "really"]
    rows = []
    for i in range(n_tr):
        if i % 3 == 2:
            cell = na[(i // 3) % len(na)]
            rows.append([cell, cell, cell])
        else:
            words = [str(w) for w in rng.choice(vocab, size=int(rng.integers(1, 4)))]
            onsets = sorted(round(i * tr + float(x), 3) for x in rng.uniform(0, tr, len(words)))
            rows.append([" ".join(words) + " ", str(words), str(onsets)])
    return rows


@pytest.fixture(scope="module")
def episode_tsvs(tmp_path_factory):
    root = tmp_path_factory.mktemp("tsv")
    rng = np.random.default_rng(3)
    tr = float(LONG_ONSET)
    _write_tsv(root / "transcript.tsv", ["text_per_tr", "words_per_tr", "onsets_per_tr"],
               _transcript_rows(14, tr, rng))
    _write_tsv(root / "seg.tsv", ["scene", "onset"],
               [[1, "0.0"], [1, "0.75"], [2, LONG_ONSET], [3, "9.3"], [3, "12.5"], [4, "15.125"]])
    return root, tr


@pytest.mark.parametrize("name", TOKENIZERS)
def test_process_episode_matches_jax(name, hf_pair, episode_tsvs):
    """Whole episodes from the TSVs: the port's tables from read_tsv, the
    JAX package's DataFrames from pandas; rows, onsets and masking
    parameters bit-equal, scene boundaries where pandas' floats put them."""
    root, tr = episode_tsvs
    tok, jtok, tmpl, jtmpl = _pair(name, hf_pair)
    geom = dataclasses.replace(VLBGeometry(**GEOM_ARGS), tr=tr)
    jgeom = dataclasses.replace(JGeometry(**GEOM_ARGS), tr=tr)
    transcript, seg = text.read_tsv(root / "transcript.tsv"), text.read_tsv(root / "seg.tsv")
    tdf, sdf = pd.read_csv(root / "transcript.tsv", sep="\t"), pd.read_csv(root / "seg.tsv", sep="\t")
    onsets = text.get_scene_onsets(seg)
    assert onsets == jtext.get_scene_onsets(sdf)
    got = text.TranscriptProcessor(tok, geom, tmpl).process_episode(transcript, onsets)
    want = jtext.TranscriptProcessor(jtok, jgeom, jtmpl).process_episode(tdf, jtext.get_scene_onsets(sdf))
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)
    # The long onset's cell decides the boundary: with float()'s parse the
    # scene would reset a TR later and the rows would differ.
    plain = [float(x) for x in ["0.0", LONG_ONSET, "9.3", "15.125"]]
    assert plain[1] == tr and onsets[1] < tr
    other = text.TranscriptProcessor(tok, geom, tmpl).process_episode(transcript, plain)
    assert not np.array_equal(other[0], got[0])


def test_read_tsv_types_cells_as_pandas(tmp_path):
    """Each column as pandas types it: ints, floats from the 17-digit
    converter (long, signed, exponent, infinite), booleans, strings with
    every default NA spelling as NaN, a quoted cell holding a tab."""
    rng = random.Random(0)
    longs = []
    for _ in range(300):
        digits = "".join(rng.choice("0123456789") for _ in range(rng.randint(1, 24)))
        cut = rng.randint(0, len(digits))
        s = digits[:cut] + "." + digits[cut:]
        s += f"e{rng.randint(-40, 40)}" if rng.random() < 0.3 else ""
        longs.append(("-" if rng.random() < 0.2 else "") + s)
    na = sorted(text.NA_VALUES)
    n = len(longs)
    cols = {
        "ints": [str(i - 7) for i in range(n)],
        "ints_na": [na[i % len(na)] if i % 5 == 0 else str(i) for i in range(n)],
        "floats": longs,
        "edge_floats": [["1e400", "-1e400", "inf", "-Infinity", " 2.5 ", "+3.", ".5", "1e-320"][i % 8]
                        for i in range(n)],
        "bools": [["True", "false", "TRUE", "False"][i % 4] if i % 7 else "NA" for i in range(n)],
        "strings": [na[i % len(na)] if i % 3 == 0 else f"w{i} 'x'\t\"q\"" for i in range(n)],
    }
    with open(tmp_path / "t.tsv", "w", newline="") as f:
        w = csv.writer(f, delimiter="\t", lineterminator="\n")
        w.writerow(list(cols))
        w.writerows(zip(*cols.values()))
    got = text.read_tsv(tmp_path / "t.tsv")
    df = pd.read_csv(tmp_path / "t.tsv", sep="\t")
    assert list(got) == list(df.columns)
    for col in df.columns:
        want = df[col].tolist()
        for g, v in zip(got[col], want):
            if isinstance(v, float) and math.isnan(v):
                assert isinstance(g, float) and math.isnan(g), (col, g, v)
            else:
                assert g == v and type(g) is type(v), (col, g, v)
    # The converter is not float(): some long strings read one ulp apart.
    assert sum(text.parse_float(s) != float(s) for s in longs) > 0
