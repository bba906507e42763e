"""Transcript processing: scene-aware rolling windows -> tokenized features.

Counterpart of ``phantom_vlb_tpu/data/text.py`` (:70-379): the same rows,
onsets and masking parameters for the same transcript, bit for bit.

- Per-TR loop with a ``window``-TR rolling buffer of dialogue text/words/
  onsets and a growing ``scene_chunk`` of already-rolled-out text; all four
  buffers reset at manual scene boundaries.
- :func:`prep_text`: per-word re-tokenization assigns each token its word
  onset; the scene context is tail-truncated to ``max_tokens - (80 +
  seg_len)`` tokens; the prompt is a chat-templated system message (naming
  the show + prior dialogue) plus a user message ``<video>\\n{instruction}
  {dialogue}``; the ``<video>`` position becomes token id -201.
- Output rows are right-padded to ``max_lang_tokens`` / ``onsets_width`` and
  ``masking_params`` = [pad_len, inst_len, diag_len].

Tables are plain: a mapping of column name -> list of cells, as
:func:`read_tsv` reads a TSV with the ``csv`` module. The JAX package reads
them with ``pandas.read_csv(path, sep="\\t")``, and :func:`read_tsv` gives
the cells pandas gives: pandas' default NA strings (and the empty cell)
become NaN, and a column becomes int, float or bool when every other cell
parses as one, floats parsed as pandas' default converter
(``precise_xstrtod``) parses them, which differs from ``float()`` in the
last bit for some strings of 16 or more digits. The scene test ``i * tr >
onset`` compares with those floats.

Tokenizer protocol: any object with ``tokenize(text) -> list[str]``,
``convert_tokens_to_string(tokens) -> str`` and ``encode(text,
add_special_tokens) -> list[int]`` works (the HF fast tokenizer of
``data/hf_tokenizer.py`` and the two test tokenizers below). The chat
template renders ``[INST] {system}\\n{user} [/INST]`` (Llama-2 style) unless
another is injected, such as the real tokenizer's ``apply_chat_template``.
"""

from __future__ import annotations

import ast
import csv
import dataclasses
import math
import re
from pathlib import Path
from typing import Callable, Mapping, Protocol, Sequence

import numpy as np

from phantom_vlb_tpu_torch.core.geometry import VIDEO_TOKEN_ID, VLBGeometry
from phantom_vlb_tpu_torch.ops.weight_mask import JOINER_POST, JOINER_PRE

__all__ = [
    "TokenizerProtocol",
    "WordPieceTestTokenizer",
    "SentencePieceTestTokenizer",
    "default_chat_template",
    "derive_joiner_counts",
    "validate_joiner_counts",
    "tokenize_multimodal",
    "prep_text",
    "read_tsv",
    "parse_float",
    "get_scene_onsets",
    "TranscriptProcessor",
]

SYSTEM_TEMPLATE = (
    "<<SYS>>\nThis video is from a scene from the TV show Friends. "
    "Try to understand what is happening in the video.\n"
    "For context, here is the dialogue that was spoken just before the video "
    "onset: {background}.\n<</SYS>>"
)
INSTRUCTION_TEXT = "Here are the words spoken in the video:"
MODAL_TOKEN = "<video>"
# Reference: 73 tokens of instructions+system w/o dialogue; 80 with buffer
# (extractfeatures.py:259-266).
SCENE_BUDGET_MARGIN = 80


class TokenizerProtocol(Protocol):
    def tokenize(self, text: str) -> list[str]: ...
    def convert_tokens_to_string(self, tokens: Sequence[str]) -> str: ...
    def encode(self, text: str, add_special_tokens: bool = True) -> list[int]: ...


class WordPieceTestTokenizer:
    """Deterministic test tokenizer (hash-based ids, <=4-char pieces).

    Mimics the properties the pipeline relies on: stable per-word piece
    counts, round-trip ``convert_tokens_to_string``, BOS on first segment,
    and ids that never collide with pad (0) or the modal sentinel (-201).
    """

    bos_token_id = 1

    def __init__(self, vocab_size: int = 1000):
        self.vocab_size = vocab_size

    def tokenize(self, text: str) -> list[str]:
        pieces = []
        for word in text.split():
            for i in range(0, len(word), 4):
                pieces.append(word[i : i + 4] if i else "▁" + word[i : i + 4])
        return pieces

    def convert_tokens_to_string(self, tokens: Sequence[str]) -> str:
        return "".join(
            (" " + t[1:]) if t.startswith("▁") else t for t in tokens
        ).strip()

    def _piece_id(self, piece: str) -> int:
        return 3 + (hash(piece) % (self.vocab_size - 3))

    def encode(self, text: str, add_special_tokens: bool = True) -> list[int]:
        ids = [self._piece_id(p) for p in self.tokenize(text)]
        return ([self.bos_token_id] + ids) if add_special_tokens else ids


def default_chat_template(system_content: str, user_content: str) -> str:
    """Llama-2-style single-turn template (see module docstring)."""
    return f"[INST] {system_content}\n{user_content} [/INST]"


class SentencePieceTestTokenizer:
    """SentencePiece-faithful fixture tokenizer (Llama conventions).

    Reproduces the tokenizer properties that the +2/+4 joiner constants
    silently encode (the reference documents them at
    extractfeatures.py:278-281):

    - dummy ``▁`` prefix at the start of every segment, spaces become ``▁``
      attached to the following alphanumeric run;
    - ``\\n`` byte-falls-back to a standalone ``<0x0A>`` piece, so a
      segment-leading newline costs exactly 2 tokens (``▁``, ``<0x0A>``);
    - ``[/INST]`` splits as ``▁[``, ``/``, ``INST``, ``]`` — 4 tokens after
      the dialogue.

    Ids are CRC32-stable (unlike ``hash``), so golden-row tests survive
    process restarts.
    """

    bos_token_id = 1
    # Multi-char pieces tried (longest-first) before the generic rules.
    _PIECES = ("<0x0A>", "▁[", "INST",)

    def __init__(self, vocab_size: int = 30000):
        self.vocab_size = vocab_size

    def _normalize(self, text: str) -> str:
        return "▁" + text.replace(" ", "▁").replace("\n", "<0x0A>")

    def tokenize(self, text: str) -> list[str]:
        s = self._normalize(text)
        pieces: list[str] = []
        i = 0
        word = re.compile(r"▁?[A-Za-z0-9']+")
        while i < len(s):
            for p in self._PIECES:
                if s.startswith(p, i):
                    pieces.append(p)
                    i += len(p)
                    break
            else:
                m = word.match(s, i)
                if m and m.group() != "▁":
                    pieces.append(m.group())
                    i = m.end()
                else:
                    pieces.append(s[i])
                    i += 1
        return pieces

    def convert_tokens_to_string(self, tokens: Sequence[str]) -> str:
        return (
            "".join(tokens).replace("<0x0A>", "\n").replace("▁", " ").strip()
        )

    def _piece_id(self, piece: str) -> int:
        import zlib

        return 3 + (zlib.crc32(piece.encode()) % (self.vocab_size - 3))

    def encode(self, text: str, add_special_tokens: bool = True) -> list[int]:
        ids = [self._piece_id(p) for p in self.tokenize(text)]
        return ([self.bos_token_id] + ids) if add_special_tokens else ids


def derive_joiner_counts(
    tokenizer: TokenizerProtocol,
    chat_template: Callable[[str, str], str] = default_chat_template,
) -> tuple[int, int]:
    """Empirically derive the (pre, post) joiner token counts.

    The training weight mask lays the multimodal sequence out as
    ``[video][pre][inst][diag][post][pad]`` with hard-coded pre=2 / post=4
    (ops/weight_mask.py; reference litmodule.py:184-202 + the comment at
    extractfeatures.py:278-281).  Those constants are properties of the
    TOKENIZER and TEMPLATE, not of the pipeline — one token of drift shifts
    every HRF language weight.  This probe recomputes them for the tokenizer/
    template actually in use, so the extraction CLI can fail loudly instead
    of writing silently mis-aligned masks.
    """
    words = ["hello", "goodbye"]
    prepped = prep_text(
        "", "hello goodbye ", [words], [[0.0, 0.5]],
        tokenizer, 866, chat_template,
    )
    ids = prepped.input_ids
    p = ids.index(VIDEO_TOKEN_ID)
    rest = len(ids) - p - 1
    diag_len = len(prepped.token_onsets)

    # Template tail after the user content, token-counted in dialogue context
    # (piece merges at the boundary cancel in the difference).
    sentinel = "QQXUSERXQQ"
    rendered = chat_template("s", sentinel)
    tail = rendered.rsplit(sentinel, 1)[1]
    last = words[-1]
    post = len(tokenizer.encode(last + tail, add_special_tokens=False)) - len(
        tokenizer.encode(last, add_special_tokens=False)
    )
    pre = rest - prepped.inst_len - diag_len - post
    return pre, post


def validate_joiner_counts(
    tokenizer: TokenizerProtocol,
    chat_template: Callable[[str, str], str] = default_chat_template,
) -> None:
    """Raise if the tokenizer/template disagree with the training-side mask
    constants (ops/weight_mask.py JOINER_PRE/JOINER_POST)."""
    pre, post = derive_joiner_counts(tokenizer, chat_template)
    if (pre, post) != (JOINER_PRE, JOINER_POST):
        raise ValueError(
            f"chat-template joiner token counts (pre={pre}, post={post}) do "
            f"not match the training weight-mask constants "
            f"({JOINER_PRE}, {JOINER_POST}): extracted masking_params would "
            "mis-align every HRF language weight. Check the tokenizer/"
            "template pair (expected Llama-family SP behavior: '\\n' -> "
            "['▁','<0x0A>'], ' [/INST]' -> ['▁[','/','INST',']'])."
        )


def tokenize_multimodal(
    prompt: str, tokenizer: TokenizerProtocol, modal_token: str = MODAL_TOKEN
) -> list[int]:
    """Tokenize, replacing ``modal_token`` by id -201 (mm_utils semantics)."""
    chunks = prompt.split(modal_token)
    ids: list[int] = []
    for i, chunk in enumerate(chunks):
        ids.extend(tokenizer.encode(chunk, add_special_tokens=(i == 0)))
        if i < len(chunks) - 1:
            ids.append(VIDEO_TOKEN_ID)
    return ids


@dataclasses.dataclass
class PreppedText:
    input_ids: list[int]
    token_onsets: list[float]
    inst_len: int


def prep_text(
    scene_text: str,
    seg_text: str,
    word_lists: Sequence[Sequence[str]],
    onset_lists: Sequence[Sequence[float]],
    tokenizer: TokenizerProtocol,
    max_tokens: int,
    chat_template: Callable[[str, str], str] = default_chat_template,
) -> PreppedText:
    """Reference ``prep_text`` (extractfeatures.py:215-300)."""
    all_words = [w for w_list in word_lists for w in w_list]
    all_onsets = [o for o_list in onset_lists for o in o_list]
    if len(all_words) != len(all_onsets):
        raise ValueError(f"{len(all_words)} words but {len(all_onsets)} onsets")

    if seg_text == "":
        seg_dialog = "No dialogue."
        token_onsets: list[float] = [0.5, 1.0]  # dummy token times (:244)
    else:
        token_onsets = []
        seg_dialog = ""
        for w, o in zip(all_words, all_onsets):
            w_t = tokenizer.tokenize(w)
            token_onsets += [o] * len(w_t)
            seg_dialog += f"{w} "
        if len(token_onsets) != len(tokenizer.tokenize(seg_dialog.strip())):
            raise ValueError("the dialogue's words tokenize to other pieces than the dialogue")

    # Scene-context tail truncation (:255-267).
    tokens = tokenizer.tokenize(scene_text.strip())
    seg_len = len(tokenizer.tokenize(seg_dialog.strip()))
    max_scene_length = max_tokens - (SCENE_BUDGET_MARGIN + seg_len)
    if len(tokens) > max_scene_length:
        tokens = tokens[-max_scene_length:]
    background_text = tokenizer.convert_tokens_to_string(tokens).strip()

    inst_len = len(tokenizer.tokenize(INSTRUCTION_TEXT.strip()))
    instructions = f"{INSTRUCTION_TEXT.strip()} {seg_dialog.strip()}"
    system_content = SYSTEM_TEMPLATE.format(background=background_text)
    user_content = MODAL_TOKEN + "\n" + instructions.strip()
    prompt = chat_template(system_content, user_content)
    input_ids = tokenize_multimodal(prompt, tokenizer)
    return PreppedText(input_ids, token_onsets, inst_len)


# pandas' default NA strings (``pandas._libs.parsers.STR_NA_VALUES``) and
# its default boolean spellings.
NA_VALUES = frozenset({
    "", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN", "-NaN", "-nan", "1.#IND", "1.#QNAN",
    "<NA>", "N/A", "NA", "NULL", "NaN", "None", "n/a", "nan", "null",
})
TRUE_VALUES, FALSE_VALUES = frozenset({"True", "TRUE", "true"}), frozenset({"False", "FALSE", "false"})
_INFINITIES = {"inf": math.inf, "+inf": math.inf, "-inf": -math.inf, "infinity": math.inf,
               "+infinity": math.inf, "-infinity": -math.inf}
_SPACE = " \t\n\r\f\v"
_INT = re.compile(r"[ \t]*[+-]?[0-9]+[ \t]*")
# Powers of ten as the C literals 1e0 .. 1e308 give them (correctly rounded).
_POW10 = [float(f"1e{k}") for k in range(309)]
_MAX_DIGITS = 17


def parse_float(s: str) -> float | None:
    """``s`` as pandas' default float converter reads it (its C
    ``precise_xstrtod``: up to 17 significant digits accumulated in a
    double, then one multiply or divide by a power of ten), or None where
    that converter rejects it. Infinity spellings are read as pandas reads
    them."""
    if s.strip(_SPACE).lower() in _INFINITIES:
        return _INFINITIES[s.strip(_SPACE).lower()]
    p, n = 0, len(s)
    while p < n and s[p] in _SPACE:
        p += 1
    negative = p < n and s[p] == "-"
    if p < n and s[p] in "+-":
        p += 1
    number, exponent, digits, decimals = 0.0, 0, 0, 0
    while p < n and "0" <= s[p] <= "9":
        if digits < _MAX_DIGITS:
            number = number * 10.0 + (ord(s[p]) - 48)
            digits += 1
        else:
            exponent += 1
        p += 1
    if p < n and s[p] == ".":
        p += 1
        while digits < _MAX_DIGITS and p < n and "0" <= s[p] <= "9":
            number = number * 10.0 + (ord(s[p]) - 48)
            digits += 1
            decimals += 1
            p += 1
        while p < n and "0" <= s[p] <= "9":          # digits past the 17th
            p += 1
        exponent -= decimals
    if digits == 0:
        return None
    if negative:
        number = -number
    if p < n and s[p] in "eE":
        p += 1
        exp_negative = p < n and s[p] == "-"
        if p < n and s[p] in "+-":
            p += 1
        exp_digits, e = 0, 0
        while exp_digits < _MAX_DIGITS and p < n and "0" <= s[p] <= "9":
            e = e * 10 + (ord(s[p]) - 48)
            exp_digits += 1
            p += 1
        exponent += -e if exp_negative else e
        if exp_digits == 0:
            p -= 1
    if exponent > 308:
        number = math.copysign(math.inf, number)
    elif exponent > 0:
        number *= _POW10[exponent]
    elif exponent < -616:
        number = 0.0 * number
    elif exponent < -308:
        number = number / _POW10[-308 - exponent] / _POW10[308]
    else:
        number /= _POW10[-exponent]
    while p < n and s[p] in _SPACE:
        p += 1
    return number if p == n else None


def _column(cells: list[str]) -> list:
    """One column's cells as pandas types them: NaN for an NA string; all
    int64 with no NA -> int; all numbers -> float; all booleans -> bool
    (NaN kept); otherwise the strings."""
    present = [c for c in cells if c not in NA_VALUES]
    nan = [c in NA_VALUES for c in cells]
    if len(present) == len(cells) and all(_INT.fullmatch(c) and -2**63 <= int(c) < 2**63 for c in cells):
        return [int(c) for c in cells]
    floats = [parse_float(c) for c in present]
    if all(f is not None for f in floats):
        it = iter(floats)
        return [math.nan if na else next(it) for na in nan]
    if all(c in TRUE_VALUES or c in FALSE_VALUES for c in present):
        return [math.nan if na else c in TRUE_VALUES for c, na in zip(cells, nan)]
    return [math.nan if na else c for c, na in zip(cells, nan)]


def read_tsv(path: str | Path) -> dict[str, list]:
    """A TSV with a header row as column -> cells, typed as
    ``pandas.read_csv(path, sep="\\t")`` types them (see the module
    docstring). Blank lines are skipped; a short row is filled with NaN."""
    with open(path, newline="", encoding="utf-8-sig") as f:
        rows = [row for row in csv.reader(f, delimiter="\t") if row]
    if not rows:
        raise ValueError(f"{path} has no header row")
    header, body = rows[0], rows[1:]
    for i, row in enumerate(body):
        if len(row) > len(header):
            raise ValueError(f"{path}: row {i + 1} has {len(row)} fields, the header {len(header)}")
    return {name: _column([row[j] if j < len(row) else "" for row in body])
            for j, name in enumerate(header)}


def get_scene_onsets(seg: Mapping[str, Sequence]) -> list[float]:
    """First onset per scene, in order of appearance."""
    scene_onsets: list[float] = []
    seen: list = []
    for scene_num, onset in zip(seg["scene"], seg["onset"]):
        if scene_num not in seen:
            scene_onsets.append(onset)
            seen.append(scene_num)
    return scene_onsets


class TranscriptProcessor:
    """Per-episode transcript -> (token rows, onset rows, masking rows)."""

    def __init__(
        self,
        tokenizer: TokenizerProtocol,
        geometry: VLBGeometry,
        chat_template: Callable[[str, str], str] = default_chat_template,
    ):
        self.tokenizer = tokenizer
        self.geometry = geometry
        self.chat_template = chat_template

    def process_episode(self, transcript: Mapping[str, Sequence], scene_onsets: Sequence[float]):
        """The per-TR text loop over a table with columns ``text_per_tr`` /
        ``words_per_tr`` / ``onsets_per_tr`` (the CNeuroMod Friends
        transcript TSV layout)."""
        geom = self.geometry
        window = geom.window
        run_tokens, run_tk_times, mask_params = [], [], []

        scene_chunk = ""
        j = 1
        tr_chunk = [""] * window
        tr_words: list[list[str]] = [[]] * window
        tr_onsets: list[list[float]] = [[]] * window

        texts, words, onsets = (transcript[c] for c in ("text_per_tr", "words_per_tr", "onsets_per_tr"))
        for i in range(len(texts)):
            if (i * geom.tr) > scene_onsets[j] and j < (len(scene_onsets) - 1):
                scene_chunk = ""
                tr_chunk = [""] * window
                tr_words = [[]] * window
                tr_onsets = [[]] * window
                j += 1

            cell = texts[i]
            if not (cell is None or (isinstance(cell, float) and np.isnan(cell))):
                i_text = str(cell)
                i_words = _as_list(words[i])
                i_times = _as_list(onsets[i])
                if len(i_words) != len(i_times):
                    raise ValueError(f"TR {i}: {len(i_words)} words but {len(i_times)} onsets")
            else:
                i_text, i_words, i_times = "", [], []

            scene_chunk += tr_chunk[0]
            tr_chunk = tr_chunk[1:] + [i_text]
            tr_words = tr_words[1:] + [i_words]
            tr_onsets = tr_onsets[1:] + [i_times]

            prepped = prep_text(
                scene_chunk, "".join(tr_chunk), tr_words, tr_onsets,
                self.tokenizer, geom.max_lang_tokens, self.chat_template,
            )

            tr_pad = geom.max_lang_tokens - len(prepped.input_ids)
            if tr_pad < 0:
                raise ValueError(f"prompt overflow: {len(prepped.input_ids)} > {geom.max_lang_tokens}")
            run_tokens.append(np.pad(prepped.input_ids, (0, tr_pad)))
            time_pad = geom.onsets_width - len(prepped.token_onsets)
            if time_pad < 0:
                raise ValueError(f"TR {i}: {len(prepped.token_onsets)} token onsets exceed "
                                 f"onsets_width {geom.onsets_width}")
            run_tk_times.append(np.pad(prepped.token_onsets, (0, time_pad)))
            mask_params.append(np.array([tr_pad, prepped.inst_len, len(prepped.token_onsets)]))

        return (
            np.asarray(run_tokens, dtype=np.int64),
            np.asarray(run_tk_times, dtype=np.float64),
            np.asarray(mask_params, dtype=np.int64),
        )


def _as_list(cell):
    if isinstance(cell, str):
        return ast.literal_eval(cell)
    if isinstance(cell, (list, tuple)):
        return list(cell)
    return []
