"""A Llama-style fast tokenizer built locally, for the CPU tests and the CLI test.

Counterpart of ``phantom_vlb_tpu/data/hf_tokenizer.py`` (:56-168), the same
vocabulary, merges and component stack, so both packages tokenize alike.
The real VideoLLaMA2-7B tokenizer (a Mistral/Llama sentencepiece BPE loaded
through HF ``AutoTokenizer``) is not in the repository; this builds a real
``tokenizers``-backed fast tokenizer with the classes ``LlamaTokenizerFast``
uses (normalizer, BPE with byte fallback, decoder chain, ``<s>``
post-processor) and wraps it in ``transformers.PreTrainedTokenizerFast``.
The SentencePiece conventions the +2/+4 joiner constants encode (``"\\n"``
-> ``['▁', '<0x0A>']`` by byte fallback, ``" [/INST]"`` -> ``['▁[', '/',
'INST', ']']``, the dummy-prefix ``▁``) are produced by that machinery.

The vocabulary is deterministic (no training step): 3 specials, 256 byte
pieces, printable ASCII singles (less ``\\n``, which must fall back to its
byte), ``▁``, prefix merge chains for a Friends and template word list, and
the ``[INST]`` / ``<<SYS>>`` piece merges of the Llama vocabulary.
``tokenizers`` and ``transformers`` are imported when a tokenizer is built.
"""

from __future__ import annotations

import string

__all__ = ["build_llama_fast_tokenizer", "hf_chat_template", "CHAT_TEMPLATE_JINJA"]

# Friends-flavored dialogue + the words of SYSTEM_TEMPLATE/INSTRUCTION_TEXT,
# so common words become single ▁-pieces and rare ones split into sub-pieces
# (both paths of the per-word onset re-tokenization get exercised).
_COMMON_WORDS = (
    "the a and you I to of it is that what this was he she we they no yeah "
    "hey oh okay right know just like so well me do don't not with her him "
    "at on in have be my your are can uh gonna really think there here look "
    "good come go get out up about one how all see now say said pivot "
    "coffee couch Ross Rachel Monica Chandler Joey Phoebe "
    "This video is from scene TV show Friends Try understand happening "
    "For context dialogue spoken before onset Here are words video:"
).split()

# Rendered equivalent of data/text.py::default_chat_template through the
# REAL transformers.apply_chat_template path (jinja).
CHAT_TEMPLATE_JINJA = (
    "{% for m in messages %}"
    "{% if m['role'] == 'system' %}[INST] {{ m['content'] }}\n"
    "{% elif m['role'] == 'user' %}{{ m['content'] }} [/INST]"
    "{% endif %}{% endfor %}"
)


def _build_vocab_and_merges() -> tuple[dict[str, int], list[tuple[str, str]]]:
    vocab: dict[str, int] = {"<unk>": 0, "<s>": 1, "</s>": 2}
    for b in range(256):
        vocab[f"<0x{b:02X}>"] = len(vocab)
    # Single-char pieces. "\n" is deliberately ABSENT: the real Llama vocab
    # has no newline piece, so '\n' byte-falls-back to <0x0A> — the property
    # behind the reference's +2 joiner (extractfeatures.py:278-281).
    singles = ["▁"] + [
        c for c in string.ascii_letters + string.digits + string.punctuation
    ]
    for c in singles:
        if c not in vocab:
            vocab[c] = len(vocab)

    merges: list[tuple[str, str]] = []
    seen_pairs: set[tuple[str, str]] = set()

    def add_chain(target: str) -> None:
        """Incremental prefix merges building ``target`` one char at a time."""
        for i in range(1, len(target)):
            left, right = target[:i], target[i]
            if right == "\n" or right not in vocab:
                return  # cannot merge through a byte-fallback char
            pair = (left, right)
            piece = left + right
            if left not in vocab:
                return
            if pair not in seen_pairs:
                seen_pairs.add(pair)
                merges.append(pair)
            if piece not in vocab:
                vocab[piece] = len(vocab)

    for word in _COMMON_WORDS:
        add_chain("▁" + word)
    # The real Llama vocab also holds BARE (no-▁) pieces for common words —
    # that is precisely what keeps the reference's standalone-vs-in-context
    # instruction token counts equal when the instruction follows the
    # template newline ('<0x0A>Here...' has no ▁ before 'Here').  'Here'
    # goes first: its chain must outrank other words' bare merges (e.g.
    # (r,e) from 'really') or greedy BPE would split it He|re in context
    # while the standalone instruction tokenizes ▁Here — a one-token drift
    # in exactly the count the +2 joiner accounting relies on.
    for word in ["Here"] + _COMMON_WORDS:
        add_chain(word)
    # Pieces the real Llama vocabulary tokenizes the template with:
    # ' [/INST]' -> ['▁[', '/', 'INST', ']'], '<<SYS>>' -> <,<,SYS,>,>.
    for target in ("IN", "INS", "INST", "▁[", "SY", "SYS"):
        add_chain(target)
    return vocab, merges


def build_llama_fast_tokenizer(chat_template: str | None = CHAT_TEMPLATE_JINJA):
    """Return a ``transformers.PreTrainedTokenizerFast`` with Llama wiring.

    Normalizer ``Prepend('▁') + Replace(' ', '▁')``, BPE with
    ``byte_fallback``, Llama decoder chain, ``<s>``-prepending
    post-processor — the exact component stack LlamaConverter emits.
    """
    from tokenizers import Tokenizer, decoders, normalizers, processors
    from tokenizers.models import BPE
    from transformers import PreTrainedTokenizerFast

    vocab, merges = _build_vocab_and_merges()
    tok = Tokenizer(
        BPE(vocab=vocab, merges=merges, byte_fallback=True, unk_token=None,
            fuse_unk=False)
    )
    tok.normalizer = normalizers.Sequence(
        [normalizers.Prepend("▁"), normalizers.Replace(" ", "▁")]
    )
    tok.decoder = decoders.Sequence(
        [
            decoders.Replace("▁", " "),
            decoders.ByteFallback(),
            decoders.Fuse(),
            decoders.Strip(" ", 1, 0),
        ]
    )
    tok.post_processor = processors.TemplateProcessing(
        single="<s> $A",
        pair="<s> $A <s> $B",
        special_tokens=[("<s>", vocab["<s>"])],
    )
    hf = PreTrainedTokenizerFast(
        tokenizer_object=tok,
        bos_token="<s>",
        eos_token="</s>",
        unk_token="<unk>",
        # Reference: pad_token = unk_token (extractfeatures.py:192-193).
        pad_token="<unk>",
        padding_side="right",
    )
    if chat_template is not None:
        hf.chat_template = chat_template
    return hf


def hf_chat_template(tokenizer):
    """(system, user) -> str through the REAL ``apply_chat_template`` path
    (jinja rendering inside transformers), mirroring the reference's use at
    extractfeatures.py:282-296."""

    def render(system_content: str, user_content: str) -> str:
        return tokenizer.apply_chat_template(
            [
                {"role": "system", "content": system_content},
                {"role": "user", "content": user_content},
            ],
            tokenize=False,
        )

    return render
