"""CLIP byte-pair-encoding tokenizer (49408 vocab, 77 context).

A copy of `clipself_tpu/tokenizer.py` that needs no third-party package:
the JAX package splits text with the `regex` package's `\\p{L}` / `\\p{N}`
classes, which the standard `re` lacks, so the same split is built here from
`unicodedata` (`tests/test_torch_tokenizer.py` pins the ids equal to the
original's, over every OV-COCO and OV-LVIS prompt and a search over the
assigned code points). It reads the JAX package's vocabulary file by path
(`clipself_tpu/assets/bpe_simple_vocab_16e6.txt.gz`, OpenAI's public CLIP BPE
merge table).

What the split keeps of `regex`'s semantics:
  - `\\s` is the Unicode White_Space property, which leaves out
    U+001C-U+001F (the standard `re`'s `\\s` and `str.isspace` take them);
  - a letter or a digit is a code point of general category L* or N* in
    this interpreter's `unicodedata`;
  - under IGNORECASE the punctuation run `[^\\s\\p{L}\\p{N}]` does not take a
    character whose case fold is a letter. Of the assigned code points only
    U+0345 (COMBINING GREEK YPOGEGRAMMENI, folded to iota) is such a
    character and not a letter itself: no alternative takes it, so it splits
    a word and is dropped;
  - the special tokens and the contractions match without regard to case
    (`'S` and `'ſ` are contractions too).

Text cleaning: `ftfy` when it is installed (it is optional, as in the JAX
package), then `html.unescape` twice and whitespace runs made one space.
"""

from __future__ import annotations

import functools
import gzip
import html
import re
import unicodedata
from pathlib import Path
from typing import Iterable, Union

import numpy as np

_VOCAB_PATH = (
    Path(__file__).resolve().parents[1] / "clipself_tpu" / "assets" / "bpe_simple_vocab_16e6.txt.gz"
)

SOT_TEXT = "<|startoftext|>"
EOT_TEXT = "<|endoftext|>"
CONTEXT_LENGTH = 77

# the Unicode White_Space property: `regex`'s `\s`
_WHITE_SPACE = "\t\n\x0b\x0c\r \x85\xa0\u1680\u2000-\u200a\u2028\u2029\u202f\u205f\u3000"
# assigned code points that are neither letters nor digits but whose case
# fold is a letter: `regex` under IGNORECASE keeps them out of a punctuation run
_FOLDS_TO_LETTER = "\u0345"
_WHITESPACE_RUN = re.compile(f"[{_WHITE_SPACE}]+")


@functools.lru_cache()
def bytes_to_unicode() -> dict[int, str]:
    """GPT-2 reversible byte <-> unicode mapping."""
    bs = (
        list(range(ord("!"), ord("~") + 1))
        + list(range(ord("¡"), ord("¬") + 1))
        + list(range(ord("®"), ord("ÿ") + 1))
    )
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


def _get_pairs(word: tuple[str, ...]) -> set[tuple[str, str]]:
    return set(zip(word[:-1], word[1:]))


def _ranges(codes: list[int]) -> str:
    """A character-class body for sorted code points, as ranges."""
    out, i = [], 0
    while i < len(codes):
        j = i
        while j + 1 < len(codes) and codes[j + 1] == codes[j] + 1:
            j += 1
        out.append(f"\\U{codes[i]:08x}" + (f"-\\U{codes[j]:08x}" if j > i else ""))
        i = j + 1
    return "".join(out)


@functools.lru_cache()
def split_pattern() -> re.Pattern:
    """The JAX tokenizer's split pattern
    `<|startoftext|>|<|endoftext|>|'s|'t|'re|'ve|'m|'ll|'d|[\\p{L}]+|[\\p{N}]|[^\\s\\p{L}\\p{N}]+`
    (IGNORECASE) in the standard `re`."""
    letters, digits = [], []
    for c in range(0x110000):
        major = unicodedata.category(chr(c))[0]
        if major == "L":
            letters.append(c)
        elif major == "N":
            digits.append(c)
    lc, nc = _ranges(letters), _ranges(digits)
    return re.compile(
        r"(?i:<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d)"
        f"|[{lc}]+|[{nc}]|[^{_WHITE_SPACE}{_FOLDS_TO_LETTER}{lc}{nc}]+"
    )


@functools.lru_cache()
def _ftfy_fix_text():
    """`ftfy.fix_text` if ftfy is installed, else None (looked up once: a
    failed import searches the path again on every call)."""
    try:
        import ftfy
    except ImportError:
        return None
    return ftfy.fix_text


def _clean_text(text: str, lower: bool = True) -> str:
    fix_text = _ftfy_fix_text()  # parity with the reference where present
    if fix_text is not None:
        text = fix_text(text)
    text = html.unescape(html.unescape(text))
    text = _WHITESPACE_RUN.sub(" ", text)
    text = text.strip()
    return text.lower() if lower else text


class SimpleTokenizer:
    def __init__(self, bpe_path: Union[str, Path] = _VOCAB_PATH):
        self.byte_encoder = bytes_to_unicode()
        self.byte_decoder = {v: k for k, v in self.byte_encoder.items()}
        with gzip.open(bpe_path, "rt", encoding="utf-8") as f:
            merge_lines = f.read().split("\n")
        merge_lines = merge_lines[1 : 49152 - 256 - 2 + 1]
        merges = [tuple(m.split()) for m in merge_lines]
        vocab = list(self.byte_encoder.values())
        vocab = vocab + [v + "</w>" for v in vocab]
        for merge in merges:
            vocab.append("".join(merge))
        vocab.extend([SOT_TEXT, EOT_TEXT])
        self.encoder = {tok: i for i, tok in enumerate(vocab)}
        self.decoder = {i: tok for tok, i in self.encoder.items()}
        self.bpe_ranks = {m: i for i, m in enumerate(merges)}
        self.cache = {SOT_TEXT: SOT_TEXT, EOT_TEXT: EOT_TEXT}
        self.pat = split_pattern()
        self.sot_token = self.encoder[SOT_TEXT]
        self.eot_token = self.encoder[EOT_TEXT]
        self.vocab_size = len(self.encoder)
        # a split piece's ids: pieces repeat across prompts
        self._ids: dict[str, list[int]] = {}

    def bpe(self, token: str) -> str:
        if token in self.cache:
            return self.cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        pairs = _get_pairs(word)
        if not pairs:
            return token + "</w>"
        while True:
            bigram = min(pairs, key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if bigram not in self.bpe_ranks:
                break
            first, second = bigram
            new_word: list[str] = []
            i = 0
            while i < len(word):
                try:
                    j = word.index(first, i)
                except ValueError:
                    new_word.extend(word[i:])
                    break
                new_word.extend(word[i:j])
                i = j
                if i < len(word) - 1 and word[i] == first and word[i + 1] == second:
                    new_word.append(first + second)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = tuple(new_word)
            if len(word) == 1:
                break
            pairs = _get_pairs(word)
        out = " ".join(word)
        self.cache[token] = out
        return out

    def _piece_ids(self, piece: str) -> list[int]:
        ids = self._ids.get(piece)
        if ids is None:
            token = "".join(self.byte_encoder[b] for b in piece.encode("utf-8"))
            ids = self._ids[piece] = [self.encoder[t] for t in self.bpe(token).split(" ")]
        return ids

    def encode(self, text: str) -> list[int]:
        bpe_tokens: list[int] = []
        for piece in self.pat.findall(_clean_text(text)):
            bpe_tokens.extend(self._piece_ids(piece))
        return bpe_tokens

    def decode(self, tokens: Iterable[int]) -> str:
        text = "".join(self.decoder[int(t)] for t in tokens)
        return (
            bytearray(self.byte_decoder[c] for c in text)
            .decode("utf-8", errors="replace")
            .replace("</w>", " ")
        )


@functools.lru_cache()
def _default_tokenizer() -> SimpleTokenizer:
    return SimpleTokenizer()


class HFTokenizer:
    """The HuggingFace tokenizer of the HF text towers
    (`clipself_tpu/tokenizer.py::HFTokenizer`, `AutoTokenizer.from_pretrained`):
    its vocabulary files come from the hub, are not in the repository and are
    never fetched, so it raises OSError naming them. The towers themselves
    take token ids (`models/hf_text.py::HFTextTower`)."""

    def __init__(self, tokenizer_name: str):
        raise OSError(
            f"HF tokenizer {tokenizer_name!r}: its hub vocabulary (tokenizer.json / vocab files) is "
            "not in the repository and nothing is fetched; give the HF text tower token ids"
        )


def tokenize(
    texts: Union[str, list[str]], context_length: int = CONTEXT_LENGTH
) -> np.ndarray:
    """Tokenize into a padded [N, context_length] int32 array; truncated
    sequences keep the EOT token at the end (reference tokenizer.py:187-214)."""
    if isinstance(texts, str):
        texts = [texts]
    tk = _default_tokenizer()
    result = np.zeros((len(texts), context_length), np.int32)
    for i, text in enumerate(texts):
        tokens = [tk.sot_token] + tk.encode(text) + [tk.eot_token]
        if len(tokens) > context_length:
            tokens = tokens[:context_length]
            tokens[-1] = tk.eot_token
        result[i, : len(tokens)] = tokens
    return result
