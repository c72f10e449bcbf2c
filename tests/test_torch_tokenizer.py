"""The port's BPE tokenizer (`clipself_tpu_torch/tokenizer.py`, no `regex`
package) against the JAX package's (`clipself_tpu/tokenizer.py`, which
imports without jax and splits with `regex`): token ids EQUAL over every
OV-COCO and OV-LVIS prompt and over a hypothesis search of the code points
this interpreter's `unicodedata` assigns."""

import unicodedata

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from clipself_tpu import tokenizer as jtok
from clipself_tpu_torch import tokenizer as ptok
from clipself_tpu_torch.detector.classes import coco_split, lvis_split
from clipself_tpu_torch.tools.text_embeddings import category_prompts

from torch_threads import capped_threads  # noqa: F401  (module fixture)

# pieces where the two splitters could part: the separators that `str.isspace`
# takes and the White_Space property does not, upper-case contractions and
# their case-folded spellings, the special tokens, U+0345 (folded to a letter)
FRAGMENTS = [
    "\x1c", "\x1d", "\x1e", "\x1f", "'S", "'T", "'RE", "'VE", "'M", "'LL", "'D", "'s", "'ll",
    "'\u017f", "\u017f", "\u212a", "<|startoftext|>", "<|ENDOFTEXT|>", "<|\u017ftartoftext|>",
    "\u0345", "&amp;", "&lt;b&gt;", " ", "\u3000", "\u2028", "\u00a0", "\x85", "\u0130",
    "\u01c5", "\u216b", "\u00bd", "\u0663", "\t\n",
]
ASSIGNED = st.characters(exclude_categories=("Cn", "Cs")).filter(
    lambda c: unicodedata.category(c) not in ("Cn", "Cs")
)
TEXTS = st.lists(
    st.one_of(st.text(ASSIGNED, max_size=6), st.sampled_from(FRAGMENTS)), max_size=10
).map("".join)


@pytest.fixture(scope="module")
def prompt_ids():
    """Every ViLD prompt of the 65 OV-COCO and 1203 OV-LVIS classes, through
    both tokenizers once."""
    prompts = [p for name in coco_split()["all"] + lvis_split()["all"] for p in category_prompts(name)]
    return prompts, jtok.tokenize(prompts), ptok.tokenize(prompts)


def test_ids_equal_over_every_coco_and_lvis_prompt(prompt_ids):
    prompts, want, got = prompt_ids
    assert len(prompts) == 79884 and got.shape == (79884, 77) and got.dtype == np.int32
    np.testing.assert_array_equal(got, want)


def test_vocab_and_known_ids():
    tk = ptok._default_tokenizer()
    assert (tk.vocab_size, tk.sot_token, tk.eot_token) == (49408, 49406, 49407)
    assert tk.encode("a photo of a cat") == [320, 1125, 539, 320, 2368]


@pytest.mark.parametrize("ctx", [16, 77])
def test_truncation_keeps_eot_last(ctx):
    texts = ["word " * 200, "a photo of " * 30, "a cat"]
    got = ptok.tokenize(texts, context_length=ctx)
    np.testing.assert_array_equal(got, jtok.tokenize(texts, context_length=ctx))
    assert got.shape == (3, ctx) and (got[:2, -1] == 49407).all()
    assert got[2, 3] == 49407 and not got[2, 4:].any()


def test_split_over_every_assigned_code_point():
    """Each assigned code point between a letter, a digit, a space and a
    period: the standard-`re` split equals the `regex` split."""
    chars = [chr(c) for c in range(0x110000) if unicodedata.category(chr(c)) not in ("Cn", "Cs")]
    text = "".join(f"a{c}1{c} {c}." for c in chars)
    assert ptok.split_pattern().findall(text) == jtok._default_tokenizer().pat.findall(text)


@settings(max_examples=300, deadline=None)
@given(TEXTS)
def test_ids_equal_on_searched_strings(text):
    got = ptok._default_tokenizer().encode(text)
    assert got == jtok._default_tokenizer().encode(text)
    assert ptok._default_tokenizer().decode(got) == jtok._default_tokenizer().decode(got)


def test_decode_round_trips():
    tk = ptok._default_tokenizer()
    for text in ["a photo of a cat.", "the quick brown fox!", "person riding a horse"]:
        decoded = tk.decode(tk.encode(text)).replace(" .", ".").replace(" !", "!").strip()
        assert decoded == text
    ids = ptok.tokenize(["This is a photo of a traffic light in the scene."])[0]
    assert tk.decode(ids[1 : int(ids.argmax())]).strip() == "this is a photo of a traffic light in the scene ."
