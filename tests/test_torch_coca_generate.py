"""The port's CoCa captioning (`clipself_tpu_torch/models/coca.py::generate`,
`beam_search`) against the JAX package on the two tiny CoCas of
`torch_coca_cases.py`, float32 on the CPU: greedy, top-k and top-p tokens
EQUAL (the sampling noise is the JAX key's own Gumbel draws, handed to the
port as ``noise``), with and without the min-length and repetition-penalty
processors; `beam_search` tokens EQUAL, with and without beam groups, and
the best beam's log-probability, each package's decoder scoring its own
tokens, within 1e-5. Each JAX generation is jitted once (module fixture).
"""

import numpy as np
import pytest
import torch

import jax

from clipself_tpu.models import coca as jcoca
from clipself_tpu_torch.models import coca
from torch_coca_cases import CASES, EOT, SOT, build, inputs

from torch_threads import capped_threads  # noqa: F401  (module fixture)

MAX_LEN = 10
KEY = 3
# name -> generate's options; "noise" marks the sampling runs
GENERATE = {
    "greedy": {},
    "greedy_processors": {"min_len": 5, "repetition_penalty": 1.5},
    "top_k": {"top_k": 5, "temperature": 0.7},
    "top_p": {"top_p": 0.9},
}
BEAMS = {
    "beam4": {"num_beams": 4},
    "beam4_groups2": {"num_beams": 4, "num_beam_groups": 2, "length_penalty": 0.5},
}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def runs():
    """case -> (port model, {run: JAX tokens}, Gumbel draws [MAX_LEN - 1,
    B, V] of the key that the sampling runs take), each JAX run one jitted
    call."""
    img, _ = inputs(seed=1)
    out = {}
    for case in CASES:
        jmodel, params, model, *_ = build(case)
        tokens = {}
        for name, kw in GENERATE.items():
            fn = jax.jit(lambda p, i, kw=kw: jcoca.generate(
                jmodel, p, i, SOT, EOT, max_len=MAX_LEN, rng=jax.random.PRNGKey(KEY), **kw))
            tokens[name] = np.asarray(fn(params, img))
        for name, kw in BEAMS.items():
            fn = jax.jit(lambda p, i, kw=kw: jcoca.beam_search(jmodel, p, i, SOT, EOT, max_len=MAX_LEN, **kw))
            tokens[name] = np.asarray(fn(params, img))
        score = jax.jit(lambda p, i, t: jmodel.apply(
            {"params": p}, jmodel.apply({"params": p}, i, method="_encode_image")[1], t, method="decode_text"))
        logits = {name: np.asarray(score(params, img, tokens[name])) for name in BEAMS}
        out[case] = (model, tokens, logits, _gumbel_draws(img.shape[0], model.cfg.text.vocab_size))
    return out


def _gumbel_draws(batch: int, vocab: int) -> np.ndarray:
    """What `jax.random.categorical` adds to the logits at each position of
    `generate` from PRNGKey(KEY): the key is split once a position."""
    key, draws = jax.random.PRNGKey(KEY), []
    for _ in range(MAX_LEN - 1):
        key, sub = jax.random.split(key)
        draws.append(np.asarray(jax.random.gumbel(sub, (batch, vocab))))
    return np.stack(draws)


def _logprob(logits: np.ndarray, tokens: np.ndarray) -> np.ndarray:
    """Sum of the next-token log-probabilities of each row up to and with
    its first EOT."""
    logp = logits - np.log(np.exp(logits - logits.max(-1, keepdims=True)).sum(-1, keepdims=True)) \
        - logits.max(-1, keepdims=True)
    total = np.zeros(tokens.shape[0])
    for b in range(tokens.shape[0]):
        for pos in range(1, tokens.shape[1]):
            total[b] += logp[b, pos - 1, tokens[b, pos]]
            if tokens[b, pos] == EOT:
                break
    return total


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("name", list(GENERATE))
def test_generate_tokens_equal_jax(runs, case, name):
    model, want, _, draws = runs[case]
    img, _ = inputs(seed=1)
    kw = dict(GENERATE[name])
    if "top_k" in kw or "top_p" in kw:
        kw["noise"] = torch.from_numpy(draws)
    got = coca.generate(model, torch.from_numpy(img), SOT, EOT, max_len=MAX_LEN, **kw)
    np.testing.assert_array_equal(got.numpy(), want[name])
    assert (got[:, 0] == SOT).all() and got.shape == (2, MAX_LEN)


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("name", list(BEAMS))
def test_beam_search_equals_jax(runs, case, name):
    model, want, jlogits, _ = runs[case]
    img = torch.from_numpy(inputs(seed=1)[0])
    got = coca.beam_search(model, img, SOT, EOT, max_len=MAX_LEN, **BEAMS[name])
    np.testing.assert_array_equal(got.numpy(), want[name])
    with torch.no_grad():
        logits = model.decode_text(model._encode_image(img)[1], got).numpy()
    np.testing.assert_allclose(_logprob(logits, got.numpy()), _logprob(jlogits[name], want[name]),
                               rtol=0, atol=1e-5)


def test_one_beam_is_greedy(runs):
    """A one-beam search is greedy decoding (the JAX package's invariant)."""
    model, want, _, _ = runs["eva"]
    img = torch.from_numpy(inputs(seed=1)[0])
    got = coca.beam_search(model, img, SOT, EOT, max_len=MAX_LEN, num_beams=1, length_penalty=0.0)
    np.testing.assert_array_equal(got.numpy(), want["greedy"])


def test_sampling_from_a_generator_is_seeded(runs):
    """Without ``noise`` the draws come from the generator: one seed, one
    caption; a tiny top_p keeps the top token alone, which is greedy."""
    model, want, _, _ = runs["vit"]
    img = torch.from_numpy(inputs(seed=1)[0])

    def sample(seed, **kw):
        gen = torch.Generator().manual_seed(seed)
        return coca.generate(model, img, SOT, EOT, max_len=MAX_LEN, generator=gen, **kw).numpy()

    np.testing.assert_array_equal(sample(4, top_k=50), sample(4, top_k=50))
    np.testing.assert_array_equal(sample(4, top_p=0.01), want["greedy"])
