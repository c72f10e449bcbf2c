"""The port's greedy NMS (`clipself_tpu_torch.ops.nms`, on the CPU its plain
PyTorch version) and the batched `detector.nms.{nms, multiclass_nms}` against
the JAX package: the Pallas kernel `nms_keep_mask` in interpret mode and the
dense-IoU loop of `clipself_tpu.detector.nms.nms`. The same NumPy boxes from
a seed go through both. The keep mask is discrete: masks, indices and labels
are compared for equality; scores and boxes are copies of the inputs and so
equal too. `nms_keep_mask_blockwise_plain` mirrors the two phases of the CUDA
kernels (the suppression bit matrix, then the scan a block of 64 boxes at a
time) in plain PyTorch: it is held equal to the one-step-a-box plain version
and to the Pallas kernel, at the sizes around a word of 64 bits too.
"""

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import jax.numpy as jnp

from clipself_tpu.detector import nms as jnms
from clipself_tpu.ops.nms_pallas import nms_keep_mask as pallas_keep_mask
from clipself_tpu_torch.detector import nms as tnms
from clipself_tpu_torch.ops import nms as ops_nms

from torch_threads import capped_threads  # noqa: F401  (module fixture)


def _boxes(rng, n, size=100.0, lo_wh=1.0):
    lo = rng.uniform(0, size * 0.8, (n, 2))
    wh = rng.uniform(lo_wh, size * 0.3, (n, 2))
    return np.concatenate([lo, lo + wh], -1).astype(np.float32)


def _case(kind, n, seed):
    """(score-sorted boxes [n, 4], valid [n]) of one kind."""
    rng = np.random.default_rng(seed)
    boxes, valid = _boxes(rng, n), np.ones(n, bool)
    if kind == "invalid":  # invalid slots anywhere, as after a size filter
        valid = rng.uniform(size=n) < 0.7
    elif kind == "duplicates":  # every box twice: IoU exactly 1
        boxes = np.repeat(boxes[: (n + 1) // 2], 2, axis=0)[:n]
    elif kind == "zero_area":  # a third of the boxes degenerate
        boxes[::3, 2:] = boxes[::3, :2]
    elif kind == "dense":  # jittered copies of a few boxes: IoUs near the threshold
        base = _boxes(rng, 8)[rng.integers(0, 8, n)]
        boxes = (base + rng.normal(scale=2.0, size=(n, 4))).astype(np.float32)
    elif kind == "identical":
        boxes = np.repeat(boxes[:1], n, axis=0)
    elif kind == "none_valid":
        valid = np.zeros(n, bool)
    return boxes, valid


CASES = [
    ("plain", 1), ("plain", 5), ("plain", 200), ("plain", 257), ("invalid", 300),
    ("duplicates", 200), ("zero_area", 200), ("dense", 257), ("identical", 5),
    ("none_valid", 5),
]


@pytest.mark.parametrize("thr", [0.4, 0.5, 0.7])
@pytest.mark.parametrize("kind,n", CASES)
def test_keep_mask_equals_pallas_interpret(kind, n, thr):
    boxes, valid = _case(kind, n, seed=n)
    want = np.asarray(pallas_keep_mask(jnp.asarray(boxes), jnp.asarray(valid), thr, interpret=True))
    got = ops_nms.nms_keep_mask(torch.from_numpy(boxes), torch.from_numpy(valid), thr)
    assert got.dtype == torch.bool and got.shape == (n,)
    np.testing.assert_array_equal(got.numpy(), want)
    assert not got.numpy()[~valid].any()


def test_keep_mask_negative_threshold_equals_pallas_interpret():
    """Below zero every pair suppresses, disjoint ones too (iou 0 > thr)."""
    boxes, valid = _case("plain", 40, seed=1)
    want = np.asarray(pallas_keep_mask(jnp.asarray(boxes), jnp.asarray(valid), -0.5, interpret=True))
    got = ops_nms.nms_keep_mask(torch.from_numpy(boxes), torch.from_numpy(valid), -0.5)
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.sum().item() == 1


@pytest.mark.parametrize("thr", [0.4, 0.5, 0.7])
@pytest.mark.parametrize("kind,n", CASES)
def test_blockwise_plain_equals_plain_and_pallas_interpret(kind, n, thr):
    boxes, valid = _case(kind, n, seed=n)
    tb, tv = torch.from_numpy(boxes), torch.from_numpy(valid)
    got = ops_nms.nms_keep_mask_blockwise_plain(tb, tv, thr)
    assert got.dtype == torch.bool and got.shape == (n,)
    assert torch.equal(got, ops_nms.nms_keep_mask_plain(tb, tv, thr))
    want = np.asarray(pallas_keep_mask(jnp.asarray(boxes), jnp.asarray(valid), thr, interpret=True))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("kind", ["plain", "invalid", "dense", "zero_area"])
@pytest.mark.parametrize("n", [1, 63, 64, 65, 128, 515, 1999])
def test_blockwise_plain_at_word_edges(kind, n):
    """Sizes around the 64 boxes of a word and a block of the scan: a lone
    box, one word short of full, full, one box into the second, a ragged
    tail of many words."""
    boxes, valid = _case(kind, n, seed=1000 + n)
    if kind == "dense":  # more than 8 clusters, so that kept boxes reach into later blocks
        boxes = np.concatenate([boxes[: n // 2], _boxes(np.random.default_rng(n), n - n // 2)])
    tb, tv = torch.from_numpy(boxes), torch.from_numpy(valid)
    got = ops_nms.nms_keep_mask_blockwise_plain(tb, tv, 0.5)
    assert torch.equal(got, ops_nms.nms_keep_mask_plain(tb, tv, 0.5))
    want = np.asarray(pallas_keep_mask(jnp.asarray(boxes), jnp.asarray(valid), 0.5, interpret=True))
    np.testing.assert_array_equal(got.numpy(), want)
    assert not got.numpy()[~valid].any()


def test_blockwise_plain_negative_threshold_equals_pallas_interpret():
    """Below zero every pair suppresses, across blocks of 64 too."""
    boxes, valid = _case("plain", 150, seed=2)
    valid[0] = False  # the first valid box is the one that stays
    want = np.asarray(pallas_keep_mask(jnp.asarray(boxes), jnp.asarray(valid), -0.5, interpret=True))
    got = ops_nms.nms_keep_mask_blockwise_plain(torch.from_numpy(boxes), torch.from_numpy(valid), -0.5)
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.tolist() == [False, True] + [False] * 148


def test_blockwise_plain_batched_with_an_invalid_tail():
    """Every image of a batch at once, each with its own invalid tail that
    ends inside a word."""
    cases = [_case(kind, 200, seed=20 + i) for i, kind in enumerate(("plain", "dense", "duplicates"))]
    boxes = torch.from_numpy(np.stack([c[0] for c in cases]))
    valid = torch.from_numpy(np.stack([c[1] for c in cases]))
    for i, tail in enumerate((0, 70, 137)):
        valid[i, 200 - tail :] = False
    got = ops_nms.nms_keep_mask_blockwise_plain(boxes, valid, 0.5)
    assert torch.equal(got, ops_nms.nms_keep_mask_plain(boxes, valid, 0.5))
    for i in range(3):
        assert torch.equal(got[i], ops_nms.nms_keep_mask_blockwise_plain(boxes[i], valid[i], 0.5))
        want = pallas_keep_mask(jnp.asarray(boxes[i].numpy()), jnp.asarray(valid[i].numpy()), 0.5, interpret=True)
        np.testing.assert_array_equal(got[i].numpy(), np.asarray(want))


@pytest.mark.parametrize("thr", [0.5, -0.5])
def test_suppression_matrix_holds_later_pairs_only(thr):
    """over[i, j] is the plain version's own test of the pair, for j > i
    alone; validity is not folded in."""
    boxes, _ = _case("dense", 70, seed=5)
    tb = torch.from_numpy(boxes)
    over = ops_nms.suppression_matrix_plain(tb[None], thr)[0]
    assert over.shape == (70, 70) and over.dtype == torch.bool
    assert not over.tril().any()
    for i in (0, 1, 63, 64, 68):
        # the plain version on the two-box set (i, j), one set per later j:
        # box j is kept iff box i does not suppress it
        later = 70 - i - 1
        pairs = torch.stack([tb[i].expand(later, 4), tb[i + 1 :]], dim=1)  # [later, 2, 4]
        keep = ops_nms.nms_keep_mask_plain(pairs, torch.ones(later, 2, dtype=torch.bool), thr)
        assert torch.equal(over[i, i + 1 :], ~keep[:, 1])
    if thr < 0:
        assert over.triu(1).sum().item() == 70 * 69 // 2


def test_keep_mask_batched_equals_per_image():
    cases = [_case(kind, 200, seed=i) for i, kind in enumerate(("plain", "invalid", "dense"))]
    boxes = torch.from_numpy(np.stack([c[0] for c in cases]))
    valid = torch.from_numpy(np.stack([c[1] for c in cases]))
    got = ops_nms.nms_keep_mask(boxes, valid, 0.5)
    for i in range(3):
        assert torch.equal(got[i], ops_nms.nms_keep_mask_plain(boxes[i], valid[i], 0.5))


def test_keep_mask_rejects_bad_shapes():
    with pytest.raises(ValueError):
        ops_nms.nms_keep_mask(torch.zeros(4, 5), torch.ones(4, dtype=torch.bool), 0.5)
    with pytest.raises(ValueError):
        ops_nms.nms_keep_mask(torch.zeros(2, 4, 4), torch.ones(2, 3, dtype=torch.bool), 0.5)


@settings(max_examples=25, deadline=None)
@given(
    n=st.integers(1, 40),
    seed=st.integers(0, 2**31 - 1),
    thr=st.sampled_from([0.3, 0.5, 0.7]),
    grid=st.sampled_from([0.0, 4.0]),
)
def test_keep_mask_hypothesis(n, seed, thr, grid):
    """Random small sets, optionally snapped to a coarse grid (exact ties of
    coordinates, zero-area boxes, IoUs that are simple fractions)."""
    rng = np.random.default_rng(seed)
    boxes = _boxes(rng, n, size=32.0, lo_wh=0.0)
    if grid:
        boxes = (np.round(boxes / grid) * grid).astype(np.float32)
    valid = rng.uniform(size=n) < 0.8
    want = np.asarray(pallas_keep_mask(jnp.asarray(boxes), jnp.asarray(valid), thr, interpret=True))
    got = ops_nms.nms_keep_mask(torch.from_numpy(boxes), torch.from_numpy(valid), thr)
    np.testing.assert_array_equal(got.numpy(), want)
    mirror = ops_nms.nms_keep_mask_blockwise_plain(torch.from_numpy(boxes), torch.from_numpy(valid), thr)
    np.testing.assert_array_equal(mirror.numpy(), want)


@settings(max_examples=15, deadline=None)
@given(
    n=st.integers(60, 200),
    seed=st.integers(0, 2**31 - 1),
    thr=st.sampled_from([0.3, 0.5, 0.7]),
    grid=st.sampled_from([0.0, 4.0]),
)
def test_blockwise_plain_hypothesis_across_blocks(n, seed, thr, grid):
    """Random sets of one to four blocks of 64, optionally on a coarse grid,
    with invalid slots: the block-wise mirror against the plain version."""
    rng = np.random.default_rng(seed)
    boxes = _boxes(rng, n, size=32.0, lo_wh=0.0)
    if grid:
        boxes = (np.round(boxes / grid) * grid).astype(np.float32)
    tb, tv = torch.from_numpy(boxes), torch.from_numpy(rng.uniform(size=n) < 0.8)
    assert torch.equal(
        ops_nms.nms_keep_mask_blockwise_plain(tb, tv, thr), ops_nms.nms_keep_mask_plain(tb, tv, thr)
    )


def _scores(rng, n, tied):
    s = rng.uniform(0.05, 1.0, n).astype(np.float32)
    return np.round(s * 8) / 8 if tied else s  # 8 distinct values: many ties


@pytest.mark.parametrize("tied", [False, True])
@pytest.mark.parametrize("kind,n,thr,max_out", [
    ("plain", 200, 0.5, 50), ("invalid", 300, 0.7, 100), ("dense", 257, 0.7, 257),
    ("duplicates", 200, 0.4, 20), ("zero_area", 200, 0.5, 200), ("plain", 5, 0.5, 5),
    ("plain", 1, 0.5, 1),
])
def test_nms_equals_jax(kind, n, thr, max_out, tied):
    rng = np.random.default_rng(n + max_out)
    b, s, v = [], [], []
    for i in range(2):  # two images a batch, each its own JAX call
        boxes, valid = _case(kind, n, seed=10 * n + i)
        order = rng.permutation(n)  # nms sorts by score itself
        b.append(boxes[order]), v.append(valid[order]), s.append(_scores(rng, n, tied))
    got = tnms.nms(
        torch.from_numpy(np.stack(b)), torch.from_numpy(np.stack(s)), thr, max_out,
        valid=torch.from_numpy(np.stack(v)),
    )
    for i in range(2):
        want = jnms.nms(jnp.asarray(b[i]), jnp.asarray(s[i]), thr, max_out, valid=jnp.asarray(v[i]))
        np.testing.assert_array_equal(got[2][i].numpy(), np.asarray(want[2]))
        np.testing.assert_array_equal(got[1][i].numpy(), np.asarray(want[1]))
        np.testing.assert_array_equal(got[0][i].numpy(), np.asarray(want[0]))


def test_nms_without_valid_equals_jax():
    rng = np.random.default_rng(3)
    boxes, scores = _boxes(rng, 64), _scores(rng, 64, tied=True)
    got = tnms.nms(torch.from_numpy(boxes)[None], torch.from_numpy(scores)[None], 0.5, 64)
    want = jnms.nms(jnp.asarray(boxes), jnp.asarray(scores), 0.5, 64)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g[0].numpy(), np.asarray(w))


@pytest.mark.parametrize("per_class_boxes", [False, True])
@pytest.mark.parametrize("tied", [False, True])
def test_multiclass_nms_equals_jax(per_class_boxes, tied):
    """Two images whose largest coordinates differ, so a span taken over the
    batch instead of per image would shift the class offsets."""
    rng = np.random.default_rng(7)
    n, c = 60, 5
    boxes, scores = [], []
    for size in (100.0, 37.0):
        shape = (n * c,) if per_class_boxes else (n,)
        bx = _boxes(rng, shape[0], size=size)
        boxes.append(bx.reshape(n, c, 4) if per_class_boxes else bx)
        sc = rng.uniform(0.0, 0.3, (n, c)).astype(np.float32)
        scores.append(np.round(sc * 16) / 16 if tied else sc)
    got = tnms.multiclass_nms(
        torch.from_numpy(np.stack(boxes)), torch.from_numpy(np.stack(scores)), 0.05, 0.4, 25,
        pre_nms=120,
    )
    for i in range(2):
        want = jnms.multiclass_nms(
            jnp.asarray(boxes[i]), jnp.asarray(scores[i]), 0.05, 0.4, 25, pre_nms=120
        )
        np.testing.assert_array_equal(got[2][i].numpy(), np.asarray(want[2]))
        np.testing.assert_array_equal(got[1][i].numpy(), np.asarray(want[1]))
        np.testing.assert_array_equal(got[0][i].numpy(), np.asarray(want[0]))


def test_neg_inf_is_not_live_in_bfloat16():
    s = torch.tensor([0.5, tnms.NEG_INF], dtype=torch.bfloat16)
    assert tnms.is_live(s).tolist() == [True, False]
    assert tnms.NEG_INF == jnms.NEG_INF
