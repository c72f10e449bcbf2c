"""The port's input pipeline (`clipself_tpu_torch/data/`, no PIL) against the
JAX package's (`clipself_tpu/data/`, PIL) on the same files.

Bars: EQUAL everywhere. The PNG decoder against `PIL.Image.open` for every
8-bit colour type and row filter; JPEG decode against the JAX package's
native `decode` and Pillow; the transforms (Pillow's 8-bit BICUBIC, crop
rounding, the float BILINEAR mask) against the JAX ones under a hypothesis
search; every dataset's items on a JPEG and a PNG corpus; the native loader's
batches against the JAX one's. The loader's order and batching are checked
against `default_rng((seed, epoch)).permutation`.
"""

import io
import json
import os
import struct
import subprocess
import sys
import textwrap
import zlib
from pathlib import Path

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st
from PIL import Image

from clipself_tpu.core import constants as jconstants
from clipself_tpu.data import coco as jcoco
from clipself_tpu.data import datasets as jdatasets
from clipself_tpu.data import loader as jloader
from clipself_tpu.data import native_loader as jnative
from clipself_tpu.data import transforms as jtransforms
from clipself_tpu_torch.core import constants
from clipself_tpu_torch.data import coco, datasets, image_io, loader, native_loader, transforms
from conftest import write_micro_coco

from torch_threads import capped_threads  # noqa: F401  (module fixture)

DET, CROP, ANNS = 96, 32, 4


def write_png(arr: np.ndarray, ctype: int, filters, palette=None, interlace=0, depth=8) -> bytes:
    """A PNG of ``arr`` [H, W(, C)] uint8 with the given row filters, cycled
    over the rows (0 None, 1 Sub, 2 Up, 3 Average, 4 Paeth)."""
    h, w = arr.shape[:2]
    a = arr.reshape(h, w, -1).astype(np.int16)
    c = a.shape[2]
    body = bytearray()
    prev = np.zeros((w, c), np.int16)
    for y in range(h):
        f = filters[y % len(filters)]
        cur = a[y]
        left = np.concatenate([np.zeros((1, c), np.int16), cur[:-1]])
        ul = np.concatenate([np.zeros((1, c), np.int16), prev[:-1]])
        if f == 0:
            pred = np.zeros_like(cur)
        elif f == 1:
            pred = left
        elif f == 2:
            pred = prev
        elif f == 3:
            pred = (left + prev) >> 1
        else:
            p = left + prev - ul
            pa, pb, pc = abs(p - left), abs(p - prev), abs(p - ul)
            pred = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, prev, ul))
        body.append(f)
        body += ((cur - pred) % 256).astype(np.uint8).tobytes()
        prev = cur

    def chunk(kind, data):
        return struct.pack(">I", len(data)) + kind + data + struct.pack(">I", zlib.crc32(kind + data))

    out = image_io.PNG_SIGNATURE
    out += chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype, 0, 0, interlace))
    if palette is not None:
        out += chunk(b"PLTE", palette.tobytes())
    return out + chunk(b"IDAT", zlib.compress(bytes(body))) + chunk(b"IEND", b"")


def test_constants_and_coco_index_are_copies(tmp_path):
    for name in ("OPENAI_DATASET_MEAN", "OPENAI_DATASET_STD", "MASKED_CROP_FILL"):
        assert getattr(constants, name) == getattr(jconstants, name)
    write_micro_coco(tmp_path, n_images=3)
    for port, ref, f in (
        (coco.COCOIndex, jcoco.COCOIndex, "instances.json"),
        (coco.COCOPanopticIndex, jcoco.COCOPanopticIndex, "panoptic.json"),
    ):
        a, b = port(str(tmp_path / f)), ref(str(tmp_path / f))
        assert (a.imgs, a.anns, a.cats, dict(a.img_to_anns)) == (
            b.imgs, b.anns, b.cats, dict(b.img_to_anns)
        )
        assert a.image_ids == b.image_ids
        assert [a.file_name(i) for i in a.image_ids] == [b.file_name(i) for i in b.image_ids]
    rng = np.random.default_rng(0)
    color = rng.integers(0, 256, (9, 11, 3), dtype=np.uint8)
    np.testing.assert_array_equal(coco.rgb2id(color), jcoco.rgb2id(color))
    mask = rng.uniform(size=(9, 11)) < 0.2
    assert coco.mask2box(mask) == jcoco.mask2box(mask)
    assert coco.mask2box(np.zeros((3, 3), bool)) is None


@pytest.mark.parametrize("ctype,channels", [(0, 1), (2, 3), (3, 1), (4, 2), (6, 4)])
def test_png_decoder_equals_pillow_for_every_filter(ctype, channels):
    """Each colour type at widths 1, 7 and 641, rows of one filter type each
    and of all five in turn, as the array `Image.open` gives and after
    `convert("RGB")`."""
    rng = np.random.default_rng(ctype)
    palette = rng.integers(0, 256, (200, 3), dtype=np.uint8) if ctype == 3 else None
    for w in (1, 7, 641):
        arr = rng.integers(0, 256, (6, w, channels), dtype=np.uint8)
        if ctype == 3:
            arr %= 200
        for filters in ([0], [1], [2], [3], [4], [0, 1, 2, 3, 4], [2, 1, 0]):
            data = write_png(arr, ctype, filters, palette)
            pil = Image.open(io.BytesIO(data))
            np.testing.assert_array_equal(image_io.decode_png(data)[0], np.asarray(pil))
            rgb = image_io.png_to_rgb(*image_io.decode_png(data))
            np.testing.assert_array_equal(rgb, np.asarray(pil.convert("RGB")))


@pytest.mark.parametrize("mode", ["L", "RGB", "P", "LA", "RGBA"])
def test_png_decoder_equals_pillow_on_pillow_files(tmp_path, mode):
    """Files Pillow writes (its adaptive filter choice per row), on a smooth
    image so that every predictor wins some rows."""
    rng = np.random.default_rng(1)
    base = Image.fromarray(rng.integers(0, 256, (6, 8, 3), dtype=np.uint8))
    img = base.resize((97, 61), Image.BICUBIC).convert(mode)
    path = tmp_path / f"a_{mode}.png"
    img.save(path)
    np.testing.assert_array_equal(image_io.read_png(str(path)), np.asarray(Image.open(path)))
    np.testing.assert_array_equal(
        image_io.open_image(str(path)), np.asarray(Image.open(path).convert("RGB"))
    )


def test_unsupported_png_forms_raise_and_corrupt_files_are_unreadable(tmp_path):
    arr = np.zeros((12, 12, 3), np.uint8)
    for name, data in (
        ("interlaced.png", write_png(arr, 2, [0], interlace=1)),
        ("sixteen.png", write_png(arr, 2, [0], depth=16)),
    ):
        p = tmp_path / name
        p.write_bytes(data)
        with pytest.raises(ValueError, match=name):
            image_io.open_image(str(p))
    good = write_png(arr, 2, [0])
    bad_crc = bytearray(good)
    bad_crc[40] ^= 0xFF  # inside IDAT: its CRC no longer matches
    for name, data in (
        ("crc.png", bytes(bad_crc)), ("trunc.png", good[:45]), ("junk.jpg", b"not an image"),
        ("small.png", write_png(np.zeros((9, 40, 3), np.uint8), 2, [1])),
    ):
        p = tmp_path / name
        p.write_bytes(data)
        assert image_io.open_image(str(p)) is None, name
    (tmp_path / "a.gif").write_bytes(b"GIF89a" + bytes(20))
    with pytest.raises(ValueError, match="GIF"):
        image_io.open_image(str(tmp_path / "a.gif"))


@pytest.mark.parametrize("quality", [75, 95])
def test_jpeg_decode_equals_native_and_pillow(tmp_path, quality):
    rng = np.random.default_rng(quality)
    arr = np.asarray(
        Image.fromarray(rng.integers(0, 256, (7, 9, 3), dtype=np.uint8)).resize((90, 70))
    )
    for mode in ("RGB", "L"):
        p = str(tmp_path / f"a_{mode}.jpg")
        Image.fromarray(arr).convert(mode).save(p, quality=quality)
        got = image_io.open_image(p)
        np.testing.assert_array_equal(got, jnative.decode(p))
        np.testing.assert_array_equal(got, np.asarray(Image.open(p).convert("RGB")))


@settings(max_examples=40, deadline=None, derandomize=True)
@given(
    st.integers(1, 700), st.integers(1, 700), st.integers(1, 700), st.integers(1, 700),
    st.integers(0, 2**32 - 1),
)
def test_bicubic_resize_equals_pillow(h, w, nh, nw, seed):
    """Pillow's 8-bit BICUBIC, shrinking and growing along each axis."""
    arr = np.random.default_rng(seed).integers(0, 256, (h, w, 3), dtype=np.uint8)
    want = np.asarray(Image.fromarray(arr).resize((nw, nh), Image.BICUBIC))
    np.testing.assert_array_equal(transforms.resize_bicubic(arr, (nw, nh)), want)


@settings(max_examples=25, deadline=None, derandomize=True)
@given(
    st.integers(10, 200), st.integers(10, 200), st.integers(4, 64),
    st.lists(st.integers(-40, 480).map(lambda v: v / 2), min_size=4, max_size=4),
    st.integers(0, 2**32 - 1),
)
def test_transforms_equal_the_jax_ones(h, w, size, box, seed):
    """det/crop transforms, crops at half-pixel ties (Pillow rounds half to
    even) and outside the image, and the mask resize after `> 0`."""
    rng = np.random.default_rng(seed)
    arr = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    img = Image.fromarray(arr)
    _same(lambda: transforms.det_transform(arr, size), lambda: jtransforms.det_transform(img, size))
    x0, y0, x1, y1 = box
    box = (min(x0, x1), min(y0, y1), max(x0, x1), max(y0, y1))
    np.testing.assert_array_equal(transforms.crop(arr, box), np.asarray(img.crop(box)))
    _same(
        lambda: transforms.crop_transform(transforms.crop(arr, box), size),
        lambda: jtransforms.crop_transform(img.crop(box), size),
    )
    mask = (rng.uniform(size=(h, w)) < 0.1).astype(np.float32)
    _same(
        lambda: transforms.resize_mask_longest(mask, size),
        lambda: jtransforms.resize_mask_longest(mask, size),
    )


def _same(ours, theirs):
    """Equal results, or the same exception type from both (Pillow refuses a
    resize to an empty size; a crop of no area divides by zero)."""
    try:
        want = theirs()
    except (ValueError, ZeroDivisionError) as e:
        with pytest.raises(type(e)):
            ours()
        return
    np.testing.assert_array_equal(ours(), want)


def test_random_transforms_draw_as_the_jax_ones():
    arr = np.random.default_rng(0).integers(0, 256, (50, 70, 3), dtype=np.uint8)
    for seed in range(6):
        ours, theirs = np.random.default_rng(seed), np.random.default_rng(seed)
        a, b = arr, Image.fromarray(arr)
        for t, j in (
            (transforms.RandomResize((0.5, 2.0)), jtransforms.RandomResize((0.5, 2.0))),
            (transforms.RandomCrop(40), jtransforms.RandomCrop(40)),
            (transforms.RandomHFlip(), jtransforms.RandomHFlip()),
        ):
            a, b = t(a, ours), j(b, theirs)
            np.testing.assert_array_equal(a, np.asarray(b))
        assert ours.bit_generator.state == theirs.bit_generator.state


def _corpus(root, fmt: str):
    """The micro corpus (JPEG images), or the same pixels as PNG files; plus
    one unreadable train image (id 99) and a panoptic JSON whose category 2
    is a thing, so that every segment takes the thing branch."""
    img_dir, seg_dir = write_micro_coco(root, n_images=5, anns_per_image=3, embed_dim=16)
    inst = json.loads((root / "instances.json").read_text())
    if fmt == "png":
        for info in inst["images"]:
            src = img_dir / info["file_name"]
            info["file_name"] = src.stem + ".png"
            Image.open(src).save(img_dir / info["file_name"])
    (img_dir / "broken.jpg").write_bytes(b"\xff\xd8\xff\xe0 this is no JPEG")
    inst["images"].append({"id": 99, "file_name": "broken.jpg", "width": 80, "height": 60})
    (root / "train.json").write_text(json.dumps(inst))
    pan = json.loads((root / "panoptic.json").read_text())
    for info in pan["images"]:
        info["file_name"] = next(i["file_name"] for i in inst["images"] if i["id"] == info["id"])
    (root / "pan.json").write_text(json.dumps(pan))
    for c in pan["categories"]:
        c["isthing"] = 1
    (root / "pan_things.json").write_text(json.dumps(pan))
    return str(img_dir), str(seg_dir)


@pytest.fixture(scope="module", params=["jpeg", "png"])
def corpus(request, tmp_path_factory):
    root = tmp_path_factory.mktemp(request.param)
    img_dir, seg_dir = _corpus(root, request.param)
    return root, img_dir, seg_dir


def _assert_items_equal(port_ds, jax_ds, indices):
    for i in indices:
        a, b = port_ds[i], jax_ds[i]
        assert sorted(a) == sorted(b)
        for k in a:
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=f"item {i} {k}")


GRID_CASES = {
    "plain": dict(max_split=3),
    "pre_scale_ratio": dict(max_split=4, pre_transforms=True, crop_scale=1.5, train_ratio=0.5),
}


@pytest.mark.parametrize("case", sorted(GRID_CASES))
def test_grid_items_equal_the_jax_items(corpus, case):
    root, img_dir, _ = corpus
    kw = dict(det_size=DET, crop_size=CROP, max_anns=ANNS, seed=3, **GRID_CASES[case])
    ours = datasets.GridDistillDataset(str(root / "train.json"), img_dir, **kw)
    theirs = jdatasets.GridDistillDataset(str(root / "train.json"), img_dir, **kw)
    assert ours.image_ids == theirs.image_ids
    for epoch in (0, 1):
        ours.set_epoch(epoch)
        theirs.set_epoch(epoch)
        _assert_items_equal(ours, theirs, range(len(ours)))
        for i in range(len(ours)):
            a, b = ours.plan_item(i), theirs.plan_item(i)
            assert (a is None) == (b is None)
            if a is not None:
                assert a["path"] == b["path"]
                np.testing.assert_array_equal(a["boxes"], b["boxes"])
                np.testing.assert_array_equal(a["crop_windows"], b["crop_windows"])


def test_the_unreadable_image_resamples_the_same_index(corpus):
    root, img_dir, _ = corpus
    ours = datasets.GridDistillDataset(str(root / "train.json"), img_dir, det_size=DET, crop_size=CROP, max_anns=ANNS)
    theirs = jdatasets.GridDistillDataset(str(root / "train.json"), img_dir, det_size=DET, crop_size=CROP, max_anns=ANNS)
    broken = ours.image_ids.index(99)
    for epoch in (0, 1):
        ours.set_epoch(epoch)
        theirs.set_epoch(epoch)
        assert ours._read(broken)[1] == theirs._read(broken)[1] != broken
        _assert_items_equal(ours, theirs, [broken])


def test_proposal_and_region_clip_items_equal_the_jax_items(corpus):
    root, img_dir, _ = corpus
    kw = dict(det_size=DET, crop_size=CROP, max_anns=ANNS, min_size=2.0, max_size=64.0, seed=1)
    _assert_items_equal(
        datasets.ProposalDistillDataset(str(root / "train.json"), img_dir, **kw),
        jdatasets.ProposalDistillDataset(str(root / "train.json"), img_dir, **kw),
        range(6),
    )
    # no box passes the size filter: the top-left-quarter fallback
    kw.update(min_size=30.0)
    _assert_items_equal(
        datasets.ProposalDistillDataset(str(root / "train.json"), img_dir, **kw),
        jdatasets.ProposalDistillDataset(str(root / "train.json"), img_dir, **kw),
        range(2),
    )
    kw = dict(det_size=DET, max_anns=2, train_ratio=0.5, seed=2)
    ours = datasets.RegionCLIPDataset(str(root / "train.json"), img_dir, **kw)
    theirs = jdatasets.RegionCLIPDataset(str(root / "train.json"), img_dir, **kw)
    assert ours.image_ids == theirs.image_ids
    _assert_items_equal(ours, theirs, range(len(ours)))


@pytest.mark.parametrize("panoptic", ["pan.json", "pan_things.json"])
def test_panoptic_eval_items_equal_the_jax_items(corpus, panoptic):
    root, img_dir, seg_dir = corpus
    kw = dict(
        embed_path=str(root / "emb.npy"), det_size=DET, crop_size=CROP, downsample_factor=8,
        min_size=2.0, max_size=256.0,
    )
    ours = datasets.COCOPanopticEvalDataset(str(root / panoptic), img_dir, seg_dir, **kw)
    theirs = jdatasets.COCOPanopticEvalDataset(str(root / panoptic), img_dir, seg_dir, **kw)
    np.testing.assert_array_equal(ours.embeddings, theirs.embeddings)
    _assert_items_equal(ours, theirs, range(len(ours)))


def test_an_unreadable_eval_image_raises_in_both(corpus, tmp_path):
    root, img_dir, seg_dir = corpus
    pan = json.loads((root / "pan.json").read_text())
    pan["images"][0]["file_name"] = "broken.jpg"
    (tmp_path / "pan.json").write_text(json.dumps(pan))
    for cls in (datasets.COCOPanopticEvalDataset, jdatasets.COCOPanopticEvalDataset):
        ds = cls(str(tmp_path / "pan.json"), img_dir, seg_dir, det_size=DET, crop_size=CROP)
        with pytest.raises(RuntimeError, match="unreadable eval image"):
            ds[0]


class _Indexed:
    """A dataset whose item is its index, with a set_epoch."""

    def __init__(self, n):
        self.n = n
        self.epoch = 0

    def set_epoch(self, epoch):
        self.epoch = epoch

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return {"idx": np.asarray([i], np.int64), "x": np.full((2, 3), i, np.float32)}


def test_loader_order_batching_and_workers():
    ds = _Indexed(11)
    for epoch in (0, 1):
        want = np.random.default_rng((7, epoch)).permutation(11)
        batches = list(loader.make_loader(ds, 3, seed=7, epoch=epoch))
        got = np.concatenate([b["idx"][:, 0].numpy() for b in batches])
        np.testing.assert_array_equal(got, want[:9])  # the train remainder dropped
        assert all(isinstance(b["x"], torch.Tensor) and b["x"].shape == (3, 2, 3) for b in batches)
    tail = list(loader.make_loader(ds, 3, shuffle=False, drop_last=False))
    assert [len(b["idx"]) for b in tail] == [3, 3, 3, 2]  # eval keeps the tail
    np.testing.assert_array_equal(np.concatenate([b["idx"][:, 0].numpy() for b in tail]), np.arange(11))


def test_loader_gives_the_same_batches_with_worker_processes(tmp_path):
    """Items depend on (seed, epoch, index) only: two worker processes (each
    with its copy of the dataset at epoch 1) give the batches one process
    gives."""
    img_dir, _ = write_micro_coco(tmp_path, n_images=5)
    ds = datasets.GridDistillDataset(
        str(tmp_path / "instances.json"), str(img_dir), det_size=64, crop_size=CROP, max_anns=3,
        max_split=3, seed=4,
    )
    ds.set_epoch(1)
    one = list(loader.make_loader(ds, 2, seed=4, epoch=1, num_workers=0))
    two = list(loader.make_loader(ds, 2, seed=4, epoch=1, num_workers=2))
    assert len(one) == len(two) == 2
    order = np.random.default_rng((4, 1)).permutation(5)
    for j, (a, b) in enumerate(zip(one, two)):
        for k in a:
            torch.testing.assert_close(a[k], b[k], rtol=0, atol=0)
        for r in range(2):
            np.testing.assert_array_equal(a["images"][r].numpy(), ds[int(order[2 * j + r])]["images"])


def test_stop_worker_server_ends_the_fork_server_and_tracker():
    """After a loader with workers, `stop_worker_server` leaves neither the
    fork server nor the resource tracker running."""
    from multiprocessing import forkserver, resource_tracker

    got = list(loader.make_loader(_Indexed(6), 2, shuffle=False, num_workers=2))
    assert np.concatenate([b["idx"][:, 0].numpy() for b in got]).tolist() == list(range(6))
    pids = [forkserver._forkserver._forkserver_pid, resource_tracker._resource_tracker._pid]
    assert all(pids)
    loader.stop_worker_server()
    assert not any(os.path.exists(f"/proc/{pid}") for pid in pids)
    loader.stop_worker_server()  # nothing running: a no-op


def test_chip_smoke_stops_every_process_it_started(tmp_path):
    """`chip_smoke.stop_children` leaves no process below its own, even with
    a loader's workers still running: they are ended before the tracker,
    which waits for every holder of its pipe, is stopped."""
    script = tmp_path / "children.py"
    script.write_text(textwrap.dedent(f"""
        import json, os, sys
        sys.path.insert(0, {str(Path(__file__).resolve().parents[1])!r})
        import numpy as np
        import chip_smoke
        from clipself_tpu_torch.data import loader

        class Items:
            def __len__(self):
                return 8

            def __getitem__(self, i):
                return {{"x": np.full(2, i, np.float32)}}

        if __name__ == "__main__":
            it = iter(loader.make_loader(Items(), 2, seed=0, epoch=0, num_workers=2))
            next(it)
            before = chip_smoke.descendants(os.getpid())
            chip_smoke.stop_children()
            print(json.dumps({{"before": len(before), "after": chip_smoke.descendants(os.getpid())}}))
    """))
    proc = subprocess.run([sys.executable, str(script)], capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["before"] >= 4  # the fork server, the tracker and two workers
    assert out["after"] == []
    assert "ended processes still running at exit" in proc.stderr  # the two workers


def test_device_prefetch_on_the_cpu_is_a_plain_conversion():
    batches = [{"a": np.arange(3, dtype=np.float32) + i, "b": torch.ones(2) * i} for i in range(3)]
    out = list(loader.device_prefetch(batches, "cpu"))
    assert len(out) == 3
    for i, b in enumerate(out):
        assert b["a"].tolist() == [i, i + 1, i + 2] and b["b"].tolist() == [i, i]


def test_native_loader_batches_equal_the_jax_ones(corpus):
    """Same library, same plans: the batches are equal, the broken row
    included (both build it by their dataset's own route), and the port
    counts that row."""
    root, img_dir, _ = corpus
    kw = dict(det_size=DET, crop_size=CROP, max_anns=ANNS, max_split=3, seed=5)
    ours_ds = datasets.GridDistillDataset(str(root / "train.json"), img_dir, **kw)
    theirs_ds = jdatasets.GridDistillDataset(str(root / "train.json"), img_dir, **kw)
    ours = loader.NativeDistillLoader(ours_ds, 2, seed=5, num_threads=2)
    theirs = jloader.NativeDistillLoader(theirs_ds, 2, seed=5, num_threads=2)
    n = 2 * (len(ours_ds) // 2)  # two epochs of batches
    for a, b in zip(_take(ours, n), _take(theirs, n)):
        for k in ("images", "boxes", "crops"):
            np.testing.assert_array_equal(a[k], b[k])
    assert ours.fallback_rows == 2  # the broken image, once an epoch
    ours.close()


def test_train_routes_give_each_epoch_its_batches():
    """The trainer's routes behind `TrainRoute`: the loader route sets the
    dataset's epoch and makes one pass in that epoch's order; the synthetic
    route repeats its one batch, staged once, across epochs."""
    ds = _Indexed(7)
    route = loader.loader_route(ds, 2, seed=7, workers=0, device="cpu")
    assert (route.steps, route.endless, route.fallback_rows) == (3, False, None)
    for epoch in (0, 1):
        batches = route.epoch(epoch)
        assert ds.epoch == epoch
        got = np.concatenate([b["idx"][:, 0].numpy() for b in batches])
        np.testing.assert_array_equal(got, np.random.default_rng((7, epoch)).permutation(7)[:6])
    route.close()
    data = loader.SyntheticDistillData(batch_size=2, det_size=16, crop_size=8, max_anns=2)
    synthetic = loader.synthetic_route(data, "cpu")
    assert (synthetic.steps, synthetic.endless, synthetic.fallback_rows) == (None, True, None)
    first = synthetic.epoch(0)
    a = next(first)
    first.close()
    assert next(synthetic.epoch(1)) is a
    assert isinstance(a["images"], torch.Tensor) and a["images"].shape == (2, 16, 16, 3)
    np.testing.assert_array_equal(a["crops"].numpy(), data.batch["crops"])


def test_the_native_route_runs_on_across_epochs(corpus):
    """Closing an epoch's generator leaves the native stream open: two
    epochs through `native_route` are the JAX `NativeDistillLoader`'s
    batches, and the route counts the broken row once an epoch."""
    root, img_dir, _ = corpus
    kw = dict(det_size=DET, crop_size=CROP, max_anns=ANNS, max_split=3, seed=5)
    ds = datasets.GridDistillDataset(str(root / "train.json"), img_dir, **kw)
    theirs = jloader.NativeDistillLoader(
        jdatasets.GridDistillDataset(str(root / "train.json"), img_dir, **kw), 2, seed=5,
        num_threads=2,
    )
    route = loader.native_route(ds, 2, seed=5, workers=2, device="cpu")
    n = len(ds) // 2
    assert (route.steps, route.endless) == (n, True)
    got = []
    for epoch in (0, 1):
        batches = route.epoch(epoch)
        got += [{k: v.numpy().copy() for k, v in next(batches).items()} for _ in range(n)]
        batches.close()
    for a, b in zip(got, _take(theirs, 2 * n), strict=True):
        for k in ("images", "boxes", "crops"):
            np.testing.assert_array_equal(a[k], b[k])
    assert route.fallback_rows == 2
    route.close()


def _take(it, n):
    out = []
    for batch in it:
        out.append({k: v.copy() for k, v in batch.items()})
        if len(out) == n:
            return out
    return out


def test_jpeg_without_the_native_core_raises(tmp_path, monkeypatch):
    p = tmp_path / "a.jpg"
    Image.fromarray(np.zeros((20, 20, 3), np.uint8)).save(p)
    monkeypatch.setattr(native_loader, "_lib", None)
    monkeypatch.setattr(native_loader, "_LIB_PATH", tmp_path / "missing.so")
    monkeypatch.setattr(native_loader, "_NATIVE_DIR", tmp_path)
    with pytest.raises(RuntimeError, match="native loader core unavailable"):
        image_io.open_image(str(p))
    png = tmp_path / "a.png"
    Image.fromarray(np.zeros((20, 20, 3), np.uint8)).save(png)
    assert image_io.open_image(str(png)).shape == (20, 20, 3)  # PNGs need no core


def test_jpeg_with_a_core_that_cannot_be_loaded_raises(tmp_path, monkeypatch):
    """A library that exists but does not load (built where libjpeg was,
    loaded where it is not) is an error naming it, never an unreadable
    image that a dataset would resample past."""
    p = tmp_path / "a.jpg"
    Image.fromarray(np.zeros((20, 20, 3), np.uint8)).save(p)
    broken = tmp_path / "libclipself_loader.so"
    broken.write_bytes(b"not a shared object")
    monkeypatch.setattr(native_loader, "_lib", None)
    monkeypatch.setattr(native_loader, "_LIB_PATH", broken)
    with pytest.raises(RuntimeError, match="cannot load .*libclipself_loader.so"):
        image_io.open_image(str(p))

