"""The port's detector file path (`clipself_tpu_torch/detector/data.py::
DetectionDataset`, `data/draw.py`, `data/transforms.py::resize_bilinear`,
`tools/synth_det_data.py`; no PIL) against the JAX package's (PIL).

Bars: EQUAL everywhere, no tolerance. The polygon fill against Pillow's
`ImageDraw.polygon(fill=1)` on mode "1" (a hypothesis search and fixed
cases), the RGB BILINEAR resize against Pillow's, `rle_decode` against the
JAX one, `DetectionDataset` items key for key and dtype for dtype (train
over several epochs so that both flip branches and crops on both axes
occur, eval, with and without masks, a crowd RLE included), and the synthetic
set tool's JSON and rectangles against the JAX tool's.
"""

import json
import os

import numpy as np
import pytest
from hypothesis import HealthCheck, example, given, settings
from hypothesis import strategies as st
from PIL import Image, ImageDraw

from clipself_tpu.detector import data as jdata
from clipself_tpu.tools import synth_det_data as jsynth
from clipself_tpu_torch.data import draw, transforms
from clipself_tpu_torch.data.image_io import decode_image
from clipself_tpu_torch.detector import data
from clipself_tpu_torch.tools import synth_det_data as synth

from torch_threads import capped_threads  # noqa: F401  (module fixture)

NAMES = ["person", "skateboard", "dog"]
SIZE, MAX_GT = 64, 4


def pil_polygon(pts, side: int) -> np.ndarray:
    im = Image.new("1", (side, side), 0)
    ImageDraw.Draw(im).polygon([tuple(p) for p in np.asarray(pts, np.float32)], fill=1)
    return np.asarray(im)


def port_polygon(pts, side: int) -> np.ndarray:
    return draw.polygon(np.zeros((side, side), bool), np.asarray(pts, np.float32))


def ellipse(cx, cy, rx, ry, n=32):
    t = np.linspace(0, 2 * np.pi, n, endpoint=False)
    return np.stack([cx + rx * np.cos(t), cy + ry * np.sin(t)], -1)


POLYGONS = {
    "ellipse": ellipse(80, 70, 50, 30),
    "ellipse_small": ellipse(7.5, 8.5, 3.2, 5.7),
    "ellipse_half_centre": ellipse(40.5, 20.5, 12.5, 9.5),
    "ellipse_off_edge": ellipse(150, -5, 40, 30),
    "rectangle": [(10, 12), (90, 12), (90, 60), (10, 60)],
    "rectangle_at_half": [(10.5, 12.5), (90.5, 12.5), (90.5, 60.5), (10.5, 60.5)],
    "horizontal_runs": [(0, 5), (4, 5), (9, 5), (9, 9), (6, 9), (2, 9), (0, 9)],
    "vertical_edges": [(3, 1), (3, 14), (12, 14), (12, 1)],
    "bowtie": [(2, 2), (14, 14), (14, 2), (2, 14)],
    "star": [(8, 0), (10, 14), (0, 5), (16, 5), (6, 14)],
    "collinear": [(1, 1), (5, 5), (9, 9), (13, 13), (13, 1)],
    "spike": [(2, 6), (6, 5), (8, 6), (6, 5)],
    "repeated_vertex": [(14, 4), (0, 13), (2, 10), (13, 12), (15, 12), (2, 10)],
    "shared_top": [(9, 1), (0, 3), (13, 1), (5, 6), (14, 5), (13, 1), (12, 13)],
    "all_negative": [(-15, -3), (-2, -18), (-9, -1)],
    "below_raster": [(3, 170), (20, 175), (9, 179)],
    "negative_halves": [(2.5, 12.5), (-3.5, 10.0), (-3.5, -2.5), (-6.0, 9.0)],
    "one_point": [(5.2, 5.7), (5.2, 5.7), (5.2, 5.7)],
    "thin_triangle": [(0, 12), (22, 20), (52, 34)],
}


@pytest.mark.parametrize("side", [16, 160])
@pytest.mark.parametrize("name", sorted(POLYGONS))
def test_polygon_cases_equal_pillow(name, side):
    pts = POLYGONS[name]
    np.testing.assert_array_equal(port_polygon(pts, side), pil_polygon(pts, side))


_coord = st.floats(-20, 180, width=32)


@settings(max_examples=300, deadline=None, suppress_health_check=list(HealthCheck))
@given(st.lists(st.tuples(_coord, _coord), min_size=3, max_size=40), st.sampled_from([16, 160]))
def test_polygon_search_equals_pillow(pts, side):
    np.testing.assert_array_equal(port_polygon(pts, side), pil_polygon(pts, side))


def test_rectangle_equals_pillow():
    rng = np.random.default_rng(0)
    for box in ([3, 4, 3, 4], [0, 0, 31, 23], [-5, 10, 12, 40], [20, -3, 45, 2], [40, 30, 50, 35]):
        arr = rng.integers(0, 255, (24, 32, 3), dtype=np.uint8)
        im = Image.fromarray(arr.copy())
        ImageDraw.Draw(im).rectangle(box, fill=(250, 7, 99))
        np.testing.assert_array_equal(draw.rectangle(arr, box, (250, 7, 99)), np.asarray(im))
    with pytest.raises(ValueError):
        draw.rectangle(arr, [5, 5, 4, 9], 1)


@settings(max_examples=40, deadline=None, suppress_health_check=list(HealthCheck))
@given(st.integers(1, 640), st.integers(1, 640), st.floats(0.1, 2.0), st.floats(0.1, 2.0),
       st.integers(0, 2**31), st.tuples(*[st.floats(0, 1)] * 4))
# a window (0, 1, 1, 2) below a 1x1 resize: Pillow's crop is one zero pixel
@example(h=1, w=1, rh=1.0, rw=1.0, seed=0, corners=(0.0, 0.0, 1.0, 1.0))
def test_resize_bilinear_equals_pillow(h, w, rh, rw, seed, corners):
    img = np.random.default_rng(seed).integers(0, 256, (h, w, 3), dtype=np.uint8)
    size = (max(int(round(w * rw)), 1), max(int(round(h * rh)), 1))
    pil = Image.fromarray(img).resize(size, Image.BILINEAR)
    np.testing.assert_array_equal(transforms.resize_bilinear(img, size), np.asarray(pil))
    # a window of the resize: the crop of Pillow's whole resize
    xs = sorted(int(c * size[0]) for c in corners[:2])
    ys = sorted(int(c * size[1]) for c in corners[2:])
    window = (xs[0], ys[0], max(xs[1], xs[0] + 1), max(ys[1], ys[0] + 1))
    got = transforms.resize_bilinear(img, size, window=window)
    np.testing.assert_array_equal(got, np.asarray(pil.crop(window)))


@pytest.mark.parametrize("hw, size", [((640, 640), (64, 64)), ((480, 640), (1280, 960)), ((427, 640), (640, 427))])
def test_resize_bilinear_recipe_ratios(hw, size):
    img = np.random.default_rng(1).integers(0, 256, hw + (3,), dtype=np.uint8)
    want = np.asarray(Image.fromarray(img).resize(size, Image.BILINEAR))
    np.testing.assert_array_equal(transforms.resize_bilinear(img, size), want)


def _compress(counts):
    """pycocotools' compressed counts (the JAX tests' encoder)."""
    out = []
    for i, x in enumerate(counts):
        if i > 2:
            x = x - counts[i - 2]
        more = True
        while more:
            c = x & 0x1F
            x >>= 5
            more = not (x == 0 and not (c & 0x10)) and not (x == -1 and (c & 0x10))
            if more:
                c |= 0x20
            out.append(chr(c + 48))
    return "".join(out)


@pytest.mark.parametrize("rle", [
    {"size": [2, 3], "counts": [1, 2, 3]},
    {"size": [4, 6], "counts": [0, 5, 3, 4, 12]},
    {"size": [4, 6], "counts": _compress([0, 5, 3, 4, 12])},
    {"size": [9, 7], "counts": _compress([3, 17, 2, 30, 11])},
])
def test_rle_decode_equal(rle):
    got, want = data.rle_decode(rle), jdata.rle_decode(rle)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """PIL-written images (PNG and one JPEG, sizes on both sides of 64)
    with box, polygon and crowd-RLE (plain and compressed) annotations: more
    gts than MAX_GT on one image, an unmapped category, an image with only
    an unmapped gt (kept by eval, dropped by train) and the LVIS image
    fields."""
    root = tmp_path_factory.mktemp("det_corpus")
    rng = np.random.default_rng(0)
    sizes = [(80, 50), (40, 96), (64, 64), (130, 70), (30, 20)]
    images, anns = [], []
    aid = 1
    for i, (w, h) in enumerate(sizes):
        name = f"im{i}.jpg" if i == 1 else f"im{i}.png"
        Image.fromarray(rng.integers(0, 255, (h, w, 3), dtype=np.uint8)).save(root / name)
        info = {"id": 10 + i, "file_name": name, "width": w, "height": h}
        if i % 2 == 0:
            info["neg_category_ids"] = [2, 9]
            info["not_exhaustive_category_ids"] = [1]
        images.append(info)
        for j in range({0: 6, 4: 1}.get(i, 2)):
            bw, bh = rng.uniform(4, w / 2), rng.uniform(4, h / 2)
            x, y = rng.uniform(0, w - bw), rng.uniform(0, h - bh)
            poly = ellipse(x + bw / 2, y + bh / 2, bw / 2, bh / 2, 12).reshape(-1).tolist()
            anns.append({
                "id": aid, "image_id": 10 + i, "category_id": 7 if (i, j) in ((0, 5), (4, 0)) else 1 + j % 3,
                "bbox": [x, y, bw, bh], "area": bw * bh * 0.7, "iscrowd": 0,
                "segmentation": [poly, [x, y, x + 3, y, x + 3, y + 2]],
            })
            aid += 1
        if i in (0, 3):
            runs = np.cumsum(rng.integers(1, 9, w * h))
            runs = runs[runs < w * h]
            counts = np.diff(np.concatenate([[0], runs, [w * h]])).tolist()
            rle = {"size": [h, w], "counts": counts if i == 0 else _compress(counts)}
            anns.append({
                "id": aid, "image_id": 10 + i, "category_id": 2, "bbox": [2, 3, 10, 8],
                "area": 40.0, "iscrowd": 1, "segmentation": rle,
            })
            aid += 1
    cats = [{"id": c + 1, "name": n} for c, n in enumerate(NAMES)] + [{"id": 7, "name": "unmapped"}]
    (root / "ann.json").write_text(json.dumps({"images": images, "annotations": anns, "categories": cats}))
    return str(root / "ann.json"), str(root)


def assert_items_equal(got: dict, want: dict):
    assert list(got) == list(want)
    for k, w in want.items():
        g = got[k]
        if isinstance(w, list):
            assert g == w, k
        else:
            assert type(g) is type(w), (k, type(g), type(w))
            assert g.dtype == w.dtype, (k, g.dtype, w.dtype)
            np.testing.assert_array_equal(g, w, err_msg=k)


def _flip_and_crops(seed, epoch, idx, hw, ratio_range=(0.1, 2.0), s=SIZE):
    """(hflip fired, cropped along x, cropped along y) of a train item,
    from the dataset's own generator calls."""
    rng = np.random.default_rng((seed, epoch, idx))
    scale = rng.uniform(*ratio_range) * min(s / hw[1], s / hw[0])
    nw, nh = max(int(round(hw[1] * scale)), 1), max(int(round(hw[0] * scale)), 1)
    rng.integers(0, nw - min(nw, s) + 1)
    rng.integers(0, nh - min(nh, s) + 1)
    return rng.uniform() < 0.5, nw > s, nh > s


@pytest.mark.parametrize("with_mask", [False, True])
def test_train_items_equal(corpus, with_mask):
    ann, root = corpus
    kw = dict(image_size=SIZE, max_gt=MAX_GT, train=True, seed=3, with_mask=with_mask)
    ours, ref = data.DetectionDataset(ann, root, NAMES, **kw), jdata.DetectionDataset(ann, root, NAMES, **kw)
    assert len(ours) == len(ref) == 4 and ours.image_ids == ref.image_ids == [10, 11, 12, 13]
    seen = set()
    for epoch in range(4):
        ours.set_epoch(epoch)
        ref.set_epoch(epoch)
        for idx in range(len(ours)):
            assert_items_equal(ours[idx], ref[idx])
            info = ours.coco.imgs[ours.image_ids[idx]]
            flip, cx, cy = _flip_and_crops(3, epoch, idx, (info["height"], info["width"]))
            seen |= {("flip", flip)} | ({"crop_x"} if cx else set()) | ({"crop_y"} if cy else set())
    assert seen >= {("flip", True), ("flip", False), "crop_x", "crop_y"}


@pytest.mark.parametrize("with_mask", [False, True])
def test_eval_items_equal(corpus, with_mask):
    ann, root = corpus
    kw = dict(image_size=SIZE, max_gt=MAX_GT, train=False, with_mask=with_mask)
    ours, ref = data.DetectionDataset(ann, root, NAMES, **kw), jdata.DetectionDataset(ann, root, NAMES, **kw)
    assert len(ours) == 5
    for idx in range(len(ours)):
        assert_items_equal(ours[idx], ref[idx])
    crowd = ours[0]
    assert crowd["_gt_ignore_full"].sum() == 1 and len(crowd["_gt_boxes_full"]) == 6
    if with_mask:
        assert crowd["gt_masks"].dtype == np.uint8 and crowd["gt_masks"].any()


def test_collate_equal(corpus):
    ann, root = corpus
    kw = dict(image_size=SIZE, max_gt=MAX_GT, train=False, with_mask=True)
    ours, ref = data.DetectionDataset(ann, root, NAMES, **kw), jdata.DetectionDataset(ann, root, NAMES, **kw)
    assert_items_equal(data.collate([ours[0], ours[2]]), jdata.collate([ref[0], ref[2]]))


def _polygon_ellipse(self, xy, fill=None, outline=None, width=1):
    """`ImageDraw.ellipse` replaced by the fill of the 32-vertex polygon the
    synthetic set's annotation carries, as the port's tool draws it."""
    x0, y0, x1, y1 = xy
    t = np.linspace(0, 2 * np.pi, 32, endpoint=False)
    px = (x0 + x1) / 2 + ((x1 - x0) / 2) * np.cos(t)
    py = (y0 + y1) / 2 + ((y1 - y0) / 2) * np.sin(t)
    self.polygon(list(zip(px, py)), fill=fill)


@pytest.fixture(scope="module")
def synth_sets(tmp_path_factory):
    """Both tools' sets at 96 px, COCO (rectangles) and LVIS (ellipses; the
    JAX tool's ellipses drawn as the port draws them)."""
    root = tmp_path_factory.mktemp("synth")
    names = [f"c{i}" for i in range(10)]
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ImageDraw.ImageDraw, "ellipse", _polygon_ellipse)
        for kind, lvis in (("coco", False), ("lvis", True)):
            kw = dict(n_images=3, size=96, boxes_per_image=4, lvis_format=lvis, ellipses=lvis, seed=5)
            out[kind] = (
                synth.write_synth_det(str(root / f"port_{kind}"), names, [1, 4, 7], **kw),
                jsynth.write_synth_det(str(root / f"jax_{kind}"), names, [1, 4, 7], **kw),
            )
    return names, out


@pytest.mark.parametrize("kind", ["coco", "lvis"])
def test_synth_tool_json_and_pixels(synth_sets, kind):
    _, sets = synth_sets
    (ann, imgs), (jann, jimgs) = sets[kind]
    with open(ann) as f, open(jann) as g:
        blob = f.read()
        assert blob == g.read()
    for info in json.loads(blob)["images"]:
        got = decode_image(os.path.join(imgs, info["file_name"]))
        want = np.asarray(Image.open(os.path.join(jimgs, info["file_name"])).convert("RGB"))
        np.testing.assert_array_equal(got, want)


def test_synth_tool_main_equal(tmp_path, capsys):
    for dataset in ("coco", "lvis"):
        argv = ["--dataset", dataset, "--n-images", "1", "--size", "64", "--n-gt-classes", "4"]
        ours = synth.main(argv + ["--root", str(tmp_path / f"p{dataset}")])
        theirs = jsynth.main(argv + ["--root", str(tmp_path / f"j{dataset}")])
        out = capsys.readouterr().out.strip().splitlines()
        assert json.loads(out[0])["gt_classes"] == json.loads(out[1])["gt_classes"]
        assert open(ours[0]).read() == open(theirs[0]).read()


def test_jax_dataset_reads_port_tool_files(synth_sets):
    names, sets = synth_sets
    (ann, imgs), _ = sets["lvis"]
    for train in (True, False):
        kw = dict(image_size=96, max_gt=MAX_GT, train=train, seed=1, with_mask=True)
        ours, ref = data.DetectionDataset(ann, imgs, names, **kw), jdata.DetectionDataset(ann, imgs, names, **kw)
        for epoch in (0, 1):
            ours.set_epoch(epoch)
            ref.set_epoch(epoch)
            for idx in range(len(ours)):
                assert_items_equal(ours[idx], ref[idx])
