"""COCO mAP of the port against the JAX package on the CPU, bit for bit.

Three layers, each on the same numpy corpus:

- the port's copy of the numpy protocol (``tpumetrics_torch.detection._coco_eval``)
  against the JAX package's (``coco_evaluate`` and the per-cell reference
  ``coco_evaluate_unfused``), every output equal;
- the port's matcher (``ops.coco_match.coco_greedy_match_plain``, what the
  kernel is held to on the card) against the JAX package's
  ``_match_cells_batched`` on the same cells, and the port's device path
  (``_coco_eval_device.coco_evaluate_rows``: cells, plain matcher, float64
  accumulation, on the CPU) against ``coco_evaluate_unfused``'s float64
  precision and recall arrays;
- ``MeanAveragePrecision`` against the JAX metric, every output entry equal
  in shape, dtype and bits: list and packed layouts, macro and micro,
  ``class_metrics``, ``extended_summary``, ``segm`` on RLE masks, every
  ``box_format``, and ``coco_to_tm`` / ``tm_to_coco`` through files.

The corpus holds score ties, -0.0 and 0.0 and NaN scores, crowds with user
and zero areas, ground-truth and detection areas on the area ranges' edges,
IoUs exactly on 0.5 and 0.75, empty images, a cell with more than 64 ground
truths, a class with no detections and one with no ground truths. The JAX
side runs with ``TPUMETRICS_JIT_MATCHER=0``: this jax has no
``jax.experimental.enable_x64``, which the JAX package's jitted matcher
needs, and its numpy path is bit-identical to the jitted one by that
package's own contract.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpumetrics.detection as jdet
from tpumetrics.detection import _coco_eval as jeval
from tpumetrics_torch.detection import MeanAveragePrecision
from tpumetrics_torch.detection import _coco_eval as peval
from tpumetrics_torch.detection import _coco_eval_device as deval
from tpumetrics_torch.detection.mean_ap import _torch_f32_linspace
from tpumetrics_torch.ops import coco_match as cm

IOU_THRS = _torch_f32_linspace(0.5, 0.95, 10)
REC_THRS = _torch_f32_linspace(0.0, 1.0, 101)
MAX_DETS = [1, 10, 100]


@pytest.fixture(autouse=True)
def _numpy_matcher(monkeypatch):
    monkeypatch.setenv("TPUMETRICS_JIT_MATCHER", "0")


def _image(rng, nd, ng, n_cls=4, exact=False, crowd_share=0.2):
    """One image: integer boxes (so that IoUs tie and hit 0.5 and 0.75 exactly) when ``exact``."""
    if exact:
        xy = rng.integers(0, 60, (ng, 2)).astype(np.float64)
        wh = 4.0 * rng.integers(1, 10, (ng, 2))
    else:
        xy, wh = rng.uniform(0, 60, (ng, 2)), rng.uniform(2, 40, (ng, 2))
    gt = np.concatenate([xy, xy + wh], 1)
    src = rng.integers(0, max(ng, 1), nd)
    if ng:
        det = gt[src] + (rng.integers(-3, 4, (nd, 4)) if exact else rng.normal(0, 2, (nd, 4)))
        if exact:  # the top half or three quarters of a ground truth: IoU 0.5 or 0.75
            cut = gt[src].copy()
            cut[:, 3] = cut[:, 1] + np.where(rng.random(nd) < 0.5, 0.5, 0.75) * (cut[:, 3] - cut[:, 1])
            det = np.where((rng.random(nd) < 0.5)[:, None], cut, det)
    else:
        det = np.concatenate([rng.uniform(0, 60, (nd, 2)), rng.uniform(62, 100, (nd, 2))], 1)
    scores = rng.random(nd).astype(np.float32)
    tie = rng.random(nd) < 0.3
    scores[tie] = np.round(scores[tie] * 4) / 4
    labels = rng.integers(0, n_cls, ng)
    d_labels = np.where(rng.random(nd) < 0.8, labels[src] if ng else 0, rng.integers(0, n_cls, nd))
    area = np.where(rng.random(ng) < 0.5, np.prod(wh, 1) * rng.uniform(0.5, 0.9, ng), 0.0)
    preds = {"boxes": det.astype(np.float32), "scores": scores, "labels": d_labels.astype(np.int64)}
    target = {"boxes": gt.astype(np.float32), "labels": labels.astype(np.int64),
              "iscrowd": (rng.random(ng) < crowd_share).astype(np.int64), "area": area.astype(np.float32)}
    return preds, target


def _corpus():
    rng = np.random.default_rng(17)
    pairs = [_image(rng, int(rng.integers(1, 15)), int(rng.integers(1, 8)), exact=bool(i % 2)) for i in range(10)]
    pairs.insert(3, _image(rng, 0, 0))  # an empty image
    pairs.insert(5, _image(rng, 4, 0))  # detections only
    pairs.insert(6, _image(rng, 0, 3))  # ground truths only
    crowded = _image(rng, 40, 70, n_cls=1, exact=True, crowd_share=0.1)  # a cell of 70 ground truths (Gp > 64)
    pairs.append(crowded)
    preds, target = [p for p, _ in pairs], [t for _, t in pairs]
    # scores: -0.0 and 0.0 tie, a NaN sorts last
    preds[0]["scores"][:3] = np.asarray([-0.0, 0.0, np.nan], np.float32)
    preds[2]["scores"][:2] = np.asarray([0.0, -0.0], np.float32)
    # areas on the ranges' edges: ground truths of area exactly 32^2 and 96^2, a detection box of 32 x 32
    target[1]["area"][:2] = [32.0**2, 96.0**2]
    preds[1]["boxes"][0] = [10.0, 10.0, 42.0, 42.0]
    # a class with no detections (9) and one with no ground truths (8)
    target[4]["labels"][0] = 9
    preds[4]["labels"][0] = 8
    return preds, target


PREDS, TARGET = _corpus()


def _host_inputs(preds, target, box_format="xyxy"):
    """The numpy protocol's per-image tuples, boxes converted as the metric converts them."""
    m = MeanAveragePrecision(box_format=box_format, device="cpu")
    conv = lambda b: m._convert_boxes(torch.from_numpy(b)).numpy()  # noqa: E731
    dets = [(conv(p["boxes"]), p["scores"], p["labels"]) for p in preds]
    gts = [(conv(t["boxes"]), t["labels"], t["iscrowd"], t["area"]) for t in target]
    return dets, gts


DETS, GTS = _host_inputs(PREDS, TARGET)
CLASSES = sorted(np.unique(np.concatenate([d[2] for d in DETS] + [g[1] for g in GTS])).tolist())


def _same(got, want, path=""):
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), path
        for k in want:
            _same(got[k], want[k], f"{path}/{k}")
        return
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype, (path, got.shape, want.shape, got.dtype, want.dtype)
    assert np.array_equal(got, want, equal_nan=True), path


# --------------------------------------------------- the numpy protocol copy


@pytest.mark.parametrize("average", ["macro", "micro"])
@pytest.mark.parametrize("fn", ["coco_evaluate", "coco_evaluate_unfused"])
def test_the_numpy_protocol_copy_is_the_jax_one(fn, average):
    want = getattr(jeval, fn)(DETS, GTS, IOU_THRS, REC_THRS, MAX_DETS, CLASSES, average=average, extended=True)
    got = getattr(peval, fn)(DETS, GTS, IOU_THRS, REC_THRS, MAX_DETS, CLASSES, average=average, extended=True)
    _same({k: v for k, v in got.items() if k != "ious"}, {k: v for k, v in want.items() if k != "ious"})
    assert got["ious"].keys() == want["ious"].keys()
    for key in want["ious"]:
        _same(got["ious"][key], want["ious"][key], str(key))


def test_the_batched_protocol_splits_buckets_like_the_jax_one(monkeypatch):
    monkeypatch.setattr(jeval, "_MATCH_BUDGET", 64)
    monkeypatch.setattr(peval, "_MATCH_BUDGET", 64)
    want = jeval.coco_evaluate(DETS, GTS, IOU_THRS, REC_THRS, MAX_DETS, CLASSES, extended=True)
    got = peval.coco_evaluate(DETS, GTS, IOU_THRS, REC_THRS, MAX_DETS, CLASSES, extended=True)
    _same(got["precision"], want["precision"])
    _same(got["recall"], want["recall"])


# ------------------------------------------------------------ the matcher


def _cells_for(case_seed, n, dp, gp, thrs=IOU_THRS):
    """``n`` cells (at most ``dp`` detections and ``gp`` ground truths each) from the corpus generator's kind of
    images, as the matcher's flat cell-sorted inputs (one garbage ground-truth row between cells, the cell rows in
    a shuffled order) and as the numpy matcher's cells (ious, det areas, scores, crowds, effective areas)."""
    rng = np.random.default_rng(case_seed)
    dcount, gcount = rng.integers(0, dp + 1, n), rng.integers(0, gp + 1, n)
    dcount[0], gcount[0] = dp, gp
    det, gt, crowd, area, rows, cells = [], [], [], [], [], []
    n_det = n_gt = 0
    for i in range(n):
        p, t = _image(rng, int(dcount[i]), int(gcount[i]), n_cls=1, exact=bool(i % 2), crowd_share=0.3)
        d, g = _host_inputs([p], [t])
        ga = (g[0][0][:, 2] - g[0][0][:, 0]) * (g[0][0][:, 3] - g[0][0][:, 1])
        eff = np.where(t["area"] > 0, t["area"], ga)
        det.append(d[0][0])
        gt += [g[0][0], rng.uniform(-1e3, 1e3, (1, 4))]
        crowd += [t["iscrowd"].astype(np.uint8), np.ones(1, np.uint8)]
        area += [eff, np.ones(1)]
        rows.append((n_det, dcount[i], n_gt, gcount[i]))
        n_det, n_gt = n_det + dcount[i], n_gt + gcount[i] + 1
        inter, da, gag = peval._pairwise_geometry(d[0][0], g[0][0], "bbox")
        union = np.where(t["iscrowd"][None, :].astype(bool), da[:, None], da[:, None] + gag[None, :] - inter)
        ious = inter / np.where(union > 0, union, 1.0)
        cells.append((ious, da, p["scores"], t["iscrowd"], eff))
    thr = np.minimum(np.asarray(thrs), 1 - 1e-10)
    ranges = np.asarray(list(peval._AREA_RANGES.values()))
    args = [torch.tensor(np.concatenate(det).reshape(-1, 4)), torch.tensor(np.concatenate(gt)),
            torch.tensor(np.concatenate(crowd)), torch.tensor(np.concatenate(area)),
            torch.tensor(np.asarray(rows)[rng.permutation(n)], dtype=torch.int32), torch.tensor(thr),
            torch.tensor(ranges)]
    return args, cells, rows


@pytest.mark.parametrize(
    "n,dp,gp,thrs",
    # the kernel's limits: no ground truth (its store pass), 32 and 33 (a lane's two slots), 64 (its warp path's
    # last); one threshold (4 pairs, a lane's one) and 20 (80 pairs, past the warp path)
    [pytest.param(n, dp, gp, thrs, id=f"{n}-{dp}-{gp}" + ("" if thrs is IOU_THRS else f"-T{len(thrs)}"))
     for n, dp, gp, thrs in [(5, 1, 1, IOU_THRS), (9, 8, 4, IOU_THRS), (6, 16, 65, IOU_THRS), (4, 32, 128, IOU_THRS),
                             (12, 40, 0, IOU_THRS), (5, 24, 32, IOU_THRS), (5, 24, 33, IOU_THRS), (4, 36, 64, IOU_THRS),
                             (8, 12, 8, [0.5]), (5, 16, 20, list(np.linspace(0.5, 0.95, 20)))]],
)
def test_the_plain_matcher_is_the_jax_packages_batched_one(n, dp, gp, thrs):
    args, cells, rows = _cells_for(n * dp + gp, n, dp, gp, thrs)
    m, ig = cm.coco_greedy_match(*args)  # the plain version: the tensors lie on the CPU
    want_m, want_ig, _, valid, _ = jeval._match_cells_batched(
        cells, np.asarray(thrs), list(peval._AREA_RANGES.values()), MAX_DETS[-1], dp, gp
    )
    assert m.dtype == ig.dtype == torch.uint8 and tuple(m.shape) == (args[0].shape[0], *want_m.shape[1:3])
    for i, (start, count, _, _) in enumerate(rows):  # a detection's row is its (A, T) slice of its cell
        assert valid[i, :count].all()
        assert np.array_equal(m[start : start + count].numpy().astype(bool), want_m[i, ..., :count].transpose(2, 0, 1))
        assert np.array_equal(ig[start : start + count].numpy().astype(bool), want_ig[i, ..., :count].transpose(2, 0, 1))
    assert cm.launches == 0  # no kernel on the CPU


def test_the_kernels_host_check_reads_the_largest_cell_only_past_its_limit():
    cells = torch.tensor([[0, 3, 0, 5], [3, 1, 5, 70]], dtype=torch.int32)

    class Unread(torch.Tensor):  # a cell table whose counts must not be read
        def __getitem__(self, index):
            raise AssertionError("read")

    cm.check_largest_cell(cells.as_subclass(Unread), 75, 75)  # no cell can hold more than the call's 75 rows
    cm.check_largest_cell(cells, 200, 70)  # read: 70 fits
    with pytest.raises(ValueError, match="at most 69 ground truths, got 70"):
        cm.check_largest_cell(cells, 200, 69)


def _rows(dets, gts):
    nd, ng = [d[1].shape[0] for d in dets], [g[1].shape[0] for g in gts]
    cat = lambda xs, dt, shape=(-1,): torch.as_tensor(np.concatenate(xs).astype(dt).reshape(shape))  # noqa: E731
    det = (cat([d[0] for d in dets], np.float64, (-1, 4)), cat([d[1] for d in dets], np.float32),
           cat([d[2] for d in dets], np.int64), torch.as_tensor(np.repeat(np.arange(len(dets)), nd)))
    gt = (cat([g[0] for g in gts], np.float64, (-1, 4)), cat([g[1] for g in gts], np.int64),
          cat([g[2] for g in gts], np.int64), cat([g[3] for g in gts], np.float64),
          torch.as_tensor(np.repeat(np.arange(len(gts)), ng)))
    return det, gt


@pytest.mark.parametrize("average", ["macro", "micro"])
@pytest.mark.parametrize("max_dets", [MAX_DETS, [1, 3, 5]])
def test_the_device_path_is_the_per_cell_reference_bit_for_bit(average, max_dets):
    want = jeval.coco_evaluate_unfused(DETS, GTS, IOU_THRS, REC_THRS, max_dets, CLASSES, average=average, extended=True)
    det, gt = _rows(DETS, GTS)
    got = deval.coco_evaluate_rows(det, gt, len(DETS), IOU_THRS, REC_THRS, max_dets, CLASSES, average=average,
                                   arrays=True)
    for key in [k for k in want if k != "ious"]:
        _same(got[key], want[key], key)


def test_the_score_key_orders_as_numpy_does():
    scores = np.asarray([0.5, -0.0, np.nan, 0.0, np.inf, -np.inf, 0.5, -1.0, np.nan, 2.0], np.float32)
    order = torch.sort(deval.score_sort_key(torch.from_numpy(scores)), stable=True).indices.numpy()
    assert np.array_equal(order, np.argsort(-scores, kind="stable"))


def test_the_device_path_records_its_stages():
    det, gt = _rows(DETS, GTS)
    with deval.record_stages() as stages:
        deval.coco_evaluate_rows(det, gt, len(DETS), IOU_THRS, REC_THRS, MAX_DETS, CLASSES)
    assert set(stages) == {"cells", "kernel", "accumulation", "fetch_summary"}


# ---------------------------------------------------- MeanAveragePrecision


def _to_torch(items):
    return [{k: torch.as_tensor(v) for k, v in d.items()} for d in items]


def _to_jax(items):
    return [{k: jnp.asarray(v) for k, v in d.items()} for d in items]


def _convert(items, fmt):
    """xyxy corpus boxes in ``fmt``."""
    out = []
    for d in items:
        b = d["boxes"]
        if fmt == "xywh":
            b = np.concatenate([b[:, :2], b[:, 2:] - b[:, :2]], 1)
        elif fmt == "cxcywh":
            b = np.concatenate([(b[:, :2] + b[:, 2:]) / 2, b[:, 2:] - b[:, :2]], 1)
        out.append({**d, "boxes": b.astype(np.float32)})
    return out


def _compare(got, want):
    assert sorted(got) == sorted(want)
    for key, value in want.items():
        if key == "ious":
            assert got[key].keys() == value.keys()
            for k in value:
                _same(got[key][k], value[k], str(k))
            continue
        assert isinstance(got[key], torch.Tensor) and got[key].device.type == "cpu", key
        _same(got[key].numpy(), np.asarray(value), key)


def _both(kw, batches):
    port, ref = MeanAveragePrecision(device="cpu", **kw), jdet.MeanAveragePrecision(**kw)
    for preds, target in batches:
        port.update(_to_torch(preds), _to_torch(target))
        ref.update(_to_jax(preds), _to_jax(target))
    return port.compute(), ref.compute()


_KWARGS = [
    {}, {"average": "micro"}, {"class_metrics": True}, {"average": "micro", "class_metrics": True},
    {"extended_summary": True}, {"max_detection_thresholds": [1, 5, 50], "iou_thresholds": [0.5, 0.75]},
    {"rec_thresholds": [0.0, 0.25, 0.6, 1.0], "class_metrics": True},
]


@pytest.mark.parametrize("kw", _KWARGS)
def test_mean_average_precision_is_the_jax_one(kw):
    batches = [(PREDS[:6], TARGET[:6]), (PREDS[6:], TARGET[6:])]
    got, want = _both(kw, batches)
    _compare(got, want)


@pytest.mark.parametrize("fmt", ["xywh", "cxcywh"])
def test_every_box_format(fmt):
    got, want = _both({"box_format": fmt, "class_metrics": True},
                      [(_convert(PREDS, fmt), _convert(TARGET, fmt))])
    _compare(got, want)


def _box_masks(boxes, h=40, w=48):
    masks = np.zeros((len(boxes), h, w), bool)
    for i, (x1, y1, x2, y2) in enumerate(np.clip(np.round(boxes / 2), 0, [w, h, w, h]).astype(int)):
        masks[i, y1:y2, x1:x2] = True
    return masks


@pytest.mark.parametrize("iou_type", ["segm", ("bbox", "segm")])
def test_segm_on_rle_masks_is_the_jax_one(iou_type):
    preds = [{**p, "masks": _box_masks(p["boxes"])} for p in PREDS[:8]]
    target = [{**t, "masks": _box_masks(t["boxes"])} for t in TARGET[:8]]
    if iou_type == "segm":
        preds = [{k: v for k, v in p.items() if k != "boxes"} for p in preds]
        target = [{k: v for k, v in t.items() if k != "boxes"} for t in target]
    got, want = _both({"iou_type": iou_type, "class_metrics": True}, [(preds[:4], target[:4]), (preds[4:], target[4:])])
    _compare(got, want)


def test_coco_files_round_trip_like_the_jax_ones(tmp_path):
    port = MeanAveragePrecision(device="cpu")
    ref = jdet.MeanAveragePrecision()
    port.update(_to_torch(PREDS), _to_torch(TARGET))
    ref.update(_to_jax(PREDS), _to_jax(TARGET))
    port.tm_to_coco(str(tmp_path / "port"))
    ref.tm_to_coco(str(tmp_path / "jax"))
    for side in ("preds", "target"):
        assert json.loads((tmp_path / f"port_{side}.json").read_text()) == json.loads(
            (tmp_path / f"jax_{side}.json").read_text())
    got_p, got_t = MeanAveragePrecision.coco_to_tm(str(tmp_path / "port_preds.json"), str(tmp_path / "port_target.json"))
    want_p, want_t = jdet.MeanAveragePrecision.coco_to_tm(str(tmp_path / "jax_preds.json"),
                                                          str(tmp_path / "jax_target.json"))
    for g, w in zip(got_p + got_t, want_p + want_t):
        assert sorted(g) == sorted(w)
        for k in w:  # the JAX package's int64 ids come back int32 (x64 off): values and shapes compared
            assert g[k].shape == w[k].shape and np.array_equal(g[k].numpy(), np.asarray(w[k]), equal_nan=True), k
    m = MeanAveragePrecision(box_format="xywh", device="cpu")
    m.update(got_p, got_t)
    r = jdet.MeanAveragePrecision(box_format="xywh")
    r.update(want_p, want_t)
    _compare(m.compute(), r.compute())


def test_states_are_the_jax_ones():
    port, ref = MeanAveragePrecision(device="cpu"), jdet.MeanAveragePrecision()
    assert port._defaults.keys() == ref._defaults.keys()
    for name in ref._defaults:  # the same reduce function, by name, or none
        jr, pr = ref._reductions[name], port._reductions[name]
        assert (jr is None) == (pr is None), name
        if jr is not None:
            assert getattr(jr, "__name__", "") == getattr(pr, "__name__", ""), name
    assert port._buffer_specs["det_rows"] == (8192, (7,), torch.float32)
    assert port._buffer_specs["gt_rows"] == (8192, (8,), torch.float32)
    assert port.packed_imgs.dtype == torch.int32 and str(np.asarray(ref.packed_imgs).dtype) == "int32"
    segm = MeanAveragePrecision(iou_type="segm", device="cpu")
    assert segm._defaults.keys() == jdet.MeanAveragePrecision(iou_type="segm")._defaults.keys()


def test_arguments_are_refused_like_the_jax_ones():
    for kw in ({"box_format": "yxyx"}, {"iou_type": "keypoints"}, {"iou_thresholds": 0.5}, {"rec_thresholds": 0.5},
               {"max_detection_thresholds": 100}, {"class_metrics": 1}, {"extended_summary": 1}, {"average": "weighted"},
               {"backend": "detectron"}, {"det_capacity": 0}):
        with pytest.raises(ValueError):
            MeanAveragePrecision(device="cpu", **kw)
        with pytest.raises(ValueError):
            jdet.MeanAveragePrecision(**kw)


_NO_DET = {"boxes": np.zeros((0,), np.float32), "scores": np.zeros(0, np.float32), "labels": np.zeros(0, np.int64)}
_NO_GT = {"boxes": np.zeros((0, 4), np.float32), "labels": np.zeros(0, np.int64)}
_ONE_DET = {"boxes": np.asarray([[0, 0, 10, 10]], np.float32), "scores": np.asarray([0.3], np.float32),
            "labels": np.asarray([2])}
_ONE_GT = {"boxes": np.asarray([[0, 0, 10, 12]], np.float32), "labels": np.asarray([3])}


@pytest.mark.parametrize(
    "name,preds,target",
    [("no images", [], []), ("empty images", [_NO_DET, _NO_DET], [_NO_GT, _NO_GT]),
     ("ground truths only", [_NO_DET], [_ONE_GT]), ("detections only", [_ONE_DET], [_NO_GT]),
     ("classes apart", [_ONE_DET, _NO_DET], [_NO_GT, _ONE_GT])],
)
@pytest.mark.parametrize("kw", [{}, {"class_metrics": True, "average": "micro"}])
def test_degenerate_corpora_are_the_jax_ones(name, preds, target, kw):
    got, want = _both(kw, [(preds, target)] if preds else [])
    _compare(got, want)
