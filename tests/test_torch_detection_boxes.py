"""The port's box primitives, IoU family and panoptic quality, held against
the JAX package on the CPU.

The same inputs, made from a seed with numpy, go through the JAX function
and its port. Tolerances, float32 against float32:

- box ops, IoU, GIoU and DIoU (functional and modular means): within
  ``RTOL`` = 1e-6 relative (plus ``ATOL`` = 1e-6 absolute): the same
  elementwise arithmetic, means summed in another order;
- CIoU: ``CIOU_RTOL`` = 1e-5, its ``atan`` is libm's in one and XLA's in the
  other;
- panoptic quality: the per-category counts (TP, FP, FN) exactly, the
  float32 ``iou_sum`` within one float32 ulp (both sum float64 IoUs, in
  another order, and round once), the values within ``RTOL``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpumetrics.detection as jdet
import tpumetrics.functional.detection as jfn
import tpumetrics.functional.detection._box_ops as jbox
import tpumetrics_torch.detection as det
import tpumetrics_torch.functional.detection as fn
import tpumetrics_torch.functional.detection._box_ops as box
from tpumetrics_torch.interop import export_state

RTOL, ATOL = 1e-6, 1e-6
CIOU_RTOL = 1e-5
FORMATS = ("xyxy", "xywh", "cxcywh")


def _boxes(rng, n, fmt="xyxy"):
    xy = rng.uniform(0, 60, (n, 2))
    wh = rng.uniform(1, 40, (n, 2))
    if fmt == "xyxy":
        b = np.concatenate([xy, xy + wh], 1)
    elif fmt == "xywh":
        b = np.concatenate([xy, wh], 1)
    else:
        b = np.concatenate([xy + wh / 2, wh], 1)
    return b.astype(np.float32)


def _close(got, want, rtol=RTOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype, (got.shape, want.shape, got.dtype, want.dtype)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=ATOL)


# ------------------------------------------------------------------ box ops


@pytest.mark.parametrize("in_fmt", FORMATS)
@pytest.mark.parametrize("out_fmt", FORMATS)
def test_box_convert(in_fmt, out_fmt):
    b = _boxes(np.random.default_rng(0), 17, in_fmt)
    _close(box.box_convert(torch.from_numpy(b), in_fmt, out_fmt), jbox.box_convert(jnp.asarray(b), in_fmt, out_fmt))


def test_box_convert_refuses_an_unknown_format():
    with pytest.raises(ValueError, match="Unsupported box format"):
        box.box_convert(torch.zeros((1, 4)), "xyxy", "yxyx")


@pytest.mark.parametrize(
    "name,rtol",
    [("box_iou", RTOL), ("generalized_box_iou", RTOL), ("distance_box_iou", RTOL), ("complete_box_iou", CIOU_RTOL)],
)
def test_pairwise_box_ops(name, rtol):
    rng = np.random.default_rng(1)
    a, b = _boxes(rng, 13), _boxes(rng, 9)
    b[3] = a[2]  # an exact overlap
    b[4] = [200, 200, 201, 201]  # disjoint
    _close(getattr(box, name)(torch.from_numpy(a), torch.from_numpy(b)), getattr(jbox, name)(jnp.asarray(a), jnp.asarray(b)),
           rtol)
    _close(box.box_area(torch.from_numpy(a)), jbox.box_area(jnp.asarray(a)))


# ----------------------------------------------------------- IoU functions

_FUNCTIONS = [
    ("intersection_over_union", RTOL), ("generalized_intersection_over_union", RTOL),
    ("distance_intersection_over_union", RTOL), ("complete_intersection_over_union", CIOU_RTOL),
]


@pytest.mark.parametrize("name,rtol", _FUNCTIONS)
@pytest.mark.parametrize("kw", [{}, {"iou_threshold": 0.3, "replacement_val": -0.5}, {"aggregate": False}])
def test_iou_functions(name, rtol, kw):
    rng = np.random.default_rng(2)
    a = _boxes(rng, 8)
    b = (a + rng.normal(0, 3, a.shape)).astype(np.float32)
    _close(getattr(fn, name)(torch.from_numpy(a), torch.from_numpy(b), **kw),
           getattr(jfn, name)(jnp.asarray(a), jnp.asarray(b), **kw), rtol)


def test_iou_function_of_empty_inputs_is_zero():
    assert float(fn.intersection_over_union(torch.zeros((0, 4)), torch.zeros((0, 4)))) == 0.0


# --------------------------------------------------------- IoU metric classes

_CLASSES = [
    ("IntersectionOverUnion", "iou", RTOL), ("GeneralizedIntersectionOverUnion", "giou", RTOL),
    ("DistanceIntersectionOverUnion", "diou", RTOL), ("CompleteIntersectionOverUnion", "ciou", CIOU_RTOL),
]


def _iou_batches(fmt, seed=3):
    """Two batches of three images, one with no detections, labels in 3 classes. The images' sizes repeat
    from batch to batch, so the JAX side's eager ops compile once per size."""
    rng = np.random.default_rng(seed)
    batches = []
    for _ in range(2):
        preds, target = [], []
        for i in range(3):
            ng, nd = (3, 5, 2)[i], (4, 0, 6)[i]
            g = _boxes(rng, ng, fmt)
            d = (g[rng.integers(0, ng, nd)] + rng.normal(0, 2, (nd, 4))).astype(np.float32)
            d[:, 2:] = np.abs(d[:, 2:]) if fmt != "xyxy" else d[:, 2:]
            preds.append({"boxes": d, "labels": rng.integers(0, 3, nd)})
            target.append({"boxes": g, "labels": rng.integers(0, 3, ng)})
        batches.append((preds, target))
    return batches


@pytest.mark.parametrize("cls,key,rtol", _CLASSES)
@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("kw", [{}, {"respect_labels": False, "class_metrics": True}, {"class_metrics": True, "iou_threshold": 0.2}])
def test_iou_metric_classes(cls, key, rtol, fmt, kw):
    port = getattr(det, cls)(box_format=fmt, device="cpu", **kw)
    ref = getattr(jdet, cls)(box_format=fmt, **kw)
    for preds, target in _iou_batches(fmt):
        port.update([{k: torch.as_tensor(v) for k, v in p.items()} for p in preds],
                    [{k: torch.as_tensor(v) for k, v in t.items()} for t in target])
        ref.update([{k: jnp.asarray(v) for k, v in p.items()} for p in preds],
                   [{k: jnp.asarray(v) for k, v in t.items()} for t in target])
    got, want = port.compute(), ref.compute()
    assert sorted(got) == sorted(want) and key in got
    for k in want:
        _close(got[k], want[k], rtol)


def test_iou_metric_states_are_the_jax_ones():
    port, ref = det.IntersectionOverUnion(device="cpu"), jdet.IntersectionOverUnion()
    assert port._defaults.keys() == ref._defaults.keys() == {"groundtruth_labels", "iou_matrix"}
    assert all(port._reductions[k] is None and ref._reductions[k] is None for k in port._defaults)
    preds, target = _iou_batches("xyxy")[0]
    port.update([{k: torch.as_tensor(v) for k, v in p.items()} for p in preds],
                [{k: torch.as_tensor(v) for k, v in t.items()} for t in target])
    assert all(t.dtype == torch.int32 for t in port.groundtruth_labels)
    assert [tuple(m.shape) for m in port.iou_matrix] == [(len(p["labels"]), len(t["labels"])) for p, t in zip(preds, target)]


def test_iou_metric_refuses_bad_arguments():
    with pytest.raises(ValueError, match="box_format"):
        det.IntersectionOverUnion(box_format="yxyx", device="cpu")
    with pytest.raises(ValueError, match="class_metrics"):
        det.IntersectionOverUnion(class_metrics=1, device="cpu")
    with pytest.raises(ValueError, match="respect_labels"):
        det.IntersectionOverUnion(respect_labels="yes", device="cpu")
    m = det.IntersectionOverUnion(device="cpu")
    with pytest.raises(ValueError, match="same length"):
        m.update([{"boxes": torch.zeros((1, 4)), "labels": torch.zeros(1)}], [])


# ---------------------------------------------------------- panoptic quality

THINGS, STUFFS = {0, 1, 3}, {6, 7}


def _panoptic(seed, b=3, h=24, w=20, unknown=False):
    """(preds, target) ``(B, H, W, 2)`` maps: stuff halves under thing rectangles, the prediction shifted and
    partly relabelled, some target pixels void (category 255)."""
    rng = np.random.default_rng(seed)
    target = np.zeros((b, h, w, 2), np.int64)
    preds = np.zeros((b, h, w, 2), np.int64)
    for i in range(b):
        target[i, : h // 2, :, 0], target[i, h // 2 :, :, 0] = 6, 7
        preds[i, ..., 0] = np.where(np.arange(h)[:, None] < h // 2 + int(rng.integers(-2, 3)), 6, 7)
        for inst in range(1, int(rng.integers(2, 6))):
            cat = int(rng.choice(sorted(THINGS)))
            bh, bw = int(rng.integers(3, 10)), int(rng.integers(3, 10))
            y, x = int(rng.integers(0, h - bh)), int(rng.integers(0, w - bw))
            target[i, y : y + bh, x : x + bw] = (cat, inst)
            dy, dx = int(rng.integers(-1, 2)), int(rng.integers(-1, 2))
            py, px = int(np.clip(y + dy, 0, h - bh)), int(np.clip(x + dx, 0, w - bw))
            preds[i, py : py + bh, px : px + bw] = (cat if rng.random() > 0.2 else int(rng.choice(sorted(THINGS))), inst)
        target[i][rng.random((h, w)) < 0.05] = (255, 0)
        if unknown:
            preds[i, 0, 0] = (42, 0)
    return preds, target


@pytest.mark.parametrize("name", ["panoptic_quality", "modified_panoptic_quality"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_panoptic_functions(name, seed):
    p, t = _panoptic(seed)
    got = getattr(fn, name)(torch.from_numpy(p), torch.from_numpy(t), THINGS, STUFFS)
    want = getattr(jfn, name)(jnp.asarray(p), jnp.asarray(t), THINGS, STUFFS)
    _close(got, want)


def test_panoptic_unknown_prediction_categories():
    p, t = _panoptic(4, unknown=True)
    with pytest.raises(ValueError, match="Unknown categories"):
        fn.panoptic_quality(torch.from_numpy(p), torch.from_numpy(t), THINGS, STUFFS)
    got = fn.panoptic_quality(torch.from_numpy(p), torch.from_numpy(t), THINGS, STUFFS, allow_unknown_preds_category=True)
    want = jfn.panoptic_quality(jnp.asarray(p), jnp.asarray(t), THINGS, STUFFS, allow_unknown_preds_category=True)
    _close(got, want)


def _ulps(a: np.ndarray, b: np.ndarray) -> int:
    return int(np.abs(a.view(np.int32).astype(np.int64) - b.view(np.int32).astype(np.int64)).max(initial=0))


@pytest.mark.parametrize("cls", ["PanopticQuality", "ModifiedPanopticQuality"])
def test_panoptic_metric_states_and_value(cls):
    port = getattr(det, cls)(THINGS, STUFFS, device="cpu")
    ref = getattr(jdet, cls)(THINGS, STUFFS)
    for seed in range(3):
        p, t = _panoptic(10 + seed, b=2)
        port.update(torch.from_numpy(p), torch.from_numpy(t))
        ref.update(jnp.asarray(p), jnp.asarray(t))
    got, want = export_state(port), {k: np.asarray(getattr(ref, k)) for k in ref._defaults}
    assert sorted(got) == sorted(want) == ["false_negatives", "false_positives", "iou_sum", "true_positives"]
    for key in ("true_positives", "false_positives", "false_negatives"):
        assert got[key].dtype == want[key].dtype == np.float32 and np.array_equal(got[key], want[key]), key
    assert got["iou_sum"].dtype == np.float32 and _ulps(got["iou_sum"], want["iou_sum"]) <= 1
    assert all(port._reductions[k] is not None for k in got)
    _close(port.compute(), ref.compute())


def test_panoptic_refuses_bad_categories_and_shapes():
    with pytest.raises(ValueError, match="distinct"):
        det.PanopticQuality({1}, {1}, device="cpu")
    with pytest.raises(TypeError, match="`int`"):
        det.PanopticQuality({1.5}, {2}, device="cpu")
    with pytest.raises(ValueError, match="same shape"):
        fn.panoptic_quality(torch.zeros((1, 4, 4, 2), dtype=torch.long), torch.zeros((1, 4, 3, 2), dtype=torch.long),
                            THINGS, STUFFS)
    with pytest.raises(ValueError, match="2 channels"):
        fn.panoptic_quality(torch.zeros((1, 4, 4, 3), dtype=torch.long), torch.zeros((1, 4, 4, 3), dtype=torch.long),
                            THINGS, STUFFS)
