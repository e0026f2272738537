"""The exact curve path (``thresholds=None``) of the port held against the
JAX package, binary, multiclass and multilabel.

The exact path keeps the raw preds and targets (list states in the modular
classes) and builds each curve at every distinct pred. Preds here sit on a
grid of eighths, so many tie; NaN preds, where a case
has them, send every pred of that call through the sigmoid (or softmax)
on both sides, whose last bits differ between the frameworks. List states
and integer values must be equal; float values agree within ``ATOL`` =
1e-6 (float32 sums in another order, and those last bits).
"""

import importlib
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpumetrics
import tpumetrics.classification as jax_cls
import tpumetrics.functional as jax_fn
import tpumetrics_torch
import tpumetrics_torch.classification as cls
import tpumetrics_torch.functional as fn
from tests.test_torch_classification import _assert_same, _both
from tpumetrics_torch.functional.classification import precision_recall_curve as prc

jax_prc = importlib.import_module("tpumetrics.functional.classification.precision_recall_curve")

N = 64
C = 4
IGNORE = -1


def _ignore(rng, target, ignore_index, rows):
    """Set ``ignore_index`` at 16 of ``rows`` in every column of ``target``
    (the same count everywhere, so the exact path's shapes repeat and JAX
    compiles each of its ops once)."""
    if ignore_index is not None:
        cols = target.reshape(N, -1)
        for j in range(cols.shape[1]):
            cols[rng.choice(rows, 16, replace=False), j] = ignore_index


def _binary(seed, shape=(N,), ignore_index=None, nan=False):
    """Preds on a grid of eighths (every value present), NaN in rows 3, 14, ...
    when asked, 0/1 targets, 16 ignored entries per column away from the NaN rows."""
    rng = np.random.default_rng(seed)
    preds = (rng.integers(0, 9, shape) / 8).astype(np.float32)
    preds[:9] = (np.arange(9) / 8).astype(np.float32).reshape((9,) + (1,) * (len(shape) - 1))
    nan_rows = np.arange(3, N, 11)
    if nan:
        preds[nan_rows] = np.nan
    target = rng.integers(0, 2, shape)
    _ignore(rng, target, ignore_index, np.setdiff1d(np.arange(9, N), nan_rows))
    return preds, target


def _multiclass(seed, ignore_index=None):
    """Scores on a grid of eighths in [0, 1] (not normalised, so no softmax) and labels."""
    rng = np.random.default_rng(seed)
    preds = (rng.integers(0, 9, (N, C)) / 8).astype(np.float32)
    preds[:9] = (np.arange(9) / 8).astype(np.float32)[:, None]
    target = rng.integers(0, C, N)
    target[:C] = np.arange(C)
    _ignore(rng, target, ignore_index, np.arange(9, N))
    return preds, target


def test_binary_clf_curve_matches_jax_with_ties_and_nan():
    preds, target = _binary(0, nan=True)
    (tp, tt), (jp, jt) = _both(preds, target)
    fps, tps, thr = prc._binary_clf_curve(tp, tt)
    ref = jax_prc._binary_clf_curve(jp, jt)
    assert fps.dtype == tps.dtype == torch.int32
    np.testing.assert_array_equal(fps.numpy(), np.asarray(ref[0]))
    np.testing.assert_array_equal(tps.numpy(), np.asarray(ref[1]))
    np.testing.assert_array_equal(thr.numpy(), np.asarray(ref[2]))
    weights = np.random.default_rng(1).random(N).astype(np.float32)
    port_w = prc._binary_clf_curve(tp, tt, sample_weights=torch.from_numpy(weights))
    _assert_same(port_w, jax_prc._binary_clf_curve(jp, jt, sample_weights=jnp.asarray(weights)), atol=1e-5)


BINARY = [
    ("binary_precision_recall_curve", {}),
    ("binary_roc", {}),
    ("binary_auroc", {}),
    ("binary_auroc", {"max_fpr": 0.25}),
]


@pytest.mark.parametrize("nan", [False, True], ids=["ties", "ties-nan"])
@pytest.mark.parametrize("ignore_index", [None, IGNORE], ids=["no-ignore", "ignore"])
@pytest.mark.parametrize("name, kwargs", BINARY, ids=[f"{n}-{i}" for i, (n, _) in enumerate(BINARY)])
def test_binary_exact_matches_jax(name, kwargs, ignore_index, nan):
    (tp, tt), (jp, jt) = _both(*_binary(2, ignore_index=ignore_index, nan=nan))
    port = getattr(fn, name)(tp, tt, ignore_index=ignore_index, **kwargs)
    _assert_same(port, getattr(jax_fn, name)(jp, jt, ignore_index=ignore_index, **kwargs))


MULTICLASS = [
    ("multiclass_precision_recall_curve", {}),
    ("multiclass_precision_recall_curve", {"average": "micro"}),
    ("multiclass_precision_recall_curve", {"average": "macro"}),
    ("multiclass_roc", {}),
    ("multiclass_roc", {"average": "micro"}),
    ("multiclass_roc", {"average": "macro"}),
    ("multiclass_auroc", {"average": "macro"}),
    ("multiclass_auroc", {"average": "weighted"}),
    ("multiclass_auroc", {"average": None}),
]


@pytest.mark.parametrize("ignore_index", [None, IGNORE], ids=["no-ignore", "ignore"])
@pytest.mark.parametrize("name, kwargs", MULTICLASS, ids=[f"{n}-{i}" for i, (n, _) in enumerate(MULTICLASS)])
def test_multiclass_exact_matches_jax(name, kwargs, ignore_index):
    (tp, tt), (jp, jt) = _both(*_multiclass(3, ignore_index))
    port = getattr(fn, name)(tp, tt, num_classes=C, ignore_index=ignore_index, **kwargs)
    _assert_same(port, getattr(jax_fn, name)(jp, jt, num_classes=C, ignore_index=ignore_index, **kwargs))


MULTILABEL = [
    ("multilabel_precision_recall_curve", {}),
    ("multilabel_roc", {}),
    ("multilabel_auroc", {"average": "macro"}),
    ("multilabel_auroc", {"average": "micro"}),
    ("multilabel_auroc", {"average": "weighted"}),
    ("multilabel_auroc", {"average": None}),
]


@pytest.mark.parametrize("ignore_index", [None, IGNORE], ids=["no-ignore", "ignore"])
@pytest.mark.parametrize("name, kwargs", MULTILABEL, ids=[f"{n}-{i}" for i, (n, _) in enumerate(MULTILABEL)])
def test_multilabel_exact_matches_jax(name, kwargs, ignore_index):
    (tp, tt), (jp, jt) = _both(*_binary(4, (N, C), ignore_index, nan=True))
    port = getattr(fn, name)(tp, tt, num_labels=C, ignore_index=ignore_index, **kwargs)
    _assert_same(port, getattr(jax_fn, name)(jp, jt, num_labels=C, ignore_index=ignore_index, **kwargs))


def test_binary_roc_warns_like_jax_without_negatives_or_positives():
    preds = np.asarray([0.1, 0.5, 0.5, 0.9], np.float32)
    for target, message in [(np.ones(4, np.int64), "No negative samples"), (np.zeros(4, np.int64), "No positive")]:
        (tp, tt), (jp, jt) = _both(preds, target)
        with pytest.warns(UserWarning, match=message):
            port = fn.binary_roc(tp, tt)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            _assert_same(port, jax_fn.binary_roc(jp, jt))


# ------------------------------------------------------------------- modular

MODULAR = [
    ("BinaryPrecisionRecallCurve", {}),
    ("BinaryROC", {}),
    ("BinaryAUROC", {}),
    ("BinaryAUROC", {"max_fpr": 0.5}),
    ("MulticlassPrecisionRecallCurve", {"num_classes": C}),
    ("MulticlassPrecisionRecallCurve", {"num_classes": C, "average": "micro"}),
    ("MulticlassROC", {"num_classes": C, "average": "macro"}),
    ("MulticlassAUROC", {"num_classes": C}),
    ("MulticlassAUROC", {"num_classes": C, "average": "weighted"}),
    ("MultilabelPrecisionRecallCurve", {"num_labels": C}),
    ("MultilabelROC", {"num_labels": C}),
    ("MultilabelAUROC", {"num_labels": C}),
    ("MultilabelAUROC", {"num_labels": C, "average": "micro"}),
]


def _states(metric):
    return {k: getattr(metric, k) for k in metric._defaults}


def _stream(name, ignore_index, seeds):
    if name.startswith("Multiclass"):
        return [_multiclass(s, ignore_index) for s in seeds]
    return [_binary(s, (N, C) if name.startswith("Multilabel") else (N,), ignore_index) for s in seeds]


@pytest.mark.parametrize("ignore_index", [None, IGNORE], ids=["no-ignore", "ignore"])
@pytest.mark.parametrize("name, kwargs", MODULAR, ids=[f"{n}-{i}" for i, (n, _) in enumerate(MODULAR)])
def test_modular_exact_matches_jax_over_batches(name, kwargs, ignore_index):
    port = getattr(cls, name)(ignore_index=ignore_index, device="cpu", **kwargs)
    ref = getattr(jax_cls, name)(ignore_index=ignore_index, **kwargs)
    assert port.thresholds is None and sorted(port._defaults) == ["preds", "target"]
    batches = _stream(name, ignore_index, (10, 11, 12))
    (tp, tt), (jp, jt) = _both(*batches[0])
    _assert_same(port(tp, tt), ref(jp, jt))  # forward: the batch value
    for preds, target in batches[1:]:
        (tp, tt), (jp, jt) = _both(preds, target)
        port.update(tp, tt)
        ref.update(jp, jt)
    _assert_same(_states(port), _states(ref))  # float32 preds, int32 targets, 3 entries each
    _assert_same(port.compute(), ref.compute())


@pytest.mark.parametrize(
    "make_port, make_ref, kind",
    [
        (lambda: cls.BinaryAUROC(device="cpu"), lambda: jax_cls.BinaryAUROC(), "binary"),
        (lambda: tpumetrics_torch.AUROC(task="binary", device="cpu"), lambda: tpumetrics.AUROC(task="binary"), "binary"),
        (
            lambda: tpumetrics_torch.ROC(task="multilabel", num_labels=C, device="cpu"),
            lambda: tpumetrics.ROC(task="multilabel", num_labels=C),
            "multilabel",
        ),
        (lambda: cls.MulticlassAUROC(num_classes=C, device="cpu"), lambda: jax_cls.MulticlassAUROC(num_classes=C), "multiclass"),
    ],
    ids=["BinaryAUROC", "AUROC-binary", "ROC-multilabel", "MulticlassAUROC"],
)
def test_default_constructors_take_the_exact_path(make_port, make_ref, kind):
    """``thresholds=None`` is every curve metric's default: it constructs, updates and computes."""
    port, ref = make_port(), make_ref()
    for seed in (20, 21):
        data = _multiclass(seed) if kind == "multiclass" else _binary(seed, (N, C) if kind == "multilabel" else (N,))
        (tp, tt), (jp, jt) = _both(*data)
        port.update(tp, tt)
        ref.update(jp, jt)
    _assert_same(port.compute(), ref.compute())


def test_exact_and_binned_members_of_one_collection():
    """The exact AUROC keeps list states of its own; the binned one and the
    stat scores form their groups as before."""
    members = {
        "acc": lambda pkg, **d: pkg.Accuracy(task="binary", **d),
        "auroc_binned": lambda pkg, **d: pkg.AUROC(task="binary", thresholds=13, **d),
        "auroc_exact": lambda pkg, **d: pkg.AUROC(task="binary", **d),
        "roc_exact": lambda pkg, **d: pkg.ROC(task="binary", **d),
    }
    port = tpumetrics_torch.MetricCollection({k: m(tpumetrics_torch, device="cpu") for k, m in members.items()}, device="cpu")
    ref = tpumetrics.MetricCollection({k: m(tpumetrics) for k, m in members.items()})
    for seed in (30, 31):
        (tp, tt), (jp, jt) = _both(*_binary(seed))
        port.update(tp, tt)
        ref.update(jp, jt)
    groups = [["acc"], ["auroc_binned"], ["auroc_exact", "roc_exact"]]
    assert list(port.compute_groups.values()) == list(ref.compute_groups.values()) == groups
    _assert_same(port.compute(), ref.compute())
