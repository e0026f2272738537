"""The port's confusion-matrix and curve-point families held against the JAX
package: Jaccard index, Matthews correlation (MCC), Cohen's kappa, recall
at a fixed precision and precision at a fixed recall.

The corpora are those of ``tests/classification/inputs.py``. Integer states
(confusion matrices, binned curve tensors, the exact path's preds and
targets) must be equal. Tolerances on the values:

- Jaccard: ``ATOL`` = 1e-6, one float32 division per class and one
  weighted sum taken in another order.
- MCC and kappa: relative ``RTOL`` = 1e-5 with an absolute floor
  ``MCC_ATOL`` = 1e-6. Both work in float32 on sums of products of counts
  (``s**2`` and ``tk * pk`` for MCC, the outer product of the marginals for
  kappa), and torch sums those in another order than XLA, so the last bits
  differ. The rounding error is set by the size of those terms, not by the
  result, so a value near 0 needs the absolute floor (1.8e-7 measured on
  the corpora, where values of 0.005 differ by 2e-5 relative). At large
  counts the worst relative difference measured is 6.8e-7 (kappa, C=1000,
  50,000 samples), and both packages stay within 7.2e-7 of a float64 numpy
  oracle. The port keeps the float32 semantics.
- Recall/precision at a fixed point: exact. The reduction is masked maxima
  and selects over the curve, and the port's batched form over all classes
  of a binned state must give the JAX per-class loop's values bit for bit.
  Their multiclass inputs are probabilities (a numpy softmax of the corpus
  logits): the exact curve's thresholds are the preds themselves, and the
  two frameworks' softmax rounds some of them apart in the last bit.
"""

import importlib

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
from tests.classification import inputs as corpus
from tests.test_torch_classification import _assert_same, _both
from tpumetrics.ops import binned_confusion_fused as jax_binned_confusion_fused
from tpumetrics_torch import MetricCollection
from tpumetrics_torch.functional.classification import precision_fixed_recall as port_pfr
from tpumetrics_torch.functional.classification import recall_fixed_precision as port_rfp
from tpumetrics_torch.functional.classification.cohen_kappa import _cohen_kappa_reduce
from tpumetrics_torch.functional.classification.matthews_corrcoef import _matthews_corrcoef_reduce
from tpumetrics_torch.functional.classification.precision_recall_curve import _multiclass_precision_recall_curve_update

jax_mcc = importlib.import_module("tpumetrics.functional.classification.matthews_corrcoef")
jax_kappa = importlib.import_module("tpumetrics.functional.classification.cohen_kappa")
jax_rfp = importlib.import_module("tpumetrics.functional.classification.recall_fixed_precision")
jax_pfr = importlib.import_module("tpumetrics.functional.classification.precision_fixed_recall")

ATOL = 1e-6
RTOL = 1e-5
MCC_ATOL = 1e-6
C = corpus.NUM_CLASSES
IGNORES = {"none": None, "minus-one": -1, "in-range": 0}


def _with_ignored(target, ignore_index, seed=0):
    if ignore_index is None:
        return target
    target = target.copy()
    target[np.random.default_rng(seed).random(target.shape) < 0.15] = ignore_index
    return target


def _size_kw(task):
    return {"num_classes": C} if task == "multiclass" else {"num_labels": C} if task == "multilabel" else {}


def _assert_rel(port, ref):
    port_np, ref_np = port.detach().cpu().numpy(), np.asarray(ref)
    assert port_np.shape == ref_np.shape and port_np.dtype == np.float32
    np.testing.assert_allclose(port_np, ref_np, rtol=RTOL, atol=MCC_ATOL)


def _softmax(logits):
    e = np.exp(logits - logits.max(axis=2, keepdims=True))
    return (e / e.sum(axis=2, keepdims=True)).astype(np.float32)


CORPORA = {
    "binary-probs": ("binary", corpus.binary_probs_preds, corpus.binary_target),
    "binary-labels": ("binary", corpus.binary_label_preds, corpus.binary_target),
    "binary-multidim": ("binary", corpus.binary_md_probs_preds, corpus.binary_md_target),
    "multiclass-logits": ("multiclass", corpus.multiclass_logits_preds, corpus.multiclass_target),
    "multiclass-labels": ("multiclass", corpus.multiclass_label_preds, corpus.multiclass_target),
    "multiclass-multidim": ("multiclass", corpus.multiclass_md_logits_preds, corpus.multiclass_md_target),
    "multiclass-probs": ("multiclass", _softmax(corpus.multiclass_logits_preds), corpus.multiclass_target),
    "multiclass-multidim-probs": (
        "multiclass", _softmax(corpus.multiclass_md_logits_preds), corpus.multiclass_md_target
    ),
    "multilabel-probs": ("multilabel", corpus.multilabel_probs_preds, corpus.multilabel_target),
    "multilabel-labels": ("multilabel", corpus.multilabel_label_preds, corpus.multilabel_target),
    "multilabel-multidim": ("multilabel", corpus.multilabel_md_probs_preds, corpus.multilabel_md_target),
}


# --------------------------------------------------------- Jaccard, MCC, kappa


@pytest.mark.parametrize("ignore", list(IGNORES))
@pytest.mark.parametrize("corpus_name", list(CORPORA))
def test_functional_confmat_families_match_jax(corpus_name, ignore):
    """Jaccard in every average of the task (its micro denominator and macro
    weights drop an in-range ``ignore_index``), MCC, and kappa in every
    weighting, on the first two batches of each corpus."""
    task, preds, target = CORPORA[corpus_name]
    ignore_index = IGNORES[ignore]
    target = _with_ignored(target, ignore_index)
    kw = {"task": task, "ignore_index": ignore_index, **_size_kw(task)}
    averages = [None] if task == "binary" else ["micro", "macro", "weighted", "none"]
    for i in range(2):
        (tp, tt), (jp, jt) = _both(preds[i], target[i])
        for average in averages:
            akw = {} if average is None else {"average": average}
            _assert_same(fn.jaccard_index(tp, tt, **kw, **akw), jax_fn.jaccard_index(jp, jt, **kw, **akw), atol=ATOL)
        _assert_rel(fn.matthews_corrcoef(tp, tt, **kw), jax_fn.matthews_corrcoef(jp, jt, **kw))
        if task != "multilabel":
            for weights in (None, "linear", "quadratic"):
                _assert_rel(
                    fn.cohen_kappa(tp, tt, weights=weights, **kw), jax_fn.cohen_kappa(jp, jt, weights=weights, **kw)
                )


MODULAR = [
    ("binary-probs", "BinaryJaccardIndex", {}),
    ("multiclass-logits", "MulticlassJaccardIndex", {"average": "micro"}),
    ("multiclass-multidim", "MulticlassJaccardIndex", {"average": "macro"}),
    ("multilabel-probs", "MultilabelJaccardIndex", {"average": "weighted"}),
    ("binary-multidim", "BinaryMatthewsCorrCoef", {}),
    ("multiclass-logits", "MulticlassMatthewsCorrCoef", {}),
    ("multilabel-multidim", "MultilabelMatthewsCorrCoef", {}),
    ("binary-probs", "BinaryCohenKappa", {"weights": "linear"}),
    ("multiclass-labels", "MulticlassCohenKappa", {"weights": "quadratic"}),
    ("multiclass-multidim", "MulticlassCohenKappa", {}),
]


@pytest.mark.parametrize("ignore", list(IGNORES))
@pytest.mark.parametrize("corpus_name, name, kwargs", MODULAR, ids=[f"{n}-{c}" for c, n, _ in MODULAR])
def test_modular_confmat_families_match_jax_over_batches(corpus_name, name, kwargs, ignore):
    """Streamed over every batch: the int32 confusion matrix exact after each update, then the value."""
    task, preds, target = CORPORA[corpus_name]
    ignore_index = IGNORES[ignore]
    target = _with_ignored(target, ignore_index, seed=1)
    kw = {"ignore_index": ignore_index, **_size_kw(task), **kwargs}
    port = getattr(cls, name)(device="cpu", **kw)
    ref = getattr(jax_cls, name)(**kw)
    for i in range(preds.shape[0]):
        (tp, tt), (jp, jt) = _both(preds[i], target[i])
        port.update(tp, tt)
        ref.update(jp, jt)
        _assert_same(port.confmat, ref.confmat)
    if "Jaccard" in name:
        _assert_same(port.compute(), ref.compute(), atol=ATOL)
    else:
        _assert_rel(port.compute(), ref.compute())


def _mcc64(cm):
    cm = cm.astype(np.float64)
    cm = cm.sum(0) if cm.ndim == 3 else cm
    tk, pk, c, s = cm.sum(1), cm.sum(0), np.trace(cm), cm.sum()
    return (c * s - tk @ pk) / np.sqrt((s * s - pk @ pk) * (s * s - tk @ tk))


def _kappa64(cm, weights):
    cm = cm.astype(np.float64)
    grid = np.arange(cm.shape[0], dtype=np.float64)
    diff = grid[None, :] - grid[:, None]
    w = 1 - np.eye(cm.shape[0]) if weights is None else np.abs(diff) if weights == "linear" else diff**2
    expected = np.outer(cm.sum(1), cm.sum(0)) / cm.sum()
    return 1 - (w * cm).sum() / (w * expected).sum()


def test_mcc_and_kappa_at_large_counts_match_jax_and_a_float64_oracle():
    """Counts where float32 loses bits in the sums of squares: a 1M-sample
    binary matrix and a 50,000-sample C=1000 one. The port within RTOL of
    the JAX package and of a float64 numpy oracle, as the JAX package is."""
    rng = np.random.default_rng(7)
    mats = []
    t = rng.random(1_000_000) < 0.3
    p = np.where(rng.random(t.size) < 0.8, t, ~t)
    mats.append(np.bincount(t * 2 + p, minlength=4).reshape(2, 2).astype(np.int32))
    for c, n in ((1000, 50_000), (10, 100_000)):
        t = rng.integers(0, c, n)
        p = np.where(rng.random(n) < 0.7, t, rng.integers(0, c, n))
        mats.append(np.bincount(t * c + p, minlength=c * c).reshape(c, c).astype(np.int32))
    for cm in mats:
        port = _matthews_corrcoef_reduce(torch.from_numpy(cm))
        ref = jax_mcc._matthews_corrcoef_reduce(jnp.asarray(cm))
        _assert_rel(port, ref)
        np.testing.assert_allclose([float(port), float(ref)], _mcc64(cm), rtol=RTOL)
        for weights in (None, "linear", "quadratic"):
            port = _cohen_kappa_reduce(torch.from_numpy(cm), weights)
            ref = jax_kappa._cohen_kappa_reduce(jnp.asarray(cm), weights)
            _assert_rel(port, ref)
            np.testing.assert_allclose([float(port), float(ref)], _kappa64(cm, weights), rtol=RTOL)


def test_mcc_binary_special_cases_match_jax():
    """The binary where-selects: all right, all wrong, a zero denominator
    (one class never predicted or never a target), an empty matrix."""
    for cm in ([[5, 0], [0, 3]], [[0, 4], [6, 0]], [[5, 0], [3, 0]], [[0, 0], [2, 6]], [[0, 0], [0, 0]],
               [[7, 2], [0, 0]], [[0, 3], [0, 4]]):
        cm = np.asarray(cm, np.int32)
        port = _matthews_corrcoef_reduce(torch.from_numpy(cm))
        ref = jax_mcc._matthews_corrcoef_reduce(jnp.asarray(cm))
        np.testing.assert_array_equal(port.numpy(), np.asarray(ref))


def test_jaccard_ignore_index_in_range_leaves_micro_and_macro():
    """An in-range ``ignore_index`` leaves the micro denominator and the
    macro weights (its row of the matrix is empty; its column is not)."""
    rng = np.random.default_rng(3)
    preds, target = rng.integers(0, 4, 200), rng.integers(0, 4, 200)
    (tp, tt), (jp, jt) = _both(preds, target)
    for ignore_index in (0, 2, 3, -1, None):
        for average in ("micro", "macro", "weighted", "none"):
            kw = {"num_classes": 4, "average": average, "ignore_index": ignore_index}
            _assert_same(fn.multiclass_jaccard_index(tp, tt, **kw), jax_fn.multiclass_jaccard_index(jp, jt, **kw))


# ------------------------------------------------- recall / precision at a point

# (corpus, thresholds, ignore): binned (int, list) and exact (None) curves of
# every task; the exact multilabel path with ignored targets is left to the
# binned cases (the JAX package drops them label by label, seconds per call)
POINT_CASES = [
    ("binary-probs", None, "none"),
    ("binary-probs", None, "minus-one"),
    ("binary-probs", 16, "minus-one"),
    ("binary-multidim", [0.1, 0.25, 0.5, 0.75, 0.9], "none"),
    ("multiclass-probs", None, "none"),
    ("multiclass-probs", None, "minus-one"),
    ("multiclass-probs", 16, "minus-one"),
    ("multiclass-multidim-probs", [0.1, 0.25, 0.5, 0.75, 0.9], "minus-one"),
    ("multilabel-probs", None, "none"),
    ("multilabel-probs", 16, "minus-one"),
    ("multilabel-multidim", [0.1, 0.25, 0.5, 0.75, 0.9], "minus-one"),
]
POINT_IDS = [f"{c}-{t}-{i}" for c, t, i in POINT_CASES]


@pytest.mark.parametrize("corpus_name, thresholds, ignore", POINT_CASES, ids=POINT_IDS)
def test_functional_fixed_point_families_match_jax(corpus_name, thresholds, ignore):
    """Both families at three operating points on one batch, binned and exact."""
    task, preds, target = CORPORA[corpus_name]
    ignore_index = IGNORES[ignore]
    target = _with_ignored(target, ignore_index)
    kw = {"thresholds": thresholds, "ignore_index": ignore_index, **_size_kw(task)}
    (tp, tt), (jp, jt) = _both(preds[0], target[0])
    for value in (0.0, 0.5, 0.9):
        port = getattr(fn, f"{task}_recall_at_fixed_precision")(tp, tt, min_precision=value, **kw)
        ref = getattr(jax_fn, f"{task}_recall_at_fixed_precision")(jp, jt, min_precision=value, **kw)
        _assert_same(port, ref, atol=0)
        port = getattr(fn, f"{task}_precision_at_fixed_recall")(tp, tt, min_recall=value, **kw)
        ref = getattr(jax_fn, f"{task}_precision_at_fixed_recall")(jp, jt, min_recall=value, **kw)
        _assert_same(port, ref, atol=0)


@pytest.mark.parametrize("corpus_name, thresholds, ignore", POINT_CASES, ids=POINT_IDS)
def test_modular_fixed_point_families_match_jax_over_batches(corpus_name, thresholds, ignore):
    """Streamed over every batch: the binned int32 curve tensor (or the exact
    list states) equal, then the values, exactly."""
    task, preds, target = CORPORA[corpus_name]
    ignore_index = IGNORES[ignore]
    target = _with_ignored(target, ignore_index, seed=1)
    prefix = task.capitalize()
    kw = {"thresholds": thresholds, "ignore_index": ignore_index, **_size_kw(task)}
    pairs = [
        (getattr(cls, f"{prefix}RecallAtFixedPrecision")(min_precision=0.5, device="cpu", **kw),
         getattr(jax_cls, f"{prefix}RecallAtFixedPrecision")(min_precision=0.5, **kw)),
        (getattr(cls, f"{prefix}PrecisionAtFixedRecall")(min_recall=0.5, device="cpu", **kw),
         getattr(jax_cls, f"{prefix}PrecisionAtFixedRecall")(min_recall=0.5, **kw)),
    ]
    for i in range(preds.shape[0]):
        (tp, tt), (jp, jt) = _both(preds[i], target[i])
        for port, ref in pairs:
            port.update(tp, tt)
            ref.update(jp, jt)
    for port, ref in pairs:
        _assert_same({k: getattr(port, k) for k in port._defaults}, {k: getattr(ref, k) for k in ref._defaults})
        _assert_same(port.compute(), ref.compute(), atol=0)


def test_batched_fixed_point_compute_equals_the_jax_per_class_loop():
    """On binned states the port reduces all classes at once; the JAX package
    loops over the classes. Same int32 state in, bit for bit the same values
    and thresholds out, for both families, at operating points from 0 to 1,
    with a class that never occurs and one that is never predicted above the
    lowest thresholds."""
    rng = np.random.default_rng(11)
    n, c = 400, 7
    preds = rng.random((n, c)).astype(np.float32)
    preds[:, 5] *= 0.1
    target = rng.integers(0, c - 1, n)  # class 6 never occurs
    target[rng.random(n) < 0.1] = -1
    for thresholds in (np.linspace(0, 1, 25, dtype=np.float32), np.asarray([0.9, 0.05, 0.5, 0.5, 0.3], np.float32)):
        thr = torch.from_numpy(thresholds)
        state = _multiclass_precision_recall_curve_update(
            torch.from_numpy(preds), torch.from_numpy(target), c, thr, None, -1
        )
        jstate, jthr = jnp.asarray(state.numpy()), jnp.asarray(thresholds)
        for value in (0.0, 0.2, 0.5, 0.75, 0.95, 1.0):
            for reduce, jax_reduce in (
                (port_rfp._recall_at_precision, jax_rfp._recall_at_precision),
                (port_pfr._precision_at_recall, jax_pfr._precision_at_recall),
            ):
                got = port_rfp._multiclass_recall_at_fixed_precision_compute(state, c, thr, value, reduce_fn=reduce)
                want = jax_rfp._multiclass_recall_at_fixed_precision_compute(
                    jstate, c, jthr, value, reduce_fn=jax_reduce
                )
                for g, w in zip(got, want):
                    assert g.dtype == torch.float32
                    np.testing.assert_array_equal(g.numpy(), np.asarray(w))
            # the multilabel compute takes the same batched path
            got = port_rfp._multilabel_recall_at_fixed_precision_compute(state, c, thr, -1, value)
            want = jax_rfp._multilabel_recall_at_fixed_precision_compute(jstate, c, jthr, -1, value)
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_fixed_point_binned_counts_match_the_pallas_kernel_in_interpret_mode():
    """The binned state behind both families counts what the JAX Pallas
    kernel counts (interpret mode) on the same batch, ignored targets out of
    every count; the values then equal the JAX package's."""
    preds = corpus.multilabel_probs_preds[0]
    target = _with_ignored(corpus.multilabel_target[0], -1, seed=4)
    thresholds = 16
    metric = cls.MultilabelRecallAtFixedPrecision(
        C, min_precision=0.5, thresholds=thresholds, ignore_index=-1, device="cpu"
    )
    metric.update(torch.from_numpy(preds), torch.from_numpy(target))
    valid = (target != -1).astype(np.float32)
    y = (target == 1).astype(np.float32) * valid
    tp, predpos = jax_binned_confusion_fused(
        *(jnp.asarray(x) for x in (preds, y, valid, np.linspace(0, 1, thresholds, dtype=np.float32))), interpret=True
    )
    np.testing.assert_array_equal(metric.confmat[:, :, 1, 1].numpy(), np.asarray(tp))
    predicted = metric.confmat[:, :, 0, 1] + metric.confmat[:, :, 1, 1]
    np.testing.assert_array_equal(predicted.numpy(), np.asarray(predpos))
    ref = jax_cls.MultilabelRecallAtFixedPrecision(C, min_precision=0.5, thresholds=thresholds, ignore_index=-1)
    ref.update(jnp.asarray(preds), jnp.asarray(target))
    _assert_same(metric.compute(), ref.compute(), atol=0)


# ------------------------------------------------------ wrappers and groups

WRAPPERS = [
    ("JaccardIndex", "binary", {}, "BinaryJaccardIndex"),
    ("JaccardIndex", "multilabel", {"num_labels": 3, "average": "micro"}, "MultilabelJaccardIndex"),
    ("MatthewsCorrCoef", "multiclass", {"num_classes": 3}, "MulticlassMatthewsCorrCoef"),
    ("MatthewsCorrCoef", "multilabel", {"num_labels": 3}, "MultilabelMatthewsCorrCoef"),
    ("CohenKappa", "binary", {"weights": "linear"}, "BinaryCohenKappa"),
    ("CohenKappa", "multiclass", {"num_classes": 3, "weights": "quadratic"}, "MulticlassCohenKappa"),
    ("RecallAtFixedPrecision", "binary", {"min_precision": 0.5}, "BinaryRecallAtFixedPrecision"),
    ("RecallAtFixedPrecision", "multiclass", {"num_classes": 3, "min_precision": 0.5, "thresholds": 8},
     "MulticlassRecallAtFixedPrecision"),
    ("PrecisionAtFixedRecall", "multilabel", {"num_labels": 3, "min_recall": 0.5, "thresholds": 8},
     "MultilabelPrecisionAtFixedRecall"),
]


@pytest.mark.parametrize(
    "wrapper, task, kwargs, concrete", WRAPPERS, ids=[f"{w}-{t}" for w, t, _, _ in WRAPPERS]
)
def test_task_wrappers_return_the_concrete_metric_of_the_jax_package(wrapper, task, kwargs, concrete):
    port = getattr(tpumetrics_torch, wrapper)(task=task, device="cpu", **kwargs)
    ref = getattr(tpumetrics, wrapper)(task=task, **kwargs)
    assert type(port) is getattr(cls, concrete) and type(ref).__name__ == concrete
    assert sorted(port._defaults) == sorted(ref._defaults)
    for name in ("threshold", "num_classes", "num_labels", "average", "weights", "min_precision", "min_recall"):
        if hasattr(ref, name):
            assert getattr(port, name) == getattr(ref, name), name


def test_wrappers_and_arguments_refused_like_jax():
    with pytest.raises(ValueError, match="Invalid Classification"):
        tpumetrics_torch.CohenKappa(task="multilabel", device="cpu")
    with pytest.raises(ValueError, match="weights"):
        cls.MulticlassCohenKappa(3, weights="cubic", device="cpu")
    with pytest.raises(ValueError, match="average"):
        cls.MulticlassJaccardIndex(3, average="samples", device="cpu")
    with pytest.raises(ValueError, match="min_precision"):
        cls.BinaryRecallAtFixedPrecision(min_precision=1.5, device="cpu")
    with pytest.raises(ValueError, match="num_labels"):
        tpumetrics_torch.PrecisionAtFixedRecall(task="multilabel", min_recall=0.5, device="cpu")


@pytest.mark.parametrize("task", ["binary", "multiclass", "multilabel"])
def test_new_members_join_the_confmat_and_auroc_groups_and_values_match_jax(task):
    """Jaccard, MCC and kappa hold the confusion matrix's state and join its
    compute group; the binned fixed-point metrics join the binned AUROC's."""
    name = {"binary": "binary-probs", "multiclass": "multiclass-logits", "multilabel": "multilabel-probs"}[task]
    _, preds, target = CORPORA[name]
    target = _with_ignored(target, -1, seed=5)
    kw = {"task": task, "ignore_index": -1, **_size_kw(task)}

    def members(pkg, **dev):
        out = {
            "auroc": pkg.AUROC(thresholds=16, **kw, **dev),
            "confmat": pkg.ConfusionMatrix(**kw, **dev),
            "jaccard": pkg.JaccardIndex(**kw, **dev),
            "mcc": pkg.MatthewsCorrCoef(**kw, **dev),
            "pafr": pkg.PrecisionAtFixedRecall(min_recall=0.5, thresholds=16, **kw, **dev),
            "rafp": pkg.RecallAtFixedPrecision(min_precision=0.5, thresholds=16, **kw, **dev),
        }
        if task != "multilabel":
            out["kappa"] = pkg.CohenKappa(**kw, **dev)
        return out

    port = MetricCollection(members(tpumetrics_torch, device="cpu"), device="cpu")
    ref = tpumetrics.MetricCollection(members(tpumetrics))
    for i in range(preds.shape[0]):
        (tp, tt), (jp, jt) = _both(preds[i], target[i])
        port.update(tp, tt)
        ref.update(jp, jt)
    groups = [list(g) for g in port.compute_groups.values()]
    confmat_group = ["confmat", "jaccard", "mcc"] + (["kappa"] if task != "multilabel" else [])
    assert groups == [["auroc", "pafr", "rafp"], sorted(confmat_group)]
    assert groups == [list(g) for g in ref.compute_groups.values()]
    got, want = port.compute(), ref.compute()
    for key in ("auroc", "confmat", "jaccard", "pafr", "rafp"):
        _assert_same(got[key], want[key], atol=ATOL)
    for key in ("mcc", "kappa"):
        if key in want:
            _assert_rel(got[key], want[key])
