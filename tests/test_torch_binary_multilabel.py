"""Binary and multilabel classification of the port, and the task-string
wrappers, held against the JAX package.

The same numpy inputs go through both packages. Integer states and counts
must be equal; float values agree within ``ATOL`` = 1e-6, the room that
float32 sums taken in another order need. Preds are probabilities on a grid
of sixteenths, so the sigmoid is skipped on both sides, many preds tie and
some sit exactly on a threshold of the 13-point grid.
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
from tests.test_torch_classification import _assert_same, _both
from tpumetrics.ops import binned_confusion_fused as jax_binned_confusion_fused
from tpumetrics_torch import MetricCollection
from tpumetrics_torch.interop import export_state

# the module (the package's ``__init__`` binds the name to the task dispatcher)
prc = importlib.import_module("tpumetrics_torch.functional.classification.precision_recall_curve")

jax_prc = importlib.import_module("tpumetrics.functional.classification.precision_recall_curve")

N = 64
L = 4
T = 13
IGNORE = -1


def _data(seed, shape, ignore_index=None, labels=False):
    """Preds on a grid of sixteenths (or 0/1 labels) and 0/1 targets of ``shape``,
    about a fifth of the targets at ``ignore_index`` when one is given."""
    rng = np.random.default_rng(seed)
    preds = rng.integers(0, 2, shape) if labels else (rng.integers(0, 17, shape) / 16).astype(np.float32)
    target = rng.integers(0, 2, shape)
    if ignore_index is not None:
        target[rng.random(shape) < 0.2] = ignore_index
    return preds, target


def _ids(cases):
    return [f"{name}-{i}" for i, (name, _) in enumerate(cases)]


# ------------------------------------------------------------------ functional

BINARY = [
    ("binary_stat_scores", {}),
    ("binary_accuracy", {}),
    ("binary_accuracy", {"threshold": 0.25}),
    ("binary_f1_score", {}),
    ("binary_fbeta_score", {"beta": 2.0}),
    ("binary_precision_recall_curve", {"thresholds": T}),
    ("binary_roc", {"thresholds": T}),
    ("binary_auroc", {"thresholds": T}),
    ("binary_auroc", {"thresholds": T, "max_fpr": 0.5}),
    ("binary_auroc", {"thresholds": [0.0, 0.25, 0.3, 0.5, 0.9, 1.0]}),
]

MULTILABEL = [
    ("multilabel_stat_scores", {"average": "micro"}),
    ("multilabel_stat_scores", {"average": "none"}),
    ("multilabel_accuracy", {"average": "micro"}),
    ("multilabel_accuracy", {"average": "macro"}),
    ("multilabel_accuracy", {"average": "weighted", "threshold": 0.75}),
    ("multilabel_f1_score", {"average": "macro"}),
    ("multilabel_f1_score", {"average": "micro"}),
    ("multilabel_fbeta_score", {"beta": 0.5, "average": "weighted"}),
    ("multilabel_precision_recall_curve", {"thresholds": T}),
    ("multilabel_roc", {"thresholds": T}),
    ("multilabel_auroc", {"thresholds": T, "average": "macro"}),
    ("multilabel_auroc", {"thresholds": T, "average": "micro"}),
    ("multilabel_auroc", {"thresholds": T, "average": "weighted"}),
    ("multilabel_auroc", {"thresholds": T, "average": None}),
]


@pytest.mark.parametrize("ignore_index", [None, IGNORE], ids=["no-ignore", "ignore"])
@pytest.mark.parametrize("name, kwargs", BINARY, ids=_ids(BINARY))
def test_binary_functional_matches_jax(name, kwargs, ignore_index):
    (tp, tt), (jp, jt) = _both(*_data(1, (N,), ignore_index))
    port = getattr(fn, name)(tp, tt, ignore_index=ignore_index, **kwargs)
    _assert_same(port, getattr(jax_fn, name)(jp, jt, ignore_index=ignore_index, **kwargs))


@pytest.mark.parametrize("ignore_index", [None, IGNORE], ids=["no-ignore", "ignore"])
@pytest.mark.parametrize("name, kwargs", MULTILABEL, ids=_ids(MULTILABEL))
def test_multilabel_functional_matches_jax(name, kwargs, ignore_index):
    (tp, tt), (jp, jt) = _both(*_data(2, (N, L), ignore_index))
    port = getattr(fn, name)(tp, tt, num_labels=L, ignore_index=ignore_index, **kwargs)
    _assert_same(port, getattr(jax_fn, name)(jp, jt, num_labels=L, ignore_index=ignore_index, **kwargs))


@pytest.mark.parametrize(
    "name, shape, kwargs",
    [
        ("binary_stat_scores", (N, 3), {}),
        ("binary_accuracy", (N, 3), {}),
        ("multilabel_stat_scores", (N, L, 3), {"num_labels": L, "average": "none"}),
        ("multilabel_f1_score", (N, L, 3), {"num_labels": L, "average": "micro"}),
    ],
)
def test_samplewise_and_label_preds_match_jax(name, shape, kwargs):
    """Per-sample counts over an extra axis, from 0/1 label preds."""
    (tp, tt), (jp, jt) = _both(*_data(3, shape, IGNORE, labels=True))
    kw = {"multidim_average": "samplewise", "ignore_index": IGNORE, **kwargs}
    _assert_same(getattr(fn, name)(tp, tt, **kw), getattr(jax_fn, name)(jp, jt, **kw))


TASKS = [
    ("stat_scores", "binary", {}),
    ("stat_scores", "multilabel", {"num_labels": L, "average": "macro"}),
    ("accuracy", "binary", {}),
    ("accuracy", "multilabel", {"num_labels": L}),
    ("fbeta_score", "multilabel", {"num_labels": L, "beta": 2.0, "average": "macro"}),
    ("f1_score", "binary", {}),
    ("precision_recall_curve", "binary", {"thresholds": T}),
    ("roc", "multilabel", {"num_labels": L, "thresholds": T}),
    ("auroc", "binary", {"thresholds": T}),
    ("auroc", "multilabel", {"num_labels": L, "thresholds": T}),
]


@pytest.mark.parametrize("name, task, kwargs", TASKS, ids=[f"{n}-{t}-{i}" for i, (n, t, _) in enumerate(TASKS)])
def test_task_dispatchers_match_jax(name, task, kwargs):
    (tp, tt), (jp, jt) = _both(*_data(4, (N,) if task == "binary" else (N, L), IGNORE))
    port = getattr(fn, name)(tp, tt, task=task, ignore_index=IGNORE, **kwargs)
    _assert_same(port, getattr(jax_fn, name)(jp, jt, task=task, ignore_index=IGNORE, **kwargs))


def test_task_dispatchers_refuse_missing_sizes_and_unknown_tasks():
    preds, target = torch.rand(4, L), torch.zeros(4, L, dtype=torch.long)
    with pytest.raises(ValueError, match="num_labels"):
        fn.accuracy(preds, target, task="multilabel")
    with pytest.raises(ValueError, match="num_classes"):
        fn.auroc(preds, target[:, 0], task="multiclass")
    with pytest.raises(ValueError, match="Invalid Classification"):
        fn.stat_scores(preds, target, task="multi-output")


def test_validation_rejects_bad_binary_and_multilabel_inputs():
    probs = torch.rand(4)
    with pytest.raises(RuntimeError, match="target"):
        fn.binary_accuracy(probs, torch.tensor([0, 1, 2, 1]))
    with pytest.raises(RuntimeError, match="preds"):
        fn.binary_stat_scores(torch.tensor([0, 1, 3, 1]), torch.tensor([0, 1, 0, 1]))
    with pytest.raises(RuntimeError, match="target"):
        fn.binary_auroc(probs, torch.tensor([0, 1, -1, 1]), thresholds=T)
    with pytest.raises(ValueError, match="float"):
        fn.binary_auroc(probs, torch.tensor([0.0, 1.0, 0.0, 1.0]))
    with pytest.raises(ValueError, match="max_fpr"):
        fn.binary_auroc(probs, torch.tensor([0, 1, 0, 1]), max_fpr=1.5)
    with pytest.raises(ValueError, match="number of labels"):
        fn.multilabel_auroc(torch.rand(4, 3), torch.zeros(4, 3, dtype=torch.long), num_labels=L)
    with pytest.raises(RuntimeError, match="target"):
        fn.multilabel_f1_score(torch.rand(4, L), torch.full((4, L), 2), num_labels=L)


def test_kernel_inputs_of_the_new_paths_match_jax_kernel_in_interpret_mode():
    """The card path builds the kernel's ``y``/``v`` in ``_binned_confusion_kernel``:
    binary preds as one column, multilabel preds with a per-entry valid mask.
    Run here through the kernel wrapper's plain version, it must count what the
    JAX Pallas kernel (interpret mode) and the JAX binned update count."""
    thr = np.asarray([0.5, 0.0, 0.25, 1.0, 0.3, 0.75, 0.5, 0.9], np.float32)  # unsorted, a duplicate
    for shape in [(N, 1), (N, L)]:
        preds, target = _data(6, shape, IGNORE)
        invalid = target == IGNORE
        bits = np.where(invalid, 0, target)
        conf = prc._binned_confusion_kernel(
            torch.from_numpy(preds), torch.from_numpy(bits), torch.from_numpy(thr), torch.from_numpy(invalid)
        )
        ref = jax_prc._binned_confusion_tensor(jnp.asarray(preds), jnp.asarray(bits), jnp.asarray(thr), jnp.asarray(invalid))
        _assert_same(conf, ref)
        v = (~invalid).astype(np.float32)
        jtp, jpp = jax_binned_confusion_fused(*(jnp.asarray(x) for x in (preds, bits * v, v, thr)), interpret=True)
        np.testing.assert_array_equal(conf[:, :, 1, 1].numpy(), np.asarray(jtp))
        np.testing.assert_array_equal((conf[:, :, 0, 1] + conf[:, :, 1, 1]).numpy(), np.asarray(jpp))


# ------------------------------------------------------------------- modular

MODULAR = [
    ("BinaryStatScores", {}),
    ("BinaryAccuracy", {}),
    ("BinaryF1Score", {}),
    ("BinaryFBetaScore", {"beta": 0.5}),
    ("BinaryPrecisionRecallCurve", {"thresholds": T}),
    ("BinaryROC", {"thresholds": T}),
    ("BinaryAUROC", {"thresholds": T}),
    ("BinaryAUROC", {"thresholds": T, "max_fpr": 0.3}),
    ("MultilabelStatScores", {"num_labels": L, "average": "none"}),
    ("MultilabelAccuracy", {"num_labels": L, "average": "micro"}),
    ("MultilabelF1Score", {"num_labels": L, "average": "macro"}),
    ("MultilabelFBetaScore", {"num_labels": L, "beta": 2.0, "average": "weighted"}),
    ("MultilabelPrecisionRecallCurve", {"num_labels": L, "thresholds": T}),
    ("MultilabelROC", {"num_labels": L, "thresholds": T}),
    ("MultilabelAUROC", {"num_labels": L, "thresholds": T, "average": "macro"}),
    ("MultilabelAUROC", {"num_labels": L, "thresholds": T, "average": "micro"}),
]


def _states(metric):
    return {k: getattr(metric, k) for k in metric._defaults}


@pytest.mark.parametrize("ignore_index", [None, IGNORE], ids=["no-ignore", "ignore"])
@pytest.mark.parametrize("name, kwargs", MODULAR, ids=_ids(MODULAR))
def test_modular_matches_jax_over_batches(name, kwargs, ignore_index):
    port = getattr(cls, name)(ignore_index=ignore_index, device="cpu", **kwargs)
    ref = getattr(jax_cls, name)(ignore_index=ignore_index, **kwargs)
    shape = (N, L) if name.startswith("Multilabel") else (N,)
    batches = [_data(seed, shape, ignore_index) for seed in (10, 11, 12, 13)]
    for preds, target in batches[:2]:
        (tp, tt), (jp, jt) = _both(preds, target)
        _assert_same(port(tp, tt), ref(jp, jt))  # forward: the batch value
    for preds, target in batches[2:]:
        (tp, tt), (jp, jt) = _both(preds, target)
        port.update(tp, tt)
        ref.update(jp, jt)
    _assert_same(_states(port), _states(ref))
    assert all(v.dtype == torch.int32 for v in _states(port).values())
    _assert_same(port.compute(), ref.compute())
    assert port.update_count == ref.update_count == 4


# -------------------------------------------------------------- task wrappers

WRAPPERS = [
    ("StatScores", "binary", {}, "BinaryStatScores"),
    ("StatScores", "multiclass", {"num_classes": 3, "top_k": 2}, "MulticlassStatScores"),
    ("Accuracy", "binary", {"threshold": 0.25}, "BinaryAccuracy"),
    ("Accuracy", "multilabel", {"num_labels": L}, "MultilabelAccuracy"),
    ("FBetaScore", "multiclass", {"num_classes": 3, "beta": 2.0}, "MulticlassFBetaScore"),
    ("F1Score", "multilabel", {"num_labels": L, "average": "macro"}, "MultilabelF1Score"),
    ("F1Score", "binary", {}, "BinaryF1Score"),
    ("PrecisionRecallCurve", "multilabel", {"num_labels": L, "thresholds": T}, "MultilabelPrecisionRecallCurve"),
    ("ROC", "multiclass", {"num_classes": 3, "thresholds": T}, "MulticlassROC"),
    ("AUROC", "binary", {"max_fpr": 0.5}, "BinaryAUROC"),
    ("AUROC", "multilabel", {"num_labels": L, "thresholds": T, "average": "micro"}, "MultilabelAUROC"),
]


@pytest.mark.parametrize(
    "wrapper, task, kwargs, concrete", WRAPPERS, ids=[f"{w}-{t}-{i}" for i, (w, t, _, _) in enumerate(WRAPPERS)]
)
def test_task_wrapper_returns_the_concrete_metric_of_the_jax_package(wrapper, task, kwargs, concrete):
    port = getattr(tpumetrics_torch, wrapper)(task=task, device="cpu", compute_with_cache=False, **kwargs)
    ref = getattr(tpumetrics, wrapper)(task=task, **kwargs)
    assert type(port) is getattr(cls, concrete) and type(ref).__name__ == concrete
    assert port.device == torch.device("cpu") and port.compute_with_cache is False
    for name, value in vars(ref).items():
        if name in ("threshold", "num_classes", "num_labels", "top_k", "average", "average_auroc", "beta", "max_fpr"):
            assert getattr(port, name) == value, name
    assert sorted(port._defaults) == sorted(ref._defaults)


def test_task_wrapper_itself_has_no_update_or_compute():
    wrapper = object.__new__(cls.Accuracy)
    with pytest.raises(TypeError, match="wrapper class"):
        cls.Accuracy.update(wrapper, torch.zeros(2), torch.zeros(2))
    with pytest.raises(TypeError, match="wrapper class"):
        cls.AUROC.compute(wrapper)
    with pytest.raises(ValueError, match="num_classes"):
        cls.F1Score(task="multiclass", device="cpu")
    with pytest.raises(ValueError, match="top_k"):
        cls.Accuracy(task="multiclass", num_classes=3, top_k=None, device="cpu")
    with pytest.raises(ValueError, match="Unexpected keyword"):
        cls.StatScores(task="binary", device="cpu", dtype=torch.float64)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="No CUDA device"):
            cls.AUROC(task="binary")


# ----------------------------------------------------------------- collection


@pytest.mark.parametrize("task", ["binary", "multilabel"])
def test_collection_groups_and_values_match_jax(task):
    """Accuracy and F1 share their stat-score states in one compute group."""
    kw = {} if task == "binary" else {"num_labels": L}

    def members(pkg, **dev):
        return {
            "acc": pkg.Accuracy(task=task, ignore_index=IGNORE, **kw, **dev),
            "f1": pkg.F1Score(task=task, ignore_index=IGNORE, **kw, **dev),
            "auroc": pkg.AUROC(task=task, thresholds=T, ignore_index=IGNORE, **kw, **dev),
        }

    port = MetricCollection(members(tpumetrics_torch, device="cpu"), device="cpu")
    ref = tpumetrics.MetricCollection(members(tpumetrics))
    shape = (N,) if task == "binary" else (N, L)
    for seed in (20, 21, 22):
        (tp, tt), (jp, jt) = _both(*_data(seed, shape, IGNORE))
        port.update(tp, tt)
        ref.update(jp, jt)
    assert list(port.compute_groups.values()) == list(ref.compute_groups.values()) == [["acc", "f1"], ["auroc"]]
    _assert_same(port.compute(), ref.compute())
    state = export_state(port)
    for leader in state:
        _assert_same({k: torch.from_numpy(v) for k, v in state[leader].items()}, _states(ref[leader]))
