"""The port's stat-score families held against the JAX package: precision,
recall, specificity, Hamming distance and exact match.

The corpora are those of ``tests/classification/inputs.py``. Integer states
(tp/fp/tn/fn, exact match's correct/total) must be equal, int32 on both
sides; float values agree within ``ATOL`` = 1e-6, the room a float32
weighted average summed in another order needs (one division per class and
one weighted sum). Logits go through each package's sigmoid or softmax
before a threshold or an argmax, which the two frameworks may round apart
in the last bit; no corpus value sits that close to a decision boundary.
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
from tpumetrics_torch import MetricCollection
from tpumetrics_torch.functional.classification.precision_recall import _precision_recall_reduce

jax_precision_recall = importlib.import_module("tpumetrics.functional.classification.precision_recall")

ATOL = 1e-6
C = corpus.NUM_CLASSES
STATS = ["precision", "recall", "specificity", "hamming_distance"]
# -1 is outside every label range; 0 is a class (a target bit) the metric then drops
IGNORES = {"none": None, "minus-one": -1, "in-range": 0}


def _with_ignored(target, ignore_index, seed=0):
    if ignore_index is None:
        return target
    target = target.copy()
    target[np.random.default_rng(seed).random(target.shape) < 0.15] = ignore_index
    return target


CORPORA = {
    "binary-probs": ("binary", corpus.binary_probs_preds, corpus.binary_target),
    "binary-labels": ("binary", corpus.binary_label_preds, corpus.binary_target),
    "binary-logits": ("binary", corpus.binary_logits_preds, corpus.binary_target),
    "binary-multidim": ("binary", corpus.binary_md_probs_preds, corpus.binary_md_target),
    "multiclass-logits": ("multiclass", corpus.multiclass_logits_preds, corpus.multiclass_target),
    "multiclass-labels": ("multiclass", corpus.multiclass_label_preds, corpus.multiclass_target),
    "multiclass-multidim": ("multiclass", corpus.multiclass_md_logits_preds, corpus.multiclass_md_target),
    "multilabel-probs": ("multilabel", corpus.multilabel_probs_preds, corpus.multilabel_target),
    "multilabel-labels": ("multilabel", corpus.multilabel_label_preds, corpus.multilabel_target),
    "multilabel-multidim": ("multilabel", corpus.multilabel_md_probs_preds, corpus.multilabel_md_target),
}


def _size_kw(task):
    return {"num_classes": C} if task == "multiclass" else {"num_labels": C} if task == "multilabel" else {}


# (corpus, kwargs): every task, every average the JAX package takes, top_k, samplewise
CASES = [
    ("binary-probs", {}),
    ("binary-labels", {}),
    ("binary-logits", {"threshold": 0.25}),
    ("binary-multidim", {"multidim_average": "samplewise"}),
    *[("multiclass-logits", {"average": a}) for a in ("micro", "macro", "weighted", "none")],
    ("multiclass-labels", {"average": "macro"}),
    ("multiclass-logits", {"average": "macro", "top_k": 2}),
    ("multiclass-multidim", {"average": "macro", "multidim_average": "samplewise"}),
    ("multiclass-multidim", {"average": "micro", "multidim_average": "samplewise"}),
    *[("multilabel-probs", {"average": a}) for a in ("micro", "macro", "weighted", "none")],
    ("multilabel-labels", {"average": "macro"}),
    ("multilabel-multidim", {"average": "weighted", "multidim_average": "samplewise"}),
]


def _case_ids(cases):
    return [f"{name}-{'-'.join(f'{k}={v}' for k, v in kw.items())}" for name, kw in cases]


@pytest.mark.parametrize("ignore", list(IGNORES))
@pytest.mark.parametrize("corpus_name, kwargs", CASES, ids=_case_ids(CASES))
def test_functional_stat_families_match_jax(corpus_name, kwargs, ignore):
    """Every dispatcher on the first two batches of the corpus, one call each."""
    task, preds, target = CORPORA[corpus_name]
    ignore_index = IGNORES[ignore]
    target = _with_ignored(target, ignore_index)
    kw = {"task": task, "ignore_index": ignore_index, **_size_kw(task), **kwargs}
    for i in range(2):
        (tp, tt), (jp, jt) = _both(preds[i], target[i])
        for stat in STATS:
            _assert_same(getattr(fn, stat)(tp, tt, **kw), getattr(jax_fn, stat)(jp, jt, **kw), atol=ATOL)


MODULAR = [
    ("Binary", "binary-probs", {}),
    ("Binary", "binary-multidim", {"multidim_average": "samplewise"}),
    ("Multiclass", "multiclass-logits", {"average": "macro"}),
    ("Multiclass", "multiclass-logits", {"average": "weighted", "top_k": 2}),
    ("Multiclass", "multiclass-multidim", {"average": "none", "multidim_average": "samplewise"}),
    ("Multilabel", "multilabel-probs", {"average": "micro"}),
    ("Multilabel", "multilabel-multidim", {"average": "macro", "multidim_average": "samplewise"}),
]
CLASSES = ["Precision", "Recall", "Specificity", "HammingDistance"]


def _states(metric):
    return {k: getattr(metric, k) for k in metric._defaults}


@pytest.mark.parametrize("ignore", ["none", "minus-one"])
@pytest.mark.parametrize(
    "prefix, corpus_name, kwargs", MODULAR, ids=[f"{p}-{c}-{i}" for i, (p, c, _) in enumerate(MODULAR)]
)
def test_modular_stat_families_match_jax_over_batches(prefix, corpus_name, kwargs, ignore):
    """Each class streamed over every batch: the int32 states (list states
    for samplewise) equal after each update, then the values."""
    task, preds, target = CORPORA[corpus_name]
    ignore_index = IGNORES[ignore]
    target = _with_ignored(target, ignore_index, seed=1)
    kw = {"ignore_index": ignore_index, **_size_kw(task), **kwargs}
    ports = [getattr(cls, prefix + name)(device="cpu", **kw) for name in CLASSES]
    refs = [getattr(jax_cls, prefix + name)(**kw) for name in CLASSES]
    for i in range(preds.shape[0]):
        (tp, tt), (jp, jt) = _both(preds[i], target[i])
        for port, ref in zip(ports, refs):
            port.update(tp, tt)
            ref.update(jp, jt)
    for port, ref in zip(ports, refs):
        _assert_same(_states(port), _states(ref))
        _assert_same(port.compute(), ref.compute(), atol=ATOL)


def test_precision_recall_reduce_zero_division_matches_jax():
    """``zero_division`` fills 0/0 (a class never predicted, or never a
    target) in every average; the public functions keep its default 0."""
    tp = np.asarray([3, 0, 0, 5, 0], np.int32)
    fp = np.asarray([1, 0, 2, 0, 0], np.int32)
    fn_ = np.asarray([0, 4, 0, 1, 0], np.int32)
    tn = np.asarray([10, 10, 12, 8, 14], np.int32)
    port_args = [torch.from_numpy(x) for x in (tp, fp, tn, fn_)]
    jax_args = [jnp.asarray(x) for x in (tp, fp, tn, fn_)]
    for stat in ("precision", "recall"):
        for average in ("micro", "macro", "weighted", "none"):
            for zero_division in (0.0, 1.0):
                port = _precision_recall_reduce(stat, *port_args, average, zero_division=zero_division)
                ref = jax_precision_recall._precision_recall_reduce(
                    stat, *jax_args, average, zero_division=zero_division
                )
                _assert_same(port, ref, atol=ATOL)
        zeros = np.zeros(3, np.int32)
        port = _precision_recall_reduce(stat, *[torch.from_numpy(zeros)] * 4, "binary", zero_division=1.0)
        ref = jax_precision_recall._precision_recall_reduce(
            stat, *[jnp.asarray(zeros)] * 4, "binary", zero_division=1.0
        )
        _assert_same(port, ref)
        assert port.tolist() == [1.0, 1.0, 1.0]


# ------------------------------------------------------------------ exact match

EXACT = [
    ("multiclass-multidim", {}),
    ("multiclass-multidim", {"multidim_average": "samplewise"}),
    ("multilabel-probs", {}),
    ("multilabel-labels", {"threshold": 0.5}),
    ("multilabel-multidim", {}),
    ("multilabel-multidim", {"multidim_average": "samplewise"}),
]


def _label_multidim(preds):
    """A batch of the multiclass multidim corpus as label preds ``(N, E)``."""
    return np.argmax(preds, axis=1)


@pytest.mark.parametrize("ignore", list(IGNORES))
@pytest.mark.parametrize("corpus_name, kwargs", EXACT, ids=_case_ids(EXACT))
def test_exact_match_matches_jax(corpus_name, kwargs, ignore):
    """The functional dispatcher per batch, then the class streamed over
    every batch: int32 correct/total (a list state of per-sample values for
    samplewise) equal after each update, and the values. Ignored positions
    count as right through the mask, at -1 and at an in-range index."""
    task, preds, target = CORPORA[corpus_name]
    ignore_index = IGNORES[ignore]
    target = _with_ignored(target, ignore_index, seed=2)
    kw = {"ignore_index": ignore_index, **_size_kw(task), **kwargs}
    port = tpumetrics_torch.ExactMatch(task=task, device="cpu", **kw)
    ref = tpumetrics.ExactMatch(task=task, **kw)
    assert type(port).__name__ == type(ref).__name__
    for i in range(preds.shape[0]):
        for p in (preds[i], _label_multidim(preds[i])) if task == "multiclass" else (preds[i],):
            (tp, tt), (jp, jt) = _both(p, target[i])
            _assert_same(fn.exact_match(tp, tt, task=task, **kw), jax_fn.exact_match(jp, jt, task=task, **kw))
        (tp, tt), (jp, jt) = _both(preds[i], target[i])
        port.update(tp, tt)
        ref.update(jp, jt)
        _assert_same(_states(port), _states(ref))
    _assert_same(port.compute(), ref.compute())


def test_exact_match_total_is_made_on_the_device_of_the_batch():
    """The update's batch count is a tensor filled on the batch's device, int32."""
    from tpumetrics_torch.functional.classification.exact_match import _exact_match_update

    ones = torch.ones((6, 3), dtype=torch.int32)
    correct, total = _exact_match_update(ones, ones, ones)
    assert total.dtype == correct.dtype == torch.int32 and total.device == ones.device
    assert int(correct) == int(total) == 6


# ------------------------------------------------------ wrappers and groups

WRAPPERS = [
    ("Precision", "binary", {}, "BinaryPrecision"),
    ("Precision", "multiclass", {"num_classes": 3, "top_k": 2}, "MulticlassPrecision"),
    ("Recall", "multilabel", {"num_labels": 3, "average": "macro"}, "MultilabelRecall"),
    ("Specificity", "multiclass", {"num_classes": 3, "average": "weighted"}, "MulticlassSpecificity"),
    ("Specificity", "multilabel", {"num_labels": 3}, "MultilabelSpecificity"),
    ("HammingDistance", "binary", {"threshold": 0.25}, "BinaryHammingDistance"),
    ("HammingDistance", "multiclass", {"num_classes": 3}, "MulticlassHammingDistance"),
    ("ExactMatch", "multilabel", {"num_labels": 3}, "MultilabelExactMatch"),
]


@pytest.mark.parametrize(
    "wrapper, task, kwargs, concrete", WRAPPERS, ids=[f"{w}-{t}" for w, t, _, _ in WRAPPERS]
)
def test_task_wrappers_return_the_concrete_metric_of_the_jax_package(wrapper, task, kwargs, concrete):
    port = getattr(tpumetrics_torch, wrapper)(task=task, device="cpu", **kwargs)
    ref = getattr(tpumetrics, wrapper)(task=task, **kwargs)
    assert type(port) is getattr(cls, concrete) and type(ref).__name__ == concrete
    assert sorted(port._defaults) == sorted(ref._defaults)
    for name in ("threshold", "num_classes", "num_labels", "top_k", "average", "multidim_average"):
        if hasattr(ref, name):
            assert getattr(port, name) == getattr(ref, name), name


def test_wrappers_refuse_missing_sizes_and_unknown_tasks():
    with pytest.raises(ValueError, match="num_classes"):
        tpumetrics_torch.Precision(task="multiclass", device="cpu")
    with pytest.raises(ValueError, match="top_k"):
        tpumetrics_torch.Recall(task="multiclass", num_classes=3, top_k=None, device="cpu")
    with pytest.raises(ValueError, match="Invalid Classification"):
        tpumetrics_torch.ExactMatch(task="binary", device="cpu")
    with pytest.raises(ValueError, match="num_labels"):
        fn.specificity(torch.zeros(2, 3), torch.zeros(2, 3, dtype=torch.long), task="multilabel")


@pytest.mark.parametrize("task", ["binary", "multiclass", "multilabel"])
def test_new_members_join_the_f1_group_and_values_match_jax(task):
    """Precision, Recall, Specificity and HammingDistance of F1's ``average``
    hold its states and join its compute group; exact match leads its own."""
    name = f"{task}-probs" if task != "multiclass" else "multiclass-logits"
    _, preds, target = CORPORA[name]
    target = _with_ignored(target, -1, seed=3)
    kw = {"task": task, "ignore_index": -1, **_size_kw(task)}
    if task != "binary":
        kw["average"] = "macro"

    def members(pkg, **dev):
        out = {
            "f1": pkg.F1Score(**kw, **dev),
            "hamming": pkg.HammingDistance(**kw, **dev),
            "precision": pkg.Precision(**kw, **dev),
            "recall": pkg.Recall(**kw, **dev),
            "specificity": pkg.Specificity(**kw, **dev),
        }
        if task == "multilabel":
            out["exact"] = pkg.ExactMatch(**{k: v for k, v in kw.items() if k != "average"}, **dev)
        return out

    port = MetricCollection(members(tpumetrics_torch, device="cpu"), device="cpu")
    ref = tpumetrics.MetricCollection(members(tpumetrics))
    for i in range(preds.shape[0]):
        (tp, tt), (jp, jt) = _both(preds[i], target[i])
        port.update(tp, tt)
        ref.update(jp, jt)
    groups = [list(g) for g in port.compute_groups.values()]
    want = ([["exact"]] if task == "multilabel" else []) + [["f1", "hamming", "precision", "recall", "specificity"]]
    assert groups == want == [list(g) for g in ref.compute_groups.values()]
    _assert_same(port.compute(), ref.compute(), atol=ATOL)
