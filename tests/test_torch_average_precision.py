"""The port's average-precision family held against the JAX package.

The corpora are those of ``tests/classification/inputs.py``; logits go
through the sigmoid or softmax of each package. Binned states (the
``(T, [C,] 2, 2)`` int32 confusion tensor) must be equal, and exact states
(the preds and targets kept for ``thresholds=None``) too. AP values agree
within ``ATOL`` = 1e-6: a float32 step sum over at most a few hundred
curve points, taken in another order, and for logits a softmax that the
two frameworks round differently in the last bit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpumetrics.classification as jax_cls
import tpumetrics.functional as jax_fn
import tpumetrics_torch
import tpumetrics_torch.classification as cls
import tpumetrics_torch.functional as fn
from tests.classification import inputs as corpus
from tests.test_torch_classification import _assert_same, _both
from tpumetrics_torch import MetricCollection
from tpumetrics_torch.utils.data import dim_zero_cat

ATOL = 1e-6
C = corpus.NUM_CLASSES
THRESHOLDS = [None, 16, [0.1, 0.25, 0.5, 0.75, 0.9]]


def _with_ignored(target, ignore_index, seed=0):
    if ignore_index is None:
        return target
    target = target.copy()
    target[np.random.default_rng(seed).random(target.shape) < 0.15] = ignore_index
    return target


CORPORA = {
    "binary": {
        "probs": (corpus.binary_probs_preds, corpus.binary_target),
        "logits": (corpus.binary_logits_preds, corpus.binary_target),
        "multidim": (corpus.binary_md_probs_preds, corpus.binary_md_target),
    },
    "multiclass": {
        "logits": (corpus.multiclass_logits_preds, corpus.multiclass_target),
        "multidim": (corpus.multiclass_md_logits_preds, corpus.multiclass_md_target),
    },
    "multilabel": {
        "probs": (corpus.multilabel_probs_preds, corpus.multilabel_target),
        "multidim": (corpus.multilabel_md_probs_preds, corpus.multilabel_md_target),
    },
}
AVERAGES = {"binary": [None], "multiclass": ["macro", "weighted", "none"], "multilabel": ["micro", "macro", "weighted", "none"]}
CASES = [(t, name, avg) for t, corpora in CORPORA.items() for name in corpora for avg in AVERAGES[t]]
# every case exact without ignored targets and binned with them; the exact
# path with ignored targets (which the JAX package runs with a compile per
# shape) for the first corpus and average of each task
MODES = [(None, None), (16, -1)]
EXACT_IGNORED = [(t, next(iter(c)), AVERAGES[t][0], None, -1) for t, c in CORPORA.items()]


def _kw(task, average):
    size = {"num_classes": C} if task == "multiclass" else {"num_labels": C} if task == "multilabel" else {}
    return {**size, **({"average": average} if task != "binary" else {})}


@pytest.mark.parametrize(
    "task,corpus_name,average,thresholds,ignore_index",
    [(*case, *mode) for case in CASES for mode in MODES]
    + EXACT_IGNORED
    + [("binary", "probs", None, THRESHOLDS[2], None), ("multiclass", "logits", "macro", THRESHOLDS[2], -1)],
)
def test_functional_average_precision_matches_jax(task, corpus_name, average, thresholds, ignore_index):
    preds, target = CORPORA[task][corpus_name]
    target = _with_ignored(target, ignore_index)
    kw = {"task": task, "thresholds": thresholds, "ignore_index": ignore_index, **_kw(task, average)}
    (tp, tt), (jp, jt) = _both(preds[0], target[0])
    _assert_same(fn.average_precision(tp, tt, **kw), jax_fn.average_precision(jp, jt, **kw), atol=ATOL)


@pytest.mark.parametrize(
    "task,corpus_name,average,thresholds,ignore_index", [(*case, *mode) for case in CASES for mode in MODES] + EXACT_IGNORED
)
def test_modular_average_precision_matches_jax(task, corpus_name, average, thresholds, ignore_index):
    """Streamed over every batch: states equal after each update (binned
    int32 counts exact, exact list states element for element), then the
    value within ATOL."""
    preds, target = CORPORA[task][corpus_name]
    target = _with_ignored(target, ignore_index, seed=1)
    kw = {"thresholds": thresholds, "ignore_index": ignore_index, **_kw(task, average)}
    metric = tpumetrics_torch.AveragePrecision(task=task, device="cpu", **kw)
    ref = getattr(jax_cls, type(metric).__name__)(**kw)
    for i in range(preds.shape[0]):
        (tp, tt), (jp, jt) = _both(preds[i], target[i])
        metric.update(tp, tt)
        ref.update(jp, jt)
        if thresholds is None:
            _assert_same(dim_zero_cat(metric.preds), jnp.concatenate(ref.preds))
            _assert_same(dim_zero_cat(metric.target), jnp.concatenate(ref.target))
        else:
            _assert_same(metric.confmat, ref.confmat)
    _assert_same(metric.compute(), ref.compute(), atol=ATOL)


def test_ap_shares_the_auroc_compute_group_and_the_wrapper_dispatches():
    """A binned AP and a binned AUROC of the same thresholds hold the same
    state: one compute group, one update, one kernel call on a card."""
    rng = np.random.default_rng(4)
    col = MetricCollection(
        {
            "auroc": cls.MulticlassAUROC(C, thresholds=16, device="cpu"),
            "ap": cls.MulticlassAveragePrecision(C, thresholds=16, device="cpu"),
        },
        device="cpu",
    )
    for _ in range(2):
        z = rng.random((24, C)).astype(np.float32)
        col.update(torch.from_numpy(z / z.sum(1, keepdims=True)), torch.from_numpy(rng.integers(0, C, 24)))
    assert [sorted(g) for g in col.compute_groups.values()] == [["ap", "auroc"]]
    assert isinstance(cls.AveragePrecision(task="binary", device="cpu"), cls.BinaryAveragePrecision)
    assert isinstance(cls.AveragePrecision(task="multilabel", num_labels=3, device="cpu"), cls.MultilabelAveragePrecision)
    with pytest.raises(ValueError, match="average"):
        cls.MulticlassAveragePrecision(3, average="micro", device="cpu")
