"""The port's confusion-matrix family held against the JAX package.

The corpora are those of ``tests/classification/inputs.py``. Integer
matrices (``normalize=None``) must be equal, int32 on both sides; the
normalized float32 matrices agree within ``ATOL`` = 1e-6 (one float32
division each; they come out equal in practice). The multiclass count
(``_masked_confmat``, an int32 ``index_add_`` into a fixed buffer) is also
held bit for bit against a numpy count and the old ``torch.bincount`` at
C=1000 with ignored positions and out-of-range labels.
"""

import importlib

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
from tpumetrics_torch.functional.classification.stat_scores import _masked_confmat

jax_stat_scores = importlib.import_module("tpumetrics.functional.classification.stat_scores")

ATOL = 1e-6
C = corpus.NUM_CLASSES
NORMALIZE = [None, "true", "pred", "all"]
IGNORE = [None, -1]


def _with_ignored(target, ignore_index, seed=0):
    if ignore_index is None:
        return target
    target = target.copy()
    target[np.random.default_rng(seed).random(target.shape) < 0.15] = ignore_index
    return target


CORPORA = {
    "binary": {
        "probs": (corpus.binary_probs_preds, corpus.binary_target),
        "labels": (corpus.binary_label_preds, corpus.binary_target),
        "logits": (corpus.binary_logits_preds, corpus.binary_target),
        "multidim": (corpus.binary_md_probs_preds, corpus.binary_md_target),
    },
    "multiclass": {
        "logits": (corpus.multiclass_logits_preds, corpus.multiclass_target),
        "labels": (corpus.multiclass_label_preds, corpus.multiclass_target),
        "multidim": (corpus.multiclass_md_logits_preds, corpus.multiclass_md_target),
    },
    "multilabel": {
        "probs": (corpus.multilabel_probs_preds, corpus.multilabel_target),
        "labels": (corpus.multilabel_label_preds, corpus.multilabel_target),
        "multidim": (corpus.multilabel_md_probs_preds, corpus.multilabel_md_target),
    },
}
CASES = [(task, name) for task, corpora in CORPORA.items() for name in corpora]


def _size_kw(task):
    return {"num_classes": C} if task == "multiclass" else {"num_labels": C} if task == "multilabel" else {}


@pytest.mark.parametrize("ignore_index", IGNORE)
@pytest.mark.parametrize("normalize", NORMALIZE)
@pytest.mark.parametrize("task,corpus_name", CASES)
def test_functional_confusion_matrix_matches_jax(task, corpus_name, normalize, ignore_index):
    preds, target = CORPORA[task][corpus_name]
    target = _with_ignored(target, ignore_index)
    kw = {"task": task, "normalize": normalize, "ignore_index": ignore_index, **_size_kw(task)}
    for i in range(preds.shape[0]):
        (tp, tt), (jp, jt) = _both(preds[i], target[i])
        _assert_same(fn.confusion_matrix(tp, tt, **kw), jax_fn.confusion_matrix(jp, jt, **kw), atol=ATOL)


@pytest.mark.parametrize("ignore_index", IGNORE)
@pytest.mark.parametrize("task,corpus_name", CASES)
def test_modular_confusion_matrix_matches_jax(task, corpus_name, ignore_index):
    """Streamed over every batch: the int32 state exact after each update,
    then every ``normalize`` of the final state within ATOL."""
    preds, target = CORPORA[task][corpus_name]
    target = _with_ignored(target, ignore_index, seed=1)
    kw = {"ignore_index": ignore_index, **_size_kw(task)}
    metric = tpumetrics_torch.ConfusionMatrix(task=task, device="cpu", **kw)
    ref = getattr(jax_cls, type(metric).__name__)(**kw)
    for i in range(preds.shape[0]):
        (tp, tt), (jp, jt) = _both(preds[i], target[i])
        metric.update(tp, tt)
        ref.update(jp, jt)
        _assert_same(metric.confmat, ref.confmat)
    _assert_same(metric.compute(), ref.compute())
    for normalize in NORMALIZE[1:]:
        metric.normalize = ref.normalize = normalize
        metric._computed = None
        ref._computed = None
        _assert_same(metric.compute(), ref.compute(), atol=ATOL)


def test_task_wrapper_and_argument_checks():
    assert isinstance(cls.ConfusionMatrix(task="binary", device="cpu"), cls.BinaryConfusionMatrix)
    assert isinstance(cls.ConfusionMatrix(task="multiclass", num_classes=3, device="cpu"), cls.MulticlassConfusionMatrix)
    assert isinstance(cls.ConfusionMatrix(task="multilabel", num_labels=3, device="cpu"), cls.MultilabelConfusionMatrix)
    with pytest.raises(ValueError, match="normalize"):
        cls.MulticlassConfusionMatrix(3, normalize="rows", device="cpu")
    with pytest.raises(ValueError, match="num_classes"):
        cls.ConfusionMatrix(task="multiclass", device="cpu")
    # a computed matrix is not the state: it keeps its value across later updates
    metric = cls.MulticlassConfusionMatrix(3, device="cpu")
    metric.update(torch.tensor([0, 1, 2]), torch.tensor([0, 1, 1]))
    first = metric.compute()
    assert first is not metric.confmat and torch.equal(first, metric.confmat)


def test_masked_confmat_at_1000_classes_is_bit_identical_on_the_cpu():
    """Ignored positions and labels outside [0, C) count nowhere: the int32
    counts equal numpy's, the old ``torch.bincount``'s and the JAX package's
    one-hot matmul, element for element."""
    rng = np.random.default_rng(12)
    n, c = 20_000, 1000
    preds = rng.integers(-2, c + 2, n)
    target = rng.integers(-2, c + 2, n)
    target[rng.random(n) < 0.1] = -1  # ignore_index -1
    mask = (target != -1).astype(np.int32)
    got = _masked_confmat(torch.from_numpy(preds), torch.from_numpy(target), torch.from_numpy(mask), c)
    assert got.dtype == torch.int32 and got.shape == (c, c)

    keep = (mask == 1) & (preds >= 0) & (preds < c) & (target >= 0) & (target < c)
    want = np.bincount(target[keep] * c + preds[keep], minlength=c * c).reshape(c, c).astype(np.int32)
    np.testing.assert_array_equal(got.numpy(), want)

    idx = torch.from_numpy(np.where(keep, target * c + preds, c * c))
    old = torch.bincount(idx, minlength=c * c + 1)[:-1].reshape(c, c).to(torch.int32)
    assert torch.equal(got, old)

    ref = jax_stat_scores._masked_confmat(jnp.asarray(preds), jnp.asarray(target), jnp.asarray(mask), c)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
