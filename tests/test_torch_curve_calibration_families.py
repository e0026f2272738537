"""The port's specificity at a fixed sensitivity, hinge loss and calibration
error held against the JAX package.

The corpora are those of ``tests/classification/inputs.py`` (through
``tests/test_torch_confmat_families.py``). Tolerances:

- Specificity at sensitivity: exact, values and thresholds. The binned
  state is the int32 curve tensor, equal in both packages; the reduction
  is a masked ``argmax`` (first index) over the ROC curve, and the port's
  batched form over all classes of a binned state must give the JAX
  per-class loop's values bit for bit.
- Hinge loss: the int32 totals exact; the float32 sums of the measures and
  the values within ``RTOL`` = 1e-6 relative (float32 sums in another
  order; a softmax of logits differs from XLA's in the last bits).
- Calibration error: list states (float32 confidences and accuracies)
  equal element for element on probability inputs; values within ``ATOL`` =
  1e-6 absolute (per-bin float32 sums in another order).
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
from tests.test_torch_confmat_families import CORPORA, IGNORES, POINT_CASES, POINT_IDS, _size_kw, _with_ignored
from tpumetrics.ops import binned_confusion_fused as jax_binned_confusion_fused
from tpumetrics_torch import MetricCollection
from tpumetrics_torch.functional.classification import specificity_sensitivity as port_sas
from tpumetrics_torch.functional.classification.calibration_error import _ce_compute
from tpumetrics_torch.functional.classification.precision_recall_curve import (
    _adjust_threshold_arg,
    _multiclass_precision_recall_curve_update,
)

jax_sas = importlib.import_module("tpumetrics.functional.classification.specificity_sensitivity")
jax_ce = importlib.import_module("tpumetrics.functional.classification.calibration_error")

ATOL = 1e-6
RTOL = 1e-6
C = corpus.NUM_CLASSES


def _rel(port, ref):
    port_np, ref_np = port.detach().cpu().numpy(), np.asarray(ref)
    assert port_np.shape == ref_np.shape and port_np.dtype == np.float32
    np.testing.assert_allclose(port_np, ref_np, rtol=RTOL, atol=1e-7)


def _states(metric):
    return {k: getattr(metric, k) for k in metric._defaults}


def _ignored_every(target, ignore_index, k=7):
    """``target`` with every k-th entry of each batch set to ``ignore_index``:
    the same positions in every batch, so the JAX package, which drops
    ignored entries by boolean indexing, sees one kept size per input shape
    and compiles its ops once, where a random mask compiles them per batch."""
    if ignore_index is None:
        return target
    target = target.copy()
    target.reshape(target.shape[0], -1)[:, ::k] = ignore_index
    return target


# ------------------------------------------------ specificity at sensitivity


@pytest.mark.parametrize("corpus_name, thresholds, ignore", POINT_CASES, ids=POINT_IDS)
def test_functional_specificity_at_sensitivity_matches_jax(corpus_name, thresholds, ignore):
    """Binned and exact curves of every task, at a middle and the top operating point, on one batch."""
    task, preds, target = CORPORA[corpus_name]
    ignore_index = IGNORES[ignore]
    target = _ignored_every(target, ignore_index)
    kw = {"thresholds": thresholds, "ignore_index": ignore_index, **_size_kw(task)}
    (tp, tt), (jp, jt) = _both(preds[0], target[0])
    for value in (0.5, 1.0):
        port = getattr(fn, f"{task}_specificity_at_sensitivity")(tp, tt, min_sensitivity=value, **kw)
        ref = getattr(jax_fn, f"{task}_specificity_at_sensitivity")(jp, jt, min_sensitivity=value, **kw)
        _assert_same(port, ref, atol=0)


@pytest.mark.parametrize("corpus_name, thresholds, ignore", POINT_CASES, ids=POINT_IDS)
def test_modular_specificity_at_sensitivity_matches_jax_over_batches(corpus_name, thresholds, ignore):
    """Streamed over every batch: the binned int32 curve tensor (or the exact
    list states) equal, then the values and thresholds, exactly."""
    task, preds, target = CORPORA[corpus_name]
    ignore_index = IGNORES[ignore]
    target = _ignored_every(target, ignore_index)
    name = f"{task.capitalize()}SpecificityAtSensitivity"
    kw = {"min_sensitivity": 0.5, "thresholds": thresholds, "ignore_index": ignore_index, **_size_kw(task)}
    port, ref = getattr(cls, name)(device="cpu", **kw), getattr(jax_cls, name)(**kw)
    for i in range(preds.shape[0]):
        (tp, tt), (jp, jt) = _both(preds[i], target[i])
        port.update(tp, tt)
        ref.update(jp, jt)
    _assert_same(_states(port), _states(ref))
    _assert_same(port.compute(), ref.compute(), atol=0)


def test_batched_specificity_at_sensitivity_equals_the_jax_per_class_loop():
    """On binned states the port reduces all classes at once; the JAX package
    loops over them. Same int32 state in, bit for bit the same values and
    thresholds out, at operating points from 0 to 1: with a class that never
    occurs (no valid point above 0), one whose best specificity is 0, and
    thresholds with duplicates (tied points: the first index wins)."""
    rng = np.random.default_rng(12)
    n, c = 400, 7
    preds = rng.random((n, c)).astype(np.float32)
    preds[:, 5] = 1.0  # every sample above every threshold: specificity 0 at every point
    target = rng.integers(0, c - 1, n)  # class 6 never occurs
    target[rng.random(n) < 0.1] = -1
    grids = (np.linspace(0, 1, 25, dtype=np.float32), np.asarray([0.9, 0.05, 0.5, 0.5, 0.3, 0.3], np.float32))
    for thresholds in grids:
        thr = torch.from_numpy(thresholds)
        state = _multiclass_precision_recall_curve_update(
            torch.from_numpy(preds), torch.from_numpy(target), c, thr, None, -1
        )
        jstate, jthr = jnp.asarray(state.numpy()), jnp.asarray(thresholds)
        for value in (0.0, 0.2, 0.5, 0.75, 0.95, 1.0):
            got = port_sas._multiclass_specificity_at_sensitivity_compute(state, c, thr, value)
            want = jax_sas._multiclass_specificity_at_sensitivity_compute(jstate, c, jthr, value)
            for g, w in zip(got, want):
                assert g.dtype == torch.float32
                np.testing.assert_array_equal(g.numpy(), np.asarray(w))
            got = port_sas._multilabel_specificity_at_sensitivity_compute(state, c, thr, -1, value)
            want = jax_sas._multilabel_specificity_at_sensitivity_compute(jstate, c, jthr, -1, value)
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_specificity_at_sensitivity_is_not_the_lexicographic_maximum():
    """Where the best specificity is 0 the threshold is that point's, not
    1e6, and among tied specificities the first point wins, with no
    tie-break on sensitivity: the JAX rule, which the port's
    ``_lexmax_constrained`` of recall at a fixed precision does not follow."""
    spec = torch.tensor([[0.0, 0.0, 0.0], [0.5, 0.5, 0.25]])
    sens = torch.tensor([[1.0, 0.9, 0.8], [0.6, 1.0, 1.0]])
    thr = torch.tensor([0.2, 0.5, 0.8])
    got = port_sas._specificity_at_sensitivity(spec, sens, thr, 0.5)
    want = [jax_sas._specificity_at_sensitivity(jnp.asarray(s), jnp.asarray(e), jnp.asarray(thr.numpy()), 0.5)
            for s, e in zip(spec.numpy(), sens.numpy())]
    np.testing.assert_array_equal(got[0].numpy(), [float(w[0]) for w in want])
    np.testing.assert_array_equal(got[1].numpy(), [float(w[1]) for w in want])
    np.testing.assert_array_equal(got[1].numpy(), np.asarray([0.2, 0.2], np.float32))


def test_specificity_at_sensitivity_binned_counts_match_the_pallas_kernel_in_interpret_mode():
    """The binned state counts what the JAX Pallas kernel counts (interpret
    mode) on the same batch, ignored targets out of every count; the values
    then equal the JAX package's."""
    preds = corpus.multilabel_probs_preds[1]
    target = _with_ignored(corpus.multilabel_target[1], -1, seed=6)
    metric = cls.MultilabelSpecificityAtSensitivity(C, min_sensitivity=0.5, thresholds=16, ignore_index=-1, device="cpu")
    metric.update(torch.from_numpy(preds), torch.from_numpy(target))
    valid = (target != -1).astype(np.float32)
    y = (target == 1).astype(np.float32) * valid
    tp, predpos = jax_binned_confusion_fused(
        *(jnp.asarray(x) for x in (preds, y, valid, np.linspace(0, 1, 16, dtype=np.float32))), interpret=True
    )
    np.testing.assert_array_equal(metric.confmat[:, :, 1, 1].numpy(), np.asarray(tp))
    np.testing.assert_array_equal((metric.confmat[:, :, 0, 1] + metric.confmat[:, :, 1, 1]).numpy(), np.asarray(predpos))
    ref = jax_cls.MultilabelSpecificityAtSensitivity(C, min_sensitivity=0.5, thresholds=16, ignore_index=-1)
    ref.update(jnp.asarray(preds), jnp.asarray(target))
    _assert_same(metric.compute(), ref.compute(), atol=0)


@pytest.mark.parametrize("task", ["binary", "multiclass", "multilabel"])
def test_specificity_at_sensitivity_joins_the_auroc_group_and_matches_jax(task):
    """A binned member holds the binned AUROC's state: one compute group, as in the JAX package."""
    name = {"binary": "binary-probs", "multiclass": "multiclass-probs", "multilabel": "multilabel-probs"}[task]
    _, preds, target = CORPORA[name]
    target = _with_ignored(target, -1, seed=5)
    kw = {"task": task, "ignore_index": -1, "thresholds": 16, **_size_kw(task)}

    def members(pkg, **dev):
        return {
            "auroc": pkg.AUROC(**kw, **dev),
            "sas": pkg.SpecificityAtSensitivity(min_sensitivity=0.5, **kw, **dev),
            "sas_low": pkg.SpecificityAtSensitivity(min_sensitivity=0.1, **kw, **dev),
        }

    port = MetricCollection(members(tpumetrics_torch, device="cpu"), device="cpu")
    ref = tpumetrics.MetricCollection(members(tpumetrics))
    for i in range(preds.shape[0]):
        (tp, tt), (jp, jt) = _both(preds[i], target[i])
        port.update(tp, tt)
        ref.update(jp, jt)
    groups = [list(g) for g in port.compute_groups.values()]
    assert groups == [["auroc", "sas", "sas_low"]] == [list(g) for g in ref.compute_groups.values()]
    got, want = port.compute(), ref.compute()
    _assert_same(got["sas"], want["sas"], atol=0)
    _assert_same(got["sas_low"], want["sas_low"], atol=0)
    _assert_same(got["auroc"], want["auroc"], atol=ATOL)


# ---------------------------------------------------------------- hinge loss

HINGE_CORPORA = {
    "binary-probs": ("binary", corpus.binary_probs_preds, corpus.binary_target),
    "binary-logits": ("binary", corpus.binary_logits_preds, corpus.binary_target),
    "binary-multidim": ("binary", corpus.binary_md_probs_preds, corpus.binary_md_target),
    "multiclass-logits": CORPORA["multiclass-logits"],
    "multiclass-probs": CORPORA["multiclass-probs"],
    "multiclass-multidim": CORPORA["multiclass-multidim"],
}


@pytest.mark.parametrize("ignore", list(IGNORES))
@pytest.mark.parametrize("corpus_name", list(HINGE_CORPORA))
def test_functional_hinge_loss_matches_jax(corpus_name, ignore):
    """Squared or not (crammer-singer and one-vs-all for multiclass), through
    the dispatcher, on one batch; ignored entries masked in the port,
    dropped in the JAX package."""
    task, preds, target = HINGE_CORPORA[corpus_name]
    ignore_index = IGNORES[ignore]
    target = _ignored_every(target, ignore_index)
    (tp, tt), (jp, jt) = _both(preds[0], target[0])
    modes = ["crammer-singer", "one-vs-all"] if task == "multiclass" else ["crammer-singer", "crammer-singer"]
    for squared, mode in zip((False, True), modes):
        kw = {"task": task, "squared": squared, "multiclass_mode": mode, "ignore_index": ignore_index,
              **({"num_classes": C} if task == "multiclass" else {})}
        _rel(fn.hinge_loss(tp, tt, **kw), jax_fn.hinge_loss(jp, jt, **kw))


HINGE_MODULAR = [
    ("binary-probs", "BinaryHingeLoss", {}),
    ("binary-logits", "BinaryHingeLoss", {"squared": True}),
    ("binary-multidim", "BinaryHingeLoss", {}),
    ("multiclass-logits", "MulticlassHingeLoss", {}),
    ("multiclass-probs", "MulticlassHingeLoss", {"multiclass_mode": "one-vs-all", "squared": True}),
    ("multiclass-multidim", "MulticlassHingeLoss", {"multiclass_mode": "one-vs-all"}),
]


@pytest.mark.parametrize("ignore", list(IGNORES))
@pytest.mark.parametrize("corpus_name, name, kwargs", HINGE_MODULAR, ids=[f"{n}-{c}" for c, n, _ in HINGE_MODULAR])
def test_modular_hinge_loss_matches_jax_over_batches(corpus_name, name, kwargs, ignore):
    """Streamed over two batches: the int32 total exact after each update
    (counted from the mask), the measures and the value within RTOL."""
    task, preds, target = HINGE_CORPORA[corpus_name]
    ignore_index = IGNORES[ignore]
    target = _ignored_every(target, ignore_index)
    kw = {"ignore_index": ignore_index, **({"num_classes": C} if task == "multiclass" else {}), **kwargs}
    port, ref = getattr(cls, name)(device="cpu", **kw), getattr(jax_cls, name)(**kw)
    for i in range(2):
        (tp, tt), (jp, jt) = _both(preds[i], target[i])
        port.update(tp, tt)
        ref.update(jp, jt)
        _assert_same(port.total, ref.total)
        _rel(port.measures, ref.measures)
    _rel(port.compute(), ref.compute())


def test_hinge_loss_batch_count_is_filled_on_the_device_and_ignored_entries_count_nothing():
    """The count is a tensor made on the metric's device from the shape (no
    host copy of a Python int), and a batch of only ignored entries adds a
    zero measure and a zero count."""
    metric = cls.MulticlassHingeLoss(3, ignore_index=-1, device="cpu")
    metric.update(torch.tensor([[0.2, 0.3, 0.5], [0.6, 0.3, 0.1]]), torch.tensor([2, -1]))
    metric.update(torch.tensor([[5.0, -1.0, 0.0]]), torch.tensor([-1]))
    assert metric.total.dtype == torch.int32 and int(metric.total) == 1
    ref = jax_cls.MulticlassHingeLoss(3, ignore_index=-1)
    ref.update(jnp.asarray([[0.2, 0.3, 0.5], [0.6, 0.3, 0.1]]), jnp.asarray([2, -1]))
    _rel(metric.compute(), ref.compute())


# ------------------------------------------------------------ calibration error

CE_CORPORA = {
    "binary-probs": HINGE_CORPORA["binary-probs"],
    "binary-logits": HINGE_CORPORA["binary-logits"],
    "binary-multidim": HINGE_CORPORA["binary-multidim"],
    "multiclass-probs": CORPORA["multiclass-probs"],
    "multiclass-multidim-probs": CORPORA["multiclass-multidim-probs"],
    "multiclass-logits": CORPORA["multiclass-logits"],
}


@pytest.mark.parametrize("ignore", list(IGNORES))
@pytest.mark.parametrize("corpus_name", list(CE_CORPORA))
def test_functional_calibration_error_matches_jax(corpus_name, ignore):
    """Every norm (l1 at 15 bins, l2 at 3, max at 1), through the dispatcher, on one batch."""
    task, preds, target = CE_CORPORA[corpus_name]
    ignore_index = IGNORES[ignore]
    target = _ignored_every(target, ignore_index)
    (tp, tt), (jp, jt) = _both(preds[0], target[0])
    for norm, n_bins in (("l1", 15), ("l2", 3), ("max", 1)):
        kw = {"task": task, "n_bins": n_bins, "norm": norm, "ignore_index": ignore_index,
              **({"num_classes": C} if task == "multiclass" else {})}
        _assert_same(fn.calibration_error(tp, tt, **kw), jax_fn.calibration_error(jp, jt, **kw), atol=ATOL)


CE_MODULAR = [
    ("binary-probs", "BinaryCalibrationError", {"n_bins": 15}),
    ("binary-multidim", "BinaryCalibrationError", {"n_bins": 4, "norm": "max"}),
    ("multiclass-probs", "MulticlassCalibrationError", {"n_bins": 15}),
    ("multiclass-multidim-probs", "MulticlassCalibrationError", {"n_bins": 10, "norm": "l2"}),
]


@pytest.mark.parametrize("ignore", list(IGNORES))
@pytest.mark.parametrize("corpus_name, name, kwargs", CE_MODULAR, ids=[f"{n}-{c}" for c, n, _ in CE_MODULAR])
def test_modular_calibration_error_matches_jax_over_batches(corpus_name, name, kwargs, ignore):
    """Streamed over two batches: the list states element for element the
    JAX package's (ignored entries dropped in both), the value within ATOL."""
    task, preds, target = CE_CORPORA[corpus_name]
    ignore_index = IGNORES[ignore]
    target = _ignored_every(target, ignore_index)
    kw = {"ignore_index": ignore_index, **({"num_classes": C} if task == "multiclass" else {}), **kwargs}
    port, ref = getattr(cls, name)(device="cpu", **kw), getattr(jax_cls, name)(**kw)
    for i in range(2):
        (tp, tt), (jp, jt) = _both(preds[i], target[i])
        port.update(tp, tt)
        ref.update(jp, jt)
    _assert_same(_states(port), _states(ref), atol=0)
    _assert_same(port.compute(), ref.compute(), atol=ATOL)


def test_calibration_bin_edges_are_the_jax_linspace_bit_for_bit():
    """The edges of 1 to 20 bins and of a few wider grids are ``jnp.linspace(0, 1, n_bins + 1)`` to the last bit."""
    for n_bins in [*range(1, 21), 50, 99, 100, 128, 200]:
        want = np.asarray(jnp.linspace(0, 1, n_bins + 1, dtype=jnp.float32))
        np.testing.assert_array_equal(_adjust_threshold_arg(n_bins + 1).numpy(), want)


@pytest.mark.parametrize("n_bins", [1, 3, 15, 100])
def test_confidences_on_bin_edges_fall_in_the_jax_bins(n_bins):
    """A confidence on an edge, or one ulp either side of it, falls in the JAX package's bin."""
    edges = np.asarray(jnp.linspace(0, 1, n_bins + 1, dtype=jnp.float32))
    conf = np.concatenate([edges, np.nextafter(edges, 2), np.nextafter(edges, -1)]).clip(0, 1).astype(np.float32)
    acc = (np.arange(conf.size) % 2).astype(np.float32)
    for norm in ("l1", "max"):
        got = _ce_compute(torch.from_numpy(conf), torch.from_numpy(acc), n_bins, norm)
        ref = jax_ce._ce_compute(jnp.asarray(conf), jnp.asarray(acc), n_bins, norm)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=ATOL)


def test_debiased_l2_calibration_error_matches_jax():
    """``debias`` of the l2 norm, with empty bins and a bin of one sample."""
    rng = np.random.default_rng(13)
    conf = np.concatenate([rng.random(300) * 0.5, [0.97]]).astype(np.float32)
    acc = (rng.random(conf.size) < conf).astype(np.float32)
    for n_bins in (4, 15):
        got = _ce_compute(torch.from_numpy(conf), torch.from_numpy(acc), n_bins, "l2", debias=True)
        ref = jax_ce._ce_compute(jnp.asarray(conf), jnp.asarray(acc), n_bins, "l2", debias=True)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=ATOL)


# ------------------------------------------------------ wrappers and arguments

WRAPPERS = [
    ("SpecificityAtSensitivity", "binary", {"min_sensitivity": 0.5}, "BinarySpecificityAtSensitivity"),
    ("SpecificityAtSensitivity", "multiclass", {"num_classes": 3, "min_sensitivity": 0.5, "thresholds": 8},
     "MulticlassSpecificityAtSensitivity"),
    ("SpecificityAtSensitivity", "multilabel", {"num_labels": 3, "min_sensitivity": 0.5},
     "MultilabelSpecificityAtSensitivity"),
    ("HingeLoss", "binary", {"squared": True}, "BinaryHingeLoss"),
    ("HingeLoss", "multiclass", {"num_classes": 3, "multiclass_mode": "one-vs-all"}, "MulticlassHingeLoss"),
    ("CalibrationError", "binary", {"n_bins": 10, "norm": "max"}, "BinaryCalibrationError"),
    ("CalibrationError", "multiclass", {"num_classes": 3, "norm": "l2"}, "MulticlassCalibrationError"),
]


@pytest.mark.parametrize("wrapper, task, kwargs, concrete", WRAPPERS, ids=[f"{w}-{t}" for w, t, _, _ in WRAPPERS])
def test_task_wrappers_return_the_concrete_metric_of_the_jax_package(wrapper, task, kwargs, concrete):
    port = getattr(tpumetrics_torch, wrapper)(task=task, device="cpu", **kwargs)
    ref = getattr(tpumetrics, wrapper)(task=task, **kwargs)
    assert type(port) is getattr(cls, concrete) and type(ref).__name__ == concrete
    assert sorted(port._defaults) == sorted(ref._defaults)
    for name in ("num_classes", "num_labels", "min_sensitivity", "squared", "multiclass_mode", "n_bins", "norm"):
        if hasattr(ref, name):
            assert getattr(port, name) == getattr(ref, name), name
    for name, default in port._defaults.items():
        ref_default = ref._defaults[name]
        if isinstance(ref_default, list):
            assert default == []
        else:
            assert default.shape == ref_default.shape and str(default.dtype).split(".")[-1] == str(ref_default.dtype)


def test_wrappers_and_arguments_refused_like_jax():
    with pytest.raises(ValueError, match="Invalid Classification"):
        tpumetrics_torch.HingeLoss(task="multilabel", device="cpu")
    with pytest.raises(ValueError, match="Invalid Classification"):
        tpumetrics_torch.CalibrationError(task="multilabel", device="cpu")
    with pytest.raises(ValueError, match="min_sensitivity"):
        cls.BinarySpecificityAtSensitivity(min_sensitivity=1.5, device="cpu")
    with pytest.raises(ValueError, match="multiclass_mode"):
        cls.MulticlassHingeLoss(3, multiclass_mode="one-vs-one", device="cpu")
    with pytest.raises(ValueError, match="squared"):
        cls.BinaryHingeLoss(squared=1, device="cpu")
    with pytest.raises(ValueError, match="n_bins"):
        cls.BinaryCalibrationError(n_bins=0, device="cpu")
    with pytest.raises(ValueError, match="norm"):
        cls.MulticlassCalibrationError(3, norm="l3", device="cpu")
    with pytest.raises(ValueError, match="num_classes"):
        tpumetrics_torch.HingeLoss(task="multiclass", device="cpu")
    with pytest.raises(ValueError, match="num_labels"):
        tpumetrics_torch.SpecificityAtSensitivity(task="multilabel", min_sensitivity=0.5, device="cpu")
