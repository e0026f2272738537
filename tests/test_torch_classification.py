"""Classification main path of the port held against the JAX package.

The same numpy inputs go through both packages. Integer states and counts
must be equal; float values agree within ``ATOL`` = 1e-6, the room that
float32 sums taken in another order need (the AUC trapezoid sums and the
weighted averages). Inputs are probabilities, so ``normalize_logits_if_needed``
is the identity on both sides and the binned counts are exact; logits go
through softmax, where the two frameworks differ in the last bits, and are
compared with their own stated tolerance.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpumetrics.classification as jax_cls
import tpumetrics.functional.classification as jax_fn
import tpumetrics_torch.classification as cls
import tpumetrics_torch.functional.classification as fn
from tpumetrics_torch.utils.data import dim_zero_cat

ATOL = 1e-6
C = 5
N = 48
T = 64
IGNORE = -1


def _probs(rng, shape):
    z = rng.standard_normal(shape).astype(np.float32) * 2
    e = np.exp(z - z.max(axis=1, keepdims=True))
    return (e / e.sum(axis=1, keepdims=True)).astype(np.float32)


def _batches(seed, nb=3, n=N, c=C, extra=(), ignore_index=None, labels=False, logits=False):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(nb):
        if labels:
            preds = rng.integers(0, c, (n, *extra))
        elif logits:
            preds = (rng.standard_normal((n, c, *extra)) * 3).astype(np.float32)
        else:
            preds = _probs(rng, (n, c, *extra))
        target = rng.integers(0, c, (n, *extra))
        if ignore_index is not None:
            target[rng.random(target.shape) < 0.2] = ignore_index
        out.append((preds, target))
    return out


def _assert_same(port, ref, atol=ATOL):
    """Port value (tensor / tuple / list / dict) against the JAX value."""
    if isinstance(ref, dict):
        assert sorted(port) == sorted(ref)
        for k in ref:
            _assert_same(port[k], ref[k], atol)
        return
    if isinstance(ref, (tuple, list)):
        assert len(port) == len(ref)
        for p, r in zip(port, ref):
            _assert_same(p, r, atol)
        return
    port_np = port.detach().cpu().numpy()
    ref_np = np.asarray(ref)
    assert port_np.shape == ref_np.shape
    if np.issubdtype(ref_np.dtype, np.integer):
        assert port_np.dtype == ref_np.dtype
        np.testing.assert_array_equal(port_np, ref_np)
    else:
        assert port_np.dtype == np.float32
        np.testing.assert_allclose(port_np, ref_np, rtol=0, atol=atol)


def _both(preds, target):
    return (torch.from_numpy(preds), torch.from_numpy(target)), (jnp.asarray(preds), jnp.asarray(target))


# ------------------------------------------------------------------ functional

FUNCTIONAL = [
    ("multiclass_accuracy", {"average": "micro"}),
    ("multiclass_accuracy", {"average": "macro"}),
    ("multiclass_accuracy", {"average": "weighted"}),
    ("multiclass_accuracy", {"average": "none"}),
    ("multiclass_accuracy", {"average": "macro", "top_k": 2}),
    ("multiclass_f1_score", {"average": "macro"}),
    ("multiclass_f1_score", {"average": "micro"}),
    ("multiclass_f1_score", {"average": "weighted"}),
    ("multiclass_f1_score", {"average": None}),
    ("multiclass_fbeta_score", {"beta": 2.0, "average": "macro"}),
    ("multiclass_stat_scores", {"average": "micro"}),
    ("multiclass_stat_scores", {"average": "macro"}),
    ("multiclass_stat_scores", {"average": "none", "top_k": 3}),
    ("multiclass_auroc", {"thresholds": T, "average": "macro"}),
    ("multiclass_auroc", {"thresholds": T, "average": "weighted"}),
    ("multiclass_auroc", {"thresholds": T, "average": "none"}),
    ("multiclass_auroc", {"thresholds": [0.0, 0.1, 0.25, 0.5, 0.75, 1.0]}),
    ("multiclass_precision_recall_curve", {"thresholds": T}),
    ("multiclass_precision_recall_curve", {"thresholds": T, "average": "micro"}),
    ("multiclass_precision_recall_curve", {"thresholds": T, "average": "macro"}),
    ("multiclass_roc", {"thresholds": T}),
    ("multiclass_roc", {"thresholds": T, "average": "micro"}),
    ("multiclass_roc", {"thresholds": 17, "average": "macro"}),
]


@pytest.mark.parametrize("ignore_index", [None, IGNORE], ids=["no-ignore", "ignore"])
@pytest.mark.parametrize("name, kwargs", FUNCTIONAL, ids=[f"{n}-{i}" for i, (n, _) in enumerate(FUNCTIONAL)])
def test_functional_matches_jax(name, kwargs, ignore_index):
    (preds, target), = _batches(1, nb=1, ignore_index=ignore_index)
    (tp, tt), (jp, jt) = _both(preds, target)
    port = getattr(fn, name)(tp, tt, num_classes=C, ignore_index=ignore_index, **kwargs)
    ref = getattr(jax_fn, name)(jp, jt, num_classes=C, ignore_index=ignore_index, **kwargs)
    _assert_same(port, ref)


@pytest.mark.parametrize(
    "name, kwargs",
    [
        ("multiclass_accuracy", {"average": "micro"}),
        ("multiclass_accuracy", {"average": "macro"}),
        ("multiclass_stat_scores", {"average": "none"}),
        ("multiclass_f1_score", {"average": "macro"}),
    ],
)
def test_functional_label_preds_match_jax(name, kwargs):
    (preds, target), = _batches(2, nb=1, labels=True, ignore_index=IGNORE)
    (tp, tt), (jp, jt) = _both(preds, target)
    port = getattr(fn, name)(tp, tt, num_classes=C, ignore_index=IGNORE, **kwargs)
    _assert_same(port, getattr(jax_fn, name)(jp, jt, num_classes=C, ignore_index=IGNORE, **kwargs))


@pytest.mark.parametrize("average", ["micro", "macro", "none"])
def test_functional_samplewise_stat_scores_match_jax(average):
    (preds, target), = _batches(3, nb=1, extra=(4,))
    (tp, tt), (jp, jt) = _both(preds, target)
    kw = {"num_classes": C, "average": average, "multidim_average": "samplewise"}
    _assert_same(fn.multiclass_stat_scores(tp, tt, **kw), jax_fn.multiclass_stat_scores(jp, jt, **kw))


@pytest.mark.parametrize(
    "name, kwargs",
    [
        ("multiclass_accuracy", {"average": "macro"}),
        ("multiclass_auroc", {"thresholds": T}),
        ("multiclass_precision_recall_curve", {"thresholds": 9, "average": "micro"}),
    ],
)
def test_functional_extra_dims_match_jax(name, kwargs):
    """(N, C, X) scores against (N, X) labels flatten the extra axis into samples."""
    (preds, target), = _batches(10, nb=1, extra=(3,), ignore_index=IGNORE)
    (tp, tt), (jp, jt) = _both(preds, target)
    port = getattr(fn, name)(tp, tt, num_classes=C, ignore_index=IGNORE, **kwargs)
    _assert_same(port, getattr(jax_fn, name)(jp, jt, num_classes=C, ignore_index=IGNORE, **kwargs))


def test_functional_out_of_range_labels_drop_like_jax():
    """Unvalidated labels outside [0, C) count nowhere, as the JAX one-hot matmul drops them."""
    preds = np.asarray([0, 1, C, 2, -3, 4, 1, 0])
    target = np.asarray([0, C + 2, 1, 2, 3, -1, 1, 4])
    (tp, tt), (jp, jt) = _both(preds, target)
    kw = {"num_classes": C, "average": "none", "validate_args": False}
    _assert_same(fn.multiclass_stat_scores(tp, tt, **kw), jax_fn.multiclass_stat_scores(jp, jt, **kw))


def test_functional_logits_match_jax_within_softmax_rounding():
    """Softmax differs in the last bits between torch and JAX, so a count can
    move across a threshold: values agree within 1e-3, not bit for bit."""
    (preds, target), = _batches(4, nb=1, n=256, logits=True)
    (tp, tt), (jp, jt) = _both(preds, target)
    for name, kw in [("multiclass_auroc", {"thresholds": T}), ("multiclass_accuracy", {})]:
        _assert_same(getattr(fn, name)(tp, tt, num_classes=C, **kw),
                     getattr(jax_fn, name)(jp, jt, num_classes=C, **kw), atol=1e-3)


def test_functional_validation_rejects_bad_targets():
    preds = torch.from_numpy(_probs(np.random.default_rng(0), (4, C)))
    with pytest.raises(RuntimeError):
        fn.multiclass_accuracy(preds, torch.tensor([0, 1, 2, C]), num_classes=C)
    with pytest.raises(RuntimeError):
        fn.multiclass_auroc(preds, torch.tensor([0, 1, -2, 1]), num_classes=C, thresholds=T)
    with pytest.raises(ValueError):
        fn.multiclass_auroc(preds, torch.tensor([0, 1, 2, 1]), num_classes=C, thresholds=1)


# ------------------------------------------------------------------- modular

MODULAR = [
    ("MulticlassAccuracy", {"average": "micro"}),
    ("MulticlassAccuracy", {"average": "macro"}),
    ("MulticlassF1Score", {"average": "macro"}),
    ("MulticlassFBetaScore", {"beta": 0.5, "average": "weighted"}),
    ("MulticlassStatScores", {"average": "none"}),
    ("MulticlassStatScores", {"average": "micro", "top_k": 2}),
    ("MulticlassPrecisionRecallCurve", {"thresholds": T}),
    ("MulticlassPrecisionRecallCurve", {"thresholds": T, "average": "micro"}),
    ("MulticlassAUROC", {"thresholds": T, "average": "macro"}),
    ("MulticlassAUROC", {"thresholds": T, "average": "weighted"}),
    ("MulticlassAUROC", {"thresholds": T, "average": "none"}),
]


def _states(metric):
    return {k: getattr(metric, k) for k in metric._defaults}


@pytest.mark.parametrize("ignore_index", [None, IGNORE], ids=["no-ignore", "ignore"])
@pytest.mark.parametrize("name, kwargs", MODULAR, ids=[f"{n}-{i}" for i, (n, _) in enumerate(MODULAR)])
def test_modular_matches_jax_over_batches(name, kwargs, ignore_index):
    port = getattr(cls, name)(num_classes=C, ignore_index=ignore_index, device="cpu", **kwargs)
    ref = getattr(jax_cls, name)(num_classes=C, ignore_index=ignore_index, **kwargs)
    batches = _batches(5, nb=4, ignore_index=ignore_index)
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

    port.reset()
    ref.reset()
    (tp, tt), (jp, jt) = _both(*batches[0])
    port.update(tp, tt)
    ref.update(jp, jt)
    _assert_same(port.compute(), ref.compute())


def test_modular_samplewise_list_states_match_jax():
    kw = {"num_classes": C, "average": "macro", "multidim_average": "samplewise"}
    port = cls.MulticlassStatScores(device="cpu", **kw)
    ref = jax_cls.MulticlassStatScores(**kw)
    batches = _batches(6, nb=3, extra=(3,))
    (tp, tt), (jp, jt) = _both(*batches[0])
    _assert_same(port(tp, tt), ref(jp, jt))
    for preds, target in batches[1:]:
        (tp, tt), (jp, jt) = _both(preds, target)
        port.update(tp, tt)
        ref.update(jp, jt)
    for name in ("tp", "fp", "tn", "fn"):
        assert len(getattr(port, name)) == len(getattr(ref, name)) == 3
        _assert_same(dim_zero_cat(getattr(port, name)), jnp.concatenate(getattr(ref, name)))
    _assert_same(port.compute(), ref.compute())


def test_modular_functional_bridge_matches_jax():
    port = cls.MulticlassAUROC(num_classes=C, thresholds=T, ignore_index=IGNORE, device="cpu")
    ref = jax_cls.MulticlassAUROC(num_classes=C, thresholds=T, ignore_index=IGNORE)
    pstate, rstate = port.init_state(), ref.init_state()
    for preds, target in _batches(7, nb=3, ignore_index=IGNORE):
        (tp, tt), (jp, jt) = _both(preds, target)
        pstate = port.functional_update(pstate, tp, tt)
        rstate = ref.functional_update(rstate, jp, jt)
    _assert_same(pstate, rstate)
    _assert_same(port.functional_compute(pstate), ref.functional_compute(rstate))
    (tp, tt), (jp, jt) = _both(*_batches(8, nb=1)[0])
    pnew, pval = port.functional_forward(pstate, tp, tt)
    rnew, rval = ref.functional_forward(rstate, jp, jt)
    _assert_same(pnew, rnew)
    _assert_same(pval, rval)
    assert port.update_count == 0  # the functional path leaves the object's state alone


def test_thresholds_live_on_the_metric_device():
    metric = cls.MulticlassPrecisionRecallCurve(num_classes=C, thresholds=T, device="cpu")
    assert metric.thresholds.device == metric.device == torch.device("cpu")
    np.testing.assert_array_equal(metric.thresholds.numpy(), np.asarray(jnp.linspace(0, 1, T)))
    assert metric.to("cpu") is metric and metric.thresholds.device.type == "cpu"


def test_modular_logits_match_jax_within_softmax_rounding():
    """See the functional logits test: 1e-3 covers a count moving across a threshold."""
    port = cls.MulticlassAUROC(num_classes=C, thresholds=T, device="cpu")
    ref = jax_cls.MulticlassAUROC(num_classes=C, thresholds=T)
    for preds, target in _batches(9, nb=2, n=128, logits=True):
        (tp, tt), (jp, jt) = _both(preds, target)
        port.update(tp, tt)
        ref.update(jp, jt)
    _assert_same(port.compute(), ref.compute(), atol=1e-3)
