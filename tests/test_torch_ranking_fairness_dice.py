"""The port's multilabel ranking metrics, group fairness and Dice held
against the JAX package, and the new members of this slice together in
``MetricCollection``s.

Tolerances:

- Ranking (coverage error, label ranking average precision, label ranking
  loss): the int32 totals exact; the float32 score sums and the values
  within ``RTOL`` = 1e-6 relative (per-row float32 sums in another order).
  The ranking loss ranks with stable argsorts, so tied preds give the JAX
  package's loss.
- Group fairness: the int32 per-group tp/fp/tn/fn exact (an ``index_add_``
  histogram in the port, an int32 one-hot product in the JAX package), the
  rates and ratios within ``ATOL`` = 1e-6, the result keys equal.
- Dice: the float32 tp/fp/fn states bit for bit (integer counts cast and
  added in the same order), the values within ``ATOL``.
"""

import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpumetrics
import tpumetrics.classification as jax_cls
import tpumetrics.functional as jax_fn
import tpumetrics_torch.classification as cls
import tpumetrics_torch.functional as fn
from tests.classification import inputs as corpus
from tests.test_torch_classification import _assert_same, _both
from tests.test_torch_confmat_families import CORPORA, IGNORES, _with_ignored
from tests.test_torch_curve_calibration_families import RTOL, _rel
from tpumetrics_torch import MetricCollection
from tpumetrics_torch.functional.classification.group_fairness import _binary_groups_stat_scores

ATOL = 1e-6
C = corpus.NUM_CLASSES
RANKING = ["coverage_error", "ranking_average_precision", "ranking_loss"]
RANKING_CLASSES = ["MultilabelCoverageError", "MultilabelRankingAveragePrecision", "MultilabelRankingLoss"]


def _edge_rows(seed, n=48, labels=C):
    """Multilabel preds on a grid of quarters (many ties) with rows of no
    relevant label, of every label relevant, and of all-tied preds."""
    rng = np.random.default_rng(seed)
    preds = (rng.integers(0, 5, (n, labels)) / 4).astype(np.float32)
    target = rng.integers(0, 2, (n, labels))
    target[0], target[1], target[2] = 0, 1, 1
    preds[2] = 0.5
    target[3, 0], target[3, 1:] = 1, 0
    return preds, target


RANKING_CORPORA = {
    "probs": (corpus.multilabel_probs_preds, corpus.multilabel_target),
    "multidim": (corpus.multilabel_md_probs_preds, corpus.multilabel_md_target),
    "logits": (corpus.multiclass_logits_preds, corpus.multilabel_target),
    "ties-and-edge-rows": tuple(np.stack(x) for x in zip(*(_edge_rows(s) for s in range(4)))),
}


# ------------------------------------------------------------------- ranking


@pytest.mark.parametrize("ignore", list(IGNORES))
@pytest.mark.parametrize("corpus_name", list(RANKING_CORPORA))
def test_functional_ranking_matches_jax(corpus_name, ignore):
    """All three ranking metrics on one batch: probabilities, (N, L, X)
    inputs, logits (a sigmoid first), and tied preds with rows of no
    relevant label and of every label relevant; ``ignore_index`` None, -1
    and in range (0: the zero targets ignored)."""
    preds, target = RANKING_CORPORA[corpus_name]
    ignore_index = IGNORES[ignore]
    target = _with_ignored(target, ignore_index)
    (tp, tt), (jp, jt) = _both(preds[0], target[0])
    for name in RANKING:
        port = getattr(fn, f"multilabel_{name}")(tp, tt, num_labels=C, ignore_index=ignore_index)
        ref = getattr(jax_fn, f"multilabel_{name}")(jp, jt, num_labels=C, ignore_index=ignore_index)
        _rel(port, ref)


@pytest.mark.parametrize("ignore", list(IGNORES))
@pytest.mark.parametrize("corpus_name", list(RANKING_CORPORA))
def test_modular_ranking_matches_jax_over_batches(corpus_name, ignore):
    """Streamed over two batches: the int32 totals exact after each update,
    the score sums and the values within RTOL."""
    preds, target = RANKING_CORPORA[corpus_name]
    ignore_index = IGNORES[ignore]
    target = _with_ignored(target, ignore_index, seed=1)
    pairs = [(getattr(cls, n)(C, ignore_index=ignore_index, device="cpu"), getattr(jax_cls, n)(C, ignore_index=ignore_index))
             for n in RANKING_CLASSES]
    for i in range(2):
        (tp, tt), (jp, jt) = _both(preds[i], target[i])
        for port, ref in pairs:
            port.update(tp, tt)
            ref.update(jp, jt)
            _assert_same(port.total, ref.total)
            _rel(port.score, ref.score)
    for port, ref in pairs:
        _rel(port.compute(), ref.compute())


def test_ranking_loss_on_tied_preds_needs_the_stable_sort():
    """Rows of tied preds: the stable double argsort gives the JAX package's
    loss exactly, where the loss of an unstable sort's ranks would differ."""
    preds = np.asarray([[0.5, 0.5, 0.5, 0.5, 0.2], [0.1, 0.7, 0.7, 0.7, 0.1], [0.3] * 5], np.float32)
    target = np.asarray([[0, 1, 0, 1, 1], [1, 0, 1, 0, 1], [1, 0, 0, 1, 0]])
    (tp, tt), (jp, jt) = _both(preds, target)
    port = fn.multilabel_ranking_loss(tp, tt, num_labels=5)
    ref = jax_fn.multilabel_ranking_loss(jp, jt, num_labels=5)
    np.testing.assert_array_equal(port.numpy(), np.asarray(ref))
    assert float(port) > 0


def test_ranking_counts_rows_with_no_or_every_label_relevant():
    """Such rows score 1 (average precision) or 0 (loss) and still count, in both packages."""
    preds = np.asarray([[0.9, 0.1, 0.4], [0.2, 0.3, 0.1], [0.5, 0.6, 0.7]], np.float32)
    target = np.asarray([[0, 0, 0], [1, 1, 1], [1, 0, 0]])
    (tp, tt), (jp, jt) = _both(preds, target)
    for name in RANKING:
        port = getattr(fn, f"multilabel_{name}")(tp, tt, num_labels=3)
        ref = getattr(jax_fn, f"multilabel_{name}")(jp, jt, num_labels=3)
        np.testing.assert_allclose(port.numpy(), np.asarray(ref), rtol=RTOL)
    metric = cls.MultilabelRankingLoss(3, device="cpu")
    metric.update(tp, tt)
    assert int(metric.total) == 3


# ------------------------------------------------------------ group fairness

G = 3


def _groups(seed, shape, num_groups=G):
    return np.random.default_rng(seed).integers(0, num_groups, shape)


FAIRNESS_CORPORA = {
    "probs": (corpus.binary_probs_preds, corpus.binary_target),
    "labels": (corpus.binary_label_preds, corpus.binary_target),
    "logits": (corpus.binary_logits_preds, corpus.binary_target),
    "multidim": (corpus.binary_md_probs_preds, corpus.binary_md_target),
}


@pytest.mark.parametrize("ignore", ["none", "minus-one"])
@pytest.mark.parametrize("corpus_name", list(FAIRNESS_CORPORA))
def test_functional_group_fairness_matches_jax(corpus_name, ignore):
    """Group rates, demographic parity, equal opportunity and every task of
    ``binary_fairness`` (its ``num_groups`` given and inferred), on one batch."""
    preds, target = FAIRNESS_CORPORA[corpus_name]
    ignore_index = IGNORES[ignore]
    target = _with_ignored(target, ignore_index)
    groups = _groups(0, preds[0].shape)
    (tp, tt), (jp, jt) = _both(preds[0], target[0])
    tg, jg = torch.from_numpy(groups), jnp.asarray(groups)
    kw = {"ignore_index": ignore_index}
    _assert_same(fn.binary_groups_stat_rates(tp, tt, tg, G, **kw), jax_fn.binary_groups_stat_rates(jp, jt, jg, G, **kw))
    _assert_same(fn.demographic_parity(tp, tg, **kw), jax_fn.demographic_parity(jp, jg, **kw))
    _assert_same(fn.equal_opportunity(tp, tt, tg, **kw), jax_fn.equal_opportunity(jp, jt, jg, **kw))
    for task in ("demographic_parity", "equal_opportunity", "all"):
        for num_groups in (None, G + 1):
            fkw = {"task": task, "num_groups": num_groups, **kw}
            with warnings.catch_warnings():
                warnings.filterwarnings("ignore", "The task demographic_parity does not require a target")
                _assert_same(fn.binary_fairness(tp, tt, tg, **fkw), jax_fn.binary_fairness(jp, jt, jg, **fkw))


@pytest.mark.parametrize("task", ["demographic_parity", "equal_opportunity", "all"])
@pytest.mark.parametrize("corpus_name", list(FAIRNESS_CORPORA))
def test_modular_group_fairness_matches_jax_over_batches(corpus_name, task):
    """``BinaryFairness`` and ``BinaryGroupStatRates`` streamed over every
    batch: the int32 per-group states exact after each update, then the
    values and their keys."""
    preds, target = FAIRNESS_CORPORA[corpus_name]
    target = _with_ignored(target, -1, seed=2)
    kw = {"num_groups": G, "ignore_index": -1, "threshold": 0.4}
    pairs = [
        (cls.BinaryFairness(task=task, device="cpu", **kw), jax_cls.BinaryFairness(task=task, **kw)),
        (cls.BinaryGroupStatRates(device="cpu", **kw), jax_cls.BinaryGroupStatRates(**kw)),
    ]
    for i in range(preds.shape[0]):
        groups = _groups(i, preds[i].shape)
        (tp, tt), (jp, jt) = _both(preds[i], target[i])
        for port, ref in pairs:
            port.update(tp, tt, torch.from_numpy(groups))
            ref.update(jp, jt, jnp.asarray(groups))
            _assert_same({k: getattr(port, k) for k in "tp fp tn fn".split()},
                         {k: getattr(ref, k) for k in "tp fp tn fn".split()})
    for port, ref in pairs:
        _assert_same(port.compute(), ref.compute())


def test_group_counts_drop_out_of_range_ids_as_the_jax_one_hot_does():
    """Without validation, negative ids and ids >= num_groups count nowhere
    (a zero one-hot row in the JAX package, the dropped sentinel bucket in
    the port); ignored targets count nowhere either."""
    rng = np.random.default_rng(3)
    preds = rng.random(500).astype(np.float32)
    target = rng.integers(0, 2, 500)
    target[::7] = -1
    groups = rng.integers(-3, G + 3, 500)
    port = _binary_groups_stat_scores(
        torch.from_numpy(preds), torch.from_numpy(target), torch.from_numpy(groups), G, 0.5, -1, validate_args=False
    )
    ref = tpumetrics.functional.classification.group_fairness._binary_groups_stat_scores(
        jnp.asarray(preds), jnp.asarray(target), jnp.asarray(groups), G, 0.5, -1, validate_args=False
    )
    assert port.dtype == torch.int32 and port.shape == (G, 4)
    np.testing.assert_array_equal(port.numpy(), np.asarray([list(map(int, s)) for s in ref]))


def test_group_counts_at_a_million_samples_equal_numpy():
    """The histogram at the size of the card's binary stream (unequal group
    shares): exact against numpy counts."""
    rng = np.random.default_rng(4)
    n = 1_000_000
    preds = rng.random(n).astype(np.float32)
    target = (rng.random(n) < 0.3).astype(np.int64)
    groups = rng.choice(5, n, p=[0.4, 0.25, 0.15, 0.12, 0.08])
    port = _binary_groups_stat_scores(
        torch.from_numpy(preds), torch.from_numpy(target), torch.from_numpy(groups), 5, validate_args=False
    )
    p, t = preds > 0.5, target == 1
    want = np.stack([np.bincount(groups[m], minlength=5) for m in (p & t, p & ~t, ~p & ~t, ~p & t)], axis=1)
    np.testing.assert_array_equal(port.numpy(), want)


def test_group_fairness_refused_like_jax():
    preds, target = torch.tensor([0.2, 0.8, 0.6]), torch.tensor([0, 1, 1])
    with pytest.raises(ValueError, match="larger than the specified"):
        fn.binary_groups_stat_rates(preds, target, torch.tensor([0, 1, 4]), 3)
    with pytest.raises(ValueError, match="dtype of argument groups"):
        fn.binary_groups_stat_rates(preds, target, torch.tensor([0.0, 1.0, 1.0]), 3)
    with pytest.raises(ValueError, match="num_groups"):
        cls.BinaryFairness(num_groups=1, device="cpu")
    with pytest.raises(ValueError, match="task"):
        cls.BinaryFairness(num_groups=2, task="parity", device="cpu")
    with pytest.warns(UserWarning, match="does not require a target"):
        fn.binary_fairness(preds, target, torch.tensor([0, 1, 1]), task="demographic_parity")


# ---------------------------------------------------------------------- Dice

DICE_CORPORA = {
    "scores": CORPORA["multiclass-logits"],
    "probs": CORPORA["multiclass-probs"],
    "scores-multidim": CORPORA["multiclass-multidim"],
    "labels": CORPORA["multiclass-labels"],
    "binary-probs": ("binary", corpus.binary_probs_preds, corpus.binary_target),
}

DICE_CASES = [
    {"average": "micro"},
    {"average": "macro", "num_classes": C},
    {"average": "weighted", "num_classes": C},
    {"average": "none", "num_classes": C},
    {"average": "samples"},
    {"average": "macro", "num_classes": C, "ignore_index": 1},
    {"average": "micro", "top_k": 2},
    {"average": "macro", "mdmc_average": "samplewise", "num_classes": C, "ignore_index": 0},
    {"average": "micro", "mdmc_average": "samplewise", "zero_division": 1},
]
DICE_IDS = ["micro", "macro", "weighted", "none", "samples", "macro-ignore", "top2", "samplewise-macro",
            "samplewise-micro"]


def _dice_applies(corpus_name, kwargs):
    if kwargs.get("top_k") and corpus_name in ("labels", "binary-probs"):
        return False  # top_k needs (N, C, ...) scores
    if corpus_name == "binary-probs" and kwargs.get("num_classes"):
        return kwargs.get("ignore_index") is None
    return True


@pytest.mark.parametrize("corpus_name", list(DICE_CORPORA))
@pytest.mark.parametrize("kwargs", DICE_CASES, ids=DICE_IDS)
def test_functional_dice_matches_jax(corpus_name, kwargs):
    """Every detected input form (scores, multidim scores, integer labels,
    binary probabilities) in every average, on one batch."""
    if not _dice_applies(corpus_name, kwargs):
        kwargs = {"average": "micro"}
    _, preds, target = DICE_CORPORA[corpus_name]
    kwargs = dict(kwargs, num_classes=2) if corpus_name == "binary-probs" and "num_classes" in kwargs else kwargs
    (tp, tt), (jp, jt) = _both(preds[0], target[0])
    _assert_same(fn.dice(tp, tt, **kwargs), jax_fn.dice(jp, jt, **kwargs), atol=ATOL)


@pytest.mark.parametrize("corpus_name", ["scores", "scores-multidim", "labels"])
@pytest.mark.parametrize("kwargs", DICE_CASES[:6] + DICE_CASES[7:], ids=DICE_IDS[:6] + DICE_IDS[7:])
def test_modular_dice_matches_jax_over_batches(corpus_name, kwargs):
    """Streamed over every batch: the float32 tp/fp/fn states bit for bit
    after each update (the per-sample score sums of ``samples`` and
    ``samplewise`` within RTOL), then the value."""
    _, preds, target = DICE_CORPORA[corpus_name]
    kwargs = {"num_classes": C, **kwargs}
    port, ref = cls.Dice(device="cpu", **kwargs), jax_cls.Dice(**kwargs)
    for i in range(preds.shape[0]):
        (tp, tt), (jp, jt) = _both(preds[i], target[i])
        port.update(tp, tt)
        ref.update(jp, jt)
        assert sorted(port._defaults) == sorted(ref._defaults)
        for name in port._defaults:
            if name.startswith("sample_"):
                _rel(getattr(port, name), getattr(ref, name))
            else:
                _assert_same(getattr(port, name), getattr(ref, name), atol=0)
    _assert_same(port.compute(), ref.compute(), atol=ATOL)


def test_dice_void_label_is_a_zero_target_row():
    """Segmentation logits (N, C, H, W) with a void label of 255 in the
    target: the void pixels have no target class, so they count as false
    positives of the predicted class, as in the JAX package."""
    rng = np.random.default_rng(5)
    preds = rng.standard_normal((2, 4, 6, 8)).astype(np.float32)
    target = rng.integers(0, 4, (2, 6, 8))
    target[rng.random(target.shape) < 0.2] = 255
    kw = {"num_classes": 4, "average": "macro", "mdmc_average": "global"}
    port, ref = cls.Dice(device="cpu", **kw), jax_cls.Dice(**kw)
    (tp, tt), (jp, jt) = _both(preds, target)
    port.update(tp, tt)
    ref.update(jp, jt)
    _assert_same({k: getattr(port, k) for k in ("tp", "fp", "fn")}, {k: getattr(ref, k) for k in ("tp", "fp", "fn")},
                 atol=0)
    assert float(port.tp.sum() + port.fn.sum()) == float((target != 255).sum())
    assert float(port.tp.sum() + port.fp.sum()) == target.size
    _assert_same(port.compute(), ref.compute(), atol=ATOL)
    with pytest.raises(ValueError, match="ignore_index"):
        cls.Dice(ignore_index=255, device="cpu", **kw)


def test_dice_float_states_round_past_two_to_the_24_as_jax():
    """Past 2^24 per class a float32 state rounds; it rounds the same way in both packages."""
    kw = {"num_classes": 2, "average": "none"}
    port, ref = cls.Dice(device="cpu", **kw), jax_cls.Dice(**kw)
    start = np.float32(2**24)
    port.tp = torch.full((2,), start)
    ref.tp = jnp.full((2,), start)
    preds = np.asarray([0, 1, 1])
    (tp, tt), (jp, jt) = _both(preds, preds)
    for _ in range(3):
        port.update(tp, tt)
        ref.update(jp, jt)
    np.testing.assert_array_equal(port.tp.numpy(), np.asarray(ref.tp))
    assert float(port.tp[0]) == 2**24  # each + 1 rounds back to 2^24
    assert float(port.tp[1]) == 2**24 + 6


# ------------------------------------------ the slice's new members together


def _new_member_collections():
    """(port collection, JAX collection, batches, groups) of the new families
    as a user would combine them: a multiclass one (hinge, calibration,
    specificity at sensitivity beside AUROC, Dice) and a multilabel one
    (the three ranking metrics and specificity at sensitivity beside AUROC)."""
    rng = np.random.default_rng(21)
    mc_batches = []
    for _ in range(3):
        z = rng.standard_normal((64, C)).astype(np.float32) * 2
        e = np.exp(z - z.max(axis=1, keepdims=True))
        mc_batches.append(((e / e.sum(axis=1, keepdims=True)).astype(np.float32), rng.integers(0, C, 64)))
    ml_batches = [_edge_rows(s, n=64) for s in range(3)]
    for preds, target in ml_batches:
        target[rng.random(target.shape) < 0.1] = -1
    mc = lambda pkg, **d: {  # noqa: E731
        "auroc": pkg.MulticlassAUROC(C, thresholds=16, **d),
        "sas": pkg.MulticlassSpecificityAtSensitivity(C, min_sensitivity=0.5, thresholds=16, **d),
        "hinge": pkg.MulticlassHingeLoss(C, **d),
        "hinge_ova": pkg.MulticlassHingeLoss(C, multiclass_mode="one-vs-all", squared=True, **d),
        "ece": pkg.MulticlassCalibrationError(C, n_bins=15, **d),
        "dice": pkg.Dice(num_classes=C, average="macro", **d),
    }
    ml = lambda pkg, **d: {  # noqa: E731
        "auroc": pkg.MultilabelAUROC(C, thresholds=16, ignore_index=-1, **d),
        "sas": pkg.MultilabelSpecificityAtSensitivity(C, min_sensitivity=0.5, thresholds=16, ignore_index=-1, **d),
        "coverage": pkg.MultilabelCoverageError(C, ignore_index=-1, **d),
        "lrap": pkg.MultilabelRankingAveragePrecision(C, ignore_index=-1, **d),
        "lrl": pkg.MultilabelRankingLoss(C, ignore_index=-1, **d),
    }
    return [(mc, mc_batches, [["auroc", "sas"], ["dice"], ["ece"], ["hinge"], ["hinge_ova"]]),
            (ml, ml_batches, [["auroc", "sas"], ["coverage"], ["lrap"], ["lrl"]])]


@pytest.mark.parametrize("which", ["multiclass", "multilabel"])
def test_new_members_in_a_collection_match_jax(which):
    """Compute groups as in the JAX package (specificity at sensitivity in
    AUROC's), states and values equal, and the fused collection update
    (its CPU path) bit for bit the unfused one."""
    members, batches, groups = dict(zip(["multiclass", "multilabel"], _new_member_collections()))[which]
    port = MetricCollection(members(cls, device="cpu"), device="cpu")
    fused = MetricCollection(members(cls, device="cpu"), device="cpu", fused_update=True)
    ref = tpumetrics.MetricCollection(members(jax_cls))
    for preds, target in batches:
        (tp, tt), (jp, jt) = _both(preds, target)
        port.update(tp, tt)
        fused.update(tp, tt)
        ref.update(jp, jt)
    assert [list(g) for g in port.compute_groups.values()] == groups == [list(g) for g in ref.compute_groups.values()]
    got, want, got_fused = port.compute(), ref.compute(), fused.compute()
    for key in want:
        _assert_same(got[key], want[key], atol=1e-6)
        for g, f in zip(*((x,) if not isinstance(x, tuple) else x for x in (got[key], got_fused[key]))):
            assert torch.equal(g, f), key
    step = fused._fused_oo_step
    eager = {"multiclass": ["ece"], "multilabel": []}[which]
    assert sorted(step.leaders) == sorted(g[0] for g in groups if g[0] not in eager)


def test_fairness_collection_takes_groups_positionally_and_fuses():
    """``BinaryFairness`` and ``BinaryGroupStatRates`` share one compute
    group; with ``groups`` passed positionally the fused update keys a
    program (no keyword tensor), and its states equal the unfused ones."""
    members = lambda pkg, **d: {  # noqa: E731
        "fair": pkg.BinaryFairness(num_groups=G, validate_args=False, **d),
        "rates": pkg.BinaryGroupStatRates(num_groups=G, validate_args=False, **d),
    }
    port = MetricCollection(members(cls, device="cpu"), device="cpu")
    fused = MetricCollection(members(cls, device="cpu"), device="cpu", fused_update=True)
    ref = tpumetrics.MetricCollection(members(jax_cls))
    preds, target = corpus.binary_probs_preds, corpus.binary_target
    for i in range(preds.shape[0]):
        groups = _groups(i, preds[i].shape)
        (tp, tt), (jp, jt) = _both(preds[i], target[i])
        port.update(tp, tt, torch.from_numpy(groups))
        fused.update(tp, tt, torch.from_numpy(groups))
        ref.update(jp, jt, jnp.asarray(groups))
    assert [list(g) for g in port.compute_groups.values()] == [["fair", "rates"]]
    assert fused._fused_oo_step.counts["replayed"] >= 1
    for name in ("tp", "fp", "tn", "fn"):
        assert torch.equal(getattr(port["fair"], name), getattr(fused["fair"], name))
    _assert_same(port.compute(), ref.compute())
    _assert_same(fused.compute(), ref.compute())


WRAPPER_CASES = [
    ("MultilabelCoverageError", {"num_labels": 3}),
    ("MultilabelRankingAveragePrecision", {"num_labels": 3, "ignore_index": -1}),
    ("MultilabelRankingLoss", {"num_labels": 4}),
    ("BinaryFairness", {"num_groups": 2, "task": "equal_opportunity"}),
    ("BinaryGroupStatRates", {"num_groups": 4}),
    ("Dice", {"num_classes": 3, "average": "macro"}),
    ("Dice", {"average": "samples"}),
]


@pytest.mark.parametrize("name, kwargs", WRAPPER_CASES, ids=[f"{n}-{i}" for i, (n, _) in enumerate(WRAPPER_CASES)])
def test_constructors_hold_the_jax_package_states(name, kwargs):
    port = getattr(cls, name)(device="cpu", **kwargs)
    ref = getattr(jax_cls, name)(**kwargs)
    assert sorted(port._defaults) == sorted(ref._defaults)
    for key, default in port._defaults.items():
        want = ref._defaults[key]
        assert tuple(default.shape) == tuple(want.shape) and str(default.dtype).split(".")[-1] == str(want.dtype)
    assert port.higher_is_better == ref.higher_is_better


def test_ranking_and_dice_refused_like_jax():
    with pytest.raises(ValueError, match="num_labels"):
        cls.MultilabelRankingLoss(1, device="cpu")
    with pytest.raises(ValueError, match="provide the number of classes"):
        cls.Dice(average="macro", device="cpu")
    with pytest.raises(ValueError, match="mdmc_average"):
        cls.Dice(mdmc_average="average", device="cpu")
    with pytest.raises(NotImplementedError):
        fn.dice(torch.tensor([0, 1]), torch.tensor([0, 1]), multiclass=False)
    with pytest.raises(ValueError, match="mdmc_average"):
        fn.dice(torch.zeros(2, 3, 4), torch.zeros(2, 4, dtype=torch.long), mdmc_average=None)
