"""The whole slice held against the JAX package: the main-path
``MetricCollection`` (accuracy micro + F1 macro + binned AUROC) at BASELINE
config #2's shape (C=16, B=1024, T=64), its compute groups, the functional
bridge, state carried between the packages, the device rules, and the rule
that the port imports nothing of JAX.

Integer states must be equal; float values agree within 1e-6, the room that
float32 sums taken in another order need.
"""

import ast
import doctest
import importlib
import os
import pkgutil
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

import tpumetrics
import tpumetrics.classification as jax_cls
import tpumetrics_torch
import tpumetrics_torch.classification as cls
from tpumetrics_torch import Metric, MetricCollection
from tpumetrics_torch.interop import export_state, load_state
from tpumetrics_torch.parallel import (
    NoOpBackend,
    TorchDistBackend,
    distributed_available,
    get_default_backend,
    set_default_backend,
)

C, B, T = 16, 1024, 64
ATOL = 1e-6
_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _batches(seed, nb):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(nb):
        z = rng.standard_normal((B, C)).astype(np.float32)
        e = np.exp(z - z.max(axis=1, keepdims=True))
        out.append(((e / e.sum(axis=1, keepdims=True)).astype(np.float32), rng.integers(0, C, B)))
    return out


def _port_collection(**kw):
    return MetricCollection(
        {
            "acc": cls.MulticlassAccuracy(C, average="micro", validate_args=False, device="cpu"),
            "f1": cls.MulticlassF1Score(C, average="macro", validate_args=False, device="cpu"),
            "auroc": cls.MulticlassAUROC(C, thresholds=T, validate_args=False, device="cpu"),
        },
        device="cpu",
        **kw,
    )


def _jax_collection(**kw):
    return tpumetrics.MetricCollection(
        {
            "acc": jax_cls.MulticlassAccuracy(C, average="micro", validate_args=False),
            "f1": jax_cls.MulticlassF1Score(C, average="macro", validate_args=False),
            "auroc": jax_cls.MulticlassAUROC(C, thresholds=T, validate_args=False),
        },
        **kw,
    )


def _assert_values(port, ref):
    """Values within ATOL; a tuple value (a fixed-point metric's value and
    threshold) entry by entry."""
    assert sorted(port) == sorted(ref)
    for k in ref:
        pairs = zip(port[k], ref[k]) if isinstance(ref[k], tuple) else [(port[k], ref[k])]
        for got, want in pairs:
            np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=ATOL)


def _assert_states(port_state, ref_state):
    """Integer tensor states int32 and equal, float ones (the sums of the
    hinge, ranking and Dice states) float32 within 1e-6 relative; list states
    (the exact curve's preds and targets, the calibration error's confidences
    and accuracies) of equal length, with equal entries of equal dtypes."""
    assert sorted(port_state) == sorted(ref_state)
    for leader in ref_state:
        assert sorted(port_state[leader]) == sorted(ref_state[leader])
        for name, ref in ref_state[leader].items():
            got = port_state[leader][name]
            if isinstance(ref, list):
                assert len(got) == len(ref)
                for g, r in zip(got, ref):
                    g = g.numpy() if isinstance(g, torch.Tensor) else g
                    assert g.dtype == np.asarray(r).dtype
                    np.testing.assert_array_equal(g, np.asarray(r))
                continue
            got = got.numpy() if isinstance(got, torch.Tensor) else got
            if np.issubdtype(np.asarray(ref).dtype, np.floating):  # float sums: float32, within 1e-6 relative
                assert got.dtype == np.float32
                np.testing.assert_allclose(got, np.asarray(ref), rtol=1e-6, atol=0)
                continue
            assert got.dtype == np.int32
            np.testing.assert_array_equal(got, np.asarray(ref))


def _jax_leader_states(col):
    return {cg[0]: {k: getattr(col[cg[0]], k) for k in col[cg[0]]._defaults} for cg in col.compute_groups.values()}


@pytest.mark.parametrize("mode", ["update", "forward"])
def test_main_path_collection_matches_jax(mode):
    port, ref = _port_collection(), _jax_collection()
    for preds, target in _batches(0, 4):
        tp, tt = torch.from_numpy(preds), torch.from_numpy(target)
        jp, jt = jnp.asarray(preds), jnp.asarray(target)
        if mode == "forward":
            _assert_values(port(tp, tt), ref(jp, jt))
        else:
            port.update(tp, tt)
            ref.update(jp, jt)
    # forward runs every metric and never merges groups, in both packages
    groups = [["acc", "f1"], ["auroc"]] if mode == "update" else [["acc"], ["auroc"], ["f1"]]
    assert list(port.compute_groups.values()) == list(ref.compute_groups.values()) == groups
    _assert_values(port.compute(), ref.compute())
    _assert_states(export_state(port), _jax_leader_states(ref))
    assert port["f1"].update_count == ref["f1"].update_count == 4


def test_leaders_only_after_groups_are_set(monkeypatch):
    """After the first update only leaders run; members see the leader's state."""
    port = _port_collection()
    (p0, t0), (p1, t1) = _batches(1, 2)
    port.update(torch.from_numpy(p0), torch.from_numpy(t0))
    calls = []
    member = port._modules["f1"]
    monkeypatch.setattr(type(member), "update", lambda self, *a: calls.append(type(self).__name__))
    port.update(torch.from_numpy(p1), torch.from_numpy(t1))
    assert calls == []
    assert port["f1"].tp is port["acc"].tp


def test_group_merge_copies_leader_states_to_host_once(monkeypatch):
    copies = []
    real_cpu = torch.Tensor.cpu
    monkeypatch.setattr(torch.Tensor, "cpu", lambda self, *a, **k: copies.append(self.shape) or real_cpu(self, *a, **k))
    port = _port_collection()
    preds, target = _batches(2, 1)[0]
    port.update(torch.from_numpy(preds), torch.from_numpy(target))
    assert len(copies) == 1  # one packed buffer for all leaders' states


def test_collection_keys_from_a_sequence_with_prefix_and_postfix_match_jax():
    kw = {"prefix": "val_", "postfix": "_ep"}
    port = MetricCollection(
        [cls.MulticlassAccuracy(C, device="cpu"), cls.MulticlassF1Score(C, device="cpu")], device="cpu", **kw
    )
    ref = tpumetrics.MetricCollection([jax_cls.MulticlassAccuracy(C), jax_cls.MulticlassF1Score(C)], **kw)
    preds, target = _batches(8, 1)[0]
    _assert_values(port(torch.from_numpy(preds), torch.from_numpy(target)), ref(jnp.asarray(preds), jnp.asarray(target)))
    assert list(port.keys()) == list(ref.keys()) == ["val_MulticlassAccuracy_ep", "val_MulticlassF1Score_ep"]
    assert list(port.keys(keep_base=True)) == ["MulticlassAccuracy", "MulticlassF1Score"]
    with pytest.raises(ValueError, match="two metrics both named"):
        MetricCollection([cls.MulticlassAccuracy(C, device="cpu")] * 2, device="cpu")


def test_collection_reset_and_reuse_match_jax():
    port, ref = _port_collection(), _jax_collection()
    batches = _batches(3, 3)
    for preds, target in batches:
        port.update(torch.from_numpy(preds), torch.from_numpy(target))
        ref.update(jnp.asarray(preds), jnp.asarray(target))
    port.reset()
    ref.reset()
    preds, target = batches[0]
    port.update(torch.from_numpy(preds), torch.from_numpy(target))
    ref.update(jnp.asarray(preds), jnp.asarray(target))
    _assert_values(port.compute(), ref.compute())


def test_collection_functional_bridge_matches_jax():
    groups = [["acc", "f1"], ["auroc"]]
    port, ref = _port_collection(compute_groups=groups), _jax_collection(compute_groups=groups)
    pstate, rstate = port.init_state(), ref.init_state()
    assert sorted(pstate) == sorted(rstate) == ["acc", "auroc"]
    for preds, target in _batches(4, 3):
        pstate = port.functional_update(pstate, torch.from_numpy(preds), torch.from_numpy(target))
        rstate = ref.functional_update(rstate, jnp.asarray(preds), jnp.asarray(target))
    _assert_states(pstate, rstate)
    _assert_values(port.functional_compute(pstate), ref.functional_compute(rstate))


def _host_state(state):
    """A collection state with numpy leaves (lists of them for list states)."""
    return {k: {s: [np.asarray(x) for x in v] if isinstance(v, list) else np.asarray(v) for s, v in st.items()}
            for k, st in state.items()}


def _jax_state(state):
    return {k: {s: [jnp.asarray(x) for x in v] if isinstance(v, list) else jnp.asarray(v) for s, v in st.items()}
            for k, st in state.items()}


def _binary_multilabel_collections():
    """Binary and multilabel members, the binary exact AUROC's list states
    among them: (port collection, JAX collection, batches) for each task."""
    rng = np.random.default_rng(9)
    out = []
    for task, kw, shape in [("binary", {}, (64,)), ("multilabel", {"num_labels": 5}, (64, 5))]:
        members = {
            "acc": lambda pkg, **d: pkg.Accuracy(task=task, ignore_index=-1, **kw, **d),
            "auroc": lambda pkg, **d: pkg.AUROC(task=task, thresholds=T, ignore_index=-1, **kw, **d),
        }
        if task == "binary":
            members["exact"] = lambda pkg, **d: pkg.AUROC(task=task, ignore_index=-1, **d)
        groups = [[k] for k in members]
        port = MetricCollection({k: m(tpumetrics_torch, device="cpu") for k, m in members.items()},
                                compute_groups=groups, device="cpu")
        ref = tpumetrics.MetricCollection({k: m(tpumetrics) for k, m in members.items()}, compute_groups=groups)
        batches = []
        for _ in range(6):
            target = rng.integers(0, 2, shape).reshape(64, -1)
            for col in target.T:  # 6 ignored entries in each column: the exact path's shapes repeat
                col[rng.choice(64, 6, replace=False)] = -1
            batches.append(((rng.integers(0, 17, shape) / 16).astype(np.float32), target.reshape(shape)))
        out.append((port, ref, batches))
    return out


def _report_collections():
    """The families of a classification report: a multiclass collection
    whose precision, recall and specificity share F1's stat scores, whose
    Jaccard, MCC and kappa share the confusion matrix and whose recall at a
    fixed precision shares the binned AUROC's curve tensor; and a multilabel
    one on (N, L, X) inputs with exact match (correct/total, and the
    samplewise list state), Hamming distance, Jaccard and precision at a
    fixed recall, binned and exact (list states)."""
    mc = {
        "f1": lambda pkg, **d: pkg.MulticlassF1Score(C, **d),
        "precision": lambda pkg, **d: pkg.MulticlassPrecision(C, **d),
        "recall": lambda pkg, **d: pkg.MulticlassRecall(C, **d),
        "specificity": lambda pkg, **d: pkg.MulticlassSpecificity(C, **d),
        "confmat": lambda pkg, **d: pkg.MulticlassConfusionMatrix(C, **d),
        "jaccard": lambda pkg, **d: pkg.MulticlassJaccardIndex(C, **d),
        "kappa": lambda pkg, **d: pkg.MulticlassCohenKappa(C, weights="linear", **d),
        "mcc": lambda pkg, **d: pkg.MulticlassMatthewsCorrCoef(C, **d),
        "auroc": lambda pkg, **d: pkg.MulticlassAUROC(C, thresholds=T, **d),
        "rafp": lambda pkg, **d: pkg.MulticlassRecallAtFixedPrecision(C, min_precision=0.5, thresholds=T, **d),
    }
    mc_groups = [
        ["f1", "precision", "recall", "specificity"], ["confmat", "jaccard", "kappa", "mcc"], ["auroc", "rafp"]
    ]
    kw = {"num_labels": 5, "ignore_index": -1}
    ml = {
        "exact": lambda pkg, **d: pkg.MultilabelExactMatch(**kw, **d),
        "exact_sw": lambda pkg, **d: pkg.MultilabelExactMatch(multidim_average="samplewise", **kw, **d),
        "hamming": lambda pkg, **d: pkg.MultilabelHammingDistance(**kw, **d),
        "jaccard": lambda pkg, **d: pkg.MultilabelJaccardIndex(**kw, **d),
        "pafr": lambda pkg, **d: pkg.MultilabelPrecisionAtFixedRecall(min_recall=0.5, thresholds=T, **kw, **d),
        "pafr_exact": lambda pkg, **d: pkg.MultilabelPrecisionAtFixedRecall(min_recall=0.5, **kw, **d),
    }
    ml_groups = [[k] for k in ml]
    rng = np.random.default_rng(10)
    ml_batches = []
    for _ in range(6):
        target = rng.integers(0, 2, (64, 5, 2))
        for label in range(5):  # 6 ignored entries of each label: the exact path's shapes repeat
            flat = rng.choice(128, 6, replace=False)
            target[flat // 2, label, flat % 2] = -1
        ml_batches.append(((rng.integers(0, 17, (64, 5, 2)) / 16).astype(np.float32), target))
    out = []
    for members, groups, batches in ((mc, mc_groups, _batches(11, 6)), (ml, ml_groups, ml_batches)):
        port = MetricCollection({k: m(cls, device="cpu") for k, m in members.items()}, compute_groups=groups,
                                device="cpu")
        ref = tpumetrics.MetricCollection({k: m(jax_cls) for k, m in members.items()}, compute_groups=groups)
        out.append((port, ref, batches))
    return out


def _new_family_collections():
    """The families of the last classification slice: a multiclass
    collection of the hinge loss (both modes), the calibration error (list
    states), a binned specificity at sensitivity and Dice; a multilabel one
    of the three ranking metrics; and a fairness one, updated with
    ``(preds, target, groups)``."""
    rng = np.random.default_rng(12)
    mc = {
        "hinge": lambda pkg, **d: pkg.MulticlassHingeLoss(C, **d),
        "hinge_ova": lambda pkg, **d: pkg.MulticlassHingeLoss(C, multiclass_mode="one-vs-all", **d),
        "ece": lambda pkg, **d: pkg.MulticlassCalibrationError(C, n_bins=15, **d),
        "sas": lambda pkg, **d: pkg.MulticlassSpecificityAtSensitivity(C, min_sensitivity=0.5, thresholds=T, **d),
        "dice": lambda pkg, **d: pkg.Dice(num_classes=C, average="macro", **d),
    }
    ml = {
        "coverage": lambda pkg, **d: pkg.MultilabelCoverageError(5, ignore_index=-1, **d),
        "lrap": lambda pkg, **d: pkg.MultilabelRankingAveragePrecision(5, ignore_index=-1, **d),
        "lrl": lambda pkg, **d: pkg.MultilabelRankingLoss(5, ignore_index=-1, **d),
    }
    fair = {
        "fair": lambda pkg, **d: pkg.BinaryFairness(3, **d),
        "rates": lambda pkg, **d: pkg.BinaryGroupStatRates(3, **d),
    }
    ml_batches, fair_batches = [], []
    for _ in range(6):
        target = rng.integers(0, 2, (64, 5))
        target[rng.random((64, 5)) < 0.1] = -1
        ml_batches.append(((rng.integers(0, 9, (64, 5)) / 8).astype(np.float32), target))
        fair_batches.append((rng.random(64).astype(np.float32), rng.integers(0, 2, 64), rng.integers(0, 3, 64)))
    out = []
    for members, batches in ((mc, _batches(13, 6)), (ml, ml_batches), (fair, fair_batches)):
        groups = [[k] for k in members] if members is not fair else [list(members)]
        port = MetricCollection({k: m(cls, device="cpu") for k, m in members.items()}, compute_groups=groups,
                                device="cpu")
        ref = tpumetrics.MetricCollection({k: m(jax_cls) for k, m in members.items()}, compute_groups=groups)
        out.append((port, ref, batches))
    return out


@pytest.mark.parametrize("direction", ["jax-to-port", "port-to-jax"])
def test_state_round_trip_between_packages(direction):
    """Accumulate 3 batches in one package, carry the state over, run 3 more
    batches in both and compare: the main-path collection, binary and
    multilabel collections with binned and exact (list state) AUROC, the
    report collections of the precision/recall, confusion-matrix, exact-match
    and fixed-point families, and the collections of the hinge, calibration,
    specificity-at-sensitivity, Dice, ranking and fairness families."""
    groups = [["acc", "f1"], ["auroc"]]
    cases = [(_port_collection(compute_groups=groups), _jax_collection(compute_groups=groups), _batches(5, 3) + _batches(6, 3))]
    for port, ref, batches in cases + _binary_multilabel_collections() + _report_collections() + _new_family_collections():
        first, second = batches[:3], batches[3:]
        if direction == "jax-to-port":
            rstate = ref.init_state()
            for batch in first:
                rstate = ref.functional_update(rstate, *map(jnp.asarray, batch))
            load_state(port, _host_state(rstate))
        else:
            pstate = port.init_state()
            for batch in first:
                pstate = port.functional_update(pstate, *map(torch.from_numpy, batch))
            load_state(port, _host_state({k: {s: v.numpy() if isinstance(v, torch.Tensor) else [x.numpy() for x in v]
                                                 for s, v in st.items()} for k, st in pstate.items()}))
            rstate = _jax_state(export_state(port))
        for batch in second:
            port.update(*map(torch.from_numpy, batch))
            rstate = ref.functional_update(rstate, *map(jnp.asarray, batch))
        _assert_states(export_state(port), rstate)
        _assert_values(port.compute(), ref.functional_compute(rstate))


def test_load_state_refuses_mismatched_groups_and_shapes():
    port = _port_collection()
    state = {"acc": export_state(port["acc"]), "auroc": export_state(port["auroc"])}
    with pytest.raises(ValueError, match="compute-group leaders"):
        load_state(port, state)
    bad = dict(state["auroc"], confmat=state["auroc"]["confmat"].astype(np.int64))
    with pytest.raises(ValueError, match="int32"):
        load_state(port["auroc"], bad)


def test_states_default_to_cuda_and_refuse_a_cpu_only_box():
    if torch.cuda.is_available():
        assert cls.MulticlassAccuracy(C).device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="No CUDA device"):
        cls.MulticlassAccuracy(C)
    with pytest.raises(RuntimeError, match="No CUDA device"):
        MetricCollection({"acc": cls.MulticlassAccuracy(C, device="cpu")})


def test_update_refuses_inputs_on_another_device():
    metric = cls.MulticlassAUROC(C, thresholds=T, device="cpu")
    preds = torch.empty((4, C), device="meta")
    with pytest.raises(RuntimeError, match="not moved"):
        metric.update(preds, torch.zeros(4, dtype=torch.long))
    with pytest.raises(RuntimeError, match="not moved"):
        metric.functional_update(metric.init_state(), preds, torch.zeros(4, dtype=torch.long))
    assert metric.update_count == 0


def test_unknown_kwarg_is_refused():
    # the sync kwargs (dist_sync_fn, process_group, ...) are known now: a misspelt one is not
    with pytest.raises(ValueError, match="Unexpected keyword"):
        cls.MulticlassAccuracy(C, device="cpu", dist_sync_func=None)


def test_sync_is_a_no_op_on_one_rank_and_refused_on_more(monkeypatch):
    metric = cls.MulticlassAccuracy(C, average="micro", device="cpu")
    preds, target = _batches(7, 1)[0]
    metric.update(torch.from_numpy(preds), torch.from_numpy(target))
    if not dist.is_initialized():
        dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
        try:
            value = metric.compute()
        finally:
            dist.destroy_process_group()
        assert value.ndim == 0
    # more ranks: no longer refused; compute syncs through the ambient backend
    # (torch.distributed's), here one that stands in for two equal ranks
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_world_size", lambda *a: 2)
    assert isinstance(get_default_backend(), TorchDistBackend) and distributed_available()

    class _TwoEqualRanks(NoOpBackend):
        reduces = 0

        def available(self):
            return True

        def all_reduce(self, x, op, group=None):
            self.reduces += 1
            return x + x if op == "sum" else x

    metric.update(torch.from_numpy(preds), torch.from_numpy(target))
    local = metric.tp
    twins = _TwoEqualRanks()
    set_default_backend(twins)
    try:
        assert float(metric.compute()) == pytest.approx(float((preds.argmax(1) == target).mean()))
    finally:
        set_default_backend(None)
    assert twins.reduces == 1  # tp, fp, tn, fn: one int32 "sum" class
    assert metric.tp is local and not metric._is_synced
    off = cls.MulticlassAccuracy(C, average="micro", device="cpu", sync_on_compute=False)
    off.update(torch.from_numpy(preds), torch.from_numpy(target))
    assert off.compute().ndim == 0


class _Total(Metric):
    full_state_update = True

    def __init__(self, **kw):
        super().__init__(**kw)
        self.add_state("total", 0, dist_reduce_fx="sum")
        self.add_state("seen", [], dist_reduce_fx="cat")

    def update(self, x):
        self.total = self.total + x.sum().to(torch.int32)
        self.seen.append(x)

    def compute(self):
        return self.total, torch.cat(self.seen) if self.seen else torch.zeros(0)


class _TotalReduce(_Total):
    full_state_update = False


def test_base_metric_forward_modes_and_persistence():
    """Both forward modes return the batch value and keep the global state."""
    full = _Total(device="cpu")
    assert full.total.dtype == torch.int32
    out = full(torch.tensor([1, 2]))
    assert out[0] == 3 and out[1].tolist() == [1, 2]
    full(torch.tensor([4]))
    assert int(full.total) == 7 and len(full.seen) == 2
    reduce = _TotalReduce(device="cpu")
    reduce(torch.tensor([1, 2]))
    assert reduce(torch.tensor([4]))[0] == 4
    assert int(reduce.total) == 7 and torch.cat(reduce.seen).tolist() == [1, 2, 4]
    reduce.persistent(True)
    restored = _Total(device="cpu")
    restored.load_state_dict(reduce.state_dict())
    assert int(restored.total) == 7 and len(restored.seen) == 2


def _port_imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module


def test_port_sources_import_neither_jax_nor_the_jax_package():
    root = os.path.dirname(tpumetrics_torch.__file__)
    bad = []
    for dirpath, _, files in os.walk(root):
        for name in files:
            if name.endswith(".py"):
                path = os.path.join(dirpath, name)
                bad += [(path, m) for m in _port_imports(path) if m.split(".")[0] in ("jax", "jaxlib", "tpumetrics")]
    assert bad == []


def test_importing_the_port_loads_no_jax():
    code = (
        "import sys\n"
        "import tpumetrics_torch, tpumetrics_torch.interop, tpumetrics_torch.functional, tpumetrics_torch.ops\n"
        "import tpumetrics_torch.utilities.data\n"
        "print(sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'tpumetrics')))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=_REPO, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


_DOC_MODULES = sorted(
    info.name
    for info in pkgutil.walk_packages(tpumetrics_torch.__path__, prefix="tpumetrics_torch.")
    if not info.ispkg
)


@pytest.mark.parametrize("module_name", _DOC_MODULES)
def test_port_docstring_examples_run(module_name):
    module = importlib.import_module(module_name)
    runner = doctest.DocTestRunner(optionflags=doctest.ELLIPSIS | doctest.NORMALIZE_WHITESPACE)
    for test in doctest.DocTestFinder().find(module, module_name):
        runner.run(test)
    assert runner.failures == 0
