"""The port's fused collection update (``MetricCollection(fused_update=True)``,
``tpumetrics_torch.parallel.FusedCollectionStep``) on the CPU.

On a CPU collection the step takes its card path without the CUDA graph:
the same keys, state ownership, copy-in of the batch into the program's
input buffers and write-back, with the transition called eagerly where a
card replays a graph. So each case here holds the fused collection against
the unfused one, states bit for bit after every update and values equal,
and one case holds the port's functional step against the JAX package's
``FusedCollectionStep`` (int32 states exact). The graph itself runs in
``tests/test_torch_cuda.py`` on a card.
"""

import copy
import pickle

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpumetrics
import tpumetrics.classification as jax_cls
import tpumetrics_torch
import tpumetrics_torch.classification as cls
from tpumetrics.parallel import FusedCollectionStep as JaxFusedCollectionStep
from tpumetrics_torch import CatMetric, MeanMetric, MetricCollection, RunningSum, SumMetric
from tpumetrics_torch.interop import export_state
from tpumetrics_torch.parallel import FusedCollectionStep, NoOpBackend, UnhashableKwargsError, set_default_backend
from tpumetrics_torch.parallel.fuse_update import fusable_oo_leaders, gather_donatable_state
from tpumetrics_torch.utils.exceptions import TPUMetricsUserError

C, T = 6, 16


def _probs(rng, n, c=C):
    z = rng.standard_normal((n, c)).astype(np.float32)
    e = np.exp(z - z.max(axis=1, keepdims=True))
    return (e / e.sum(axis=1, keepdims=True)).astype(np.float32)


def _multiclass_batches(seed=0, sizes=(40, 40, 40, 40, 9, 40)):
    rng = np.random.default_rng(seed)
    return [(_probs(rng, n), rng.integers(0, C, n)) for n in sizes]


def _task_batches(task, seed=1, nb=5):
    rng = np.random.default_rng(seed)
    shape = (64,) if task == "binary" else (32, 4)
    out = []
    for _ in range(nb):
        target = rng.integers(0, 2, shape)
        target[rng.random(shape) < 0.1] = -1
        out.append(((rng.integers(0, 65, shape) / 64).astype(np.float32), target))
    return out


def _members(kind):
    if kind == "multiclass":
        return {
            "acc": cls.MulticlassAccuracy(C, average="micro", device="cpu"),
            "f1": cls.MulticlassF1Score(C, device="cpu"),
            "auroc": cls.MulticlassAUROC(C, thresholds=T, device="cpu"),
            "ap": cls.MulticlassAveragePrecision(C, thresholds=T, device="cpu"),
            "confmat": cls.MulticlassConfusionMatrix(C, device="cpu"),
        }
    kw = {"task": kind, "ignore_index": -1, "device": "cpu", **({"num_labels": 4} if kind == "multilabel" else {})}
    out = {
        "acc": tpumetrics_torch.Accuracy(**kw),
        "f1": tpumetrics_torch.F1Score(**kw),
        "auroc": tpumetrics_torch.AUROC(thresholds=T, **kw),
        "ap": tpumetrics_torch.AveragePrecision(thresholds=T, **kw),
        "confmat": tpumetrics_torch.ConfusionMatrix(**kw),
    }
    if kind == "binary":
        out["exact"] = tpumetrics_torch.AUROC(**kw)  # list states: stays eager
    return out


def _pair(kind):
    return [MetricCollection(_members(kind), fused_update=f, device="cpu") for f in (False, True)]


def _assert_same_states(got, want):
    """Every state of two collections identical: int32 tensors bit for bit,
    list states entry by entry."""
    a, b = export_state(got), export_state(want)
    assert a.keys() == b.keys()
    for leader in b:
        for name, ref in b[leader].items():
            val = a[leader][name]
            if isinstance(ref, list):
                assert len(val) == len(ref) and all(np.array_equal(x, y) for x, y in zip(val, ref))
            else:
                assert val.dtype == ref.dtype and np.array_equal(val, ref), f"{leader}.{name}"


def _assert_same_values(got, want):
    assert got.keys() == want.keys()
    for key in want:
        assert torch.equal(got[key], want[key]), key


def _t(batch):
    return tuple(torch.from_numpy(x) for x in batch)


@pytest.mark.parametrize("kind", ["multiclass", "binary", "multilabel"])
def test_fused_collection_matches_unfused_bit_for_bit(kind):
    plain, fused = _pair(kind)
    batches = _multiclass_batches() if kind == "multiclass" else _task_batches(kind)
    for batch in batches:
        plain.update(*_t(batch))
        fused.update(*_t(batch))
        _assert_same_states(fused, plain)
    _assert_same_values(fused.compute(), plain.compute())
    step = fused._fused_oo_step
    groups = {g[0]: g for g in fused.compute_groups.values()}
    assert sorted(groups["ap"]) == ["ap", "auroc"]  # AP shares AUROC's state: no extra update
    assert step.leaders == [g for g in groups if g != "exact"]
    # update 1 establishes the groups; each batch signature then runs eagerly once,
    # is captured at its second sighting and replays after that
    sizes = [b[0].shape[0] for b in batches[1:]]
    first = len(set(sizes))
    assert step.counts == {
        "eager": first, "captured": sum(sizes.count(s) > 1 for s in set(sizes)),
        "replayed": len(sizes) - first - step.program_count, "unfused": 0,
    }
    assert step.program_count == 1


def test_tensor_kwargs_run_the_whole_call_eagerly():
    """A tensor among the keyword arguments (the synced stream's ``value=``)
    cannot key a graph: the call runs every leader eagerly."""

    def make(fused):
        return MetricCollection(
            {"acc": cls.MulticlassAccuracy(C, device="cpu"), "mean": MeanMetric(device="cpu"), "cat": CatMetric(device="cpu")},
            fused_update=fused,
            device="cpu",
        )

    plain, fused = make(False), make(True)
    for preds, target in _multiclass_batches(sizes=(20, 20, 20, 20)):
        preds, target = torch.from_numpy(preds), torch.from_numpy(target)
        for col in (plain, fused):
            col.update(preds=preds, target=target, value=preds.max(dim=1).values.mean())
        _assert_same_states(fused, plain)
    step = fused._fused_oo_step
    assert step.leaders == fusable_oo_leaders(fused) == ["acc", "mean"]  # cat has a list state
    assert step.counts == {"eager": 0, "captured": 0, "replayed": 0, "unfused": 3}
    assert step.program_count == 0
    _assert_same_values(fused.compute(), plain.compute())


def test_list_states_and_wrappers_stay_eager_beside_fused_leaders():
    """A CatMetric (list state) and a RunningSum (a wrapper, no functional
    bridge) update eagerly while the SumMetric beside them replays."""

    def make(fused):
        return MetricCollection(
            {"sum": SumMetric(device="cpu"), "cat": CatMetric(device="cpu"), "rsum": RunningSum(window=2, device="cpu")},
            fused_update=fused,
            device="cpu",
        )

    plain, fused = make(False), make(True)
    rng = np.random.default_rng(3)
    for _ in range(5):
        x = torch.from_numpy(rng.random(7).astype(np.float32))
        plain.update(x)
        fused.update(x)
        _assert_same_states(fused, plain)
    step = fused._fused_oo_step
    assert step.leaders == ["sum"] and step.counts["replayed"] == 2
    _assert_same_values(fused.compute(), plain.compute())


def test_reset_forward_and_sync_between_fused_updates():
    """The step copies in whatever state it does not own: the stored
    defaults after reset() (which it never changes), forward()'s merged
    states, and the states unsync() puts back after a synced compute()."""

    class Synced(NoOpBackend):
        def available(self):
            return True

    plain, fused = _pair("multiclass")
    batches = [_t(b) for b in _multiclass_batches(sizes=(30,) * 8)]
    defaults = {name: m._defaults["confmat" if name == "confmat" else "tp"].clone() for name, m in fused._modules.items() if name in ("acc", "confmat")}

    def both(fn):
        out = [fn(col) for col in (plain, fused)]
        _assert_same_states(fused, plain)
        return out

    for batch in batches[:3]:
        both(lambda col: col.update(*batch))
    both(lambda col: col.reset())
    both(lambda col: col.update(*batches[3]))
    assert torch.equal(fused._modules["acc"]._defaults["tp"], defaults["acc"])
    assert torch.equal(fused._modules["confmat"]._defaults["confmat"], defaults["confmat"])
    got, want = both(lambda col: col(*batches[4]))  # forward
    _assert_same_values(got, want)
    both(lambda col: col.update(*batches[5]))
    set_default_backend(Synced())
    try:
        got, want = both(lambda col: col.compute())
    finally:
        set_default_backend(None)
    _assert_same_values(got, want)
    set_default_backend(Synced())
    try:
        fused._modules["acc"].sync()
        with pytest.raises(TPUMetricsUserError, match="unsync"):
            fused.update(*batches[6])
        fused._modules["acc"].unsync()
    finally:
        set_default_backend(None)
    both(lambda col: col.update(*batches[6]))
    both(lambda col: col.update(*batches[7]))
    _assert_same_values(fused.compute(), plain.compute())
    assert fused._fused_oo_step.counts["replayed"] >= 2


def test_update_count_and_compute_cache():
    plain, fused = _pair("multiclass")
    batches = [_t(b) for b in _multiclass_batches(sizes=(25,) * 4)]
    for i, batch in enumerate(batches, start=1):
        plain.update(*batch)
        fused.update(*batch)
        for name in fused.keys(keep_base=True):
            assert fused[name].update_count == plain[name].update_count == i
        leader = fused._modules["confmat"]
        first = leader.compute()
        assert leader.compute() is first  # served from the cache until the next update
        assert i == 1 or first is not previous
        previous = first
        _assert_same_values(fused.compute(), plain.compute())
    assert fused._fused_oo_step.counts["replayed"] == 1


def test_a_clone_builds_its_own_step():
    plain, fused = _pair("multiclass")
    batches = [_t(b) for b in _multiclass_batches(sizes=(25,) * 6)]
    for batch in batches[:3]:
        plain.update(*batch)
        fused.update(*batch)
    clone = copy.deepcopy(fused)
    assert fused._fused_oo_step is not None and clone._fused_oo_step is None
    assert pickle.loads(pickle.dumps(fused))._fused_oo_step is None
    for batch in batches[3:]:
        for col in (plain, fused, clone):
            col.update(*batch)
    assert clone._fused_oo_step is not None and clone._fused_oo_step is not fused._fused_oo_step
    assert clone._modules["acc"].tp is not fused._modules["acc"].tp
    _assert_same_states(clone, plain)
    _assert_same_states(fused, plain)
    _assert_same_values(clone.compute(), plain.compute())


def test_unhashable_kwargs_error_for_a_tensor_at_any_depth():
    metric = cls.MulticlassAccuracy(C, device="cpu")
    step = FusedCollectionStep(metric)
    state = step.init_state()
    preds, target = _t(_multiclass_batches(sizes=(8,))[0])
    for kwargs in ({"extra": {"deep": [torch.ones(2)]}}, {"extra": (1, torch.zeros(()))}, {"extra": [1, 2]}):
        with pytest.raises(UnhashableKwargsError):
            step.update(state, preds, target, **kwargs)
    with pytest.raises(UnhashableKwargsError):
        step.update(state, preds, target.tolist())  # a positional argument that is not a tensor
    assert issubclass(UnhashableKwargsError, TypeError)
    assert step.counts["unfused"] == 4 and step.program_count == 0
    with pytest.raises(ValueError, match="leaders"):
        FusedCollectionStep(metric, leaders=["acc"])


def test_establish_compute_groups_then_the_functional_step():
    """Groups from one throwaway update on probe copies; the step then covers
    the leaders only and matches the eager collection."""
    col = MetricCollection(_members("multiclass"), device="cpu")
    ref = MetricCollection(_members("multiclass"), device="cpu")
    batches = [_t(b) for b in _multiclass_batches(sizes=(30, 30, 30, 12))]
    col.establish_compute_groups(*batches[0])
    assert [sorted(g) for g in col.compute_groups.values()] == [["acc", "f1"], ["ap", "auroc"], ["confmat"]]
    assert all(m.update_count == 0 for m in col.values(copy_state=False))
    step = FusedCollectionStep(col)
    assert step.leaders == ["acc", "ap", "confmat"]
    state = step.init_state()
    for batch in batches:
        state = step.update(state, *batch)
        ref.update(*batch)
    _assert_same_values(col.functional_compute(state), ref.compute())
    assert step.program_count == 1 and step.counts["replayed"] == 1


def test_donate_false_returns_copies_and_keeps_the_callers_state():
    metric = cls.MulticlassConfusionMatrix(C, device="cpu")
    step = FusedCollectionStep(metric, donate=False)
    state = step.init_state()
    kept = state["confmat"]
    batches = [_t(b) for b in _multiclass_batches(sizes=(20,) * 4)]
    ref = cls.MulticlassConfusionMatrix(C, device="cpu")
    for batch in batches:
        new = step.update(state, *batch)
        assert new["confmat"] is not state["confmat"]
        state = new
        ref.update(*batch)
    assert int(kept.sum()) == 0
    assert torch.equal(state["confmat"], ref.confmat)


def test_gather_copies_into_owned_buffers_and_a_dtype_change_raises():
    metric = cls.MulticlassConfusionMatrix(C, device="cpu")
    owned = {}
    first, replaced = gather_donatable_state({"cm": metric._copy_state_dict()}, owned)
    buf = owned[("cm", "confmat")]
    assert first[("cm", "confmat")] is buf and buf is not metric.confmat and not replaced  # the default is never owned
    again, replaced = gather_donatable_state({"cm": {"confmat": buf}}, owned)
    assert again[("cm", "confmat")] is buf and not replaced
    grown, replaced = gather_donatable_state({"cm": {"confmat": torch.zeros((C + 1, C + 1), dtype=torch.int32)}}, owned)
    assert replaced and grown[("cm", "confmat")] is not buf

    class Widening(SumMetric):
        def update(self, value):
            self.sum_value = self.sum_value.double() + value.sum()

    step = FusedCollectionStep(Widening(device="cpu"))
    with pytest.raises(TPUMetricsUserError, match="fixed shape and dtype"):
        step.update(step.init_state(), torch.ones(3))


def test_functional_step_matches_the_jax_step():
    """The port's FusedCollectionStep (init_state, update) against the JAX
    package's on the same seeded batches: int32 states exact, values within
    1e-6."""

    def collections():
        port = MetricCollection(
            {"acc": cls.MulticlassAccuracy(C, device="cpu"), "auroc": cls.MulticlassAUROC(C, thresholds=T, device="cpu"),
             "confmat": cls.MulticlassConfusionMatrix(C, device="cpu")},
            device="cpu",
        )
        ref = tpumetrics.MetricCollection(
            {"acc": jax_cls.MulticlassAccuracy(C), "auroc": jax_cls.MulticlassAUROC(C, thresholds=T),
             "confmat": jax_cls.MulticlassConfusionMatrix(C)}
        )
        return port, ref

    port, ref = collections()
    batches = _multiclass_batches(seed=5, sizes=(32, 32, 32, 32))
    port.establish_compute_groups(*_t(batches[0]))
    ref.establish_compute_groups(*(jnp.asarray(x) for x in batches[0]))
    step, jax_step = FusedCollectionStep(port), JaxFusedCollectionStep(ref)
    state, jax_state = step.init_state(), jax_step.init_state()
    for batch in batches:
        state = step.update(state, *_t(batch))
        jax_state = jax_step.update(jax_state, *(jnp.asarray(x) for x in batch))
        for leader in jax_state:
            for name, val in jax_state[leader].items():
                got = state[leader][name].numpy()
                assert got.dtype == np.int32 and np.array_equal(got, np.asarray(val)), f"{leader}.{name}"
    got, want = port.functional_compute(state), ref.functional_compute(jax_state)
    for key in want:
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), rtol=0, atol=1e-6)
