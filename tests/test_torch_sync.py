"""Cross-rank sync of the port held against the JAX package.

Two parts:

- A real ``torch.distributed`` gloo world of 2 ranks and one of 3, each
  launched once for the whole module (two launches, five processes), run
  every scenario of ``tests/torch_sync_worker.py``: the main-path
  collection, exact binary AUROC over list states with one rank empty,
  MaskedBuffer states, a ragged list, every aggregator under every
  nan_strategy, a regression collection (Pearson's rank-stacked moments,
  ``MinMaxMetric``, Spearman, MSE) with a MinMax's extrema merged by
  "min"/"max", and the backend's own edge cases. The children import
  neither JAX nor the JAX package, rendezvous through a ``file://`` store
  under ``tmp_path``, and are joined within 120 s. Their synced
  ``compute()`` is held against the JAX package on the whole data, in this
  process (the MaskedBuffer case under ``shard_map`` on the CPU mesh, as
  ``tests/test_buffers.py`` runs it).
- The fused sync's collectives, counted with recording backends in one
  process, against the same schedule from the JAX package.

Tolerances: integer states and counts exact, float values within 1e-6,
relative to the value where it exceeds 1 (``RTOL``): a sum reduced rank by
rank adds in another order than the JAX sum over the whole data, and one
float32 step at 31 is already 1.9e-6.
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import tpumetrics
import tpumetrics.classification as jax_cls
import tpumetrics_torch
import tpumetrics_torch.classification as cls
from tests import torch_sync_worker as w
from tests.helpers.testers import shard_map
from tpumetrics.aggregation import MeanMetric as JaxMeanMetric
from tpumetrics.aggregation import SumMetric as JaxSumMetric
from tpumetrics.parallel import AxisBackend
from tpumetrics.parallel.backend import set_default_backend as jax_set_default_backend
from tpumetrics.parallel.fuse import FusedReducer as JaxFusedReducer
from tpumetrics.parallel.merge import merge_metric_states as jax_merge
from tpumetrics.parallel.merge import reshard_metric_states as jax_reshard
from tpumetrics_torch import MetricCollection
from tpumetrics_torch.parallel import (
    FusedReducer,
    NoOpBackend,
    TorchDistBackend,
    distributed_available,
    get_default_backend,
    merge_metric_states,
    reshard_metric_states,
    set_default_backend,
)
from tpumetrics_torch.utils.exceptions import TPUMetricsUserError

ATOL = 1e-6
RTOL = 1e-6
CORR_TOL = 1e-5  # Pearson and Spearman: float32 moments merged in another order than one pass
WORLDS = (2, 3)
JOIN_TIMEOUT_S = 120


# ------------------------------------------------------------ the gloo worlds


@pytest.fixture(scope="module")
def gloo(tmp_path_factory):
    """Every rank's results, ``{world: [rank0, rank1, ...]}``: one launch per
    world, both started before either is joined."""
    try:
        return w.run_worlds(WORLDS, tmp_path_factory.mktemp("gloo"), None, JOIN_TIMEOUT_S)
    except TimeoutError as err:
        pytest.fail(str(err))


@pytest.mark.parametrize("world", WORLDS)
def test_gloo_ranks_import_neither_jax_nor_the_jax_package(gloo, world):
    assert [r["modules"] for r in gloo[world]] == [[]] * world


def _jax_main_path():
    batches = w.multiclass_batches()
    col = tpumetrics.MetricCollection(
        {
            "acc": jax_cls.MulticlassAccuracy(w.C, average="micro", validate_args=False),
            "f1": jax_cls.MulticlassF1Score(w.C, average="macro", validate_args=False),
            "auroc": jax_cls.MulticlassAUROC(w.C, thresholds=w.T, validate_args=False),
        }
    )
    mean, cat = tpumetrics.MeanMetric(), tpumetrics.CatMetric()
    for (p, y), v in zip(batches, w.batch_values(batches)):
        col.update(jnp.asarray(p), jnp.asarray(y))
        mean.update(jnp.asarray(v))
        cat.update(jnp.asarray(v))
    ref = {k: np.asarray(v) for k, v in col.compute().items()}
    ref["mean"], ref["cat"] = np.asarray(mean.compute()), np.asarray(cat.compute())
    return ref


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("path", ["values", "functional"])
def test_gloo_main_path_collection_matches_jax_on_the_whole_data(gloo, world, path):
    ref = _jax_main_path()
    for res in gloo[world]:
        got = res["collection"][path]
        assert sorted(got) == sorted(ref)
        for k in ("acc", "f1", "auroc", "mean"):
            np.testing.assert_allclose(got[k], ref[k], rtol=0, atol=ATOL, err_msg=k)
        np.testing.assert_array_equal(got["cat"], ref["cat"])


@pytest.mark.parametrize("world", WORLDS)
def test_gloo_collection_syncs_one_reduce_per_class_and_unsyncs(gloo, world):
    for res in gloo[world]:
        col = res["collection"]
        # leaders only: acc (tp/fp/tn/fn) and auroc (confmat) are int32 sums, mean's two states float32 sums
        assert sorted((op, dt) for op, dt, _ in col["reduces"]) == [("sum", "torch.float32"), ("sum", "torch.int32")]
        assert sum(n for _, _, n in col["reduces"]) == col["leader_reduce_elements"]
        assert col["gathers"] == 1  # the CatMetric's list
        assert col["wire"] == 2 + 2 * 1  # each gather: one of shapes, one of data
        # after compute every state is back to the rank's own
        for leader, states in col["states_before"].items():
            for name, before in states.items():
                after = col["states_after"][leader][name]
                if isinstance(before, list):
                    assert len(after) == len(before) and all(np.array_equal(a, b) for a, b in zip(after, before))
                else:
                    assert after.dtype == before.dtype and np.array_equal(after, before)


@pytest.mark.parametrize("world", WORLDS)
def test_gloo_binary_exact_auroc_with_an_empty_rank_matches_jax(gloo, world):
    preds, target = w.binary_data()
    ref = jax_cls.BinaryAUROC(thresholds=None)
    ref.update(jnp.asarray(preds), jnp.asarray(target))
    rows = [res["binary_exact_auroc"]["local_rows"] for res in gloo[world]]
    assert sum(rows) == preds.size and (world == 2 or rows[-1] == 0)
    for res in gloo[world]:
        np.testing.assert_allclose(res["binary_exact_auroc"]["value"], np.asarray(ref.compute()), rtol=0, atol=ATOL)


@pytest.mark.parametrize("world", WORLDS)
def test_gloo_ragged_list_keeps_every_item_in_rank_order(gloo, world):
    want = []
    for r in range(world):
        want += [np.arange((r + 1) * (k + 2), dtype=np.float32).reshape(r + 1, k + 2) for k in range(r)]
        want.append(np.asarray(float(r), np.float32))
    for res in gloo[world]:
        got = res["ragged_list"]["items"]
        assert [g.shape for g in got] == [x.shape for x in want]
        assert all(np.array_equal(g, x) for g, x in zip(got, want))


@pytest.mark.parametrize("world", WORLDS)
def test_gloo_masked_buffer_sync_matches_jax_under_shard_map(gloo, world):
    from tests.test_buffers import MaskedCatAUROC

    from tests.conftest import cpu_mesh

    preds, target, keep = w.masked_buffer_data(world)
    metric = MaskedCatAUROC(capacity=32)

    def run(p, t):
        valid = jnp.arange(p.shape[0]) < (3 + 2 * jax.lax.axis_index("r"))
        state = metric.functional_update(metric.init_state(), p, t, valid=valid)
        return metric.sync_state(state, AxisBackend("r"))

    synced = jax.jit(shard_map(run, mesh=cpu_mesh(world), in_specs=(P("r"), P("r")), out_specs=P()))(
        jnp.asarray(preds.reshape(-1)), jnp.asarray(target.reshape(-1))
    )
    ref_value = np.asarray(metric.functional_compute(synced))
    for res in gloo[world]:
        got = res["masked_buffer"]["synced"]
        for name in ("preds", "target"):
            ref = synced[name]
            assert int(got[name]["count"]) == int(ref.count) == sum(keep)
            assert int(got[name]["requested"]) == int(ref.requested)
            assert got[name]["values"].shape == ref.values.shape == (world * 32,)
            assert got[name]["values"].dtype == np.asarray(ref.values).dtype
            n = int(ref.count)
            np.testing.assert_array_equal(got[name]["values"][:n], np.asarray(ref.values)[:n])
        np.testing.assert_allclose(res["masked_buffer"]["value"], ref_value, rtol=0, atol=ATOL)


def _jax_aggregator(name, strategy, batches, world):
    """The JAX aggregator on the whole data; a running one on the union of
    every rank's last window of batches."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        if name.startswith("Running"):
            metric = getattr(tpumetrics, "MeanMetric" if name == "RunningMean" else "SumMetric")(nan_strategy=strategy)
            feed = [b for sl in w.shards(len(batches), world) for b in w.last_window(batches[sl], w.WINDOW)]
        else:
            metric = getattr(tpumetrics, name)(nan_strategy=strategy)
            feed = batches
        for x, wt in feed:
            if name == "MeanMetric":
                metric.update(jnp.asarray(x), jnp.asarray(wt))
            else:
                metric.update(jnp.asarray(x))
        return np.asarray(metric.compute())


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("name", w.AGGREGATORS)
def test_gloo_aggregators_match_jax_on_the_whole_data(gloo, world, name):
    batches = w.aggregator_batches()
    for strategy in w.NAN_STRATEGIES:
        ref = _jax_aggregator(name, strategy, batches, world)
        for res in gloo[world]:
            got = res["aggregators"][f"{name}[{strategy}]"]
            if name == "CatMetric":
                assert got.dtype == ref.dtype and np.array_equal(got, ref, equal_nan=True), strategy
            else:
                np.testing.assert_allclose(got, ref, rtol=RTOL, atol=ATOL, equal_nan=True, err_msg=str(strategy))


@pytest.mark.parametrize("world", WORLDS)
def test_gloo_aggregator_collection_and_composition_match_jax(gloo, world):
    batches = w.aggregator_batches()
    ref = {}
    for key, name in [("sum", "SumMetric"), ("mean", "MeanMetric"), ("max", "MaxMetric"), ("min", "MinMetric"), ("cat", "CatMetric")]:
        metric = getattr(tpumetrics, name)(nan_strategy=0.0)
        for x, _ in batches:
            metric.update(jnp.asarray(x))
        ref[key] = np.asarray(metric.compute())
    composed = JaxSumMetric(nan_strategy="ignore") / JaxMeanMetric(nan_strategy="ignore")
    for x, _ in batches:
        composed.update(jnp.asarray(x))
    for res in gloo[world]:
        got = res["aggregator_collection"]
        for key in ref:
            np.testing.assert_allclose(got["values"][key], ref[key], rtol=RTOL, atol=ATOL, err_msg=key)
        np.testing.assert_allclose(got["composed"], np.asarray(composed.compute()), rtol=RTOL, atol=ATOL)
        # one reduce per (op, dtype) class: sum (sum, mean, weight), max, min; one gather (cat)
        assert sorted(op for op, _, _ in got["reduces"]) == ["max", "min", "sum"]
        assert sum(n for op, _, n in got["reduces"] if op == "sum") == 3
        assert got["gathers"] == 1


@pytest.mark.parametrize("world", WORLDS)
def test_gloo_running_metrics_in_a_collection_sync_the_union_of_last_windows(gloo, world):
    """RunningMean and RunningSum inside a synced MetricCollection, next to a
    SumMetric: each running value is that of the union of every rank's last
    window (the wrapped metric syncs once, in its own compute), not that
    union multiplied by the world size; the sum is that of the whole data."""
    batches = w.aggregator_batches()
    ref = {
        "sum": _jax_aggregator("SumMetric", 0.0, batches, world),
        "rmean": _jax_aggregator("RunningMean", 0.0, batches, world),
        "rsum": _jax_aggregator("RunningSum", 0.0, batches, world),
    }
    for res in gloo[world]:
        got = res["running_collection"]
        assert sorted(got["values"]) == sorted(ref)
        for key, val in ref.items():
            np.testing.assert_allclose(got["values"][key], val, rtol=RTOL, atol=ATOL, err_msg=key)


def _jax_regression_members():
    import tpumetrics.regression as jax_reg
    from tpumetrics.wrappers import MinMaxMetric as JaxMinMax

    return {
        "pearson": jax_reg.PearsonCorrCoef(),
        "minmax": JaxMinMax(jax_reg.MeanAbsoluteError()),
        "spearman": jax_reg.SpearmanCorrCoef(),
        "mse": jax_reg.MeanSquaredError(),
    }


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("path", ["values", "functional"])
def test_gloo_regression_collection_matches_jax_on_the_whole_data(gloo, world, path):
    """Pearson's rank-stacked moments merged rank by rank, MinMax's wrapped
    MAE, Spearman's gathered lists and MSE's sums, synced over gloo (one rank
    empty at world 3): every value that of the JAX collection on the whole
    data (MSE and MAE within RTOL, the correlations within CORR_TOL)."""
    ref = tpumetrics.MetricCollection(_jax_regression_members())
    for p, t in w.regression_batches():
        ref.update(jnp.asarray(p), jnp.asarray(t))
    want = {k: np.asarray(v) for k, v in ref.compute().items()}
    for res in gloo[world]:
        got = res["regression_collection"][path]
        assert sorted(got) == sorted(want) == ["max", "min", "mse", "pearson", "raw", "spearman"]
        for k in want:
            tol = CORR_TOL if k in ("pearson", "spearman") else RTOL
            np.testing.assert_allclose(got[k], want[k], rtol=tol, atol=ATOL, err_msg=k)
        assert sorted(map(sorted, res["regression_collection"]["groups"])) == [["minmax"], ["mse"], ["pearson"], ["spearman"]]


@pytest.mark.parametrize("world", WORLDS)
def test_gloo_text_states_sync_to_those_of_one_rank_fed_the_union(gloo, world):
    """BLEU's four float32 sums and EED's gathered sentence scores (one rank
    empty at world 3) equal bit for bit those of one metric fed every
    sentence, and so do the values; both values that of the JAX metrics."""
    import tpumetrics.text as jax_text

    preds, target = w.text_corpus()
    refs = [[t] for t in target]
    want = {"bleu": jax_text.BLEUScore(), "eed": jax_text.ExtendedEditDistance()}
    for m in want.values():
        m.update(preds, refs)
    for res in gloo[world]:
        for name, got in res["text"].items():
            assert sorted(got["synced"]) == sorted(got["union"])
            for k, v in got["union"].items():
                assert got["synced"][k].dtype == v.dtype
                np.testing.assert_array_equal(got["synced"][k], v, err_msg=f"{name} {k}")
            assert got["value"] == got["union_value"]
            np.testing.assert_allclose(got["value"], np.asarray(want[name].compute()), rtol=RTOL, atol=ATOL)
    assert gloo[world][0]["text"]["eed"]["synced"]["sentence_eed"].shape == (w.TEXT_PAIRS,)


@pytest.mark.parametrize("world", WORLDS)
def test_gloo_minmax_extrema_merge_with_min_and_max_as_jax(gloo, world):
    """Each rank's extrema, observed on its own batches, merge to the least
    minimum and the largest maximum over the ranks (an empty rank's +-inf
    drop out); the wrapped MSE syncs to the whole data's."""
    from tpumetrics.regression import MeanSquaredError as JaxMSE
    from tpumetrics.wrappers import MinMaxMetric as JaxMinMax

    batches = w.regression_batches()
    lows, highs = [], []
    for sl in w.shards(len(batches), world):
        m = JaxMinMax(JaxMSE())
        state = m.init_state()
        for p, t in batches[sl]:
            state, _ = m.functional_forward(state, jnp.asarray(p), jnp.asarray(t))
        lows.append(float(state["min_val"]))
        highs.append(float(state["max_val"]))
    whole = JaxMSE()
    for p, t in batches:
        whole.update(jnp.asarray(p), jnp.asarray(t))
    for res in gloo[world]:
        synced = res["regression_collection"]["minmax_synced"]
        np.testing.assert_allclose(synced["min_val"], min(lows), rtol=RTOL)
        np.testing.assert_allclose(synced["max_val"], max(highs), rtol=RTOL)
        np.testing.assert_allclose(res["regression_collection"]["minmax_value"]["raw"], np.asarray(whole.compute()),
                                   rtol=RTOL)


@pytest.mark.parametrize("world", WORLDS)
def test_gloo_backend_pads_gathers_means_ints_and_refuses_foreign_devices(gloo, world):
    for r, res in enumerate(gloo[world]):
        b = res["backend"]
        assert b["available"] and b["world_size"] == world and b["rank"] == r
        # rank 0's empty float32 placeholder took the int32 dtype and ndim of the ranks with data
        assert [(s, dt) for s, dt, _ in b["gathered"]] == [((0, 3), "torch.int32")] + [
            ((2 * q, 3), "torch.int32") for q in range(1, world)
        ]
        for q in range(1, world):
            np.testing.assert_array_equal(b["gathered"][q][2], np.arange(q * 6, dtype=np.int32).reshape(2 * q, 3))
        stacked = jnp.stack([jnp.asarray([q, 2 * q + 1], jnp.int32) for q in range(world)])
        ref = np.asarray(jnp.mean(stacked, axis=0))  # the JAX package's int "mean": a float32 mean
        assert b["mean"].dtype == ref.dtype
        np.testing.assert_allclose(b["mean"], ref, rtol=0, atol=ATOL)
        assert "'gloo'" in b["refused"] and "meta" in b["refused"]
        assert b["objects"] == [{"rank": q} for q in range(world)]


# ------------------------------------------- the fused schedule, one process


class _Recording(NoOpBackend):
    """World size 1 that syncs (identity values) and records every collective."""

    def __init__(self):
        self.reduces, self.gathers = [], 0

    def available(self):
        return True

    def all_gather(self, x, group=None):
        self.gathers += 1
        return [x]

    def all_reduce(self, x, op, group=None):
        self.reduces.append((op, str(x.dtype).replace("torch.", ""), int(np.prod(x.shape))))
        return x

    def all_gather_object(self, obj, group=None):
        return [obj]


class _Doubling(_Recording):
    """Two identical ranks: sums double, gathers repeat."""

    def all_reduce(self, x, op, group=None):
        super().all_reduce(x, op, group)
        return x + x if op == "sum" else x

    def all_gather(self, x, group=None):
        self.gathers += 1
        return [x, x]


def test_fused_reducer_one_collective_per_class_matches_jax():
    port, ref = _Recording(), _Recording()
    red, jred = FusedReducer(port), JaxFusedReducer(ref)
    vals = [
        (np.ones(3, np.float32), "sum"),
        (np.full((2, 2), 2.0, np.float32), "sum"),
        (np.asarray(5, np.int32), "sum"),
        (np.ones(4, np.float32), "max"),
    ]
    handles = [red.add(torch.from_numpy(np.array(v)), op) for v, op in vals]
    jhandles = [jred.add(jnp.asarray(v), op) for v, op in vals]
    red.flush()
    jred.flush()
    assert port.reduces == ref.reduces and len(port.reduces) == 3
    for h, jh in zip(handles, jhandles):
        got, want = red.result(h), np.asarray(jred.result(jh))
        assert got.shape == want.shape and got.numpy().dtype == want.dtype
        np.testing.assert_array_equal(got.numpy(), want)


def test_fused_reducer_guards():
    red = FusedReducer(_Recording())
    with pytest.raises(RuntimeError, match="before flush"):
        red.result(0)
    red.add(torch.ones(2), "sum")
    red.flush()
    with pytest.raises(RuntimeError, match="already flushed"):
        red.add(torch.ones(2), "sum")


def _pair_collections():
    """Accuracy and F1 (one compute group) and a binned AUROC, in both
    packages, after one batch."""
    p, y = w.multiclass_batches()[0]
    port = MetricCollection(
        {
            "acc": cls.MulticlassAccuracy(w.C, average="macro", validate_args=False, device="cpu"),
            "f1": cls.MulticlassF1Score(w.C, average="macro", validate_args=False, device="cpu"),
            "auroc": cls.MulticlassAUROC(w.C, thresholds=w.T, validate_args=False, device="cpu"),
        },
        device="cpu",
    )
    ref = tpumetrics.MetricCollection(
        {
            "acc": jax_cls.MulticlassAccuracy(w.C, average="macro", validate_args=False),
            "f1": jax_cls.MulticlassF1Score(w.C, average="macro", validate_args=False),
            "auroc": jax_cls.MulticlassAUROC(w.C, thresholds=w.T, validate_args=False),
        }
    )
    port.update(torch.from_numpy(p), torch.from_numpy(y))
    ref.update(jnp.asarray(p), jnp.asarray(y))
    return port, ref


@pytest.mark.parametrize("backend_cls", [_Recording, _Doubling])
def test_collection_compute_registers_leaders_only_and_matches_jax(backend_cls):
    port, ref = _pair_collections()
    assert [list(g) for g in port.compute_groups.values()] == [["acc", "f1"], ["auroc"]]
    pb, jb = backend_cls(), backend_cls()
    set_default_backend(pb)
    jax_set_default_backend(jb)
    try:
        got, want = port.compute(), ref.compute()
    finally:
        set_default_backend(None)
        jax_set_default_backend(None)
    # one int32 "sum" for the two leaders' states; the member f1 adds nothing
    assert pb.reduces == jb.reduces == [("sum", "int32", 4 * w.C + w.T * w.C * 4)]
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=0, atol=ATOL, err_msg=k)
    for m in port.values():
        assert not m._is_synced and m._to_sync and m._cache is None


def test_compositional_metric_syncs_under_a_distributed_backend():
    be = _Recording()
    set_default_backend(be)
    try:
        c = tpumetrics_torch.SumMetric(device="cpu") + tpumetrics_torch.SumMetric(device="cpu")
        c.update(torch.tensor([1.0, 2.0]))
        assert float(c.compute()) == pytest.approx(6.0)
    finally:
        set_default_backend(None)
    assert be.reduces == [("sum", "float32", 1)] * 2  # each child in its own compute


def test_member_with_its_own_process_group_syncs_on_its_own():
    be = _Recording()
    groups = []

    class _Grouped(_Recording):
        def all_reduce(self, x, op, group=None):
            groups.append(group)
            return x

    col = MetricCollection(
        {
            "a": tpumetrics_torch.SumMetric(device="cpu"),
            "b": tpumetrics_torch.SumMetric(device="cpu", process_group="g", sync_backend=_Grouped()),
        },
        compute_groups=False,
        device="cpu",
    )
    col.update(torch.tensor([1.0, 2.0]))
    set_default_backend(be)
    try:
        col.compute()
    finally:
        set_default_backend(None)
    assert len(be.reduces) == 1 and groups == ["g"]


def test_a_failing_collective_propagates_and_restores_the_states():
    class _Broken(_Recording):
        def all_reduce(self, x, op, group=None):
            raise ConnectionError("peer lost")

    port, _ = _pair_collections()
    leader = port["acc"]
    local = leader.tp
    set_default_backend(_Broken())
    try:
        with pytest.raises(ConnectionError, match="peer lost"):
            port.compute()
    finally:
        set_default_backend(None)
    assert leader.tp is local  # the leader's own tensor again, not a synced one
    for m in port.values():
        assert not m._is_synced and m._to_sync and m._cache is None
    assert float(port.compute()["acc"]) >= 0  # usable again, locally


def test_sync_unsync_contract_and_custom_dist_sync_fn():
    m = tpumetrics_torch.SumMetric(device="cpu", distributed_available_fn=lambda: True, sync_backend=_Doubling())
    m.update(torch.tensor([1.0, 2.0]))
    with pytest.raises(TPUMetricsUserError, match="un-synced"):
        m.unsync()
    m.sync()
    assert float(m.sum_value) == 6.0
    with pytest.raises(TPUMetricsUserError, match="already been synced"):
        m.sync()
    with pytest.raises(TPUMetricsUserError, match="unsync"):
        m(torch.tensor([1.0]))
    m.unsync()
    assert float(m.sum_value) == 3.0
    # a custom gather over two equal ranks, as in the JAX package
    gathered = tpumetrics_torch.CatMetric(device="cpu", distributed_available_fn=lambda: True, dist_sync_fn=lambda x, g: [x, x])
    gathered.update(torch.tensor([1.0, 2.0]))
    ref = tpumetrics.CatMetric(distributed_available_fn=lambda: True, dist_sync_fn=lambda x, g: [x, x])
    ref.update(jnp.asarray([1.0, 2.0]))
    np.testing.assert_array_equal(gathered.compute().numpy(), np.asarray(ref.compute()))


def test_dist_sync_on_step_syncs_every_forward():
    m = tpumetrics_torch.SumMetric(device="cpu", dist_sync_on_step=True, distributed_available_fn=lambda: True, sync_backend=_Doubling())
    assert float(m(torch.tensor([1.0, 2.0]))) == 6.0  # the batch value, synced
    assert float(m.sum_value) == 3.0 and not m._is_synced  # the local state
    assert float(m.compute()) == 6.0


def test_axis_name_points_to_backend():
    m = tpumetrics_torch.SumMetric(device="cpu")
    with pytest.raises(ValueError, match="backend="):
        m.functional_compute(m.init_state(), axis_name="dp")
    col = MetricCollection({"s": m}, device="cpu")
    with pytest.raises(ValueError, match="backend="):
        col.functional_compute(col.init_state(), axis_name="dp")


def test_default_backend_choice_without_a_process_group():
    assert not torch.distributed.is_initialized()
    assert isinstance(get_default_backend(), NoOpBackend) and not distributed_available()
    assert not TorchDistBackend().available()
    marker = _Recording()
    set_default_backend(marker)
    try:
        assert get_default_backend() is marker and distributed_available()
    finally:
        set_default_backend(None)
    assert isinstance(get_default_backend(), NoOpBackend)


def test_compute_on_cpu_moves_list_states_to_the_host():
    m = tpumetrics_torch.CatMetric(device="cpu", compute_on_cpu=True)
    m.update(torch.tensor([1.0, 2.0]))
    assert all(v.device.type == "cpu" for v in m.value)
    assert m.compute().tolist() == [1.0, 2.0]


# ------------------------------------------------------------ merge / reshard


def _merge_cases():
    """Per-rank states of a sum, a max, a cat-tensor and a cat-list state, in numpy."""
    rng = np.random.default_rng(2)
    return [
        {
            "total": rng.integers(0, 9, 4).astype(np.int32),
            "peak": rng.random(3).astype(np.float32),
            "rows": rng.random(2 + r).astype(np.float32),
            "items": [rng.random(r + 1).astype(np.float32)] if r != 1 else [],
        }
        for r in range(3)
    ]


def _reductions(pkg_data):
    return {
        "total": pkg_data.dim_zero_sum,
        "peak": pkg_data.dim_zero_max,
        "rows": pkg_data.dim_zero_cat,
        "items": pkg_data.dim_zero_cat,
    }


def _to(pkg, state):
    conv = torch.from_numpy if pkg == "torch" else jnp.asarray
    return {k: [conv(x) for x in v] if isinstance(v, list) else conv(v) for k, v in state.items()}


def _same(port_state, jax_state):
    assert sorted(port_state) == sorted(jax_state)
    for k, want in jax_state.items():
        got = port_state[k]
        if isinstance(want, list):
            assert len(got) == len(want)
            for g, x in zip(got, want):
                np.testing.assert_array_equal(g.numpy(), np.asarray(x))
        else:
            assert got.numpy().dtype == np.asarray(want).dtype
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_merge_metric_states_matches_jax():
    import tpumetrics.utils.data as jdata

    import tpumetrics_torch.utils.data as tdata

    states = _merge_cases()
    got = merge_metric_states([_to("torch", s) for s in states], _reductions(tdata))
    want = jax_merge([_to("jax", s) for s in states], _reductions(jdata))
    _same(got, want)


@pytest.mark.parametrize("placement", ["rank0", "balanced"])
@pytest.mark.parametrize("world", [2, 3])
def test_reshard_metric_states_matches_jax_and_merges_back(placement, world):
    import tpumetrics.utils.data as jdata

    import tpumetrics_torch.utils.data as tdata

    states = _merge_cases()
    merged_t = merge_metric_states([_to("torch", s) for s in states], _reductions(tdata))
    merged_j = jax_merge([_to("jax", s) for s in states], _reductions(jdata))
    shares = []
    for r in range(world):
        got = reshard_metric_states(merged_t, _reductions(tdata), r, world, cat_placement=placement)
        _same(got, jax_reshard(merged_j, _reductions(jdata), r, world, cat_placement=placement))
        shares.append(got)
    _same(merge_metric_states(shares, _reductions(tdata)), merged_j)


def test_reshard_refuses_what_has_no_inverse():
    with pytest.raises(TPUMetricsUserError, match="gather"):
        reshard_metric_states({"x": torch.zeros(2)}, {"x": None}, 0, 2)
    with pytest.raises(TPUMetricsUserError, match="custom reduce"):
        reshard_metric_states({"x": torch.zeros(2)}, {"x": lambda s: s.sum(0)}, 0, 2)
