"""One rank of a real ``torch.distributed`` gloo world for ``tests/test_torch_sync.py``.

Each rank makes the same global data from a seed with numpy, takes its own
contiguous shard, runs every scenario below through the port with
``compute()`` synced across the world, and pickles what it computed to
``<out_dir>/rank<r>.pkl``. The parent test holds those results against the
JAX package on the whole data. This module imports neither JAX nor the JAX
package (the parent checks ``sys.modules`` as each rank reports it).
"""

from __future__ import annotations

import os
import pickle
import sys
from typing import Any, Callable, Dict, List

import numpy as np
import torch
import torch.distributed as dist

C, T = 16, 64  # BASELINE config #2's classes and thresholds
N_BATCHES, BATCH = 6, 1024  # config #2: B=1024
AGG_BATCHES, AGG_SIZE = 6, 5
REG_BATCHES, REG_SIZE = 6, 256
WINDOW = 2
NAN_STRATEGIES = ("warn", "ignore", 10.0, "disable")
AGGREGATORS = ("SumMetric", "MeanMetric", "MaxMetric", "MinMetric", "CatMetric", "RunningMean", "RunningSum")


# ----------------------------------------------------------------- the data (numpy)


def multiclass_batches(seed: int = 3) -> List[tuple]:
    """Softmax probabilities ``(BATCH, C)`` float32 and int labels, N_BATCHES of them."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(N_BATCHES):
        z = rng.standard_normal((BATCH, C)).astype(np.float32)
        e = np.exp(z - z.max(axis=1, keepdims=True))
        out.append(((e / e.sum(axis=1, keepdims=True)).astype(np.float32), rng.integers(0, C, BATCH)))
    return out


def batch_values(batches: List[tuple]) -> List[np.ndarray]:
    """A per-batch value for the MeanMetric and CatMetric of the collection:
    the batch's mean top probability (float32, computed the same way everywhere)."""
    return [p.max(axis=1).mean(dtype=np.float32).reshape(1) for p, _ in batches]


def binary_data(seed: int = 5) -> tuple:
    """120 binary preds with ties (multiples of 1/16) and targets."""
    rng = np.random.default_rng(seed)
    target = rng.integers(0, 2, 120)
    preds = (np.round(16 * rng.random(120)) / 16).astype(np.float32)
    return preds, target


def aggregator_batches(seed: int = 7) -> List[tuple]:
    """AGG_BATCHES batches of (values, weights), float32, with NaNs in two of them."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(AGG_BATCHES):
        x = rng.random(AGG_SIZE).astype(np.float32)
        w = (rng.random(AGG_SIZE) + 0.5).astype(np.float32)
        if i in (1, 4):
            x[i % AGG_SIZE] = np.nan
        out.append((x, w))
    return out


def regression_batches(seed: int = 17) -> List[tuple]:
    """REG_BATCHES batches of (preds, target), float32, targets on a grid of
    halves (ties for Spearman), preds the target plus noise."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(REG_BATCHES):
        target = (np.round(rng.normal(size=REG_SIZE) * 2) / 2).astype(np.float32)
        out.append(((target + 0.5 * rng.normal(size=REG_SIZE)).astype(np.float32), target))
    return out


def masked_buffer_data(world: int, per_rank: int = 20, seed: int = 11) -> tuple:
    """Each rank's ``per_rank`` preds and targets; rank r keeps 3 + 2r of them."""
    rng = np.random.default_rng(seed)
    preds = rng.random(world * per_rank).astype(np.float32)
    target = rng.integers(0, 2, world * per_rank).astype(np.int32)
    keep = [3 + 2 * r for r in range(world)]
    return preds.reshape(world, per_rank), target.reshape(world, per_rank), keep


def shards(n_items: int, world: int) -> List[slice]:
    """Contiguous, uneven shards: at world 2, a third and two thirds; at
    world 3, halves for ranks 0 and 1 and nothing for rank 2 (a rank with
    no data)."""
    if world == 2:
        cut = n_items // 3
        return [slice(0, cut), slice(cut, n_items)]
    half = n_items // 2
    return [slice(0, half), slice(half, n_items), slice(n_items, n_items)]


def last_window(items: list, window: int) -> list:
    return items[max(0, len(items) - window) :]


# ------------------------------------------------------------------ the rank's side


def _np(x: Any) -> Any:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    if isinstance(x, dict):
        return {k: _np(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)) and not hasattr(x, "_fields"):
        return [_np(v) for v in x]
    if hasattr(x, "_fields"):  # a MaskedBuffer
        return {f: _np(getattr(x, f)) for f in x._fields}
    return x


def _counting_backend():
    from tpumetrics_torch.parallel import TorchDistBackend

    class Counting(TorchDistBackend):
        """Counts the collectives of a sync: logical ones, and the wire ops."""

        def __init__(self) -> None:
            super().__init__()
            self.reduces: List[tuple] = []
            self.gathers = 0
            self.wire = 0

        def all_reduce(self, x, op, group=None):
            self.reduces.append((op, str(x.dtype), x.numel()))
            self.wire += 1
            return super().all_reduce(x, op, group)

        def all_gather(self, x, group=None):
            self.gathers += 1
            return super().all_gather(x, group)

        def _gather_equal(self, x, group):
            self.wire += 1
            return super()._gather_equal(x, group)

    return Counting()


def scenario_collection(rank: int, world: int) -> Dict[str, Any]:
    """The main-path collection (micro accuracy, macro F1, binned AUROC) with
    a MeanMetric and a CatMetric of per-batch values, synced in compute()."""
    from tpumetrics_torch import CatMetric, MeanMetric, MetricCollection
    from tpumetrics_torch import classification as cls
    from tpumetrics_torch.interop import export_state
    from tpumetrics_torch.parallel import TorchDistBackend, set_default_backend

    batches = multiclass_batches()
    values = batch_values(batches)
    mine = shards(len(batches), world)[rank]
    col = MetricCollection(
        {
            "acc": cls.MulticlassAccuracy(C, average="micro", validate_args=False, device="cpu"),
            "f1": cls.MulticlassF1Score(C, average="macro", validate_args=False, device="cpu"),
            "auroc": cls.MulticlassAUROC(C, thresholds=T, validate_args=False, device="cpu"),
            "mean": MeanMetric(device="cpu"),
            "cat": CatMetric(device="cpu"),
        },
        compute_groups=[["acc", "f1"], ["auroc"], ["mean"], ["cat"]],
        device="cpu",
    )
    for (p, y), v in zip(batches[mine], values[mine]):
        col.update(preds=torch.from_numpy(p), target=torch.from_numpy(y), value=torch.from_numpy(v))
    before = export_state(col)
    counting = _counting_backend()
    set_default_backend(counting)
    try:
        synced = col.compute()
    finally:
        set_default_backend(None)
    after = export_state(col)
    leaders = [col._modules[g[0]] for g in col.compute_groups.values()]
    leader_reduce_elements = sum(v.numel() for m in leaders for v in m.metric_state().values() if isinstance(v, torch.Tensor))
    # the same sync through the functional path
    state = col.init_state()
    for (p, y), v in zip(batches[mine], values[mine]):
        state = col.functional_update(state, preds=torch.from_numpy(p), target=torch.from_numpy(y), value=torch.from_numpy(v))
    functional = col.functional_compute(state, backend=TorchDistBackend())
    return {
        "values": _np(synced),
        "functional": _np(functional),
        "states_before": before,
        "states_after": after,
        "reduces": counting.reduces,
        "gathers": counting.gathers,
        "wire": counting.wire,
        "leader_reduce_elements": leader_reduce_elements,
    }


def scenario_binary_exact_auroc(rank: int, world: int) -> Dict[str, Any]:
    """Exact binary AUROC over list states; at world 3 rank 2 has no data."""
    from tpumetrics_torch import classification as cls

    preds, target = binary_data()
    mine = shards(preds.shape[0], world)[rank]
    import warnings

    metric = cls.BinaryAUROC(thresholds=None, device="cpu")
    if preds[mine].size:
        metric.update(torch.from_numpy(preds[mine]), torch.from_numpy(target[mine]))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # a rank with no data warns that compute came before update
        value = metric.compute()
    return {"value": _np(value), "local_rows": int(sum(t.numel() for t in metric.preds))}


def ragged_items_metric():
    """A metric with a reduce-None ragged list state: items of different
    shapes and ranks, gathered with their boundaries kept."""
    from tpumetrics_torch.metric import Metric

    class RaggedItems(Metric):
        full_state_update = False

        def __init__(self, **kw):
            super().__init__(**kw)
            self.add_state("items", [], dist_reduce_fx=None)

        def update(self, x):
            self.items.append(x)

        def compute(self):
            return list(self.items)

    return RaggedItems(device="cpu")


def scenario_ragged_list(rank: int, world: int) -> Dict[str, Any]:
    metric = ragged_items_metric()
    for k in range(rank):  # rank 0 adds nothing
        metric.update(torch.arange((rank + 1) * (k + 2), dtype=torch.float32).reshape(rank + 1, k + 2))
    metric.update(torch.tensor(float(rank)))  # a 0-d item
    return {"items": _np(metric.compute())}


def masked_cat_auroc(capacity: int):
    """An exact AUROC over two fixed-capacity list states (preds float32,
    target int32), appended with a validity mask."""
    from tpumetrics_torch.functional.classification import binary_auroc
    from tpumetrics_torch.metric import Metric
    from tpumetrics_torch.utils.data import dim_zero_cat

    class MaskedCatAUROC(Metric):
        full_state_update = False

        def __init__(self, **kwargs):
            super().__init__(**kwargs)
            self.add_state("preds", default=[], dist_reduce_fx="cat", capacity=capacity)
            self.add_state("target", default=[], dist_reduce_fx="cat", capacity=capacity, feature_dtype=torch.int32)

        def update(self, preds, target, valid=None):
            self._append_state("preds", preds, valid=valid)
            self._append_state("target", target, valid=valid)

        def compute(self):
            return binary_auroc(dim_zero_cat(self.preds), dim_zero_cat(self.target), thresholds=None)

    return MaskedCatAUROC(device="cpu")


def scenario_masked_buffer(rank: int, world: int) -> Dict[str, Any]:
    """MaskedBuffer states on the functional path: rank r keeps 3 + 2r of its rows."""
    from tpumetrics_torch.parallel import TorchDistBackend

    preds, target, keep = masked_buffer_data(world)
    metric = masked_cat_auroc(capacity=32)
    valid = torch.arange(preds.shape[1]) < keep[rank]
    state = metric.functional_update(
        metric.init_state(), torch.from_numpy(preds[rank]), torch.from_numpy(target[rank]), valid=valid
    )
    synced = metric.sync_state(state, TorchDistBackend())
    return {
        "synced": _np(synced),
        "value": _np(metric.functional_compute(state, backend=TorchDistBackend())),
    }


def _aggregator(name: str, nan_strategy: Any):
    import tpumetrics_torch as tm

    if name.startswith("Running"):
        return getattr(tm, name)(window=WINDOW, nan_strategy=nan_strategy, device="cpu")
    return getattr(tm, name)(nan_strategy=nan_strategy, device="cpu")


def scenario_aggregators(rank: int, world: int) -> Dict[str, Any]:
    """Every aggregator under every non-raising nan_strategy, each synced in
    its own compute(); at world 3 rank 2 has no data."""
    import warnings

    batches = aggregator_batches()
    mine = batches[shards(len(batches), world)[rank]]
    out: Dict[str, Any] = {}
    for name in AGGREGATORS:
        for strategy in NAN_STRATEGIES:
            metric = _aggregator(name, strategy)
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")  # "warn" drops NaNs with a warning; no-data ranks warn at compute
                for x, w in mine:
                    if name == "MeanMetric":
                        metric.update(torch.from_numpy(x), torch.from_numpy(w))
                    else:
                        metric.update(torch.from_numpy(x))
                value = metric.compute()
            out[f"{name}[{strategy}]"] = _np(value)
    return out


def scenario_aggregator_collection(rank: int, world: int) -> Dict[str, Any]:
    """Sum, Mean, Max, Min and Cat in one collection, and a CompositionalMetric."""
    import warnings

    from tpumetrics_torch import CatMetric, MaxMetric, MeanMetric, MetricCollection, MinMetric, SumMetric

    batches = aggregator_batches()
    mine = batches[shards(len(batches), world)[rank]]
    col = MetricCollection(
        {
            "sum": SumMetric(nan_strategy=0.0, device="cpu"),
            "mean": MeanMetric(nan_strategy=0.0, device="cpu"),
            "max": MaxMetric(nan_strategy=0.0, device="cpu"),
            "min": MinMetric(nan_strategy=0.0, device="cpu"),
            "cat": CatMetric(nan_strategy=0.0, device="cpu"),
        },
        compute_groups=False,
        device="cpu",
    )
    composed = SumMetric(nan_strategy="ignore", device="cpu") / MeanMetric(nan_strategy="ignore", device="cpu")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        for x, _ in mine:
            col.update(torch.from_numpy(x))
            composed.update(torch.from_numpy(x))
        counting = _counting_backend()
        from tpumetrics_torch.parallel import set_default_backend

        set_default_backend(counting)
        try:
            values = col.compute()
        finally:
            set_default_backend(None)
        composed_value = composed.compute()
    return {
        "values": _np(values),
        "composed": _np(composed_value),
        "reduces": counting.reduces,
        "gathers": counting.gathers,
    }


def scenario_running_collection(rank: int, world: int) -> Dict[str, Any]:
    """RunningMean and RunningSum next to a SumMetric in one collection,
    synced in the collection's compute(): each Running metric's wrapped
    metric syncs the union of every rank's last window."""
    import warnings

    from tpumetrics_torch import MetricCollection, RunningMean, RunningSum, SumMetric

    batches = aggregator_batches()
    mine = batches[shards(len(batches), world)[rank]]
    col = MetricCollection(
        {
            "sum": SumMetric(nan_strategy=0.0, device="cpu"),
            "rmean": RunningMean(window=WINDOW, nan_strategy=0.0, device="cpu"),
            "rsum": RunningSum(window=WINDOW, nan_strategy=0.0, device="cpu"),
        },
        device="cpu",
    )
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # a rank without data warns at compute
        for x, _ in mine:
            col.update(torch.from_numpy(x))
        values = col.compute()
    return {"values": _np(values), "groups": [list(g) for g in col.compute_groups.values()]}


def scenario_regression_collection(rank: int, world: int) -> Dict[str, Any]:
    """Pearson (rank-stacked moments), MinMaxMetric over MAE, Spearman (cat)
    and MSE in one collection, synced in compute() and through the
    functional path; and a MinMaxMetric whose extrema this rank observed on
    its own batches (``functional_forward``), merged across ranks with
    "min"/"max" through its ``_sync_state_collect``."""
    import warnings

    from tpumetrics_torch import MetricCollection
    from tpumetrics_torch import regression as reg
    from tpumetrics_torch.parallel import TorchDistBackend
    from tpumetrics_torch.wrappers import MinMaxMetric

    mine = regression_batches()[shards(REG_BATCHES, world)[rank]]

    def members():
        return {
            "pearson": reg.PearsonCorrCoef(device="cpu"),
            "minmax": MinMaxMetric(reg.MeanAbsoluteError(device="cpu")),
            "spearman": reg.SpearmanCorrCoef(device="cpu"),
            "mse": reg.MeanSquaredError(device="cpu"),
        }

    col = MetricCollection(members(), device="cpu")
    fcol = MetricCollection(members(), compute_groups=[["pearson"], ["minmax"], ["spearman"], ["mse"]], device="cpu")
    state = fcol.init_state()
    minmax = MinMaxMetric(reg.MeanSquaredError(device="cpu"))
    mm_state = minmax.init_state()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # a rank without data warns at compute
        for p, t in mine:
            p, t = torch.from_numpy(p), torch.from_numpy(t)
            col.update(p, t)
            state = fcol.functional_update(state, p, t)
            mm_state, _ = minmax.functional_forward(mm_state, p, t)
        values = col.compute()
        functional = fcol.functional_compute(state, backend=TorchDistBackend())
        mm_synced = minmax.sync_state(mm_state, TorchDistBackend())
    return {
        "values": _np(values),
        "functional": _np(functional),
        "minmax_synced": _np(mm_synced),
        "minmax_value": _np(minmax.functional_compute(mm_synced)),
        "groups": [list(g) for g in col.compute_groups.values()],
    }


def scenario_backend(rank: int, world: int) -> Dict[str, Any]:
    """The backend's own edge cases: gathers of ranks that differ in ndim,
    dtype and size, an int "mean", and a state the group cannot carry."""
    from tpumetrics_torch.parallel import TorchDistBackend

    backend = TorchDistBackend()
    if rank == 0:
        x = torch.zeros((0,), dtype=torch.float32)  # an empty list state's placeholder
    else:
        x = torch.arange(rank * 2 * 3, dtype=torch.int32).reshape(rank * 2, 3)
    gathered = backend.all_gather(x)
    mean = backend.all_reduce(torch.tensor([rank, 2 * rank + 1], dtype=torch.int32), "mean")
    try:
        backend.all_reduce(torch.zeros(2, device="meta"), "sum")
        refused = ""
    except RuntimeError as err:
        refused = str(err)
    objects = backend.all_gather_object({"rank": rank})
    return {
        "gathered": [(tuple(g.shape), str(g.dtype), g.numpy()) for g in gathered],
        "mean": mean.numpy(),
        "refused": refused,
        "objects": objects,
        "available": backend.available(),
        "world_size": backend.world_size(),
        "rank": backend.rank(),
    }


# ------------------------------------------- the ledger and the monitoring metrics


MON_UPDATES, MON_BATCH = 7, 96  # every rank ticks every update: each batch is split across the ranks
MON_WINDOW, MON_SLOTS = 4, 2


def monitoring_batches(seed: int = 23) -> List[tuple]:
    """MON_UPDATES batches of (values, valid): log-normal values with some on
    bucket edges (integers), NaNs and a masked-out tail."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(MON_UPDATES):
        x = rng.lognormal(1.0, 1.0, MON_BATCH).astype(np.float32)
        x[::5] = np.round(x[::5])
        x[i] = np.nan
        valid = np.ones(MON_BATCH, dtype=bool)
        valid[-3:] = False
        out.append((x, valid))
    return out


def rank_rows(world: int, rank: int, n: int = MON_BATCH) -> slice:
    """Rank ``rank``'s rows of every batch: contiguous, the last rank the rest."""
    per = n // world
    return slice(rank * per, n if rank == world - 1 else (rank + 1) * per)


def monitoring_members(device: str = "cpu") -> Dict[str, Any]:
    from tpumetrics_torch import monitoring as mon

    ref = monitoring_batches(seed=29)[0][0]
    return {
        "quantiles": mon.SketchQuantiles((0.1, 0.5, 0.9), window=MON_WINDOW, slots=MON_SLOTS, device=device),
        "cumulative": mon.SketchQuantiles((0.5,), device=device),
        "psi": mon.PSI(ref, window=MON_WINDOW, slots=MON_SLOTS, device=device),
        "mean": mon.WindowedMean(MON_WINDOW, slots=MON_SLOTS, device=device),
        "max": mon.WindowedMax(MON_WINDOW, device=device),
        "min": mon.WindowedMin(MON_WINDOW, device=device),
        "decayed": mon.DecayedMean(half_life=2.0, device=device),
    }


def scenario_ledger(rank: int, world: int) -> Dict[str, Any]:
    """The main-path collection with a MeanMetric and a CatMetric, its
    ``compute()`` synced inside a ledger capture, beside a backend that
    counts what it sends."""
    from tpumetrics_torch import CatMetric, MeanMetric, MetricCollection, telemetry
    from tpumetrics_torch import classification as cls
    from tpumetrics_torch.parallel import set_default_backend

    batches = multiclass_batches()
    values = batch_values(batches)
    mine = shards(len(batches), world)[rank]
    col = MetricCollection(
        {
            "acc": cls.MulticlassAccuracy(C, average="micro", validate_args=False, device="cpu"),
            "auroc": cls.MulticlassAUROC(C, thresholds=T, validate_args=False, device="cpu"),
            "mean": MeanMetric(device="cpu"),
            "cat": CatMetric(device="cpu"),
        },
        device="cpu",
    )
    for (p, y), v in zip(batches[mine], values[mine]):
        col.update(preds=torch.from_numpy(p), target=torch.from_numpy(y), value=torch.from_numpy(v))
    counting = _counting_backend()
    set_default_backend(counting)
    try:
        with telemetry.capture() as led:
            col.compute()
    finally:
        set_default_backend(None)
    return {"records": [r.to_dict() for r in led.records], "summary": led.summary(), "wire": counting.wire,
            "reduces": counting.reduces, "gathers": counting.gathers}


def scenario_monitoring(rank: int, world: int) -> Dict[str, Any]:
    """The monitoring members in one collection, each rank updating with its
    rows of every batch (so the ranks tick together), ``compute()`` synced,
    and the synced states through the functional path."""
    from tpumetrics_torch import MetricCollection
    from tpumetrics_torch.parallel import TorchDistBackend

    rows = rank_rows(world, rank)
    col = MetricCollection(monitoring_members(), compute_groups=False, device="cpu")
    for x, valid in monitoring_batches():
        col.update(torch.from_numpy(x[rows]), torch.from_numpy(valid[rows]))
    values = col.compute()
    state = {name: m._copy_state_dict() for name, m in col.items(keep_base=True, copy_state=False)}
    synced = col.sync_states(state, TorchDistBackend())
    return {"values": _np(values), "synced": _np(synced)}


def detection_images(n: int = 12, seed: int = 29) -> tuple:
    """``n`` images of detections and ground truths (3 classes, crowds, user areas, an empty image), numpy."""
    rng = np.random.default_rng(seed)
    preds, target = [], []
    for i in range(n):
        ng, nd = (0, 0) if i == 4 else (int(rng.integers(1, 6)), int(rng.integers(1, 9)))
        xy, wh = rng.uniform(0, 60, (ng, 2)), rng.uniform(4, 40, (ng, 2))
        gt = np.concatenate([xy, xy + wh], 1).astype(np.float32)
        det = (gt[rng.integers(0, max(ng, 1), nd)] + rng.normal(0, 2, (nd, 4))).astype(np.float32) if ng else np.zeros((0, 4), np.float32)
        labels = rng.integers(0, 3, ng)
        preds.append({"boxes": det, "scores": rng.random(nd).astype(np.float32),
                      "labels": (labels[rng.integers(0, ng, nd)] if ng else np.zeros(0, np.int64)).astype(np.int64)})
        target.append({"boxes": gt, "labels": labels.astype(np.int64), "iscrowd": (rng.random(ng) < 0.2).astype(np.int64),
                       "area": np.where(rng.random(ng) < 0.5, rng.uniform(20, 900, ng), 0).astype(np.float32)})
    return preds, target


def scenario_detection(rank: int, world: int) -> Dict[str, Any]:
    """``MeanAveragePrecision`` on each rank's contiguous shard of images (list-of-dicts, two updates), its
    ``compute()`` synced: the ragged per-image list states gather with their image boundaries. A packed state's
    sync is refused."""
    from tpumetrics_torch.detection import MeanAveragePrecision, pack_detection_batch
    from tpumetrics_torch.utils.exceptions import TPUMetricsUserError

    preds, target = detection_images()
    sl = shards(len(preds), world)[rank]
    p = [{k: torch.from_numpy(v) for k, v in d.items()} for d in preds[sl]]
    t = [{k: torch.from_numpy(v) for k, v in d.items()} for d in target[sl]]
    m = MeanAveragePrecision(class_metrics=True, device="cpu")
    half = len(p) // 2
    m.update(p[:half], t[:half])
    m.update(p[half:], t[half:])
    values = m.compute()
    packed = MeanAveragePrecision(device="cpu")
    pd, gd = pack_detection_batch(preds[sl], target[sl])
    packed.update({k: torch.from_numpy(v) for k, v in pd.items()}, {k: torch.from_numpy(v) for k, v in gd.items()})
    try:
        packed.compute()
        refused = ""
    except TPUMetricsUserError as err:
        refused = str(err)
    return {"values": _np(values), "packed_refused": refused}


TEXT_WORDS = "the cat sat on mat a dog ran fast over lazy fox brown quick it is was and naïve café".split()
TEXT_PAIRS = 8


def text_corpus(seed: int = 31) -> tuple:
    """``(preds, target)``: hypotheses and one reference each, from the seed."""
    rng = np.random.default_rng(seed)
    target = [" ".join(rng.choice(TEXT_WORDS, int(rng.integers(3, 12)))) for _ in range(TEXT_PAIRS)]
    preds = [" ".join(w if rng.random() > 0.3 else str(rng.choice(TEXT_WORDS)) for w in t.split()) for t in target]
    return preds, target


def scenario_text(rank: int, world: int) -> Dict[str, Any]:
    """BLEU's sum states and EED's list state synced across the ranks, each
    rank fed its shard, beside a metric fed the union of the shards
    (``sync_on_compute=False``): the states while synced, and both values."""
    from tpumetrics_torch.text import BLEUScore, ExtendedEditDistance
    from tpumetrics_torch.utils.data import dim_zero_cat

    preds, target = text_corpus()
    mine = shards(TEXT_PAIRS, world)[rank]
    out = {}
    for name, make in (("bleu", BLEUScore), ("eed", ExtendedEditDistance)):
        metric, union = make(device="cpu"), make(device="cpu", sync_on_compute=False)
        metric.update(preds[mine], [[t] for t in target[mine]])
        union.update(preds, [[t] for t in target])

        def states(m):
            return {k: _np(dim_zero_cat(v) if isinstance(v, list) else v) for k, v in m.metric_state().items()}

        metric.sync()
        synced = states(metric)
        metric.unsync()
        out[name] = {"synced": synced, "union": states(union), "value": _np(metric.compute()),
                     "union_value": _np(union.compute())}
    return out


def bertscore_tokenizer(sentences, **_):
    """Words hashed into 60 ids after [CLS] = 1, closed by [SEP] = 2 (ragged lists: BERTScore pads them)."""
    import zlib

    ids = [[1] + [4 + zlib.crc32(w.encode()) % 60 for w in s.split()] + [2] for s in sentences]
    return {"input_ids": ids, "attention_mask": [[1] * len(r) for r in ids]}


def bertscore_table() -> Any:
    """The token embeddings of the BERTScore scenario: 64 x 16 from the seed."""
    return torch.from_numpy(np.random.default_rng(37).standard_normal((64, 16)).astype(np.float32))


def scenario_bertscore(rank: int, world: int) -> Dict[str, Any]:
    """BERTScore (idf on) with each rank fed its shard: ``compute()`` gathers
    the sentence lists over the object channel and scores the union, beside a
    metric fed the union (``sync_on_compute=False``); and the host-sentence
    mixin's three refusals in a real world: a custom ``dist_sync_fn``,
    ``dist_sync_on_step`` and a backend with no object channel."""
    from tpumetrics_torch.parallel.backend import DistributedBackend
    from tpumetrics_torch.text import BERTScore
    from tpumetrics_torch.utils.exceptions import TPUMetricsUserError

    class NoObjects(DistributedBackend):
        def available(self) -> bool:
            return True

    preds, target = text_corpus()
    mine = shards(TEXT_PAIRS, world)[rank]
    table = bertscore_table()

    def make(**kw):
        return BERTScore(model=table, user_tokenizer=bertscore_tokenizer, user_forward_fn=lambda m, b: m[b["input_ids"]],
                         idf=True, device="cpu", **kw)

    metric, union = make(), make(sync_on_compute=False)
    metric.update(preds[mine], target[mine])
    union.update(preds, target)
    out = {"value": {k: _np(v) for k, v in metric.compute().items()},
           "union": {k: _np(v) for k, v in union.compute().items()},
           "local": metric.sentence_state, "refusals": {}}
    for name, kw in (("dist_sync_fn", {}), ("dist_sync_on_step", {"dist_sync_on_step": True}),
                     ("no_object_channel", {"sync_backend": NoObjects()})):
        m = make(**kw)
        m.update(preds[mine], target[mine])
        try:
            m.sync(dist_sync_fn=(lambda x, group: [x]) if name == "dist_sync_fn" else None)
            out["refusals"][name] = None
        except TPUMetricsUserError as err:
            out["refusals"][name] = str(err)
        out["refusals"][name + " kept"] = m.sentence_state == (preds[mine], target[mine])
    return out


SCENARIOS: Dict[str, Callable[[int, int], Dict[str, Any]]] = {
    "collection": scenario_collection,
    "binary_exact_auroc": scenario_binary_exact_auroc,
    "ragged_list": scenario_ragged_list,
    "masked_buffer": scenario_masked_buffer,
    "aggregators": scenario_aggregators,
    "aggregator_collection": scenario_aggregator_collection,
    "running_collection": scenario_running_collection,
    "regression_collection": scenario_regression_collection,
    "backend": scenario_backend,
    "text": scenario_text,
    "bertscore": scenario_bertscore,
}


# run only by the worlds of the files that check them (tests/test_torch_{telemetry,monitoring,detection_packed}.py)
OTHER_SCENARIOS: Dict[str, Callable[[int, int], Dict[str, Any]]] = {
    "ledger": scenario_ledger,
    "monitoring": scenario_monitoring,
    "detection": scenario_detection,
}


def run_rank(rank: int, world: int, init_file: str, out_dir: str, names: Any = None) -> None:
    """Entry point of one rank (``torch.multiprocessing`` passes ``rank``
    first): every scenario of ``SCENARIOS``, or those named in ``names``."""
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}", rank=rank, world_size=world)
    chosen = SCENARIOS if names is None else {n: {**SCENARIOS, **OTHER_SCENARIOS}[n] for n in names}
    try:
        results = {name: fn(rank, world) for name, fn in chosen.items()}
        dist.barrier()
    finally:
        dist.destroy_process_group()
    results["modules"] = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "tpumetrics"))
    path = os.path.join(out_dir, f"rank{rank}.pkl")
    with open(path + ".tmp", "wb") as fh:
        pickle.dump(results, fh)
    os.replace(path + ".tmp", path)


def run_worlds(worlds: Any, root: Any, names: Any, timeout_s: float = 120.0) -> Dict[int, List[Dict[str, Any]]]:
    """Launch one gloo world per size in ``worlds`` (spawned ranks, a
    ``file://`` rendezvous under ``root``), all started before any is joined,
    running the scenarios ``names`` (``None``: every one of ``SCENARIOS``);
    every rank's results by world size. Raises ``TimeoutError`` when a world
    does not finish within ``timeout_s``."""
    import time

    import torch.multiprocessing as tmp

    launched = {}
    try:
        for world in worlds:
            d = os.path.join(str(root), f"gloo{world}")
            os.makedirs(d, exist_ok=True)
            ctx = tmp.start_processes(run_rank, args=(world, os.path.join(d, "rendezvous"), d, names),
                                      nprocs=world, join=False, start_method="spawn")
            launched[world] = (ctx, d)
        deadline = time.monotonic() + timeout_s
        for world, (ctx, _) in launched.items():
            while not ctx.join(timeout=max(0.1, deadline - time.monotonic())):
                if time.monotonic() >= deadline:
                    raise TimeoutError(f"the {world}-rank gloo world did not finish within {timeout_s} s")
    finally:
        for ctx, _ in launched.values():
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                    p.join(5)
    out = {}
    for world, (_, d) in launched.items():
        out[world] = []
        for r in range(world):
            with open(os.path.join(d, f"rank{r}.pkl"), "rb") as fh:
                out[world].append(pickle.load(fh))
    return out
