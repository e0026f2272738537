"""The port on a CUDA card: the kernel against its plain version, the
multiclass, binary and multilabel collections on the card against the same
streams on the CPU, a collection synced over a real NCCL group of one rank,
a MaskedBuffer's dump row on the card, the fused collection update
(CUDA graphs) against the unfused one, and the regression domain: Spearman's
ranks and Kendall's pair count on the card against the CPU, the regression
leaders captured in a graph, and a ``MultioutputWrapper`` free of host
syncs; the clustering and nominal tables and leaders; and the retrieval
and pairwise slice: the retrieval sort's permutation on the card against
the CPU's (NaN, +-inf, +-0.0 among the scores), a retrieval ``compute()``
twice with the same bits, the full-float32 product under the caller's
``set_float32_matmul_precision("medium")``, and a buffered retrieval
leader replayed with no host sync; and the audio slice: the biquad
kernel against a float64 reference beside its plain version (at the
chunk and tile edges too), two calls and a graph replay bit for bit, the separation members on the card
against the CPU, SDR's host syncs and its eager place beside a graph,
audio collections replayed in graphs, and three-speaker PIT eagerly and
under capture; and the image slice: SSIM, UQI and VIF under torch's
default TF32 settings against float64 oracles (the library's own float32
guard), 3-D SSIM through ``conv3d``, and restoration and pan-sharpening
collections replayed in graphs bit for bit with no host sync (the float64
oracles and the texture generator come from ``chip_smoke.py``); and the
detection slice: the greedy COCO matcher against its plain version at its
edge shapes, ``MeanAveragePrecision`` on the card bit for bit its CPU path,
and a packed update replayed with no host sync (the inputs come from
``chip_smoke.py``); and the
monitoring slice: the sketch's bucket index on the card against the float64
numpy oracle (``chip_smoke.sketch_index_oracle``) and a windowed sketch at
the Criteo stream's batch shape bit for bit the CPU's, and every monitoring
member in a fused collection replayed bit for bit its unfused twin with no
host sync; and the backbone slice: the Inception and LPIPS forwards on the
card against the CPU path within a tolerance that TF32 would not hold, a
captured FID update replayed bit for bit the unfused one, the eager latch
with an extractor that reads the host, the engine's graphs per bucket and
its eager bucket after a failed capture, and the bfloat16 gates; and the
text slice: the ``token_nll`` kernel against its plain version and a
float64 reference (GPT-2's misaligned rows, strided rows, one class,
out-of-range, wrapped and ignored targets, non-finite logits), two calls and
graph replays bit for bit, its backward against the plain version's
autograd gradient, and ``Perplexity`` replayed in a fused collection with no
host sync against the CPU.

Every test here needs a card and skips without one. The machine with the
card has no JAX, and ``tests/conftest.py`` imports JAX, so this file imports
neither and runs there without the conftest::

    python -m pytest tests/test_torch_cuda.py --noconftest -q
"""

import numpy as np
import pytest
import torch

import tpumetrics_torch
import tpumetrics_torch.classification as cls
from tpumetrics_torch import MetricCollection
from tpumetrics_torch.interop import export_state
from tpumetrics_torch.ops import binned_confusion as bc

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    """The card, or a skip: CUDA kernels have no CPU mode."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (on the card: python -m pytest tests/test_torch_cuda.py --noconftest)")
    return torch.device("cuda")


# thresholds every case starts from: a duplicate, a NaN, +-inf, and -0.0 beside 0.0
_ODD_THRESHOLDS = np.asarray([0.5, -0.0, np.nan, np.inf, -np.inf, 0.5, 0.0], np.float32)


def _inputs(n, c, t, seed=0):
    """t unsorted thresholds (the first of them from ``_ODD_THRESHOLDS``), ties, NaN and signed-zero preds."""
    rng = np.random.default_rng(seed)
    preds = rng.random((n, c)).astype(np.float32)
    valid = (rng.random((n, c)) < 0.8).astype(np.float32)
    y = rng.integers(0, 2, (n, c)).astype(np.float32) * valid
    odd = _ODD_THRESHOLDS[:t]
    thr = rng.permutation(np.concatenate([rng.random(t - odd.size), odd])).astype(np.float32)
    preds[: min(n, t), 0] = thr[: min(n, t)]  # ties
    preds[1::11, -1] = np.nan
    preds[2::13, -1] = -0.0
    preds[3::13, -1] = 0.0
    return [torch.from_numpy(x) for x in (preds, y, valid, thr)]


@pytest.mark.parametrize(
    "n,c,t",
    [
        (257, 5, 13), (64, 1, 3), (130, 4, 129), (8192, 128, 64), (848, 1000, 200), (256, 8193, 64),
        (1 << 20, 1, 200),  # narrow C: every row of a warp in the same 201 buckets
        (1000, 37, 1),
        (200000, 3, 200),  # splits of thousands of rows into one histogram
        (512, 3, 30000),  # one class's histogram exceeds shared memory: the buckets split into ranges
        (65536, 1, 200),  # a binary batch: one column
        (4096, 80, 200),  # a multilabel batch, a fifth of its entries masked out
    ],
)
def test_kernel_matches_plain_version(cuda, n, c, t):
    args = [x.to(cuda) for x in _inputs(n, c, t)]
    before = bc.launches
    tp, pp = bc.binned_confusion_counts(*args)
    torch.cuda.synchronize()
    assert bc.launches == before + 1
    assert tp.dtype == pp.dtype == torch.int32
    ref_tp, ref_pp = bc.binned_confusion_plain(*args)
    assert torch.equal(tp.float(), ref_tp) and torch.equal(pp.float(), ref_pp)
    cpu_tp, cpu_pp = bc.binned_confusion_counts(*_inputs(n, c, t))
    assert torch.equal(tp.cpu(), cpu_tp) and torch.equal(pp.cpu(), cpu_pp)


def test_kernel_refuses_mixed_devices(cuda):
    preds, y, v, thr = _inputs(16, 3, 4)
    with pytest.raises(ValueError, match="Expected `thresholds` on"):
        bc.binned_confusion_counts(preds.to(cuda), y.to(cuda), v.to(cuda), thr)


def _collection(device, c, t):
    return MetricCollection(
        {
            "acc": cls.MulticlassAccuracy(c, average="micro", validate_args=False, device=device),
            "f1": cls.MulticlassF1Score(c, average="macro", validate_args=False, device=device),
            "auroc": cls.MulticlassAUROC(c, thresholds=t, validate_args=False, device=device),
        },
        device=device,
    )


@pytest.mark.parametrize("ignore_index", [None, -1])
def test_main_path_on_the_card_matches_the_cpu(cuda, ignore_index):
    c, b, t = 16, 1024, 64
    rng = np.random.default_rng(1)
    batches = []
    for _ in range(3):
        z = rng.standard_normal((b, c)).astype(np.float32)
        e = np.exp(z - z.max(axis=1, keepdims=True))
        target = rng.integers(0, c, b)
        if ignore_index is not None:
            target[rng.random(b) < 0.2] = ignore_index
        batches.append(((e / e.sum(axis=1, keepdims=True)).astype(np.float32), target))
    results = {}
    for device in ("cuda", "cpu"):
        col = MetricCollection(
            {
                "acc": cls.MulticlassAccuracy(c, average="micro", ignore_index=ignore_index, device=device),
                "auroc": cls.MulticlassAUROC(c, thresholds=t, ignore_index=ignore_index, device=device),
                "prc_micro": cls.MulticlassPrecisionRecallCurve(
                    c, thresholds=t, average="micro", ignore_index=ignore_index, device=device
                ),
            },
            device=device,
        )
        before = bc.launches
        for preds, target in batches:
            col.update(torch.from_numpy(preds).to(device), torch.from_numpy(target).to(device))
        launched = bc.launches - before
        assert launched == (2 * len(batches) if device == "cuda" else 0)
        results[device] = (export_state(col), col.compute())
    (gpu_state, gpu_vals), (cpu_state, cpu_vals) = results["cuda"], results["cpu"]
    for leader in cpu_state:
        for name in cpu_state[leader]:
            np.testing.assert_array_equal(gpu_state[leader][name], cpu_state[leader][name])
    for key in cpu_vals:
        for g, r in zip(*(v if isinstance(v, tuple) else (v,) for v in (gpu_vals[key], cpu_vals[key]))):
            np.testing.assert_allclose(g.cpu().numpy(), r.numpy(), rtol=0, atol=1e-6)


def test_states_default_to_the_card_and_refuse_host_inputs(cuda):
    col = _collection(None, 8, 16)
    assert col.device.type == "cuda" and col["auroc"].thresholds.device.type == "cuda"
    with pytest.raises(RuntimeError, match="not moved"):
        col.update(torch.rand(4, 8), torch.zeros(4, dtype=torch.long))


def _assert_same_states(gpu_state, cpu_state):
    """Tensor states equal; list states (the exact curves' preds and targets) equal entry by entry."""
    for leader, states in cpu_state.items():
        for name, ref in states.items():
            got = gpu_state[leader][name]
            if isinstance(ref, list):
                assert len(got) == len(ref)
                for g, r in zip(got, ref):
                    assert g.dtype == r.dtype
                    np.testing.assert_array_equal(g, r)
            else:
                assert got.dtype == ref.dtype == np.int32
                np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("task", ["binary", "multilabel"])
def test_binary_and_multilabel_collections_on_the_card_match_the_cpu(cuda, task):
    """Binned updates launch the kernel once per batch (binary preds as one
    column, multilabel preds with a per-entry mask); the exact AUROC's list
    states and every value equal the CPU run's."""
    shape, kw = ((2048,), {}) if task == "binary" else ((512, 6), {"num_labels": 6})
    rng = np.random.default_rng(2)
    batches = []
    for _ in range(3):
        target = rng.integers(0, 2, shape)
        target[rng.random(shape) < 0.05] = -1
        batches.append(((rng.integers(0, 257, shape) / 256).astype(np.float32), target))
    results = {}
    for device in ("cuda", "cpu"):
        common = {"ignore_index": -1, "device": device, **kw}
        col = MetricCollection(
            {
                "acc": tpumetrics_torch.Accuracy(task=task, **common),
                "f1": tpumetrics_torch.F1Score(task=task, **common),
                "auroc": tpumetrics_torch.AUROC(task=task, thresholds=64, **common),
                "exact": tpumetrics_torch.AUROC(task=task, **common),
            },
            device=device,
        )
        before = bc.launches
        for preds, target in batches:
            col.update(torch.from_numpy(preds).to(device), torch.from_numpy(target).to(device))
        assert bc.launches - before == (len(batches) if device == "cuda" else 0)
        assert list(col.compute_groups.values()) == [["acc", "f1"], ["auroc"], ["exact"]]
        results[device] = (export_state(col), col.compute())
    (gpu_state, gpu_vals), (cpu_state, cpu_vals) = results["cuda"], results["cpu"]
    _assert_same_states(gpu_state, cpu_state)
    for key in cpu_vals:
        np.testing.assert_allclose(gpu_vals[key].cpu().numpy(), cpu_vals[key].numpy(), rtol=0, atol=1e-6)


def test_collection_synced_over_nccl_at_world_size_one(cuda, tmp_path):
    """A real NCCL group of one rank, the sync forced on (world size 1 skips
    it otherwise): one all_reduce per (op, dtype) class, two gathers for the
    list state, values equal to the unsynced ones, and every state back to
    its own tensor afterwards."""
    import torch.distributed as dist

    from tpumetrics_torch import CatMetric, MeanMetric
    from tpumetrics_torch.parallel import NoOpBackend, TorchDistBackend, set_default_backend

    class Forced(TorchDistBackend):
        reduces, gathers = [], 0

        def available(self):
            return True

        def all_reduce(self, x, op, group=None):
            self.reduces.append((op, x.dtype))
            return super().all_reduce(x, op, group)

        def all_gather(self, x, group=None):
            self.gathers += 1
            return super().all_gather(x, group)

    col = _collection(cuda, 8, 16)
    col.add_metrics({"mean": MeanMetric(device=cuda), "cat": CatMetric(device=cuda)})
    rng = np.random.default_rng(4)
    for _ in range(3):
        preds = torch.from_numpy(rng.random((256, 8)).astype(np.float32)).to(cuda)
        col.update(preds=preds, target=torch.from_numpy(rng.integers(0, 8, 256)).to(cuda), value=preds.mean())
    dist.init_process_group("nccl", store=dist.FileStore(str(tmp_path / "store"), 1), rank=0, world_size=1)
    forced = Forced()
    try:
        set_default_backend(NoOpBackend())
        local = col.compute()
        own = {k: m._copy_state_dict() for k, m in col.items(keep_base=True, copy_state=False)}
        for m in col.values(copy_state=False):
            m._computed = None
        set_default_backend(forced)
        synced = col.compute()
    finally:
        set_default_backend(None)
        dist.destroy_process_group()
    assert sorted(forced.reduces, key=str) == [("sum", torch.float32), ("sum", torch.int32)]
    assert forced.gathers == 1
    for key in local:
        assert torch.equal(synced[key], local[key])
    for k, m in col.items(keep_base=True, copy_state=False):
        for name, val in own[k].items():
            now = getattr(m, name)
            assert all(a is b for a, b in zip(now, val)) if isinstance(val, list) else now is val


def test_masked_buffer_dump_row_on_the_card(cuda):
    """Masked-out and overflow rows go to the dump row on the card, with no
    host sync, and the buffer equals the same appends on the CPU."""
    from tpumetrics_torch import buffers as tb

    rng = np.random.default_rng(6)
    batches = [(rng.random((5, 3)).astype(np.float32), rng.random(5) < 0.6) for _ in range(4)]
    out = {}
    for device in ("cpu", "cuda"):
        buf = tb.create_buffer(8, (3,), torch.float32, device)
        for i, (rows, valid) in enumerate(batches):
            rows, valid = torch.from_numpy(rows).to(device), torch.from_numpy(valid).to(device)
            if device == "cuda" and i == 1:
                torch.cuda.set_sync_debug_mode("error")
                try:
                    buf = tb.buffer_append(buf, rows, valid)
                finally:
                    torch.cuda.set_sync_debug_mode(0)
            else:
                buf = tb.buffer_append(buf, rows, valid)
        out[device] = [t.cpu() for t in buf]
    for got, want in zip(out["cuda"], out["cpu"]):
        assert got.dtype == want.dtype and torch.equal(got, want)
    assert int(out["cuda"][1]) == 8 and int(out["cuda"][2]) == sum(int(v.sum()) for _, v in batches) > 8


# ---------------------------------------------------------- fused update (CUDA graphs)


def _fused_pair(kind, device):
    """The same collection twice, unfused and fused, with its batches: the
    multiclass one with accuracy, F1, binned AUROC, AP and the confusion
    matrix; binary with an exact AUROC (list states: it stays eager); and
    multilabel with ignore_index."""
    rng = np.random.default_rng(8)
    if kind == "multiclass":
        c, n = 10, 512
        batches = []
        for b in (n, n, n, n, 96, n):
            z = rng.standard_normal((b, c)).astype(np.float32)
            e = np.exp(z - z.max(axis=1, keepdims=True))
            batches.append(((e / e.sum(axis=1, keepdims=True)).astype(np.float32), rng.integers(0, c, b)))

        def members():
            return {
                "acc": cls.MulticlassAccuracy(c, average="micro", device=device),
                "f1": cls.MulticlassF1Score(c, device=device),
                "auroc": cls.MulticlassAUROC(c, thresholds=32, device=device),
                "ap": cls.MulticlassAveragePrecision(c, thresholds=32, device=device),
                "confmat": cls.MulticlassConfusionMatrix(c, device=device),
            }

    else:
        shape = (1024,) if kind == "binary" else (256, 6)
        kw = {"task": kind, "device": device, "ignore_index": -1}
        if kind == "multilabel":
            kw["num_labels"] = 6
        batches = []
        for _ in range(5):
            target = rng.integers(0, 2, shape)
            target[rng.random(shape) < 0.05] = -1
            batches.append(((rng.integers(0, 257, shape) / 256).astype(np.float32), target))

        def members():
            out = {
                "acc": tpumetrics_torch.Accuracy(**kw),
                "f1": tpumetrics_torch.F1Score(**kw),
                "auroc": tpumetrics_torch.AUROC(thresholds=32, **kw),
                "ap": tpumetrics_torch.AveragePrecision(thresholds=32, **kw),
            }
            if kind == "binary":
                out["exact"] = tpumetrics_torch.AUROC(**kw)
            return out

    cols = [MetricCollection(members(), fused_update=fused, device=device) for fused in (False, True)]
    return cols, [(torch.from_numpy(p).to(device), torch.from_numpy(t).to(device)) for p, t in batches]


@pytest.mark.parametrize("kind", ["multiclass", "binary", "multilabel"])
def test_fused_collection_matches_the_unfused_one_bit_for_bit(cuda, kind):
    """States equal after every update and values equal at the end; the
    fused collection captured a graph and replayed it, and the kernel's
    launches (eager ones plus replays times captured calls) equal the
    unfused run's."""
    (plain, fused), batches = _fused_pair(kind, cuda)
    launches = {"plain": 0, "fused": 0}
    for preds, target in batches:
        for name, col in (("plain", plain), ("fused", fused)):
            before = bc.launches
            col.update(preds, target)
            launches[name] += bc.launches - before
        _assert_same_states(export_state(fused), export_state(plain))
    step = fused._fused_oo_step
    assert step.counts["captured"] >= 1 and step.counts["replayed"] >= 1
    assert step.program_count >= 1
    eager_leaders = [g[0] for g in fused.compute_groups.values() if g[0] not in step.leaders]
    assert eager_leaders == (["exact"] if kind == "binary" else [])
    replayed = step.kernel_launches().get("binned_confusion", 0)
    assert launches["fused"] + replayed == launches["plain"]
    vals, ref = fused.compute(), plain.compute()
    for key in ref:
        assert torch.equal(vals[key], ref[key]), key


def test_a_replayed_update_syncs_nothing(cuda):
    """A graph replay (batch copied in, graph launched, states written back)
    raises nothing with host syncs made errors."""
    (_, fused), batches = _fused_pair("multiclass", cuda)
    for preds, target in batches[:3]:  # groups, warm-up, capture
        fused.update(preds, target)
    torch.cuda.set_sync_debug_mode("error")
    try:
        fused.update(*batches[3])
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert fused._fused_oo_step.counts["replayed"] == 1


def test_a_steady_multiclass_eager_update_syncs_nothing(cuda):
    """The unfused multiclass update (the confusion matrix's int32 count
    included) raises nothing with host syncs made errors."""
    col = _collection(cuda, 1000, 200)
    col.add_metrics({"confmat": cls.MulticlassConfusionMatrix(1000, validate_args=False, device=cuda)})
    rng = np.random.default_rng(9)
    batches = [
        (torch.from_numpy(rng.random((2048, 1000), dtype=np.float32)).to(cuda), torch.from_numpy(rng.integers(0, 1000, 2048)).to(cuda))
        for _ in range(2)
    ]
    col.update(*batches[0])
    torch.cuda.set_sync_debug_mode("error")
    try:
        col.update(*batches[1])
    finally:
        torch.cuda.set_sync_debug_mode(0)


def test_a_capture_breaking_update_raises_instead_of_running_eagerly(cuda):
    """An update that reads the device on the host runs on its first
    sighting (eagerly) and raises at the capture of the second; the state
    is left as the first update made it."""
    from tpumetrics_torch.metric import Metric

    class HostRead(Metric):
        def __init__(self, **kw):
            super().__init__(**kw)
            self.add_state("total", torch.zeros((), dtype=torch.float32), dist_reduce_fx="sum")

        def update(self, x):
            self.total = self.total + float(x.sum())  # a host read

        def compute(self):
            return self.total

    col = MetricCollection({"h": HostRead(device=cuda)}, compute_groups=[["h"]], fused_update=True, device=cuda)
    x = torch.ones(8, device=cuda)
    col.update(x)
    with pytest.raises(RuntimeError):
        col.update(x)
    step = col._fused_oo_step
    assert step.counts == {"eager": 1, "captured": 0, "replayed": 0, "unfused": 0} and step.program_count == 0
    torch.cuda.synchronize()
    assert float(col["h"].total) == 8.0


def test_masked_confmat_counts_at_1000_classes_equal_the_cpu(cuda):
    """The int32 index_add_ count at C=1000, with ignored positions and
    out-of-range labels, equals the CPU count."""
    from tpumetrics_torch.functional.classification.stat_scores import _masked_confmat

    rng = np.random.default_rng(10)
    n, c = 200_000, 1000
    preds = rng.integers(-3, c + 3, n)
    target = rng.integers(-3, c + 3, n)
    mask = (rng.random(n) < 0.9).astype(np.int32)
    args = [torch.from_numpy(a) for a in (preds, target, mask)]
    cpu = _masked_confmat(*args, c)
    gpu = _masked_confmat(*(a.to(cuda) for a in args), c)
    assert gpu.dtype == cpu.dtype == torch.int32
    assert torch.equal(gpu.cpu(), cpu)


def test_fused_aggregators_replay_with_nans_as_the_eager_update_drops_them(cuda):
    """Sum, Mean, Max and Min with their default NaN strategy ("warn": an
    eager update drops NaN entries after reading on the host whether there
    are any) are captured and replayed: inside the graph a NaN entry becomes
    the reduction's identity with a zero weight, so every state equals the
    unfused collection's: max and min exactly, the float32 sums within 1e-6
    relative (the zeros change the order of the device's summation tree)."""
    import warnings

    from tpumetrics_torch import MaxMetric, MeanMetric, MinMetric, SumMetric

    def make(fused):
        return MetricCollection(
            {"sum": SumMetric(device=cuda), "mean": MeanMetric(device=cuda), "max": MaxMetric(device=cuda),
             "min": MinMetric(device=cuda)},
            fused_update=fused,
            device=cuda,
        )

    plain, fused = make(False), make(True)
    rng = np.random.default_rng(11)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # "warn" warns on the eager path
        for i in range(6):
            x = rng.random(64).astype(np.float32)
            if i % 2:
                x[[3, 17]] = np.nan
            x = torch.from_numpy(x).to(cuda)
            plain.update(x)
            fused.update(x)
            got = export_state(fused)
            for key, want in export_state(plain).items():
                for name, ref in want.items():
                    rtol = 0 if key in ("max", "min") else 1e-6
                    np.testing.assert_allclose(got[key][name], ref, rtol=rtol, atol=0, err_msg=f"{i} {key}.{name}")
    assert fused._fused_oo_step.counts["replayed"] >= 3


# ------------------------------------------- classification report (card, fused)


def _report_members(task, device):
    """A classification report per task: the new families beside the
    members they share a compute group with. Returns the members and the
    compute groups they must form."""
    if task == "multiclass":
        c, t = 10, 32
        kw = {"validate_args": False, "device": device}
        members = {
            "acc": cls.MulticlassAccuracy(c, average="micro", **kw),
            "f1": cls.MulticlassF1Score(c, **kw),
            "precision": cls.MulticlassPrecision(c, **kw),
            "recall": cls.MulticlassRecall(c, **kw),
            "specificity": cls.MulticlassSpecificity(c, **kw),
            "auroc": cls.MulticlassAUROC(c, thresholds=t, **kw),
            "ap": cls.MulticlassAveragePrecision(c, thresholds=t, **kw),
            "rafp": cls.MulticlassRecallAtFixedPrecision(c, min_precision=0.5, thresholds=t, **kw),
            "confmat": cls.MulticlassConfusionMatrix(c, **kw),
            "jaccard": cls.MulticlassJaccardIndex(c, **kw),
            "mcc": cls.MulticlassMatthewsCorrCoef(c, **kw),
            "kappa": cls.MulticlassCohenKappa(c, **kw),
        }
        groups = [["acc", "f1", "precision", "recall", "specificity"], ["ap", "auroc", "rafp"],
                  ["confmat", "jaccard", "kappa", "mcc"]]
        return members, groups
    kw = {"task": task, "ignore_index": -1, "validate_args": False, "device": device}
    if task == "multilabel":
        kw["num_labels"] = 6
    members = {
        "acc": tpumetrics_torch.Accuracy(**kw),
        "f1": tpumetrics_torch.F1Score(**kw),
        "precision": tpumetrics_torch.Precision(**kw),
        "recall": tpumetrics_torch.Recall(**kw),
        "auroc": tpumetrics_torch.AUROC(thresholds=32, **kw),
    }
    if task == "binary":
        members["specificity"] = tpumetrics_torch.Specificity(**kw)
        members["mcc"] = tpumetrics_torch.MatthewsCorrCoef(**kw)
        members["kappa"] = tpumetrics_torch.CohenKappa(**kw)
        members["rafp"] = tpumetrics_torch.RecallAtFixedPrecision(min_precision=0.5, thresholds=32, **kw)
        groups = [["acc", "f1", "precision", "recall", "specificity"], ["auroc", "rafp"], ["kappa", "mcc"]]
    else:
        members["hamming"] = tpumetrics_torch.HammingDistance(**kw)
        members["exact"] = tpumetrics_torch.ExactMatch(**kw)
        members["jaccard"] = tpumetrics_torch.JaccardIndex(**kw)
        members["pafr"] = tpumetrics_torch.PrecisionAtFixedRecall(min_recall=0.5, thresholds=32, **kw)
        groups = [["acc", "f1", "hamming", "precision", "recall"], ["auroc", "pafr"], ["exact"], ["jaccard"]]
    return members, groups


def _report_batches(task, rng):
    out = []
    for _ in range(6):
        if task == "multiclass":
            z = rng.standard_normal((512, 10)).astype(np.float32)
            e = np.exp(z - z.max(axis=1, keepdims=True))
            out.append(((e / e.sum(axis=1, keepdims=True)).astype(np.float32), rng.integers(0, 10, 512)))
            continue
        shape = (1024,) if task == "binary" else (256, 6)
        target = rng.integers(0, 2, shape)
        target[rng.random(shape) < 0.05] = -1
        out.append(((rng.integers(0, 257, shape) / 256).astype(np.float32), target))
    return out


def _values_close(got, want):
    for key in want:
        pairs = zip(got[key], want[key]) if isinstance(want[key], tuple) else [(got[key], want[key])]
        for g, w in pairs:
            g, w = g.cpu().numpy(), w.cpu().numpy()
            np.testing.assert_allclose(g, w, rtol=1e-5 if key in ("mcc", "kappa") else 0, atol=1e-6, err_msg=key)


@pytest.mark.parametrize("task", ["binary", "multiclass", "multilabel"])
def test_report_collection_on_the_card_fused_and_against_the_cpu(cuda, task):
    """The new families in one collection per task: their compute groups
    (they join the leaders already there), the fused collection bit for bit
    the unfused one after every update with a replay under host-sync errors,
    and the card's states identical to the CPU's, values within 1e-6 (MCC
    and kappa 1e-5 relative: float32 sums in another order)."""
    batches = _report_batches(task, np.random.default_rng(12))
    cols = {}
    for name, device, fused in (("plain", cuda, False), ("fused", cuda, True), ("cpu", "cpu", False)):
        members, groups = _report_members(task, device)
        cols[name] = MetricCollection(members, fused_update=fused, device=device)
    for i, (preds, target) in enumerate(batches):
        for name, col in cols.items():
            dev = torch.device("cpu") if name == "cpu" else cuda
            args = (torch.from_numpy(preds).to(dev), torch.from_numpy(target).to(dev))
            if name == "fused" and i >= 3:  # replays: a host sync raises
                torch.cuda.set_sync_debug_mode("error")
                try:
                    col.update(*args)
                finally:
                    torch.cuda.set_sync_debug_mode(0)
            else:
                col.update(*args)
        _assert_same_states(export_state(cols["fused"]), export_state(cols["plain"]))
    step = cols["fused"]._fused_oo_step
    assert step.counts["replayed"] >= 3 and step.program_count == 1
    for col in cols.values():
        assert [list(g) for g in col.compute_groups.values()] == groups
    _assert_same_states(export_state(cols["plain"]), export_state(cols["cpu"]))
    plain, fused, cpu = (cols[k].compute() for k in ("plain", "fused", "cpu"))
    for key in plain:
        for g, w in zip(*(v if isinstance(v, tuple) else (v,) for v in (fused[key], plain[key]))):
            assert torch.equal(g, w), key
    _values_close(plain, cpu)


def test_fairness_counts_on_the_card_equal_the_cpu(cuda):
    """The per-group counts are an int32 index_add_ histogram (torch has no
    CUDA int32 matmul, the JAX package's form): on the card they equal the
    CPU's, out-of-range group ids and ignored targets counted nowhere."""
    from tpumetrics_torch.functional.classification.group_fairness import _binary_groups_stat_scores

    rng = np.random.default_rng(13)
    n = 300_000
    preds = rng.random(n).astype(np.float32)
    target = rng.integers(0, 2, n)
    target[rng.random(n) < 0.05] = -1
    groups = rng.integers(-2, 7, n)
    args = [torch.from_numpy(a) for a in (preds, target, groups)]
    cpu = _binary_groups_stat_scores(*args, 5, 0.5, -1, validate_args=False)
    gpu = _binary_groups_stat_scores(*(a.to(cuda) for a in args), 5, 0.5, -1, validate_args=False)
    assert gpu.dtype == torch.int32 and gpu.device.type == cuda.type
    assert torch.equal(gpu.cpu(), cpu)
    in_range = (groups >= 0) & (groups < 5) & (target != -1)
    assert int(cpu.sum()) == int(in_range.sum())


def test_ranking_loss_with_tied_preds_on_the_card_equals_the_cpu(cuda):
    """Preds on a grid of eighths (many ties): the stable argsorts rank the
    ties the same way on the card as on the CPU, so the ranking loss and the
    other ranking states are equal."""
    rng = np.random.default_rng(14)
    preds = (rng.integers(0, 9, (4096, 80)) / 8).astype(np.float32)
    target = (rng.random((4096, 80)) < 0.1).astype(np.int64)
    target[rng.random((4096, 80)) < 0.01] = -1
    for name in ("MultilabelRankingLoss", "MultilabelRankingAveragePrecision", "MultilabelCoverageError"):
        metrics = [getattr(cls, name)(80, ignore_index=-1, validate_args=False, device=d) for d in (cuda, "cpu")]
        for m, d in zip(metrics, (cuda, "cpu")):
            m.update(torch.from_numpy(preds).to(d), torch.from_numpy(target).to(d))
        gpu, cpu = metrics
        assert int(gpu.total) == int(cpu.total) == 4096
        np.testing.assert_allclose(float(gpu.score), float(cpu.score), rtol=1e-6, err_msg=name)
        np.testing.assert_allclose(float(gpu.compute()), float(cpu.compute()), rtol=1e-6, err_msg=name)


def test_calibration_error_on_the_card_matches_the_cpu(cuda):
    """List states equal element for element; the value (per-bin sums as
    masked reductions, the same on every compute) within 1e-6 of the CPU's,
    and two computes of one state bit for bit equal."""
    rng = np.random.default_rng(15)
    z = rng.standard_normal((20_000, 100)).astype(np.float32) * 3
    e = np.exp(z - z.max(axis=1, keepdims=True))
    probs = (e / e.sum(axis=1, keepdims=True)).astype(np.float32)
    target = rng.integers(0, 100, 20_000)
    for norm in ("l1", "l2", "max"):
        metrics = [cls.MulticlassCalibrationError(100, n_bins=15, norm=norm, device=d) for d in (cuda, "cpu")]
        for m, d in zip(metrics, (cuda, "cpu")):
            for lo in range(0, 20_000, 5000):
                m.update(torch.from_numpy(probs[lo : lo + 5000]).to(d), torch.from_numpy(target[lo : lo + 5000]).to(d))
        gpu, cpu = metrics
        for name in ("confidences", "accuracies"):
            for g, c in zip(getattr(gpu, name), getattr(cpu, name)):
                assert torch.equal(g.cpu(), c)
        first = gpu.compute()
        gpu._computed = None
        assert torch.equal(gpu.compute(), first)
        np.testing.assert_allclose(float(first), float(cpu.compute()), rtol=0, atol=1e-6, err_msg=norm)


def test_new_capturable_members_replay_with_host_syncs_made_errors(cuda):
    """Hinge, the ranking metrics, binned specificity at sensitivity beside
    AUROC, fairness and Dice: captured and replayed by the fused collection
    update, a replay raising nothing with host syncs made errors, states bit
    for bit the unfused ones and the CPU's (float sums within 1e-6)."""
    rng = np.random.default_rng(16)

    def mc(d):
        return {
            "auroc": cls.MulticlassAUROC(10, thresholds=32, validate_args=False, device=d),
            "sas": cls.MulticlassSpecificityAtSensitivity(10, 0.5, thresholds=32, validate_args=False, device=d),
            "hinge": cls.MulticlassHingeLoss(10, validate_args=False, device=d),
            "dice": cls.Dice(num_classes=10, average="macro", device=d),
        }

    def ml(d):
        kw = {"ignore_index": -1, "validate_args": False, "device": d}
        return {"lrl": cls.MultilabelRankingLoss(6, **kw), "lrap": cls.MultilabelRankingAveragePrecision(6, **kw),
                "coverage": cls.MultilabelCoverageError(6, **kw), "hinge": cls.BinaryHingeLoss(validate_args=False, device=d)}

    def fair(d):
        return {"fair": cls.BinaryFairness(4, validate_args=False, device=d),
                "rates": cls.BinaryGroupStatRates(4, validate_args=False, device=d)}

    def batches(kind):
        out = []
        for _ in range(5):
            if kind == "mc":
                out.append(((rng.standard_normal((512, 10)) * 2).astype(np.float32), rng.integers(0, 10, 512)))
            elif kind == "ml":
                target = rng.integers(0, 2, (256, 6))
                target[rng.random((256, 6)) < 0.05] = -1
                out.append(((rng.integers(0, 9, (256, 6)) / 8).astype(np.float32), target))
            else:
                out.append((rng.random(1024).astype(np.float32), rng.integers(0, 2, 1024), rng.integers(0, 4, 1024)))
        return out

    for kind, members in (("mc", mc), ("ml", ml), ("fair", fair)):
        cols = {name: MetricCollection(members(dev), fused_update=f, device=dev)
                for name, dev, f in (("plain", cuda, False), ("fused", cuda, True), ("cpu", "cpu", False))}
        for i, batch in enumerate(batches(kind)):
            for name, col in cols.items():
                args = [torch.from_numpy(x).to(cuda if name != "cpu" else "cpu") for x in batch]
                if name == "fused" and i >= 3:
                    torch.cuda.set_sync_debug_mode("error")
                    try:
                        col.update(*args)
                    finally:
                        torch.cuda.set_sync_debug_mode(0)
                else:
                    col.update(*args)
            fused, plain = export_state(cols["fused"]), export_state(cols["plain"])
            for leader, states in plain.items():
                for name, ref in states.items():
                    assert fused[leader][name].dtype == ref.dtype and np.array_equal(fused[leader][name], ref), (kind, name)
        step = cols["fused"]._fused_oo_step
        assert step.counts["replayed"] >= 2 and len(step.leaders) == len(cols["fused"].compute_groups), kind
        gpu, cpu = export_state(cols["plain"]), export_state(cols["cpu"])
        for leader, states in cpu.items():
            for name, ref in states.items():
                if ref.dtype == np.float32 and name not in ("tp", "fp", "fn"):
                    np.testing.assert_allclose(gpu[leader][name], ref, rtol=1e-6, err_msg=f"{kind} {leader}.{name}")
                else:
                    assert gpu[leader][name].dtype == ref.dtype and np.array_equal(gpu[leader][name], ref), (kind, name)


def test_spearman_closed_form_ranks_on_the_card_equal_the_cpu(cuda):
    """A half-star rating scale over 2,000,026 ratings (tie groups of some
    200,000 ranks) and a column without ties: the card's average ranks equal
    the CPU's bit for bit (both exact), and the correlation the CPU's within 1e-5."""
    from tpumetrics_torch.functional.regression import spearman_corrcoef
    from tpumetrics_torch.functional.regression.spearman import _rank_data

    rng = np.random.default_rng(17)
    target = (rng.integers(1, 11, 2_000_026) / 2).astype(np.float32)
    preds = np.clip(target + rng.normal(size=target.size), 0.5, 5.0).astype(np.float32)
    for x in (target, preds):
        got = _rank_data(torch.from_numpy(x).to(cuda)).cpu()
        assert torch.equal(got, _rank_data(torch.from_numpy(x)))
    rho = spearman_corrcoef(torch.from_numpy(preds).to(cuda), torch.from_numpy(target).to(cuda)).cpu()
    np.testing.assert_allclose(rho.numpy(), spearman_corrcoef(torch.from_numpy(preds), torch.from_numpy(target)).numpy(),
                               rtol=0, atol=1e-5)


def test_kendall_pair_count_on_the_card_equals_the_cpu(cuda):
    """10,831 rows (a QM9 test split), two columns: the concordant-minus-
    discordant count, whose running float32 total passes 2^24, and the tie
    statistics equal the CPU's bit for bit; tau-b and its p-value too."""
    from tpumetrics_torch.functional.regression import kendall

    rng = np.random.default_rng(18)
    target = rng.normal(size=(10_831, 2)).astype(np.float32)
    target[:, 1] = np.round(target[:, 1] * 4) / 4  # ties
    preds = (target + 0.1 * rng.normal(size=target.shape)).astype(np.float32)
    for i in range(2):
        x, y = torch.from_numpy(preds[:, i].copy()), torch.from_numpy(target[:, i].copy())
        got = kendall._pair_stats(x.to(cuda), y.to(cuda)).cpu()
        assert float(got) > 2**24 and torch.equal(got, kendall._pair_stats(x, y))
        for g, c in zip(kendall._tie_stats(y.to(cuda)), kendall._tie_stats(y)):
            assert torch.equal(g.cpu(), c)
    tau, p = kendall.kendall_rank_corrcoef(torch.from_numpy(preds).to(cuda), torch.from_numpy(target).to(cuda), t_test=True)
    cpu_tau, cpu_p = kendall.kendall_rank_corrcoef(torch.from_numpy(preds), torch.from_numpy(target), t_test=True)
    assert torch.equal(tau.cpu(), cpu_tau)
    np.testing.assert_allclose(p.cpu().numpy(), cpu_p.numpy(), rtol=0, atol=1e-6)


def test_regression_leaders_captured_in_a_graph_equal_the_unfused_ones(cuda):
    """The sum-state regression metrics and Pearson (with concordance in its
    group) replay in a CUDA graph: states bit for bit the unfused
    collection's after every update, the replays raising nothing with host
    syncs made errors (Tweedie's domain checks run only eagerly), Spearman an
    eager leader beside the graph."""
    import tpumetrics_torch.regression as reg

    def members(d):
        return {
            "mse": reg.MeanSquaredError(device=d), "rmse": reg.MeanSquaredError(squared=False, device=d),
            "mae": reg.MeanAbsoluteError(device=d), "mape": reg.MeanAbsolutePercentageError(device=d),
            "smape": reg.SymmetricMeanAbsolutePercentageError(device=d),
            "wmape": reg.WeightedMeanAbsolutePercentageError(device=d), "msle": reg.MeanSquaredLogError(device=d),
            "log_cosh": reg.LogCoshError(device=d), "minkowski": reg.MinkowskiDistance(p=3, device=d),
            "tweedie": reg.TweedieDevianceScore(power=1.5, device=d), "r2": reg.R2Score(device=d),
            "ev": reg.ExplainedVariance(device=d), "rse": reg.RelativeSquaredError(device=d),
            "pearson": reg.PearsonCorrCoef(device=d), "ccc": reg.ConcordanceCorrCoef(device=d),
            "spearman": reg.SpearmanCorrCoef(device=d),
        }

    rng = np.random.default_rng(19)
    cols = {f: MetricCollection(members(cuda), fused_update=f, device=cuda) for f in (False, True)}
    for i in range(6):
        target = (rng.integers(1, 11, 4096) / 2).astype(np.float32)
        preds = np.clip(target + rng.normal(size=4096), 0.5, 5.0).astype(np.float32)
        args = [torch.from_numpy(x).to(cuda) for x in (preds, target)]
        cols[False].update(*args)
        if i >= 3:  # replays: the eager Spearman appends without a host read too
            torch.cuda.set_sync_debug_mode("error")
        try:
            cols[True].update(*args)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        fused, plain = export_state(cols[True]), export_state(cols[False])
        for leader, states in plain.items():
            for name, ref in states.items():
                got = fused[leader][name]
                if isinstance(ref, list):
                    assert len(got) == len(ref) and all(np.array_equal(g, r) for g, r in zip(got, ref))
                else:
                    assert got.dtype == ref.dtype and np.array_equal(got, ref), (leader, name)
    step = cols[True]._fused_oo_step
    assert step.counts["replayed"] >= 3 and "spearman" not in step.leaders and len(step.leaders) == 13
    for k, v in cols[False].compute().items():
        assert torch.equal(cols[True].compute()[k], v), k


def test_multioutput_without_nan_removal_syncs_nothing(cuda):
    """``MultioutputWrapper(remove_nans=False)``: an update of 12 per-target
    MAEs raises nothing with host syncs made errors; with ``remove_nans=True``
    (the JAX package's default) the NaN-row removal reads the host."""
    import tpumetrics_torch.regression as reg
    from tpumetrics_torch.wrappers import MultioutputWrapper

    rng = np.random.default_rng(20)
    preds, target = (torch.from_numpy(rng.normal(size=(1024, 12)).astype(np.float32)).to(cuda) for _ in range(2))
    clean = MultioutputWrapper(reg.MeanAbsoluteError(device=cuda), 12, remove_nans=False)
    nan_rows = MultioutputWrapper(reg.MeanAbsoluteError(device=cuda), 12)
    clean.update(preds, target)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        clean.update(preds, target)
        with pytest.raises(RuntimeError, match="synchroniz"):
            nan_rows.update(preds, target)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    want = (preds - target).abs().mean(0).cpu()
    np.testing.assert_allclose(clean.compute().cpu().numpy(), want.numpy(), rtol=1e-6)


# ------------------------------------------------------ clustering and nominal


def test_contingency_tables_on_the_card_equal_the_cpu(cuda):
    """The clustering contingency table (1000 x 1000 classes, 50,000 rows,
    some labels negative or out of range) and the nominal table (16 x 16,
    NaNs replaced) on the card equal the CPU's exactly."""
    from tpumetrics_torch.functional.clustering.utils import calculate_contingency_matrix
    from tpumetrics_torch.functional.nominal.utils import _nominal_confmat

    rng = np.random.default_rng(21)
    preds, target = rng.integers(-3, 1003, 50_000), rng.integers(0, 1000, 50_000)
    got = calculate_contingency_matrix(*(torch.from_numpy(x).to(cuda) for x in (preds, target)), None, 1000, 1000)
    want = calculate_contingency_matrix(*(torch.from_numpy(x) for x in (preds, target)), None, 1000, 1000)
    assert got.dtype == torch.float32 and torch.equal(got.cpu(), want)
    x, y = rng.integers(0, 16, 48_842).astype(np.float32), rng.integers(0, 15, 48_842).astype(np.float32)
    x[::97] = np.nan
    got = _nominal_confmat(torch.from_numpy(x).to(cuda), torch.from_numpy(y).to(cuda), 16)
    assert torch.equal(got.cpu(), _nominal_confmat(torch.from_numpy(x), torch.from_numpy(y), 16))


def test_chunked_centroid_distances_equal_the_unchunked_ones(cuda, monkeypatch):
    """Centroid distances taken 3 rows at a time equal one pass over all 37
    rows and a float64 numpy oracle (p = 2 and 1); Davies-Bouldin and Dunn
    of a clustering give the same value twice, in either chunking, and with
    TF32 products allowed or not."""
    from tpumetrics_torch.functional.clustering import davies_bouldin_score, dunn_index
    from tpumetrics_torch.functional.clustering import utils

    rng = np.random.default_rng(22)
    centroids = rng.normal(size=(37, 64)).astype(np.float32)
    c = torch.from_numpy(centroids).to(cuda)
    data = torch.from_numpy(rng.normal(size=(2000, 64)).astype(np.float32)).to(cuda)
    labels = torch.from_numpy(rng.integers(0, 37, 2000)).to(cuda)
    whole = {p: utils._centroid_distances(c, p) for p in (2, 1)}
    values = [davies_bouldin_score(data, labels, 37), dunn_index(data, labels, 2, 37)]
    monkeypatch.setattr(utils, "_DIFF_BUDGET", 3 * 37 * 64)
    for p, ref in whole.items():
        chunked = utils._centroid_distances(c, p)
        assert torch.equal(chunked, ref) or torch.allclose(chunked, ref, rtol=1e-6, atol=0)
        diff = centroids[:, None, :].astype(np.float64) - centroids[None, :, :]
        oracle = np.sqrt((diff**2).sum(-1)) if p == 2 else np.abs(diff).sum(-1)
        np.testing.assert_allclose(chunked.cpu().numpy(), oracle, rtol=1e-5, atol=1e-5)
    again = [davies_bouldin_score(data, labels, 37), dunn_index(data, labels, 2, 37)]
    for a, b in zip(values, again):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=0)
    assert all(torch.equal(a, b) for a, b in zip(again, [davies_bouldin_score(data, labels, 37), dunn_index(data, labels, 2, 37)]))
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = not saved  # the per-cluster sums are float64 products: TF32 never applies
    try:
        flipped = [davies_bouldin_score(data, labels, 37), dunn_index(data, labels, 2, 37)]
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved
    assert all(torch.equal(a, b) for a, b in zip(again, flipped))


def _numpy_emi(table: np.ndarray) -> float:
    """Expected mutual information as a float64 numpy grid (scipy's gammaln)."""
    from scipy.special import gammaln

    a, b, n = table.sum(1), table.sum(0), table.sum()
    total = 0.0
    for i in range(a.size):
        for j in range(b.size):
            lo, hi = max(1, a[i] + b[j] - n), min(a[i], b[j])
            nij = np.arange(lo, hi + 1, dtype=np.float64)
            if nij.size == 0:
                continue
            gln = (gammaln(a[i] + 1) + gammaln(b[j] + 1) + gammaln(n - a[i] + 1) + gammaln(n - b[j] + 1)
                   - gammaln(nij + 1) - gammaln(n + 1) - gammaln(a[i] - nij + 1) - gammaln(b[j] - nij + 1)
                   - gammaln(n - a[i] - b[j] + nij + 1))
            total += float(np.sum(nij / n * (np.log(n * nij) - np.log(a[i]) - np.log(b[j])) * np.exp(gln)))
    return total


def test_device_expected_mutual_info_equals_a_numpy_float64_grid(cuda, monkeypatch):
    """The float64 EMI grid on the card, whole and in chunks of rows and of
    n_ij values, equals a float64 numpy loop (rounded once to float32)."""
    import importlib

    from tpumetrics_torch.functional.clustering.utils import calculate_contingency_matrix

    ami = importlib.import_module("tpumetrics_torch.functional.clustering.adjusted_mutual_info_score")
    rng = np.random.default_rng(23)
    target = rng.integers(0, 40, 3000)
    preds = np.where(rng.random(3000) < 0.6, target, rng.integers(0, 45, 3000))
    table = calculate_contingency_matrix(*(torch.from_numpy(x).to(cuda) for x in (preds, target)), None, 45, 40)
    want = np.float32(_numpy_emi(table.cpu().numpy().astype(np.float64)))
    for budget in (1 << 23, 40 * 45 * 3, 100):
        monkeypatch.setattr(ami, "_EMI_BUDGET", budget)
        got = ami.expected_mutual_info_score(table, table.sum())
        assert got.device == table.device
        np.testing.assert_allclose(float(got), want, rtol=1e-6)


def test_buffered_clustering_and_nominal_updates_replay_in_a_graph(cuda):
    """The label-pair clustering members with live capacity buffers, the
    Calinski-Harabasz capacity copy and the nominal association metrics
    (``nan_strategy="replace"``) replay in CUDA graphs: states bit for bit
    the unfused collections' after every update, the replays raising nothing
    with host syncs made errors."""
    from tpumetrics_torch.clustering import AdjustedMutualInfoScore, AdjustedRandScore, CalinskiHarabaszScore, MutualInfoScore
    from tpumetrics_torch.interop import load_state
    from tpumetrics_torch.nominal import CramersV, TheilsU

    def buffered(m, cap=4096):
        for state in m._defaults:
            m.set_state_capacity(state, cap, feature_shape=(32,) if state == "data" else ())
        load_state(m, m.init_state())
        return m

    def makers(d):
        spaces = {"num_classes_preds": 50, "num_classes_target": 50, "device": d}
        return [
            lambda f: MetricCollection({"mi": buffered(MutualInfoScore(**spaces)), "ami": buffered(AdjustedMutualInfoScore(**spaces)),
                                        "ari": buffered(AdjustedRandScore(**spaces))}, fused_update=f, device=d),
            lambda f: MetricCollection({"ch": buffered(CalinskiHarabaszScore(num_labels=50, device=d))}, fused_update=f, device=d),
            lambda f: MetricCollection({"v": CramersV(16, device=d), "u": TheilsU(16, device=d)}, fused_update=f, device=d),
        ]

    rng = np.random.default_rng(24)
    for k, make in enumerate(makers(cuda)):
        cols = {f: make(f) for f in (False, True)}
        for i in range(5):
            labels = rng.integers(0, 50, 512)
            if k == 0:
                args = (labels, np.where(rng.random(512) < 0.5, labels, rng.integers(0, 50, 512)))
            elif k == 1:
                args = (rng.normal(size=(512, 32)).astype(np.float32), labels)
            else:
                x = rng.integers(0, 16, 512).astype(np.float32)
                x[::31] = np.nan
                args = (x, rng.integers(0, 15, 512).astype(np.float32))
            args = [torch.from_numpy(a).to(cuda) for a in args]
            cols[False].update(*args)
            if i >= 3:
                torch.cuda.set_sync_debug_mode("error")
            try:
                cols[True].update(*args)
            finally:
                torch.cuda.set_sync_debug_mode(0)
            fused, plain = export_state(cols[True]), export_state(cols[False])
            for leader, states in plain.items():
                for name, ref in states.items():
                    got = fused[leader][name]
                    assert all(np.array_equal(g, r) for g, r in zip(got, ref)) if isinstance(ref, tuple) else np.array_equal(got, ref)
        assert cols[True]._fused_oo_step.counts["replayed"] >= 2
        for key, val in cols[False].compute().items():
            assert torch.equal(cols[True].compute()[key], val), key


# ---------------------------------------------------------- retrieval and pairwise

_SORT_KEYS = np.array([0.0, -0.0, np.nan, -np.nan, np.inf, -np.inf, 0.5, -0.5, 1e-30, -1e-30], np.float32)


def test_retrieval_sort_permutation_on_the_card_equals_the_cpu(cuda):
    """The two stable sorts on canonical keys give the CPU's permutation on
    the card, with NaN of both signs, +-inf and +-0.0 among the scores."""
    from tpumetrics_torch.functional.retrieval._grouped import _ranked_order, sort_queries

    rng = np.random.default_rng(31)
    idx = torch.from_numpy(rng.integers(0, 50, 200_000).astype(np.int32))
    preds = torch.from_numpy(rng.choice(_SORT_KEYS, 200_000))
    assert torch.equal(_ranked_order(idx.to(cuda), preds.to(cuda)).cpu(), _ranked_order(idx, preds))
    got = sort_queries(idx.to(cuda), preds.to(cuda), preds.abs().nan_to_num(0.0, 0.0, 0.0).to(cuda), 50)
    want = sort_queries(idx, preds, preds.abs().nan_to_num(0.0, 0.0, 0.0), 50)
    for field in ("idx", "rank", "counts", "starts", "ends"):
        assert torch.equal(getattr(got, field).cpu(), getattr(want, field)), field


def test_retrieval_compute_gives_the_same_bits_twice_and_the_cpu_values(cuda):
    """A collection's ``compute()`` on the card twice: identical bits; within
    1e-6 of the CPU's."""
    from tpumetrics_torch import retrieval as rt

    def members(d):
        return {"map": rt.RetrievalMAP(device=d), "ndcg": rt.RetrievalNormalizedDCG(top_k=10, device=d),
                "mrr": rt.RetrievalMRR(top_k=10, device=d), "prc": rt.RetrievalPrecisionRecallCurve(max_k=20, device=d)}

    rng = np.random.default_rng(32)
    idx = np.repeat(np.arange(3000), 200).astype(np.int64)
    preds = (rng.integers(0, 1024, idx.size) / 1024).astype(np.float32)
    target = (rng.random(idx.size) < 0.02).astype(np.int64)
    gpu, cpu = MetricCollection(members(cuda), device=cuda), MetricCollection(members("cpu"), device="cpu")
    for lo in range(0, idx.size, 65536):
        batch = [torch.from_numpy(a[lo : lo + 65536]) for a in (preds, target, idx)]
        gpu.update(*(b.to(cuda) for b in batch))
        cpu.update(*batch)
    first = gpu.compute()
    for m in gpu._modules.values():
        m._computed = None
    second, want = gpu.compute(), cpu.compute()
    for key in want:
        a, b, c = (x if isinstance(x, tuple) else (x,) for x in (first[key], second[key], want[key]))
        for x, y, z in zip(a, b, c):
            assert torch.equal(x, y), key
            torch.testing.assert_close(x.cpu().double(), z.double(), rtol=0, atol=1e-6)


def test_safe_matmul_is_full_float32_under_medium_precision(cuda):
    """``set_float32_matmul_precision("medium")`` by the caller: the product
    still agrees with float64 to float32's tolerance (TF32 misses it by
    three orders), and the caller's setting comes back."""
    from tpumetrics_torch.utils.compute import _safe_matmul

    rng = np.random.default_rng(33)
    x = torch.from_numpy(rng.standard_normal((512, 768)).astype(np.float32))
    y = torch.from_numpy(rng.standard_normal((1024, 768)).astype(np.float32))
    want = x.double() @ y.double().T
    torch.set_float32_matmul_precision("medium")
    try:
        got = _safe_matmul(x.to(cuda), y.to(cuda)).cpu().double()
        assert torch.backends.cuda.matmul.fp32_precision == "tf32"
    finally:
        torch.set_float32_matmul_precision("highest")
    scale = (x.double().abs() @ y.double().abs().T)
    assert bool(((got - want).abs() <= 768 * 2**-24 * scale).all())


def test_buffered_retrieval_leader_replays_without_a_host_sync(cuda):
    """A retrieval leader on live MaskedBuffers is captured and replayed;
    the replays raise nothing with host syncs made errors; states bit for
    bit the unfused collection's; a list leader stays eager beside it."""
    from tpumetrics_torch import retrieval as rt
    from tpumetrics_torch.interop import load_state

    def buffered(m, cap=8192):
        for state in m._defaults:
            m.set_state_capacity(state, cap)
        load_state(m, m.init_state())
        return m

    def make(f):
        return MetricCollection(
            {"cap_mrr": buffered(rt.RetrievalMRR(top_k=10, num_queries=40, device=cuda)),
             "cap_map": buffered(rt.RetrievalMAP(num_queries=40, device=cuda)),
             "list_ndcg": rt.RetrievalNormalizedDCG(device=cuda)},
            fused_update=f, device=cuda,
        )

    cols = {f: make(f) for f in (False, True)}
    rng = np.random.default_rng(34)
    for i in range(6):
        args = [torch.from_numpy(a).to(cuda) for a in (
            rng.random(1024).astype(np.float32), rng.integers(0, 2, 1024), np.sort(rng.integers(0, 40, 1024)))]
        cols[False].update(*args)
        if i >= 3:
            torch.cuda.set_sync_debug_mode("error")
        try:
            # the list leader's eager binary check reads the host: let it through by name
            ndcg = cols[True]._modules["list_ndcg"]
            update = ndcg.update

            def allowed(*a, **k):
                torch.cuda.set_sync_debug_mode(0)
                try:
                    return update(*a, **k)
                finally:
                    torch.cuda.set_sync_debug_mode("error" if i >= 3 else 0)

            object.__setattr__(ndcg, "update", allowed)
            cols[True].update(*args)
        finally:
            torch.cuda.set_sync_debug_mode(0)
            object.__setattr__(ndcg, "update", update)
        fused, plain = export_state(cols[True]), export_state(cols[False])
        for leader, states in plain.items():
            for name, ref in states.items():
                got = fused[leader][name]
                assert all(np.array_equal(g, r) for g, r in zip(got, ref)), (leader, name)
    step = cols[True]._fused_oo_step
    assert step.leaders == ["cap_map"] and step.counts["replayed"] >= 3
    for key, val in cols[False].compute().items():
        assert torch.equal(cols[True].compute()[key], val), key


# ------------------------------------------------------------------ audio: the IIR kernel and the streams


def _biquad_case(kind, lanes_per, t, seed=0):
    """``(x, b, a, clamp)`` on the card as SRMR's call sites give them at 16 kHz
    for 8 utterances: the gammatone bank (184 lanes, 4 stages, clipped) or
    the modulation bank (1,472 lanes, 1 stage)."""
    from tpumetrics_torch.functional.audio import srmr

    rng = np.random.default_rng(seed)
    const = srmr._constants(16000, 23, 125, 4, 128.0, "cuda")
    if kind == "gammatone":
        x = np.repeat(rng.uniform(-1, 1, (8, 1, t)), 23, axis=1).reshape(-1, t)
        b, a, clamp = const["as_"].repeat(1, 8, 1), const["bs"].repeat(1, 8, 1), True
    else:
        x = np.repeat(np.abs(rng.standard_normal((184, 1, t))) * 1e-3, 8, axis=1).reshape(-1, t)
        b, a, clamp = const["mb"].repeat(184, 1)[None], const["ma"].repeat(184, 1)[None], False
    x = torch.from_numpy(x.astype(np.float32)).cuda()
    return x[:lanes_per] if lanes_per else x, (b[:, :lanes_per] if lanes_per else b), (a[:, :lanes_per] if lanes_per else a), clamp


# the kernel's chunk (K = 16 samples a thread) and tile (4,096 samples a block): csrc/biquad_cascade.cu
_K, _TILE = 16, 4096


def _biquad_edit(x, edit):
    if edit == "zeros":
        return torch.zeros_like(x)
    x = x.clone()
    if edit == "loud":
        x[::7] *= 3e4
    elif edit == "nan":
        x[3, 100] = float("nan")
        x[10, 500:] = float("nan")
        x[11, 0] = float("inf")
        x[12] = 0.0  # a silent lane beside them
    return x


@pytest.mark.parametrize(
    "kind,lanes,t,edit",
    [
        ("gammatone", 0, 2048, None), ("gammatone", 0, 4096, None), ("modulation", 0, 2048, None),
        ("modulation", 0, 4096, None), ("gammatone", 0, 1, None), ("gammatone", 1, 4096, None),
        ("gammatone", 0, 1000, "zeros"), ("gammatone", 0, 1000, "loud"), ("gammatone", 0, 1000, "nan"),
        ("modulation", 0, 1000, "nan"),
        # the chunk and tile edges, and T not a multiple of K (T % 4 != 0 takes the kernel's 4-byte loads)
        ("gammatone", 0, _K - 1, None), ("gammatone", 0, _K + 1, None), ("gammatone", 0, 1001, None),
        ("gammatone", 0, _TILE - 1, None), ("gammatone", 0, _TILE + 1, None), ("gammatone", 0, 3 * _TILE + 5, None),
        ("modulation", 0, _K + 1, None), ("modulation", 0, _TILE - 1, None), ("modulation", 0, _TILE + 1, None),
        ("modulation", 0, 3 * _TILE + 5, None),
    ],
)
def test_biquad_kernel_matches_plain_version(cuda, kind, lanes, t, edit):
    """The kernel against the float64 reference beside its plain version on
    the same inputs: ``rel(kernel) <= 2 rel(plain) + 1e-6`` (a scan
    reassociates the recurrence, so not bit for bit), the non-finite outputs
    where the plain loop's are, exact zeros on silent lanes; at both call
    sites at short T, the chunk and tile edges, T=1, one lane, silence, lanes
    driven into the clip, and NaN and inf inputs."""
    from tpumetrics_torch.ops import biquad as bq

    x, b, a, clamp = _biquad_case(kind, lanes, t)
    x = _biquad_edit(x, edit)
    before = bq.launches
    got = bq.biquad_cascade(x, b, a, clamp)
    torch.cuda.synchronize()
    assert bq.launches == before + 1
    want = bq.biquad_cascade_plain(x, b, a, clamp)
    assert torch.equal(torch.isfinite(got), torch.isfinite(want))
    silent = (x == 0).all(dim=1)
    assert bool((got[silent] == 0).all())
    ref = bq.biquad_cascade_reference(x, b, a, clamp)
    rel, rel_plain = bq.relative_error(got, ref), bq.relative_error(want, ref)
    assert rel <= bq.REL_SLACK * rel_plain + bq.REL_FLOOR, (rel, rel_plain)
    if edit == "loud":  # the clip between the stages acted: the output is not the unclipped cascade's
        assert not np.array_equal(ref, bq.biquad_cascade_reference(x, b, a, False))
    if edit == "zeros":
        assert bool(silent.all()) and not bool(got.any())


@pytest.mark.parametrize("kind,t", [("gammatone", 3 * _TILE + 5), ("modulation", 2 * _TILE)])
def test_biquad_kernel_is_deterministic_and_replays_bit_for_bit(cuda, kind, t):
    """The carries between tiles compose in one fixed order: two calls give
    the same bits, and a CUDA graph's replays (the scratch zeroed inside the
    graph) give the eager call's."""
    from tpumetrics_torch.ops import biquad as bq

    x, b, a, clamp = _biquad_case(kind, 0, t, seed=3)
    first = bq.biquad_cascade(x, b, a, clamp)
    second = bq.biquad_cascade(x, b, a, clamp)
    torch.cuda.synchronize()
    assert torch.equal(first.view(torch.int32), second.view(torch.int32))
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        bq.biquad_cascade(x, b, a, clamp)
    torch.cuda.current_stream().wait_stream(side)
    captured, graph = bq.captured, torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        replayed = bq.biquad_cascade(x, b, a, clamp)
    assert bq.captured == captured + 1
    for _ in range(3):
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(replayed.view(torch.int32), first.view(torch.int32))


def _separation_batch(seed, n=8, spk=2, t=8000):
    rng = np.random.default_rng(seed)
    src = rng.standard_normal((n, spk, t)).astype(np.float32)
    est = src + 0.2 * rng.standard_normal(src.shape).astype(np.float32)
    perm = np.stack([rng.permutation(spk) for _ in range(n)])
    return np.take_along_axis(est, perm[:, :, None], 1), src, perm


def test_separation_members_on_the_card_match_the_cpu(cuda):
    """PIT (speaker-wise SI-SDR), pit_permutate, SI-SNR, SNR, SA-SDR, SDR
    (filter 512) and C-SI-SNR on a 512-point STFT: the card's sums within
    1e-5 relative of the CPU's (SDR's LU solves 1e-4), counts exact, the
    permutations equal and the data's."""
    import tpumetrics_torch.audio as au
    from tpumetrics_torch.functional.audio import (
        permutation_invariant_training,
        pit_permutate,
        scale_invariant_signal_distortion_ratio,
    )

    def members(dev):
        return {"pit": au.PermutationInvariantTraining(scale_invariant_signal_distortion_ratio, device=dev),
                "si_snr": au.ScaleInvariantSignalNoiseRatio(device=dev), "snr": au.SignalNoiseRatio(device=dev),
                "sa_sdr": au.SourceAggregatedSignalDistortionRatio(device=dev),
                "sdr": au.SignalDistortionRatio(device=dev), "c_si_snr": au.ComplexScaleInvariantSignalNoiseRatio(device=dev)}

    def spec(x):
        win = torch.hann_window(512, device=x.device)
        s = torch.stft(x.reshape(-1, x.shape[-1]), 512, hop_length=128, window=win, return_complex=True)
        return s.reshape(*x.shape[:-1], *s.shape[-2:])

    ms = {dev: members(dev) for dev in ("cpu", cuda)}
    for i in range(3):
        est, src, perm = _separation_batch(40 + i)
        for dev, m in ms.items():
            p, t = torch.from_numpy(est).to(dev), torch.from_numpy(src).to(dev)
            m["pit"].update(p, t)
            _, best = permutation_invariant_training(p, t, scale_invariant_signal_distortion_ratio)
            assert np.array_equal(best.cpu().numpy(), np.argsort(perm, axis=1))
            q = pit_permutate(p, best)
            for name in ("si_snr", "snr", "sa_sdr", "sdr"):
                m[name].update(q, t)
            m["c_si_snr"].update(spec(q), spec(t))
    for name, metric in ms[cuda].items():
        for state in metric._defaults:
            got, want = getattr(metric, state).cpu().double(), getattr(ms["cpu"][name], state).double()
            rtol = 1e-4 if name == "sdr" else 1e-5
            assert float((got - want).abs()) <= rtol * float(want.abs()), (name, state, got, want)


def test_sdr_update_syncs_nothing_and_stays_eager_in_a_fused_collection(cuda):
    """SDR's steady update shows no host sync; its batched LU (MAGMA's, for
    100 systems of 512) cannot be captured, so a fused collection keeps it
    eager beside the graph of the other members and their states stay bit
    for bit the unfused ones."""
    import warnings

    import tpumetrics_torch.audio as au

    est, src, _ = _separation_batch(50, n=50, t=32000)
    p, t = torch.from_numpy(est).to(cuda), torch.from_numpy(src).to(cuda)
    sdr = au.SignalDistortionRatio(device=cuda)
    sdr.update(p, t)
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            sdr.update(p, t)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    syncs = [w for w in caught if "synchroniz" in str(w.message) and "prototype" not in str(w.message)]
    assert syncs == []
    assert sdr._update_reads_host

    def make(f):
        return MetricCollection({"sdr": au.SignalDistortionRatio(device=cuda), "snr": au.SignalNoiseRatio(device=cuda)},
                                fused_update=f, device=cuda)

    cols = {f: make(f) for f in (False, True)}
    for _ in range(4):
        for col in cols.values():
            col.update(p, t)
        got, want = export_state(cols[True]), export_state(cols[False])
        assert all(np.array_equal(got[k][s], want[k][s]) for k in want for s in want[k])
    step = cols[True]._fused_oo_step
    assert step.leaders == ["snr"] and step.counts["replayed"] == 1


def test_audio_collections_replay_in_graphs_with_the_kernel(cuda):
    """A separation collection (SI-SNR, SNR, SA-SDR) and an SRMR one (16 kHz:
    the biquad kernel twice an update) captured in graphs: replays raise
    nothing with host syncs made errors, replay the kernel's two captured
    calls, and leave the states bit for bit the unfused collections'."""
    import tpumetrics_torch.audio as au

    def separation(f):
        return MetricCollection({"si_snr": au.ScaleInvariantSignalNoiseRatio(device=cuda),
                                 "snr": au.SignalNoiseRatio(device=cuda),
                                 "sa_sdr": au.SourceAggregatedSignalDistortionRatio(device=cuda)},
                                fused_update=f, device=cuda)

    def srmr(f):
        return MetricCollection({"srmr": au.SpeechReverberationModulationEnergyRatio(16000, device=cuda)},
                                fused_update=f, device=cuda)

    est, src, _ = _separation_batch(52, n=4, t=8000)
    rng = np.random.default_rng(51)
    wave = torch.from_numpy(rng.standard_normal((2, 8000)).astype(np.float32) * 0.1).to(cuda)
    for make, batch in ((separation, (torch.from_numpy(est).to(cuda), torch.from_numpy(src).to(cuda))), (srmr, (wave,))):
        cols = {f: make(f) for f in (False, True)}
        for i in range(5):
            cols[False].update(*batch)
            if i >= 3:  # the fourth and fifth updates are replays
                torch.cuda.set_sync_debug_mode("error")
            try:
                cols[True].update(*batch)
            finally:
                torch.cuda.set_sync_debug_mode(0)
            got, want = export_state(cols[True]), export_state(cols[False])
            assert all(np.array_equal(got[k][s], want[k][s]) for k in want for s in want[k])
        step = cols[True]._fused_oo_step
        assert step.counts["replayed"] == 2
        if make is srmr:
            # two calls captured, run by the capture's own replay and each replay after it
            assert step.kernel_launches()["biquad_cascade"] == 2 * (step.counts["captured"] + step.counts["replayed"])
        for k, v in cols[False].compute().items():
            assert torch.equal(cols[True].compute()[k], v)


def test_three_speakers_take_the_hungarian_path_eagerly_and_the_exhaustive_one_under_capture(cuda):
    """Three speakers: eagerly the Hungarian assignment (it reads the metric
    matrix on the host), under a CUDA graph capture the exhaustive search
    (permutations decoded on the device); the same permutations, the data's,
    and the same best metric."""
    import warnings

    from tpumetrics_torch.functional.audio import permutation_invariant_training, scale_invariant_signal_distortion_ratio

    est, src, perm = _separation_batch(53, n=10, spk=3)
    p, t = torch.from_numpy(est).to(cuda), torch.from_numpy(src).to(cuda)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            eager_metric, eager_perm = permutation_invariant_training(p, t, scale_invariant_signal_distortion_ratio)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    assert any("synchroniz" in str(w.message) and "prototype" not in str(w.message) for w in caught)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        permutation_invariant_training(p, t, scale_invariant_signal_distortion_ratio)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        cap_metric, cap_perm = permutation_invariant_training(p, t, scale_invariant_signal_distortion_ratio)
    graph.replay()
    torch.cuda.synchronize()
    assert np.array_equal(eager_perm.cpu().numpy(), np.argsort(perm, axis=1))
    assert torch.equal(cap_perm, eager_perm)
    assert float((cap_metric - eager_metric).abs().max()) <= 1e-6 * float(eager_metric.abs().max())


def _textures(seed, n, c, h, w):
    """``(preds, target)`` float32 ``(n, c, h, w)`` in [0, 1]: 1/f-spectrum textures (the restoration
    stream's generator in ``chip_smoke.py``) and their copies with noise of 0.02, both 8-bit."""
    import chip_smoke

    rng = np.random.default_rng(seed)
    target = np.stack([[0.5 + 0.12 * chip_smoke.natural_field(rng, h, w) for _ in range(c)] for _ in range(n)])
    target = np.round(np.clip(target, 0, 1) * 255) / 255
    preds = np.round(np.clip(target + 0.02 * rng.standard_normal(target.shape), 0, 1) * 255) / 255
    return preds.astype(np.float32), target.astype(np.float32)


def test_image_convolutions_under_torch_default_tf32_match_float64_oracles(cuda):
    """With torch's TF32 defaults (cuDNN may run float32 convolutions in TF32), SSIM, UQI and VIF on the card
    stay within their float64 oracles' bounds (``chip_smoke.py``'s: SSIM and UQI one float32 rounding of their
    moments' terms times the images' condition, at least 1e-5; VIF 1e-4 relative): the library runs its
    convolutions in full float32 by itself."""
    import chip_smoke
    from tpumetrics_torch.functional.image import (
        structural_similarity_index_measure,
        universal_image_quality_index,
        visual_information_fidelity,
    )

    preds, target = _textures(60, 2, 3, 192, 256)
    p64, t64 = preds.astype(np.float64), target.astype(np.float64)
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = True, False
    try:
        p, t = torch.from_numpy(preds).to(cuda), torch.from_numpy(target).to(cuda)
        ssim = float(structural_similarity_index_measure(p, t, data_range=1.0))
        uqi = float(universal_image_quality_index(p, t))
        vif = float(visual_information_fidelity(p, t))
        assert torch.backends.cudnn.allow_tf32  # the library's guard restored the caller's setting
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved
    moments, pad = chip_smoke.moments64(p64, t64)
    want_ssim = np.mean([chip_smoke.ssim64(p64[i], t64[i])[0] for i in range(2)])
    want_uqi = chip_smoke.uqi_from64(moments, pad).mean()
    want_vif = np.mean([chip_smoke.vif64(p64[i, c], t64[i, c]) for i in range(2) for c in range(3)])
    k_ssim = chip_smoke.condition64(moments, pad, 0.03**2)
    k_uqi = chip_smoke.condition64(moments, pad, chip_smoke.F32_EPS)
    assert abs(ssim - want_ssim) <= max(1e-5, chip_smoke.F32_U * k_ssim)
    assert abs(uqi - want_uqi) <= max(1e-5, chip_smoke.F32_U * k_uqi)
    assert abs(vif - want_vif) <= 1e-4 * abs(want_vif)


def test_ssim_3d_runs_conv3d_on_the_card_as_on_the_cpu(cuda):
    """3-D SSIM through ``conv3d`` on the card equals the CPU's within 1e-5 (the moments cancel as in 2-D),
    and the unequal-sigma crop that empties the map gives NaN there too."""
    from tpumetrics_torch.functional.image import structural_similarity_index_measure as ssim

    rng = np.random.default_rng(61)
    target = rng.random((2, 1, 32, 32, 32)).astype(np.float32)
    preds = np.clip(target + 0.05 * rng.standard_normal(target.shape), 0, 1).astype(np.float32)
    p, t = torch.from_numpy(preds), torch.from_numpy(target)
    got = ssim(p.to(cuda), t.to(cuda), data_range=1.0, reduction="none").cpu()
    want = ssim(p, t, data_range=1.0, reduction="none")
    assert torch.isfinite(want).all() and float((got - want).abs().max()) <= 1e-5
    nan = ssim(p[:, :, :16, :16, :16].to(cuda), t[:, :, :16, :16, :16].to(cuda), sigma=(1.5, 1.0, 0.5))
    assert torch.isnan(nan)


def test_restoration_collection_replays_bit_for_bit_without_host_syncs(cuda):
    """An RGB restoration collection (PSNR, SSIM, MS-SSIM, UQI, VIF) and a pan-sharpening one (ERGAS, SAM and
    its capacity copy, RASE, RMSE-SW) captured in graphs: replays raise nothing with host syncs made errors,
    the list leaders update eagerly beside the graph, and the states stay bit for bit the unfused ones'."""
    import tpumetrics_torch.image as im
    from tpumetrics_torch.interop import load_state

    def capacity_sam():
        sam = im.SpectralAngleMapper(reduction="none", device=cuda)
        for state in ("preds", "target"):
            sam.set_state_capacity(state, 16, feature_shape=(8, 64, 64))
        load_state(sam, sam.init_state())
        return sam

    def rgb(f):
        return MetricCollection({"psnr": im.PeakSignalNoiseRatio(data_range=1.0, device=cuda),
                                 "ssim": im.StructuralSimilarityIndexMeasure(data_range=1.0, device=cuda),
                                 "ms_ssim": im.MultiScaleStructuralSimilarityIndexMeasure(data_range=1.0, device=cuda),
                                 "uqi": im.UniversalImageQualityIndex(device=cuda),
                                 "vif": im.VisualInformationFidelity(device=cuda)}, fused_update=f, device=cuda)

    def spectral(f):
        return MetricCollection({"ergas": im.ErrorRelativeGlobalDimensionlessSynthesis(device=cuda),
                                 "sam": im.SpectralAngleMapper(device=cuda), "cap_sam": capacity_sam(),
                                 "rase": im.RelativeAverageSpectralError(device=cuda),
                                 "rmse_sw": im.RootMeanSquaredErrorUsingSlidingWindow(device=cuda)},
                                fused_update=f, device=cuda)

    preds, target = _textures(62, 2, 3, 192, 192)
    rng = np.random.default_rng(63)
    spec_t = (0.1 + rng.random((2, 8, 64, 64))).astype(np.float32)
    spec_p = (spec_t + 0.01 * rng.standard_normal(spec_t.shape)).astype(np.float32)
    for make, batch in ((rgb, (preds, target)), (spectral, (spec_p, spec_t))):
        args = tuple(torch.from_numpy(x).to(cuda) for x in batch)
        cols = {f: make(f) for f in (False, True)}
        for i in range(5):
            cols[False].update(*args)
            if i >= 3:  # the fourth and fifth updates are replays
                torch.cuda.set_sync_debug_mode("error")
            try:
                cols[True].update(*args)
            finally:
                torch.cuda.set_sync_debug_mode(0)
            got, want = export_state(cols[True]), export_state(cols[False])
            for leader, states in want.items():
                for name, ref in states.items():
                    refs, vals = (ref, got[leader][name]) if isinstance(ref, (list, tuple)) else ([ref], [got[leader][name]])
                    assert all(np.array_equal(v, r) for v, r in zip(vals, refs, strict=True)), (leader, name)
        step = cols[True]._fused_oo_step
        assert step.counts["replayed"] == 2
        if make is spectral:
            assert sorted(step.leaders) == ["cap_sam", "rmse_sw", "sam"]
        for k, v in cols[False].compute().items():
            assert torch.equal(cols[True].compute()[k], v)


def _criteo_like_batch(seed, n=65_536, ragged=None):
    """One monitoring batch at the Criteo stream's shape: scores in (0, 1),
    integer counts with NaNs (bucket edges everywhere), and a valid mask
    (a ragged batch's padding masked out)."""
    rng = np.random.default_rng(seed)
    scores = (1 / (1 + np.exp(-rng.normal(-1.2, 0.6, n)))).astype(np.float32)
    counts = np.floor(rng.lognormal(1.0, 1.5, n)).astype(np.float32)
    counts[rng.random(n) < 0.2] = np.nan
    valid = np.ones(n, dtype=bool)
    if ragged is not None:
        valid[ragged:] = False
    return scores, counts, valid


def _monitoring_members(device, reference):
    import tpumetrics_torch.monitoring as mon

    return {
        "q": mon.SketchQuantiles((0.5, 0.99), window=4, slots=2, device=device),
        "cum": mon.SketchQuantiles((0.5,), device=device),
        "psi": mon.PSI(reference, window=4, slots=2, threshold=0.1, device=device),
        "ks": mon.KSDistance(reference, window=4, slots=2, threshold=0.1, device=device),
        "mean": mon.WindowedMean(4, slots=2, device=device),
        "sum": mon.WindowedSum(4, slots=2, device=device),
        "max": mon.WindowedMax(4, slots=2, device=device),
        "min": mon.WindowedMin(4, slots=2, device=device),
        "decayed": mon.DecayedMean(half_life=2.0, device=device),
    }


def test_sketch_ingest_on_the_card_is_bit_for_bit_the_cpu_and_the_oracle(cuda):
    """The bucket index on the card equals the float64 numpy oracle (level edges, one ulp either side, the
    integers 0..69,999, the specials, a batch of each column), and a windowed sketch fed the stream's batch
    shape (65,536 rows, a ragged last batch) holds on the card the CPU's state bit for bit."""
    import chip_smoke
    import tpumetrics_torch.monitoring as mon

    layout = mon.SketchLayout()
    bounds = (layout.unit * 2.0 ** np.arange(-1, layout.levels + 1)).astype(np.float32)
    edges = np.concatenate([bounds, np.nextafter(bounds, np.float32(np.inf)), np.nextafter(bounds, np.float32(0)),
                            np.float32([0.0, -0.0, np.inf, -np.inf, np.nan, 3.4e38])])
    scores, counts, _ = _criteo_like_batch(70)
    for values in (np.concatenate([edges, -edges]), np.arange(70_000, dtype=np.float32), scores, counts):
        got = layout.bucket_index(torch.from_numpy(values).to(cuda)).cpu().numpy()
        np.testing.assert_array_equal(got, chip_smoke.sketch_index_oracle(values))
    card = mon.SketchQuantiles((0.5, 0.9, 0.999), window=4, slots=2, device=cuda)
    cpu = mon.SketchQuantiles((0.5, 0.9, 0.999), window=4, slots=2, device="cpu")
    for i in range(6):
        _, x, valid = _criteo_like_batch(71 + i, ragged=30_953 if i == 5 else None)
        card.update(torch.from_numpy(x).to(cuda), torch.from_numpy(valid).to(cuda))
        cpu.update(torch.from_numpy(x), torch.from_numpy(valid))
        assert torch.equal(card.sketch.cpu(), cpu.sketch) and int(card.count) == int(cpu.count)
    assert torch.equal(card.compute().cpu(), cpu.compute())


def test_monitoring_collection_replays_bit_for_bit_without_host_syncs(cuda):
    """Every monitoring member in one fused collection: a steady unfused update and the replays raise nothing
    with host syncs made errors, and the fused states stay bit for bit the unfused ones'; the drift scores and
    quantiles equal."""
    scores, counts, _ = _criteo_like_batch(80)
    reference = torch.from_numpy(_criteo_like_batch(81)[0][:100_000])
    cols = {f: MetricCollection(_monitoring_members(cuda, reference), fused_update=f, device=cuda) for f in (False, True)}
    for i in range(7):
        s, _, valid = _criteo_like_batch(82 + i, ragged=30_953 if i == 6 else None)
        args = (torch.from_numpy(s).to(cuda), torch.from_numpy(valid).to(cuda).float())
        for fused in (False, True):
            if i >= (3 if fused else 1):  # steady: unfused after the groups formed, fused the replays
                torch.cuda.set_sync_debug_mode("error")
            try:
                cols[fused].update(*args)
            finally:
                torch.cuda.set_sync_debug_mode(0)
        got, want = export_state(cols[True]), export_state(cols[False])
        for leader, states in want.items():
            for name, ref in states.items():
                assert np.array_equal(got[leader][name], ref), (leader, name)
    step = cols[True]._fused_oo_step
    assert step.counts["replayed"] == 4 and sorted(step.leaders) == sorted(g[0] for g in cols[True].compute_groups.values())
    for k, v in cols[False].compute().items():
        assert torch.equal(cols[True].compute()[k], v), k


# ------------------------------------------------------------ the backbone image metrics


@pytest.fixture
def tf32_on():
    """torch's TF32 defaults for cuDNN (float32 convolutions may run in TF32): the library keeps its own in full
    float32 whatever this says."""
    saved = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    yield
    torch.backends.cudnn.allow_tf32 = saved


def _unguarded(module):
    """The module's full-float32 guard taken out: what the card computes under TF32."""
    import contextlib
    from unittest import mock

    return mock.patch.object(module, "_ieee_float32", lambda *b: contextlib.nullcontext())


def _u8_images(n, seed, side=32):
    return torch.from_numpy(np.random.default_rng(seed).integers(0, 256, (n, 3, side, side), dtype=np.uint8))


def test_inception_on_the_card_matches_the_cpu_where_tf32_would_not(cuda, tf32_on):
    """The 2048-d features of 8 images on the card within 1e-5 of the CPU path's largest (float32 sums in
    another order; measured 2.4e-7), and the same forward with the float32 guard taken out beyond it."""
    from tpumetrics_torch.image import _inception

    params = _inception.random_inception_params(0)
    cpu_p = {k: torch.from_numpy(v) for k, v in params.items()}
    card_p = {k: v.to(cuda) for k, v in cpu_p.items()}
    imgs = _u8_images(8, 1)
    want = _inception.inception_v3_features(cpu_p, ("2048",))(imgs)[0]
    scale = float(want.abs().max())
    got = _inception.inception_v3_features(card_p, ("2048",))(imgs.to(cuda))[0].cpu()
    assert float((got - want).abs().max()) <= 1e-5 * scale
    with _unguarded(_inception):
        loose = _inception.inception_v3_features(card_p, ("2048",))(imgs.to(cuda))[0].cpu()
    assert float((loose - want).abs().max()) > 1e-5 * scale


def test_lpips_on_the_card_matches_the_cpu_where_tf32_would_not(cuda, tf32_on):
    from tpumetrics_torch.functional.image import learned_perceptual_image_patch_similarity as lpips
    from tpumetrics_torch.functional.image.lpips import lpips_head_weights
    from tpumetrics_torch.image import _backbones

    params = _backbones.random_lpips_params("alex", 0)
    rng = np.random.default_rng(2)
    a, b = (torch.from_numpy(rng.uniform(0, 1, (2, 3, 256, 256)).astype(np.float32)) for _ in range(2))
    heads = [torch.from_numpy(w) for w in lpips_head_weights("alex")]
    cpu_net = _backbones.alexnet_features(_backbones.lpips_conv_params(params, "cpu", torch.float64))
    want = lpips(a.double(), b.double(), cpu_net, [h.double() for h in heads], normalize=True, reduction="none")
    card_net = _backbones.alexnet_features(_backbones.lpips_conv_params(params, cuda))
    got = lpips(a.to(cuda), b.to(cuda), card_net, heads, normalize=True, reduction="none").cpu().double()
    assert float(((got - want) / want).abs().max()) <= 1e-5
    with _unguarded(_backbones):
        loose = lpips(a.to(cuda), b.to(cuda), card_net, heads, normalize=True, reduction="none").cpu().double()
    assert float(((loose - want) / want).abs().max()) > 1e-5


@pytest.fixture
def inception_file(tmp_path):
    from tpumetrics_torch.backbones import registry
    from tpumetrics_torch.image._inception import random_inception_params

    path = tmp_path / "inception.npz"
    np.savez(path, **random_inception_params(3))
    registry._reset_backbones()
    yield str(path)
    registry._reset_backbones()


def test_a_captured_fid_update_replays_bit_for_bit_the_unfused_one(cuda, tf32_on, inception_file):
    """FID's update captured as a graph (the forward inlined) against the same update run op by op (the
    extractor through the engine's own graph): states bit for bit after every update, with TF32 allowed
    around them (the captured convolutions keep full float32), and a replay that syncs nothing."""
    from tpumetrics_torch.backbones import registry_stats
    from tpumetrics_torch.image import FrechetInceptionDistance

    kw = dict(feature=2048, feature_extractor_weights_path=inception_file, device=cuda)
    fused, unfused = FrechetInceptionDistance(**kw), FrechetInceptionDistance(**kw)
    for i in range(4):
        imgs = _u8_images(16, 10 + i).to(cuda)
        if i == 3:
            torch.cuda.set_sync_debug_mode("error")
        try:
            fused.update(imgs, real=i % 2 == 0)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        unfused.update(imgs, real=i % 2 == 0)
        if i == 0:
            unfused._jit_accum.eager_mode = True
        for name in fused._defaults:
            assert torch.equal(getattr(fused, name), getattr(unfused, name)), (i, name)
    assert fused._jit_accum.counts == {"eager": 1, "captured": 1, "replayed": 2}
    (stats,) = registry_stats().values()
    assert stats["refs"] == 2 and stats["compiles"] == 1  # the engine captured bucket 16 for the unfused one
    assert bool(torch.isfinite(fused.compute()))


def test_the_eager_latch_with_an_extractor_that_reads_the_host(cuda, recwarn):
    """An extractor that reads the device on the host fails its capture; the eager run succeeds, so FID latches
    eager mode with one warning, and its states equal a plain eager FID's. A transient error does not latch."""
    from tpumetrics_torch.image import FrechetInceptionDistance

    def reads_host(x):
        f = x.reshape(x.shape[0], -1)[:, :8].float()
        return f * (1.0 + 0.0 * float(f.mean()))

    def plain(x):
        return x.reshape(x.shape[0], -1)[:, :8].float()

    latched = FrechetInceptionDistance(feature=reads_host, num_features=8, device=cuda)
    ref = FrechetInceptionDistance(feature=plain, num_features=8, device=cuda)
    for i in range(3):
        imgs = _u8_images(6, 20 + i).to(cuda)
        latched.update(imgs, real=True)
        ref.update(imgs, real=True)
        ref._jit_accum.eager_mode = True
    assert latched._jit_accum.eager_mode and latched._jit_accum.counts == {"eager": 3, "captured": 0, "replayed": 0}
    assert len([w for w in recwarn if "cannot be captured" in str(w.message)]) == 1
    for name in latched._defaults:
        assert torch.equal(getattr(latched, name), getattr(ref, name)), name

    state = {"bad": False}

    def flaky(x):
        if state["bad"]:
            raise ValueError("bad batch")
        return plain(x)

    fid = FrechetInceptionDistance(feature=flaky, num_features=8, device=cuda)
    fid.update(_u8_images(6, 30).to(cuda), real=True)
    state["bad"] = True
    with pytest.raises(ValueError, match="bad batch"):
        fid.update(_u8_images(6, 31).to(cuda), real=True)
    assert not fid._jit_accum.eager_mode
    state["bad"] = False
    fid.update(_u8_images(6, 32).to(cuda), real=True)
    warned = [str(w.message) for w in recwarn if "cannot be captured" in str(w.message)]
    assert fid._jit_accum.counts["captured"] == 1 and not fid._jit_accum.eager_mode, (fid._jit_accum.counts, warned)


def test_the_engine_captures_one_graph_per_bucket_on_the_card(cuda):
    from tpumetrics_torch.backbones import get_backbone, registry

    registry._reset_backbones()
    rng = np.random.default_rng(5)
    params = {"w": (rng.standard_normal((8, 3, 3, 3)) * 0.2).astype(np.float32)}
    h = get_backbone("test:conv", params, device=cuda,
                     forward=lambda p, x: torch.tanh(torch.nn.functional.conv2d(x, p["w"], padding=1)))
    xs = {n: torch.from_numpy(rng.standard_normal((n, 3, 8, 8)).astype(np.float32)).to(cuda) for n in (3, 4, 5, 7, 8)}
    outs = {n: h(x) for n, x in xs.items()}  # buckets 4 (eager, captured) and 8 (eager, captured, replayed)
    assert h.engine.compile_count == 2 and h.engine.dispatch_count == 5
    assert all(outs[n].shape[0] == n for n in outs)
    x5 = xs[8][:5]
    assert torch.equal(h(x5), h(xs[8])[:5])  # the pad rows leak into nothing
    h.close()


def test_an_engine_bucket_whose_capture_fails_runs_eagerly(cuda, recwarn):
    """A custom forward that reads the host cannot be captured: its bucket runs eagerly from then on, with one
    warning, and gives the same values; other engines capture as before."""
    from tpumetrics_torch.backbones import get_backbone, registry

    registry._reset_backbones()
    h = get_backbone("test:host", {"s": np.float32(2.0)}, device=cuda,
                     forward=lambda p, x: x * p["s"] * (1.0 + 0.0 * float(x.sum())))
    x = torch.arange(6.0, device=cuda).reshape(3, 2)
    outs = [h(x).cpu() for _ in range(3)]
    assert all(torch.equal(o, outs[0]) for o in outs) and outs[0].tolist() == [[0.0, 2.0], [4.0, 6.0], [8.0, 10.0]]
    assert h.engine.compile_count == 0 and [p.eager for p in h.engine._programs.values()] == [True]
    assert len([w for w in recwarn if "cannot be captured" in str(w.message)]) == 1
    g = get_backbone("test:ok", {"s": np.float32(3.0)}, device=cuda, forward=lambda p, x: x * p["s"])
    for _ in range(3):
        g(x)
    assert g.engine.compile_count == 1  # the pool the failed capture left behind was replaced
    registry._reset_backbones()


def test_bf16_policy_gates_on_the_card(cuda):
    """bfloat16 is opt-in: FID within max(0.05, 10 %), KID within max(0.005, 25 %) and LPIPS within max(0.01,
    5 %) of float32 (the JAX package's gates), on the card's tensor cores."""
    from tpumetrics_torch.backbones import get_backbone, registry
    from tpumetrics_torch.image import (
        FrechetInceptionDistance, KernelInceptionDistance, LearnedPerceptualImagePatchSimilarity)
    from tpumetrics_torch.image._backbones import random_lpips_params

    registry._reset_backbones()
    rng = np.random.default_rng(30)
    params = {"w": (rng.standard_normal((16, 3, 3, 3)) * 0.2).astype(np.float32),
              "b": (rng.standard_normal((16,)) * 0.1).astype(np.float32)}
    real, fake = (torch.from_numpy(rng.integers(0, 255, (32, 3, 32, 32)).astype(np.uint8)).to(cuda) for _ in range(2))

    def feat(p, x):
        return torch.tanh(torch.nn.functional.conv2d(x, p["w"], padding=1) + p["b"].reshape(1, -1, 1, 1)).mean((2, 3))

    def run(policy):
        h = get_backbone("test:feat", params, forward=feat, dtype_policy=policy, device=cuda)
        fid = FrechetInceptionDistance(feature=lambda x: h(x.float() / 255.0), num_features=16, device=cuda)
        kid = KernelInceptionDistance(feature=lambda x: h(x.float() / 255.0), subsets=4, subset_size=16, device=cuda)
        for m in (fid, kid):
            m.update(real, real=True)
            m.update(fake, real=False)
        return float(fid.compute()), float(kid.compute()[0])

    (f32, k32), (f16, k16) = run("float32"), run("bfloat16")
    assert abs(f16 - f32) <= max(0.05, 0.1 * abs(f32)) and f16 != f32
    assert abs(k16 - k32) <= max(0.005, 0.25 * abs(k32))
    lp = random_lpips_params("alex", 31)
    img1, img2 = (torch.from_numpy(rng.uniform(-1, 1, (8, 3, 64, 64)).astype(np.float32)).to(cuda) for _ in range(2))
    values = {}
    for policy in ("float32", "bfloat16"):
        m = LearnedPerceptualImagePatchSimilarity(net_type="alex", backbone_params=lp, backbone_dtype_policy=policy,
                                                  device=cuda)
        m.update(img1, img2)
        values[policy] = float(m.compute())
        m.release_backbones()
    assert abs(values["bfloat16"] - values["float32"]) <= max(0.01, 0.05 * abs(values["float32"]))
    registry._reset_backbones()


# ------------------------------------------------------------------ detection

def _coco_cases():
    import chip_smoke

    return chip_smoke.COCO_MATCH_CASES


@pytest.mark.parametrize("label,n,dp,gp,case,areas,thrs", _coco_cases(), ids=[c[0] for c in _coco_cases()])
def test_coco_greedy_match_kernel_matches_its_plain_version(cuda, label, n, dp, gp, case, areas, thrs):
    """The greedy matcher on the card, bit for bit its plain version on the card and on the CPU, at the edge
    shapes of ``chip_smoke.py``'s kernel check (Gp 1, 32, 33, 64, 65, 128, 600; Dp 1, 100, 200; all-crowd and
    all-ignored cells; IoU ties and IoUs exactly on 0.5 and 0.75; COCO's mix of cells, a 100 x 600 cell among
    thousands of small ones, more cells than the grid has warps, cells of a few ground truths; 2 to 160 (area,
    threshold) pairs, past the warp path's 64)."""
    import chip_smoke
    from tpumetrics_torch.ops import coco_match as cm

    args = chip_smoke.coco_match_inputs(torch, n, dp, gp, 0, case, device="cuda", areas=areas, thrs=thrs)
    before = cm.launches
    m, ig = cm.coco_greedy_match(*args)
    torch.cuda.synchronize()
    assert cm.launches == before + 1
    pm, pig = cm.coco_greedy_match_plain(*args)
    assert torch.equal(m, pm) and torch.equal(ig, pig)
    cpu_m, cpu_ig = cm.coco_greedy_match(*(a.cpu() for a in args))
    assert torch.equal(m.cpu(), cpu_m) and torch.equal(ig.cpu(), cpu_ig)


def _coco_dev(items, device):
    return [{k: torch.as_tensor(v, device=device) for k, v in d.items()} for d in items]


@pytest.mark.parametrize(
    "kw", [{}, {"average": "micro", "class_metrics": True}, {"box_format": "cxcywh"}, {"iou_thresholds": [0.5]}]
)
def test_mean_average_precision_on_the_card_matches_the_cpu_bit_for_bit(cuda, kw):
    import chip_smoke
    from tpumetrics_torch.detection import MeanAveragePrecision
    from tpumetrics_torch.ops import coco_match as cm

    preds, target = chip_smoke.coco_stream(120)
    out = {}
    for device in ("cuda", "cpu"):
        m = MeanAveragePrecision(device=device, **kw)
        for lo in range(0, 120, 32):
            m.update(_coco_dev(preds[lo : lo + 32], device), _coco_dev(target[lo : lo + 32], device))
        before = cm.launches
        out[device] = m.compute()
        if device == "cuda":
            assert cm.launches > before  # the card's match is the kernel's
    assert set(out["cuda"]) == set(out["cpu"])
    for key, value in out["cuda"].items():
        assert value.device.type == "cuda" and torch.equal(value.cpu(), out["cpu"][key]), key


def test_packed_detection_update_replays_with_no_host_sync(cuda):
    import chip_smoke
    from tpumetrics_torch import MetricCollection, interop
    from tpumetrics_torch.detection import MeanAveragePrecision, pack_detection_batch

    preds, target = chip_smoke.coco_stream(200)
    m = MeanAveragePrecision(det_capacity=1 << 15, gt_capacity=1 << 12, device="cuda")
    interop.load_state(m, m.init_state())
    col = MetricCollection([m], fused_update=True, device="cuda")
    ref = MeanAveragePrecision(device="cuda")
    for i, lo in enumerate(range(0, 200, 16)):
        pd, gd = pack_detection_batch(preds[lo : lo + 16], target[lo : lo + 16], det_slots=128, gt_slots=64)
        pd, gd = ({k: torch.as_tensor(v, device="cuda") for k, v in d.items()} for d in (pd, gd))
        torch.cuda.synchronize()
        if i == 6:
            replayed = col._fused_oo_step.counts["replayed"]
            torch.cuda.set_sync_debug_mode("error")
            try:
                col.update(pd, gd)
            finally:
                torch.cuda.set_sync_debug_mode(0)
            assert col._fused_oo_step.counts["replayed"] == replayed + 1
        else:
            col.update(pd, gd)
        ref.update(_coco_dev(preds[lo : lo + 16], "cuda"), _coco_dev(target[lo : lo + 16], "cuda"))
    counts = col._fused_oo_step.counts
    assert counts["eager"] == 2 and counts["captured"] == 1 and counts["replayed"] >= 9  # the ragged last batch eager
    got, want = m.compute(), ref.compute()
    assert all(torch.equal(got[k], want[k]) for k in want)


# ------------------------------------------------------------------ the text slice: token_nll


def _nll_case(b, s, v, dtype, seed=0, spread=3.0, ignore=None):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    logits = (spread * torch.randn(b, s, v, device="cuda", generator=gen)).to(dtype)
    target = torch.randint(0, v, (b, s), device="cuda", generator=gen)
    if ignore is not None:
        target[:, ::3] = ignore
    return logits, target


def _hold_nll_contract(tn, logits, target, ignore_index):
    """The kernel's rows against the float64 reference beside the plain
    version's: ``row_error(kernel) <= 2 row_error(plain) + 1e-6`` row by row,
    NaN where the plain version has NaN; the total within 1e-6 of float64."""
    got, lse = tn.token_nll_rows(logits, target, ignore_index)
    torch.cuda.synchronize()
    plain, plain_lse = tn.token_nll_rows_plain(logits, target, ignore_index)
    ref = tn.token_nll_reference(logits, target, ignore_index)
    err, err_plain = tn.row_error(got, ref), tn.row_error(plain, ref)
    assert torch.equal(got.isnan(), plain.isnan())
    assert bool((err <= tn.REL_SLACK * err_plain + tn.REL_FLOOR).all()), float((err - tn.REL_SLACK * err_plain).max())
    assert bool((tn.row_error(lse, plain_lse.double()) <= 1e-6).all())
    total, count = tn.token_nll(logits, target, ignore_index)
    want = ref.sum()
    if torch.isnan(want):
        assert torch.isnan(total)
    else:
        assert abs(float(total) - float(want)) <= 1e-6 * max(abs(float(want)), 1.0)
    assert float(count) == float(tn.token_nll_plain(logits, target, ignore_index)[1])


@pytest.mark.parametrize(
    ("b", "s", "v", "dtype", "ignore"),
    [
        (2, 16, 50257, torch.bfloat16, None),  # GPT-2: a bf16 row of 100,514 bytes, rows not 16-byte aligned
        (2, 8, 32000, torch.float16, -100),  # Llama 2
        (1, 4, 128256, torch.float32, None),  # Llama 3
        (3, 5, 1, torch.float16, None),  # one class: every NLL 0
        (3, 7, 37, torch.float32, 5),  # ragged B x S, a class ignored
        (2, 3, 4103, torch.bfloat16, None),  # odd V: a scalar head and tail around the body
    ],
)
def test_token_nll_kernel_holds_its_contract(cuda, b, s, v, dtype, ignore):
    from tpumetrics_torch.ops import token_nll as tn

    logits, target = _nll_case(b, s, v, dtype, seed=v, ignore=ignore)
    n0 = tn.launches
    _hold_nll_contract(tn, logits, target, ignore)
    assert tn.launches > n0


def test_token_nll_reads_strided_rows_and_copies_other_layouts(cuda):
    from tpumetrics_torch.ops import token_nll as tn

    logits, target = _nll_case(2, 9, 50257, torch.bfloat16, seed=1)
    shifted, shifted_target = logits[:, :-1], target[:, 1:]
    assert not shifted.is_contiguous() and shifted.stride(2) == 1
    _hold_nll_contract(tn, shifted, shifted_target, None)
    transposed = logits.transpose(1, 2).contiguous().transpose(1, 2)  # the V axis strided
    with pytest.warns(UserWarning, match="contiguous"):
        got, _ = tn.token_nll_rows(transposed, target)
    assert torch.equal(got, tn.token_nll_rows(logits, target)[0])


@pytest.mark.parametrize(("targets", "ignore_index"), [([5, -1, -5, 0], None), ([-100, 1, -6, 2], None),
                                                       ([-100, -100, -100, -100], -100)])
def test_token_nll_out_of_range_wrapped_and_ignored_targets(cuda, targets, ignore_index):
    from tpumetrics_torch.ops import token_nll as tn

    logits, _ = _nll_case(1, 4, 5, torch.float32, seed=2)
    target = torch.tensor([targets], device="cuda")
    _hold_nll_contract(tn, logits, target, ignore_index)
    got, _ = tn.token_nll_rows(logits, target, ignore_index)
    plain, _ = tn.token_nll_rows_plain(logits, target, ignore_index)
    assert torch.equal(got.isnan(), plain.isnan())
    if ignore_index is not None:
        assert float(tn.token_nll(logits, target, ignore_index)[1]) == 0.0 and float(got.abs().sum()) == 0.0


def test_token_nll_non_finite_logits_as_the_plain_version(cuda):
    from tpumetrics_torch.ops import token_nll as tn

    logits, target = _nll_case(1, 4, 4103, torch.float32, seed=4)
    logits[0, 0, 7] = float("nan")
    logits[0, 1, 9] = float("inf")
    logits[0, 2] = float("-inf")
    got, _ = tn.token_nll_rows(logits, target)
    plain, _ = tn.token_nll_rows_plain(logits, target)
    assert torch.equal(got.isnan(), plain.isnan()) and bool(got[:3].isnan().all())
    assert torch.isfinite(got[3])


def test_token_nll_is_deterministic_and_replays_bit_for_bit(cuda):
    from tpumetrics_torch.ops import token_nll as tn

    logits, target = _nll_case(4, 64, 50257, torch.bfloat16, seed=5, ignore=-100)
    first = tn.token_nll(logits, target, -100)
    second = tn.token_nll(logits, target, -100)
    assert all(torch.equal(a, b) for a, b in zip(first, second))
    graph = torch.cuda.CUDAGraph()
    captured0 = tn.captured
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        tn.token_nll(logits, target, -100)  # warm on the side stream
        torch.cuda.synchronize()
        with torch.cuda.graph(graph):
            out = tn.token_nll(logits, target, -100)
    torch.cuda.current_stream().wait_stream(stream)
    assert tn.captured == captured0 + 1
    for _ in range(3):
        graph.replay()
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(out, first))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_token_nll_backward_matches_the_plain_autograd_gradient(cuda, dtype):
    from tpumetrics_torch.ops import token_nll as tn

    logits, target = _nll_case(2, 8, 4103, dtype, seed=6, ignore=-100)
    x = logits.clone().requires_grad_(True)
    y = logits.clone().requires_grad_(True)
    (3.0 * tn.token_nll(x, target, -100)[0]).backward()
    (3.0 * tn.token_nll_plain(y, target, -100)[0]).backward()
    assert x.grad.dtype == dtype
    tol = 1e-6 if dtype == torch.float32 else 8e-3  # the gradient rounded to bf16 on both sides
    torch.testing.assert_close(x.grad.float(), y.grad.float(), atol=tol, rtol=0)


def test_perplexity_on_the_card_and_replayed_matches_the_cpu(cuda):
    from tpumetrics_torch.ops import token_nll as tn
    from tpumetrics_torch.text import Perplexity

    col = MetricCollection({"ppl": Perplexity(ignore_index=-100, device="cuda")}, fused_update=True, device="cuda")
    ref = Perplexity(ignore_index=-100, device="cpu")
    calls = tn.launches
    for seed in range(5):
        logits, target = _nll_case(2, 32, 32000, torch.bfloat16, seed=10 + seed, ignore=-100)
        if seed == 4:
            torch.cuda.set_sync_debug_mode("error")
            try:
                col.update(logits, target)
            finally:
                torch.cuda.set_sync_debug_mode(0)
        else:
            col.update(logits, target)
        ref.update(logits.cpu(), target.cpu())
    step = col._fused_oo_step
    assert step.counts["replayed"] >= 2
    assert step.kernel_launches()["token_nll"] == step.counts["captured"] + step.counts["replayed"]
    assert tn.launches - calls == 1 + step.counts["eager"]  # the first update, which forms the groups, is eager
    got, want = col["ppl"], ref
    assert float(got.count) == float(want.count)
    assert abs(float(got.total_log_probs) - float(want.total_log_probs)) <= 1e-6 * float(want.total_log_probs)
