"""The port on a CUDA card: the kernel against its plain version, and the
main-path collection on the card against the same stream on the CPU.

Every test here needs a card and skips without one. The machine with the
card has no JAX, and ``tests/conftest.py`` imports JAX, so this file imports
neither and runs there without the conftest::

    python -m pytest tests/test_torch_cuda.py --noconftest -q
"""

import numpy as np
import pytest
import torch

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
