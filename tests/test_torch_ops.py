"""The port's binned-confusion kernel module and its CPU paths, held against
the JAX package.

On the CPU the wrapper runs the plain version, which must equal the JAX
Pallas kernel run in interpret mode bit for bit (all counts are integers).
The CUDA kernel itself runs only on a card, where JAX is not installed: its
tests are in ``tests/test_torch_cuda.py``.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpumetrics.ops import binned_confusion_fused as jax_binned_confusion_fused
from tpumetrics_torch.ops import binned_confusion as bc
from tpumetrics_torch.utils.data import _bincount

# the module (the package's ``__init__`` binds the name to the task dispatcher)
prc = importlib.import_module("tpumetrics_torch.functional.classification.precision_recall_curve")

# the JAX package's classification namespace re-exports a function of the same name
jax_prc = importlib.import_module("tpumetrics.functional.classification.precision_recall_curve")


def _inputs(case, seed=42):
    """(preds, y, v, thresholds) as float32 numpy arrays, for the named case."""
    kind, (n, c, t) = case
    rng = np.random.default_rng(seed)
    preds = rng.random((n, c)).astype(np.float32)
    bits = rng.integers(0, 2, (n, c)).astype(np.float32)
    valid = rng.integers(0, 2, (n, c)).astype(np.float32)
    thr = np.sort(rng.random(t).astype(np.float32))
    # exact ties at thresholds exercise the >= semantics
    preds[: min(n, t), 0] = thr[: min(n, t)]
    if kind == "nan_inf":
        preds[1::7, -1] = np.nan
        preds[2::7, 0] = np.inf
        preds[3::7, 0] = -np.inf
        thr = np.concatenate([thr, np.asarray([-np.inf, np.inf], np.float32)])
    if kind == "unsorted_dup":
        thr = rng.permutation(np.concatenate([thr, thr[: t // 2]])).astype(np.float32)
    return preds, bits * valid, valid, thr


CASES = [
    ("plain", (257, 5, 13)),
    ("plain", (64, 1, 3)),
    ("plain", (130, 4, 129)),
    ("nan_inf", (97, 6, 11)),
    ("unsorted_dup", (120, 3, 17)),
    ("plain", (300, 1, 40)),
]


@pytest.mark.parametrize("case", CASES, ids=[f"{k}-{n}x{c}x{t}" for k, (n, c, t) in CASES])
def test_plain_matches_jax_kernel_in_interpret_mode(case):
    preds, y, v, thr = _inputs(case)
    jtp, jpp = jax_binned_confusion_fused(*(jnp.asarray(x) for x in (preds, y, v, thr)), interpret=True)
    plain_tp, plain_pp = bc.binned_confusion_plain(*(torch.from_numpy(x) for x in (preds, y, v, thr)))
    np.testing.assert_array_equal(plain_tp.numpy(), np.asarray(jtp))
    np.testing.assert_array_equal(plain_pp.numpy(), np.asarray(jpp))
    tp, pp = bc.binned_confusion_fused(*(torch.from_numpy(x) for x in (preds, y, v, thr)))
    assert tp.dtype == pp.dtype == torch.float32
    assert tuple(tp.shape) == (thr.shape[0], preds.shape[1])
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jtp))
    np.testing.assert_array_equal(pp.numpy(), np.asarray(jpp))
    counts_tp, counts_pp = bc.binned_confusion_counts(*(torch.from_numpy(x) for x in (preds, y, v, thr)))
    assert counts_tp.dtype == counts_pp.dtype == torch.int32
    np.testing.assert_array_equal(counts_tp.numpy(), np.asarray(jtp).astype(np.int32))
    np.testing.assert_array_equal(counts_pp.numpy(), np.asarray(jpp).astype(np.int32))


def test_nan_preds_fall_below_every_threshold():
    preds = torch.tensor([[0.2], [float("nan")], [0.8]])
    y = torch.tensor([[1.0], [1.0], [0.0]])
    tp, pp = bc.binned_confusion_fused(preds, y, torch.ones(3, 1), torch.tensor([0.5]))
    assert float(tp[0, 0]) == 0.0 and float(pp[0, 0]) == 1.0


@pytest.mark.parametrize(
    "mutate, err",
    [
        (lambda p, y, v, t: (p.double(), y, v, t), TypeError),
        (lambda p, y, v, t: (p, y[:-1], v, t), ValueError),
        (lambda p, y, v, t: (p.T.contiguous().T, y, v, t), ValueError),
        (lambda p, y, v, t: (p, y, v, t[None]), ValueError),
        (lambda p, y, v, t: (p, y, v, t.to(torch.float16)), TypeError),
    ],
    ids=["float64", "shape", "strided", "thresholds-2d", "thresholds-f16"],
)
def test_wrapper_refuses_what_the_kernel_does_not_take(mutate, err):
    preds, y, v, thr = (torch.from_numpy(x) for x in _inputs(("plain", (16, 3, 4))))
    with pytest.raises(err):
        bc.binned_confusion_counts(*mutate(preds, y, v, thr))


def _confusion_case(seed, n, c, t, with_invalid, squeeze):
    rng = np.random.default_rng(seed)
    preds = rng.random((n, c)).astype(np.float32)
    preds[::9, 0] = np.nan
    bits = rng.integers(0, 2, (n, c)).astype(np.int32)
    thr = rng.random(t).astype(np.float32)
    thr[::5] = thr[0]  # duplicates, unsorted
    preds[1 : 1 + t, -1] = thr  # ties
    invalid = rng.random((n, c)) < 0.3 if with_invalid else None
    if squeeze:
        preds, bits = preds[:, 0], bits[:, 0]
        invalid = invalid[:, 0] if invalid is not None else None
    return preds, bits, thr, invalid


@pytest.mark.parametrize("branch", ["contract", "hist"])
@pytest.mark.parametrize("with_invalid", [False, True], ids=["all-valid", "masked"])
@pytest.mark.parametrize("squeeze", [False, True], ids=["2d", "1d"])
def test_cpu_branches_match_jax_binned_confusion_tensor(branch, with_invalid, squeeze):
    preds, bits, thr, invalid = _confusion_case(3, 211, 7, 23, with_invalid, squeeze)
    ref = jax_prc._binned_confusion_tensor(
        jnp.asarray(preds), jnp.asarray(bits), jnp.asarray(thr), None if invalid is None else jnp.asarray(invalid)
    )
    ref_hist = jax_prc._binned_confusion_hist(
        *(jnp.asarray(x)[:, None] if squeeze else jnp.asarray(x) for x in (preds, bits)),
        jnp.asarray(thr),
        None if invalid is None else (jnp.asarray(invalid)[:, None] if squeeze else jnp.asarray(invalid)),
    )
    p, b, th = torch.from_numpy(preds), torch.from_numpy(bits), torch.from_numpy(thr)
    inv = None if invalid is None else torch.from_numpy(invalid)
    if squeeze:
        p, b = p[:, None], b[:, None]
        inv = None if inv is None else inv[:, None]
    fn = prc._binned_confusion_contract if branch == "contract" else prc._binned_confusion_hist
    out = fn(p, b, th, inv)
    assert out.dtype == torch.int32
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref_hist))
    np.testing.assert_array_equal((out[:, 0] if squeeze else out).numpy(), np.asarray(ref))


def test_cpu_dispatch_takes_the_jax_branch(monkeypatch):
    """Below the JAX package's size gate the CPU path contracts, above it histograms."""
    taken = []
    monkeypatch.setattr(prc, "_binned_confusion_contract", lambda *a: taken.append("contract") or a[0])
    monkeypatch.setattr(prc, "_binned_confusion_hist", lambda *a: taken.append("hist") or a[0])
    prc._binned_confusion_tensor(torch.rand(64, 4), torch.zeros(64, 4), torch.rand(8))
    prc._binned_confusion_tensor(torch.rand(1 << 12, 1 << 7), torch.zeros(1 << 12, 1 << 7), torch.rand(1 << 8))
    assert taken == ["contract", "hist"]


def test_contract_counts_stay_exact_under_bf16_autocast():
    """Counts above 256 are not representable in bf16: the count path turns autocast off."""
    preds, bits, thr, invalid = _confusion_case(5, 2000, 3, 9, True, False)
    args = (torch.from_numpy(preds), torch.from_numpy(bits), torch.from_numpy(thr), torch.from_numpy(invalid))
    expected = prc._binned_confusion_contract(*args)
    assert int(expected.max()) > 256
    with torch.autocast(device_type="cpu", dtype=torch.bfloat16):
        got = prc._binned_confusion_contract(*args)
    assert torch.equal(got, expected)


@pytest.mark.parametrize("t", [2, 3, 5, 13, 64, 100, 129, 200, 1000, 4096])
def test_threshold_grid_is_bit_equal_to_jnp_linspace(t):
    grid = prc._adjust_threshold_arg(t)
    assert grid.dtype == torch.float32
    np.testing.assert_array_equal(grid.numpy().view(np.int32), np.asarray(jnp.linspace(0, 1, t)).view(np.int32))


def test_threshold_list_and_tensor_match_jax():
    values = [0.0, 0.1, 0.3333333333, 0.7, 1.0]
    np.testing.assert_array_equal(
        prc._adjust_threshold_arg(values).numpy(), np.asarray(jax_prc._adjust_threshold_arg(values))
    )
    as_f64 = torch.tensor(values, dtype=torch.float64)
    assert prc._adjust_threshold_arg(as_f64).dtype == torch.float32


def test_bincount_drops_negative_and_out_of_range_values():
    x = torch.tensor([-3, -1, 0, 0, 2, 4, 5, 9, 4])
    out = _bincount(x, minlength=5)
    assert out.dtype == torch.int32
    assert out.tolist() == [2, 0, 1, 0, 2]
    assert _bincount(torch.tensor([1, 1, 3]), minlength=None).tolist() == [0, 2, 0, 1]
