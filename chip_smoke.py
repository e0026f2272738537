#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``tpumetrics_torch``) on one CUDA card.

Run from the repository root, on a machine with an NVIDIA card and ``nvcc``::

    python3 chip_smoke.py

Phases, each of which passes or exits non-zero:

1. the card's name and power limit;
2. build every CUDA kernel of the port from ``tpumetrics_torch/csrc``;
3. kernel phase: ``binned_confusion`` against its plain torch version on
   the same inputs, exact, at the shapes of every path below and at edge
   cases (contended narrow C, T=1, unsorted and duplicate thresholds with
   +-inf, NaN, -0.0 and 0.0, more thresholds than shared memory holds,
   C=8193), with the kernel's time (on the device, between CUDA events, the
   L2 flushed before each call) and the host's time to make the call, the
   plain version's time, the time of the torch-ops histogram path as a
   yardstick, and the bound, at the main-path, headline, binary and
   multilabel shapes;
4. slice phase: an ImageNet-1k validation-sized evaluation (50,000 samples,
   1000 classes, batches of 8192 and a ragged 848) through a classification
   report, ``MetricCollection({acc, f1, precision, recall, specificity,
   auroc(T=200), ap(T=200), recall@precision(T=200),
   specificity@sensitivity(T=200), confmat, jaccard, mcc, kappa, hinge,
   calibration error (15 bins, l1)})``, on the card, held against the same
   stream on the CPU (identical int32 and list states, float sums within
   1e-6 relative, values within 1e-6), against numpy counts and, for the
   report's values, against a float64 numpy oracle (the calibration error
   within 1e-5), with one steady update run with host syncs made errors;
   its compute groups must be the five of the accuracy, AP,
   confusion-matrix, calibration and hinge leaders, and the kernel's
   launches are counted per update. The bench headline shape (N=8192,
   C=128, T=64, 5 batches; acc, f1 and auroc) runs the same way;
5. task phase: a binary stream (1,000,000 samples, batches of 65,536 and a
   ragged 16,960: a CTR or fraud classifier's eval shard) through
   ``Accuracy``, ``F1Score``, ``Precision``, ``Recall``, ``Specificity``,
   ``MatthewsCorrCoef``, ``CohenKappa``, binned and exact ``AUROC``,
   binned ``RecallAtFixedPrecision`` and ``SpecificityAtSensitivity``,
   ``HingeLoss`` and ``CalibrationError`` with ``task="binary"``, and a
   multilabel stream at MS-COCO 2014 val size (40,504 images x 80 labels,
   batches of 4096 and a ragged 3640, about 1% of the targets ignored)
   through ``Accuracy``, macro ``F1Score``, ``Precision``, ``Recall`` and
   ``HammingDistance``, ``ExactMatch``, ``JaccardIndex``, binned ``AUROC``,
   binned ``PrecisionAtFixedRecall`` and ``SpecificityAtSensitivity`` with
   ``task="multilabel"``, and the coverage error, label ranking average
   precision and label ranking loss. Each runs on the card and on the CPU:
   identical states (the list states included), binned counts equal to
   numpy's, exact AUROC against a float64 rank statistic, the new values
   against a float64 numpy oracle, one steady update run with host syncs
   made errors, and the kernel's launches counted. Beside the binary
   stream, a fairness audit of the same 1M samples in five groups of
   unequal shares (``BinaryFairness`` and ``BinaryGroupStatRates``, updated
   with ``(preds, target, groups)``): per-group counts equal to numpy's and
   the CPU's, and the histogram's device time;
5b. segmentation phase, at Cityscapes val geometry (19 classes, 2 x 1024 x
   2048 logits per batch, about 10% void pixels labelled 255, 50 batches
   made on the card from the seed one at a time: 100 of the 500 val
   images): mIoU (``MulticlassJaccardIndex``), pixel accuracy and macro
   ``Dice``; the first 4 batches held against the CPU (identical states),
   the whole stream against numpy (the int64 confusion matrix, Dice's
   counts accumulated in float32 per batch);
6. sync phase: the ImageNet-size stream again, through the collection of
   the slice phase with a ``MeanMetric`` and a ``CatMetric`` of per-batch
   values added, its ``compute()`` synced over a real NCCL process group of
   world size 1 (one card) through ``MetricCollection``'s fused sync:
   values and synced states bit for bit equal to the unsynced ones, every
   state back to its own tensor after ``compute()``, the collectives of one
   ``compute()`` (one ``all_reduce`` per (op, dtype) class of the group
   leaders' states, two gathers per list state) counted by a wrapper around
   the backend and in ``torch.profiler``, the binned update free of host
   syncs, and the sync's host-clock time per ``compute()``;
7. fused phase, at the end of each of the seven streams above: the stream's
   collection twice, ``fused_update=False`` and ``True`` (CUDA graphs), fed
   update by update in turns: states bit for bit and ``compute()`` values
   equal after every update, the updates of each mode counted (a key's
   first sighting eager, its capture, its replays; the synced stream's
   tensor kwarg keeps every update eager), one replay with host syncs made
   errors, 15 steady updates of each timed on the host clock in turns, one
   of each under ``torch.profiler`` (device union), the capture time, and
   the kernel's launches (eager calls plus each graph's replays times the
   calls it captured) equal to the unfused run's.

The line before the last is the kernel report (JSON); the last line is
``{"ok": true, "device": {...}}``. Without a card, or without the port's
package beside this file, it exits non-zero and prints no result.
"""

from __future__ import annotations

import gc
import json
import math
import os
import subprocess
import sys
import time
import warnings

import numpy as np

H100_BYTES_PER_S = 3.35e12  # HBM3, H100 SXM data sheet
H100_FP32_OPS_PER_S = 67e12  # fp32 outside the tensor cores, H100 SXM data sheet
SEED = 0


def fail(msg: str) -> None:
    print(f"chip_smoke FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def cuda_ms(torch, fn, reps: int, ahead) -> tuple:
    """Median milliseconds of ``fn()`` over ``reps`` calls after 3 warm ones,
    each between its own pair of CUDA events, and the median host time of the
    call itself (from the call to its return; nothing is synchronised).
    ``ahead()`` runs before each call, outside the events: device work that
    evicts the L2 and outlasts the host's time to queue ``fn()``, so the
    device reaches the first event with the call already queued. The time
    between the events is then the device's: the host's launch cost is left
    out of it, and is the second number."""
    for _ in range(3):
        fn()
    times, host = [], []
    for _ in range(reps):
        ahead()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        t0 = time.perf_counter()
        fn()
        host.append((time.perf_counter() - t0) * 1e3)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times)), float(np.median(host))


def l2_flush(torch):
    """``ahead`` for ``cuda_ms``: one pass over 512 MB (ten times the L2), about
    0.37 ms of device time on an H100, in a kernel (``bitwise_not``) that no wrapper timed
    here launches, so a trace can leave it out by name."""
    buf = torch.empty(512 << 20, dtype=torch.uint8, device="cuda")
    return lambda: buf.bitwise_not_()


def binned_bound(n: int, c: int, t: int) -> dict:
    """Least time for ``binned_confusion`` on an H100 SXM: the inputs read once
    (preds, y, v as float32, the thresholds) and the two int32 outputs written
    once, over the memory rate; against the operations the function needs, at
    the fp32 rate outside the tensor cores. Those are not this kernel's N*C*T
    comparisons: with the thresholds sorted once, each pred finds its bucket in
    ceil(log2(T + 1)) comparisons and adds its y and v bits there (2 adds), and
    a suffix sum over the T buckets of each class (2*T*C adds) gives the
    counts."""
    nbytes = 3 * n * c * 4 + t * 4 + 2 * t * c * 4
    ops = n * c * (math.ceil(math.log2(t + 1)) + 2) + 2 * t * c
    bytes_ms = nbytes / H100_BYTES_PER_S * 1e3
    ops_ms = ops / H100_FP32_OPS_PER_S * 1e3
    return {
        "bytes": nbytes, "ops": ops, "bytes_ms": bytes_ms, "ops_ms": ops_ms,
        "bound_ms": max(bytes_ms, ops_ms), "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
    }


def kernel_phase(torch, bc) -> dict:
    """Kernel against plain version, exact, at every listed shape; times at the two large ones."""
    from tpumetrics_torch.functional.classification.precision_recall_curve import _binned_confusion_hist

    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED)

    def inputs(n, c, t, ties=False, special=False, unsorted=False, edge_thr=False, one_bucket=False):
        preds = rng.random((n, c), dtype=np.float32)
        bits = rng.integers(0, 2, (n, c)).astype(np.float32)
        valid = (rng.random((n, c)) < 0.9).astype(np.float32)
        thr = np.linspace(0, 1, t, dtype=np.float32) if t > 1 else np.asarray([0.5], np.float32)
        if unsorted:
            thr = rng.permutation(np.concatenate([thr, thr[: t // 2]])).astype(np.float32)
        if ties:
            k = min(n, thr.shape[0])
            preds[:k, 0] = thr[:k]
            preds[k : 2 * k, -1] = thr[:k][: max(0, min(k, n - k))]
        if special:
            thr = np.concatenate([thr, np.asarray([-np.inf, np.inf, 0.0, 1.0], np.float32)])
            flat = preds.reshape(-1)
            idx = rng.choice(flat.size, size=min(flat.size, 64), replace=False)
            flat[idx[0::3]] = np.nan
            flat[idx[1::3]] = np.inf
            flat[idx[2::3]] = -np.inf
        if edge_thr:
            odd = [np.nan, np.inf, -np.inf, -0.0, 0.0, 0.5, 0.5, np.nan, -0.0, 1.0]
            thr = rng.permutation(np.concatenate([thr, np.asarray(odd, np.float32)])).astype(np.float32)
            flat = preds.reshape(-1)
            idx = rng.choice(flat.size, size=min(flat.size, 600), replace=False)
            for j, val in enumerate([0.0, -0.0, 0.5, 1.0, np.nan, np.inf]):
                flat[idx[j::6]] = val
        if one_bucket:
            preds[:] = np.float32(0.999)
        return [torch.from_numpy(x).to(dev) for x in (preds, bits * valid, valid, thr)]

    cases = [
        ("headline (bench) 8192x128x64", (8192, 128, 64), {}),
        ("main path 8192x1000x200", (8192, 1000, 200), {}),
        ("ragged last batch 848x1000x200", (848, 1000, 200), {}),
        ("test_ops 257x5x13", (257, 5, 13), {"ties": True}),
        ("test_ops 64x1x3", (64, 1, 3), {"ties": True}),
        ("test_ops 130x4x129", (130, 4, 129), {"ties": True}),
        ("micro path 8192000x1x200", (8192 * 1000, 1, 200), {}),
        ("wider than the TPU kernel 256x8193x64", (256, 8193, 64), {}),
        ("T=1 1000x37x1", (1000, 37, 1), {}),
        ("ties 4096x33x200", (4096, 33, 200), {"ties": True}),
        ("NaN and +-inf preds 2048x130x64", (2048, 130, 64), {"special": True}),
        ("unsorted duplicate thresholds 3000x70x100", (3000, 70, 100), {"unsorted": True}),
        ("contended micro path 1048576x1x200", (1 << 20, 1, 200), {}),
        ("every pred in one bucket 200000x3x200", (200000, 3, 200), {"one_bucket": True}),
        ("+-inf, NaN, -0.0 and 0.0 thresholds 2048x130x64", (2048, 130, 64), {"edge_thr": True}),
        ("bucket ranges 8192x128x4096", (8192, 128, 4096), {}),
        ("histogram beyond shared memory 512x3x30000, unsorted with duplicates", (512, 3, 30000), {"unsorted": True}),
        ("binary stream 65536x1x200", (65536, 1, 200), {}),
        ("multilabel stream 4096x80x200", (4096, 80, 200), {}),
    ]
    max_err = 0.0
    timed = {}
    for label, (n, c, t), kw in cases:
        preds, y, v, thr = inputs(n, c, t, **kw)
        tp, pp = bc.binned_confusion_fused(preds, y, v, thr)
        torch.cuda.synchronize()
        ref_tp, ref_pp = bc.binned_confusion_plain(preds, y, v, thr)
        err = max(float((tp - ref_tp).abs().max()), float((pp - ref_pp).abs().max()))
        max_err = max(max_err, err)
        check(torch.equal(tp, ref_tp) and torch.equal(pp, ref_pp), f"kernel != plain version at {label} (err {err})")
        print(f"kernel phase: {label}: exact (T={thr.shape[0]})", flush=True)
        if label.startswith(("headline", "main path", "binary stream", "multilabel stream")):
            flush = l2_flush(torch)
            ms, host_ms = cuda_ms(torch, lambda: bc.binned_confusion_counts(preds, y, v, thr), reps=30, ahead=flush)
            plain_ms, _ = cuda_ms(torch, lambda: bc.binned_confusion_plain(preds, y, v, thr), reps=5, ahead=flush)
            # yardstick, not a port: the torch-ops histogram (argsort, searchsorted, bincount, cumsum)
            bits, invalid = y != 0, v == 0
            hist_ms, _ = cuda_ms(torch, lambda: _binned_confusion_hist(preds, bits, thr, invalid), reps=10, ahead=flush)
            bound = binned_bound(n, c, thr.shape[0])
            timed[label] = {
                "n": n, "c": c, "t": thr.shape[0], "ms": ms, "host_ms": host_ms, "plain_ms": plain_ms,
                "torch_ops_hist_ms": hist_ms, **bound,
            }
            print(
                f"kernel phase: {label}: kernel {ms:.4f} ms on the device ({ms / bound['bound_ms']:.2f}x its bound),"
                f" {host_ms:.4f} ms of host time to make the call; plain {plain_ms:.4f} ms,"
                f" torch-ops histogram {hist_ms:.4f} ms; bound {bound['bound_ms']:.4f} ms"
                f" by {bound['bound_by']} (bytes {bound['bytes']} -> {bound['bytes_ms']:.4f} ms at 3.35 TB/s;"
                f" ops {bound['ops']} -> {bound['ops_ms']:.4f} ms at 67 TFLOP/s fp32)",
                flush=True,
            )
            del flush, bits, invalid
        del preds, y, v, thr, tp, pp, ref_tp, ref_pp
        torch.cuda.empty_cache()
    return {"max_abs_err": max_err, "timed": timed}


def make_stream(n: int, c: int, batch: int, seed: int):
    """Probabilities (softmax of seeded logits, the true class boosted) and labels, in batches."""
    rng = np.random.default_rng(seed)
    target = rng.integers(0, c, size=n)
    logits = rng.standard_normal((n, c), dtype=np.float32) * 2.0
    logits[np.arange(n), target] += 7.0
    logits -= logits.max(axis=1, keepdims=True)
    probs = np.exp(logits.astype(np.float64))
    probs = (probs / probs.sum(axis=1, keepdims=True)).astype(np.float32)
    return [(probs[i : i + batch], target[i : i + batch]) for i in range(0, n, batch)]


def numpy_binned_counts(probs: np.ndarray, hit: np.ndarray, valid: np.ndarray, thresholds: np.ndarray) -> tuple:
    """``(tp, predpos)``, each ``(T, C)``: how many valid entries of column c
    have ``probs >= thresholds[t]``, among the hits and among all, in numpy."""
    n, c = probs.shape
    t = thresholds.shape[0]
    check(bool(np.all(np.diff(thresholds) > 0)), "numpy reference expects increasing thresholds")
    # probs[n, c] >= thr[k]  <=>  k < (number of thresholds <= probs[n, c])
    key = np.arange(c) * (t + 1) + np.searchsorted(thresholds, probs, side="right")

    def above(mask):  # entries with key > k per column: reverse cumulative sum over k
        hist = np.bincount(key[mask], minlength=c * (t + 1)).reshape(c, t + 1)
        return np.cumsum(hist[:, ::-1], axis=1)[:, ::-1][:, 1:].T

    return above(valid & hit), above(valid)


def numpy_reference(batches, c: int, thresholds: np.ndarray) -> dict:
    """Micro accuracy and the binned per-class tp / predicted-positive counts, in numpy."""
    probs = np.concatenate([b[0] for b in batches])
    target = np.concatenate([b[1] for b in batches])
    acc = float(np.mean(np.argmax(probs, axis=1) == target))
    hit = target[:, None] == np.arange(c)[None, :]
    tp, predpos = numpy_binned_counts(probs, hit, np.ones_like(hit), thresholds)
    confmat = np.bincount(target * c + np.argmax(probs, axis=1), minlength=c * c).reshape(c, c).astype(np.int32)
    return {"acc": acc, "tp": tp, "predpos": predpos, "confmat": confmat}


def multiclass_members(c: int, t: int, device, extra: bool) -> dict:
    """Micro accuracy, macro F1 and binned AUROC (BASELINE config #2's set);
    with ``extra``, a whole classification report: macro precision, recall
    and specificity (in F1's compute group), binned AP, recall at precision
    0.5 and specificity at sensitivity 0.5 (in AUROC's), the confusion matrix
    with the Jaccard index, MCC and Cohen's kappa (in its group), and the
    crammer-singer hinge loss and the 15-bin expected calibration error (the
    ImageNet calibration report of Guo et al. 2017), each a leader."""
    from tpumetrics_torch import classification as cls

    kw = {"validate_args": False, "device": device}
    out = {
        "acc": cls.MulticlassAccuracy(c, average="micro", **kw),
        "f1": cls.MulticlassF1Score(c, average="macro", **kw),
        "auroc": cls.MulticlassAUROC(c, thresholds=t, **kw),
    }
    if extra:
        out.update({
            "ap": cls.MulticlassAveragePrecision(c, thresholds=t, **kw),
            "confmat": cls.MulticlassConfusionMatrix(c, **kw),
            "precision": cls.MulticlassPrecision(c, average="macro", **kw),
            "recall": cls.MulticlassRecall(c, average="macro", **kw),
            "specificity": cls.MulticlassSpecificity(c, average="macro", **kw),
            "jaccard": cls.MulticlassJaccardIndex(c, **kw),
            "mcc": cls.MulticlassMatthewsCorrCoef(c, **kw),
            "kappa": cls.MulticlassCohenKappa(c, **kw),
            "rafp": cls.MulticlassRecallAtFixedPrecision(c, min_precision=0.5, thresholds=t, **kw),
            "sas": cls.MulticlassSpecificityAtSensitivity(c, min_sensitivity=0.5, thresholds=t, **kw),
            "hinge": cls.MulticlassHingeLoss(c, **kw),
            "ece": cls.MulticlassCalibrationError(c, n_bins=15, norm="l1", **kw),
        })
    return out


# The compute groups of the ImageNet-size collection: the three leaders of the
# report (acc, ap, confmat) with its other members inside, and two more: the
# calibration error (list states, eager beside the captured leaders) and the
# hinge loss.
IMAGENET_GROUPS = [
    ["acc", "f1", "precision", "recall", "specificity"],
    ["ap", "auroc", "rafp", "sas"],
    ["confmat", "jaccard", "kappa", "mcc"],
    ["ece"],
    ["hinge"],
]
# float64 numpy oracle tolerances of the new values: absolute for the
# float32 ratios and averages, relative (to max(1, |value|)) for MCC and
# kappa, whose float32 sums of squared counts lose low bits at these sizes,
# and for the coverage error, a count of labels; absolute 1e-5 for the
# calibration error, whose per-bin float32 sums run over up to a million
# confidences in another order than float64's
ORACLE_TOL = 1e-6
ORACLE_RTOL_MCC_KAPPA = 1e-5
ORACLE_TOL_ECE = 1e-5
RELATIVE_KEYS = {"mcc": ORACLE_RTOL_MCC_KAPPA, "kappa": ORACLE_RTOL_MCC_KAPPA, "coverage": ORACLE_TOL}


def sdiv(num, den):
    """num / den with 0 where den is 0, in float64."""
    num, den = np.asarray(num, np.float64), np.asarray(den, np.float64)
    return np.where(den == 0, 0.0, num / np.where(den == 0, 1.0, den))


def macro(score, tp, fp, fn, multilabel: bool) -> float:
    """The JAX package's macro average: classes with no tp, fp or fn weigh 0 (multiclass)."""
    w = np.ones_like(score) if multilabel else np.where(tp + fp + fn == 0, 0.0, 1.0)
    return float((w * score).sum() / w.sum())


def stat_oracle(tp, fp, tn, fn, multilabel: bool = False) -> dict:
    """Precision, recall, specificity and Hamming distance in float64 from
    int counts: per class and macro-averaged, or scalars for binary counts."""
    scores = {
        "precision": sdiv(tp, tp + fp),
        "recall": sdiv(tp, tp + fn),
        "specificity": sdiv(tn, tn + fp),
        "hamming": 1 - sdiv(tp + tn, tp + fp + tn + fn) if multilabel or np.ndim(tp) == 0 else 1 - sdiv(tp, tp + fn),
    }
    if np.ndim(tp) == 0:
        return {k: float(v) for k, v in scores.items()}
    return {k: macro(v, tp, fp, fn, multilabel) for k, v in scores.items()}


def confmat_oracle(cm) -> dict:
    """Macro Jaccard, MCC and unweighted Cohen's kappa of a (C, C) confusion matrix, in float64."""
    cm = np.asarray(cm, np.float64)
    diag, rows, cols, s = np.diag(cm), cm.sum(1), cm.sum(0), cm.sum()
    jaccard = sdiv(diag, rows + cols - diag)
    w = np.where(rows + cols == 0, 0.0, 1.0)
    mcc = (diag.sum() * s - rows @ cols) / np.sqrt((s * s - cols @ cols) * (s * s - rows @ rows))
    expected = np.outer(rows, cols) / s
    off = 1 - np.eye(cm.shape[0])
    kappa = 1 - (off * cm).sum() / (off * expected).sum()
    return {"jaccard": float((w * jaccard).sum() / w.sum()), "mcc": float(mcc), "kappa": float(kappa)}


def fixed_point_oracle(tp, predpos, npos, thresholds, min_value: float, primary: str):
    """Per class, the largest recall with precision >= ``min_value``
    (``primary="recall"``) or the largest precision with recall >=
    ``min_value``, and its threshold, ties to the larger other value, then
    the larger threshold; (0, 1e6) when nothing qualifies or the value is 0.
    From the numpy binned counts ``(T, C)`` in float64."""
    precision, recall = sdiv(tp, predpos), sdiv(tp, np.asarray(npos)[None, :])
    first, second = (recall, precision) if primary == "recall" else (precision, recall)
    constraint = precision if primary == "recall" else recall
    values, best = [], []
    for col in range(tp.shape[1]):
        ok = constraint[:, col] >= min_value
        if not ok.any():
            values.append(0.0)
            best.append(1e6)
            continue
        top = first[ok, col].max()
        ok &= first[:, col] == top
        ok &= second[:, col] == second[ok, col].max()
        values.append(float(top))
        best.append(1e6 if top == 0 else float(thresholds[ok].max()))
    return np.asarray(values), np.asarray(best)


def check_oracle(label: str, values: dict, oracle: dict) -> float:
    """Every value with an oracle entry against it; returns the worst
    difference (relative for MCC, kappa and the coverage error). A
    fixed-point value is checked with its threshold, which must be equal.
    The calibration error's difference is kept apart (``ece_err``)."""
    worst = 0.0
    for key, want in oracle.items():
        got = values[key]
        if isinstance(want, tuple):
            val, thr = (np.asarray(x.cpu(), np.float64).reshape(-1) for x in got)
            check(np.array_equal(thr, np.asarray(want[1], np.float64).reshape(-1)),
                  f"{label}: {key} thresholds {thr} vs float64 oracle {want[1]}")
            diff = float(np.max(np.abs(val - np.asarray(want[0]).reshape(-1))))
            tol = ORACLE_TOL
        else:
            scale = max(1.0, abs(want)) if key in RELATIVE_KEYS else 1.0
            diff = abs(float(got) - want) / scale
            tol = RELATIVE_KEYS.get(key, ORACLE_TOL_ECE if key == "ece" else ORACLE_TOL)
        check(diff <= tol, f"{label}: {key} = {got} vs float64 oracle {want} (diff {diff}, tolerance {tol})")
        if key == "ece":
            ECE_ERR[label] = diff
        else:
            worst = max(worst, diff)
    return worst


# the calibration error's worst difference from its float64 oracle, by stream
ECE_ERR: dict = {}


def hinge_oracle(probs: np.ndarray, target: np.ndarray) -> float:
    """Mean hinge loss in float64: binary (``probs`` 1-D: the margin is the
    pred, negated for negatives) or crammer-singer (the true class's score
    less the best other one)."""
    p = probs.astype(np.float64)
    if p.ndim == 1:
        margin = np.where(target == 1, p, -p)
    else:
        rows = np.arange(p.shape[0])
        true = p[rows, target]
        p[rows, target] = -np.inf
        margin = true - p.max(axis=1)
    return float(np.mean(np.maximum(1.0 - margin, 0.0)))


def ece_oracle(conf: np.ndarray, acc: np.ndarray, n_bins: int = 15) -> float:
    """Expected calibration error (l1) in float64 over float32 confidences:
    the edges are the float32 grid ``arange(n_bins + 1) * (1 / n_bins)`` with
    the last set to 1 (``jnp.linspace``'s rounding), a confidence falls in
    the bin of the inner edges at or below it."""
    edges = np.arange(n_bins + 1, dtype=np.float32) * (np.float32(1) / np.float32(n_bins))
    edges[-1] = 1.0
    idx = np.clip(np.searchsorted(edges[1:-1], conf.astype(np.float32), side="right"), 0, n_bins - 1)
    count = np.bincount(idx, minlength=n_bins).astype(np.float64)
    conf_bin = sdiv(np.bincount(idx, weights=conf.astype(np.float64), minlength=n_bins), count)
    acc_bin = sdiv(np.bincount(idx, weights=acc.astype(np.float64), minlength=n_bins), count)
    return float(np.sum(np.abs(acc_bin - conf_bin) * count / count.sum()))


def sas_oracle(tp, predpos, npos, nneg, thresholds, min_sensitivity: float):
    """Per class, the largest specificity with sensitivity >= the minimum,
    the first of ties in decreasing threshold order, and its threshold; (0,
    1e6) where no point qualifies. From the numpy binned counts ``(T, C)``
    of increasing ``thresholds``, in float64."""
    tp, predpos = tp[::-1].astype(np.float64), predpos[::-1].astype(np.float64)
    tpr = sdiv(tp, np.asarray(npos)[None, :])
    spec = 1.0 - sdiv(predpos - tp, np.asarray(nneg)[None, :])
    thr = thresholds[::-1]
    values, best = [], []
    for col in range(tp.shape[1]):
        ok = tpr[:, col] >= min_sensitivity
        if not ok.any():
            values.append(0.0)
            best.append(1e6)
            continue
        idx = int(np.argmax(np.where(ok, spec[:, col], -np.inf)))
        values.append(float(spec[idx, col]))
        best.append(float(thr[idx]))
    return np.asarray(values), np.asarray(best)


def ranking_oracle(probs: np.ndarray, target: np.ndarray, valid: np.ndarray) -> dict:
    """Coverage error, label ranking average precision and label ranking
    loss in float64, by their definitions, with an ignored entry ranked below
    every pred and never relevant: coverage is how many labels score at least
    the lowest of the relevant and ignored ones; a relevant label's precision
    is its rank among the relevant over its rank among all ('max' ranks for
    ties; rows with no or every label relevant score 1); the loss is the
    share of (relevant, other) pairs where the other label comes later in a
    stable ascending sort (higher pred, or a tie at a higher index)."""
    n, labels = probs.shape
    p = np.where(valid, probs.astype(np.float64), -4.0 * labels)
    rel = (target == 1) & valid
    cov = lrap = lrl = 0.0
    idx = np.arange(labels)
    for lo in range(0, n, 4096):
        pc, rc, zc = p[lo : lo + 4096], rel[lo : lo + 4096], ((target == 0) & valid)[lo : lo + 4096]
        depth = np.where(zc, pc + 10.0 * labels, pc).min(axis=1)
        cov += float((pc >= depth[:, None]).sum())
        ge = pc[:, None, :] >= pc[:, :, None]  # [n, i, j]: p_j >= p_i
        nrel = rc.sum(axis=1)
        ratio = (ge & rc[:, None, :]).sum(-1) / ge.sum(-1)
        per = np.where(rc, ratio, 0.0).sum(axis=1) / np.maximum(nrel, 1)
        some = (nrel > 0) & (nrel < labels)
        lrap += float(np.where(some, per, 1.0).sum())
        later = (pc[:, None, :] > pc[:, :, None]) | ((pc[:, None, :] == pc[:, :, None]) & (idx[None, :] > idx[:, None]))
        wrong = (later & rc[:, :, None] & ~rc[:, None, :]).sum(axis=(1, 2))
        lrl += float(np.where(some, wrong / np.maximum(nrel * (labels - nrel), 1), 0.0).sum())
    return {"coverage": cov / n, "lrap": lrap / n, "lrl": lrl / n}


def flat_values(values: dict) -> dict:
    """``compute()`` values with each fixed-point (value, threshold) pair as two entries."""
    out = {}
    for key, val in values.items():
        if isinstance(val, tuple):
            out.update({f"{key}[{i}]": v for i, v in enumerate(val)})
        else:
            out[key] = val
    return out


def slice_phase(torch, bc, label: str, n: int, c: int, t: int, batch: int, extra: bool = False) -> dict:
    """Stream through the collection on the card and on the CPU; compare;
    then the fused phase of the same stream."""
    from tpumetrics_torch import MetricCollection
    from tpumetrics_torch.interop import export_state

    def collection(device, fused=False):
        return MetricCollection(multiclass_members(c, t, device, extra), fused_update=fused, device=device)

    batches = make_stream(n, c, batch, SEED)
    dev_batches = [(torch.from_numpy(p).cuda(), torch.from_numpy(y).cuda()) for p, y in batches]
    col = collection("cuda")
    torch.cuda.synchronize()

    bc.launches = 0  # count only the main path's launches
    update_ms, per_update = [], []
    for i, (preds, target) in enumerate(dev_batches):
        n0 = bc.launches
        t0 = time.perf_counter()
        if i == 1:  # a steady update (leaders only): a host sync in it raises
            torch.cuda.set_sync_debug_mode("error")
            try:
                col.update(preds, target)
            finally:
                torch.cuda.set_sync_debug_mode(0)
        else:
            col.update(preds, target)
        torch.cuda.synchronize()
        update_ms.append((time.perf_counter() - t0) * 1e3)
        per_update.append(bc.launches - n0)
    t0 = time.perf_counter()
    values = col.compute()
    torch.cuda.synchronize()
    compute_ms = (time.perf_counter() - t0) * 1e3
    launches = bc.launches

    groups = [list(g) for g in col.compute_groups.values()]
    want = IMAGENET_GROUPS if extra else [["acc", "f1"], ["auroc"]]
    check(groups == want, f"{label}: compute groups {groups}")
    leaders = [g[0] for g in groups]
    check(leaders == (["acc", "ap", "confmat", "ece", "hinge"] if extra else ["acc", "auroc"]), f"{label}: leaders {leaders}")
    # the first update runs every member: AP's, recall-at-precision's and specificity-at-sensitivity's own
    # launches beside AUROC's; all share AUROC's group, so a steady update launches the kernel once, as before
    first = 4 if extra else 1
    want_per_update = [first] + [1] * (len(batches) - 1)
    check(per_update == want_per_update, f"{label}: kernel launches per update {per_update}, expected {want_per_update}")

    cpu = collection("cpu")
    for preds, target in batches:
        cpu.update(torch.from_numpy(preds), torch.from_numpy(target))
    cpu_values = cpu.compute()

    gpu_state, cpu_state = export_state(col), export_state(cpu)
    check_same_states(label, gpu_state, cpu_state)
    check_same_values(torch, label, values, cpu_values)

    ref = numpy_reference(batches, c, col["auroc"].thresholds.cpu().numpy())
    check(abs(float(values["acc"]) - ref["acc"]) <= 1e-6, f"{label}: acc {float(values['acc'])} vs numpy {ref['acc']}")
    confmat = gpu_state["ap" if extra else "auroc"]["confmat"]
    check(np.array_equal(confmat[:, :, 1, 1], ref["tp"]), f"{label}: AUROC tp counts differ from numpy")
    check(
        np.array_equal(confmat[:, :, 0, 1] + confmat[:, :, 1, 1], ref["predpos"]),
        f"{label}: AUROC predicted-positive counts differ from numpy",
    )
    report = ""
    if extra:
        check(np.array_equal(gpu_state["confmat"]["confmat"], ref["confmat"]), f"{label}: confusion matrix != numpy")
        cm = ref["confmat"].astype(np.int64)
        tp = np.diag(cm)
        fp, fn = cm.sum(0) - tp, cm.sum(1) - tp
        oracle = {**stat_oracle(tp, fp, cm.sum() - tp - fp - fn, fn), **confmat_oracle(cm)}
        del oracle["hamming"]
        thresholds = col["auroc"].thresholds.cpu().numpy()
        oracle["rafp"] = fixed_point_oracle(ref["tp"], ref["predpos"], cm.sum(1), thresholds, 0.5, "recall")
        oracle["sas"] = sas_oracle(ref["tp"], ref["predpos"], cm.sum(1), cm.sum() - cm.sum(1), thresholds, 0.5)
        probs = np.concatenate([b[0] for b in batches])
        target = np.concatenate([b[1] for b in batches])
        oracle["hinge"] = hinge_oracle(probs, target)
        oracle["ece"] = ece_oracle(probs.max(axis=1), np.argmax(probs, axis=1) == target)
        worst = check_oracle(label, values, oracle)
        report = (
            f" precision {float(values['precision']):.6f} recall {float(values['recall']):.6f}"
            f" specificity {float(values['specificity']):.6f} jaccard {float(values['jaccard']):.6f}"
            f" mcc {float(values['mcc']):.6f} kappa {float(values['kappa']):.6f}"
            f" recall@precision0.5 mean {float(values['rafp'][0].mean()):.6f}"
            f" specificity@sensitivity0.5 mean {float(values['sas'][0].mean()):.6f}"
            f" hinge {float(values['hinge']):.6f} ece {float(values['ece']):.7f};"
            f" new values against a float64 numpy oracle: worst difference {worst:.3e}"
            f" (ece {ECE_ERR[label]:.3e}, tolerance {ORACLE_TOL_ECE})"
        )
    # the first update runs every metric and compares states: report it apart
    steady = update_ms[1:]
    ap = f" ap {float(values['ap']):.6f};{report}" if extra else ""
    print(
        f"slice phase: {label}: {len(batches)} batches, states identical to the CPU run and to numpy counts;"
        f" acc {float(values['acc']):.6f} f1 {float(values['f1']):.6f} auroc {float(values['auroc']):.6f}{ap};"
        f" first update {update_ms[0]:.3f} ms, later updates median {np.median(steady):.3f} ms"
        f" (min {min(steady):.3f}, max {max(steady):.3f}); compute {compute_ms:.3f} ms;"
        f" kernel launches {launches} ({per_update} per update); update 1 free of host syncs",
        flush=True,
    )
    profile_step(torch, col, dev_batches[0], label)
    del col
    fused = fused_pair(torch, bc, label, lambda f: collection("cuda", f), dev_batches)
    if extra:
        check(fused["groups"] == want, f"{label}: fused compute groups {fused['groups']}")
        check(fused["eager_leaders"] == ["ece"], f"{label}: eager leaders {fused['eager_leaders']}, expected ['ece']")
    return {"launches": launches, "update_ms": update_ms, "compute_ms": compute_ms, "fused": fused}


# float32 states that hold sums of integer counts (Dice's): bit for bit card vs CPU;
# other float32 states are sums of floats, which the card adds in another order
COUNT_STATES = ("tp", "fp", "fn")
STATE_RTOL = 1e-6


def check_same_states(label: str, gpu_state: dict, cpu_state: dict) -> None:
    """The card's states equal the CPU's: int32 tensor states and float32
    count states bit for bit, float32 sums (hinge, ranking) within 1e-6
    relative, and list states (the exact curve's float32 preds and int32
    targets, the calibration error's confidences and accuracies) entry by
    entry."""
    for leader, states in cpu_state.items():
        for name, arr in states.items():
            got = gpu_state[leader][name]
            if isinstance(arr, list):
                same = len(got) == len(arr) and all(
                    g.dtype == a.dtype and np.array_equal(g, a, equal_nan=True) for g, a in zip(got, arr)
                )
                check(same, f"{label}: list state {leader}.{name} differs card vs CPU")
                continue
            check(arr.dtype in (np.int32, np.float32) and got.dtype == arr.dtype,
                  f"{label}: {leader}.{name} is {got.dtype} on the card, {arr.dtype} on the CPU")
            if arr.dtype == np.float32 and name not in COUNT_STATES:
                check(np.allclose(got, arr, rtol=STATE_RTOL, atol=0), f"{label}: {leader}.{name} card {got} vs CPU {arr}")
                continue
            check(np.array_equal(got, arr), f"{label}: {leader}.{name} differs card vs CPU")


def check_same_values(torch, label: str, values: dict, cpu_values: dict) -> None:
    """Finite values of the CPU run's shapes, within 1e-6 of max(1, |value|)
    of them (MCC and kappa: 1e-5, float32 sums of squared counts taken in
    another order on the card)."""
    values, cpu_values = flat_values(values), flat_values(cpu_values)
    check(values.keys() == cpu_values.keys(), f"{label}: keys {sorted(values)} vs CPU {sorted(cpu_values)}")
    for key, val in values.items():
        val, ref = val.cpu(), cpu_values[key]
        check(bool(torch.isfinite(val).all()) and val.shape == ref.shape, f"{label}: {key} = {val}")
        diff = float((val.double() - ref.double()).abs().max())
        scale = max(1.0, float(ref.double().abs().max()))
        tol = (ORACLE_RTOL_MCC_KAPPA if key in ("mcc", "kappa") else 1e-6) * scale
        check(diff <= tol, f"{label}: {key} card {val} vs CPU {ref} (diff {diff})")


def check_identical_states(label: str, got: dict, want: dict) -> None:
    """Two collections' exported states bit for bit: every tensor state of
    one dtype and equal, list states entry by entry."""
    check(got.keys() == want.keys(), f"{label}: leaders {sorted(got)} vs {sorted(want)}")
    for leader, states in want.items():
        for name, ref in states.items():
            val = got[leader][name]
            if isinstance(ref, list):
                same = len(val) == len(ref) and all(
                    v.dtype == r.dtype and np.array_equal(v, r, equal_nan=True) for v, r in zip(val, ref)
                )
            else:
                same = val.dtype == ref.dtype and np.array_equal(val, ref, equal_nan=True)
            check(same, f"{label}: {leader}.{name} differs fused vs unfused")


def update_mode(step, before: dict) -> str:
    """How the fused collection's last update ran: "groups" (the first, every
    metric), "eager", "captured", "replayed" or "unfused" (every leader eager)."""
    if step is None:
        return "groups"
    now = step.counts
    changed = [k for k in now if now[k] != before.get(k, 0)]
    return changed[0] if len(changed) == 1 else "groups"


def profile_update(torch, fn) -> dict:
    """One call of ``fn`` (an update) under ``torch.profiler``: its wall time
    (host clock, to the end of ``torch.cuda.synchronize()``), the union of
    its device intervals and their count."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    device = [e for e in prof.events() if e.device_type == DeviceType.CUDA and e.time_range.end > e.time_range.start]
    busy = busy_union_us([(e.time_range.start, e.time_range.end) for e in device]) / 1e3
    return {"wall_ms": wall, "busy_ms": busy, "intervals": len(device), "share": busy / wall if wall else 0.0}


def fused_pair(torch, bc, label: str, make, dev_batches, update=None, rounds: int = 15) -> dict:
    """The fused phase of one stream: the same collection twice,
    ``fused_update=False`` and ``True``, fed the stream update by update in
    turns. After every update the states are identical bit for bit and the
    ``compute()`` values equal. Then one steady update of each on the first
    batch, the fused one with host syncs made errors when it is a replay,
    and ``rounds`` more of each in turns (the order flips each round),
    timed on the host clock to the end of ``torch.cuda.synchronize()``; the
    states and values are compared again, and one update of each runs
    under the profiler.
    Kernel launches: the wrapper's count for eager calls, plus each graph's
    replays times the kernel calls it captured."""
    from tpumetrics_torch.interop import export_state

    update = update or (lambda col, batch: col.update(*batch))
    cols = {"plain": make(False), "fused": make(True)}
    launches = {"plain": 0, "fused": 0}
    modes = {"groups": 0, "eager": 0, "captured": 0, "replayed": 0, "unfused": 0}
    times = {"plain": [], "fused": []}

    def run(name, batch, guard=False):
        col = cols[name]
        step = col._fused_oo_step
        before = dict(step.counts) if step is not None else {}
        n0 = bc.launches
        t0 = time.perf_counter()
        if guard:
            torch.cuda.set_sync_debug_mode("error")
        try:
            update(col, batch)
        finally:
            if guard:
                torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        launches[name] += bc.launches - n0
        mode = update_mode(col._fused_oo_step, before) if name == "fused" else "plain"
        if name == "fused":
            modes[mode] += 1
        return ms, mode

    def compare(when):
        check_identical_states(f"{label} {when}", export_state(cols["fused"]), export_state(cols["plain"]))
        got, want = flat_values(cols["fused"].compute()), flat_values(cols["plain"].compute())
        for key in want:
            check(torch.equal(got[key], want[key]), f"{label} {when}: {key} fused {got[key]} vs unfused {want[key]}")

    for i, batch in enumerate(dev_batches):
        run("plain", batch)
        run("fused", batch)
        compare(f"after update {i + 1}")
    steady = dev_batches[0]
    run("plain", steady)
    _, guarded = run("fused", steady, guard=modes["replayed"] > 0)  # a replay raises on any host sync
    timed_modes = []
    # what else the host did in the timed updates: Python's garbage collections and
    # their time, and new device memory segments (cudaMalloc calls of the allocator)
    gc_ms = {"plain": 0.0, "fused": 0.0}
    gc_runs = {"plain": 0, "fused": 0}
    segments = {"plain": 0, "fused": 0}
    current = {"name": None, "t0": 0.0}

    def on_gc(phase, info):
        if current["name"] is None:
            return
        if phase == "start":
            current["t0"] = time.perf_counter()
        else:
            gc_ms[current["name"]] += (time.perf_counter() - current["t0"]) * 1e3
            gc_runs[current["name"]] += 1

    gc.callbacks.append(on_gc)
    try:
        for r in range(rounds):
            for name in ("plain", "fused") if r % 2 == 0 else ("fused", "plain"):
                seg0 = torch.cuda.memory_stats().get("segment.all.allocated", 0)
                current["name"] = name
                ms, mode = run(name, steady)
                current["name"] = None
                segments[name] += torch.cuda.memory_stats().get("segment.all.allocated", 0) - seg0
                times[name].append(ms)
                if name == "fused":
                    timed_modes.append(mode)
    finally:
        gc.callbacks.remove(on_gc)
    compare("after the timed updates")
    step = cols["fused"]._fused_oo_step
    replay_launches = step.kernel_launches().get("binned_confusion", 0) if step is not None else 0
    prof = {name: profile_update(torch, lambda: update(cols[name], steady)) for name in ("plain", "fused")}
    groups = [list(g) for g in cols["fused"].compute_groups.values()]
    leaders = step.leaders if step is not None else []
    out = {
        "modes": modes,
        "timed_modes": sorted(set(timed_modes)),
        "guarded_replay": guarded == "replayed",
        "plain_ms": float(np.median(times["plain"])),
        "fused_ms": float(np.median(times["fused"])),
        "plain_ms_all": times["plain"],
        "fused_ms_all": times["fused"],
        "gc_ms": gc_ms,
        "gc_runs": gc_runs,
        "new_segments": segments,
        "profile": prof,
        "capture_s": list(step.capture_seconds) if step is not None else [],
        "graphs": step.program_count if step is not None else 0,
        "launches_plain": launches["plain"],
        "launches_fused": launches["fused"] + replay_launches,
        "launches_fused_eager": launches["fused"],
        "launches_fused_replayed": replay_launches,
        "groups": groups,
        "eager_leaders": [g[0] for g in groups if g[0] not in leaders],
    }
    check(out["launches_fused"] == out["launches_plain"],
          f"{label}: fused kernel launches {out['launches_fused']} (eager {launches['fused']} + replayed"
          f" {replay_launches}) vs unfused {out['launches_plain']}")
    print(
        f"fused phase: {label}: {len(dev_batches)} + {rounds + 1} updates in turns, states bit for bit and values"
        f" equal to the unfused collection after every update; fused updates by mode {modes}"
        f" (timed ones: {out['timed_modes']}); a replay under sync errors: {out['guarded_replay']};"
        f" host-clock update median fused {out['fused_ms']:.3f} ms vs unfused {out['plain_ms']:.3f} ms"
        f" ({rounds} each, in turns; in them, garbage collections {gc_runs} taking {({k: round(v, 3) for k, v in gc_ms.items()})} ms,"
        f" new device memory segments {segments}); device union of a fused update over its unprofiled median"
        f" {100 * prof['fused']['busy_ms'] / out['fused_ms']:.1f}%; profiled update: fused {prof['fused']['wall_ms']:.3f} ms wall, device union"
        f" {prof['fused']['busy_ms']:.3f} ms ({100 * prof['fused']['share']:.1f}%, {prof['fused']['intervals']}"
        f" intervals) vs unfused {prof['plain']['wall_ms']:.3f} ms wall, {prof['plain']['busy_ms']:.3f} ms"
        f" ({100 * prof['plain']['share']:.1f}%, {prof['plain']['intervals']} intervals); graphs {out['graphs']},"
        f" capture {[round(x, 4) for x in out['capture_s']]} s; eager leaders {out['eager_leaders']};"
        f" binned_confusion launches fused {out['launches_fused']} ({launches['fused']} eager + {replay_launches}"
        f" replayed) vs unfused {out['launches_plain']}",
        flush=True,
    )
    return out


def make_binary_stream(n: int, batch: int, seed: int):
    """A binary classifier's eval shard: 30% positives, probabilities a sigmoid
    of seeded logits that lean towards the true class, rounded to multiples of
    2^-12 so that many tie."""
    rng = np.random.default_rng(seed)
    target = (rng.random(n) < 0.3).astype(np.int64)
    logits = rng.standard_normal(n) * 1.5 + np.where(target == 1, 1.0, -1.0)
    probs = (np.round(4096.0 / (1.0 + np.exp(-logits))) / 4096.0).astype(np.float32)
    return [(probs[i : i + batch], target[i : i + batch]) for i in range(0, n, batch)]


def make_multilabel_stream(n: int, labels: int, batch: int, seed: int):
    """Multilabel tagging: about 5% of labels present, probabilities a sigmoid
    of seeded logits that lean towards the truth, about 1% of target entries
    at ``ignore_index=-1``."""
    rng = np.random.default_rng(seed)
    target = (rng.random((n, labels)) < 0.05).astype(np.int64)
    logits = rng.standard_normal((n, labels)) * 1.5 + np.where(target == 1, 2.0, -2.0)
    probs = (1.0 / (1.0 + np.exp(-logits))).astype(np.float32)
    target[rng.random((n, labels)) < 0.01] = -1
    return [(probs[i : i + batch], target[i : i + batch]) for i in range(0, n, batch)]


def rank_auroc(probs: np.ndarray, target: np.ndarray) -> float:
    """AUROC as the float64 rank statistic (Mann-Whitney U, ties averaged)."""
    from scipy.stats import rankdata

    pos = target == 1
    n_pos, n_neg = int(pos.sum()), int((~pos).sum())
    ranks = rankdata(probs.astype(np.float64), method="average")
    return float((ranks[pos].sum() - n_pos * (n_pos + 1) / 2) / (n_pos * n_neg))


def task_phase(torch, bc, task: str) -> dict:
    """One binary or multilabel stream through its collection on the card and
    on the CPU (see the module note); returns the launches and times."""
    import tpumetrics_torch as tm
    from tpumetrics_torch import MetricCollection
    from tpumetrics_torch.interop import export_state

    t = 200
    if task == "binary":
        label = "binary stream 1000000 T=200 + exact"
        batches = make_binary_stream(1_000_000, 65536, SEED)
        kw = {"task": "binary", "validate_args": False}
        members = {
            "acc": lambda **d: tm.Accuracy(**kw, **d),
            "f1": lambda **d: tm.F1Score(**kw, **d),
            "auroc": lambda **d: tm.AUROC(thresholds=t, **kw, **d),
            "auroc_exact": lambda **d: tm.AUROC(**kw, **d),
            "precision": lambda **d: tm.Precision(**kw, **d),
            "recall": lambda **d: tm.Recall(**kw, **d),
            "specificity": lambda **d: tm.Specificity(**kw, **d),
            "mcc": lambda **d: tm.MatthewsCorrCoef(**kw, **d),
            "kappa": lambda **d: tm.CohenKappa(**kw, **d),
            "rafp": lambda **d: tm.RecallAtFixedPrecision(min_precision=0.5, thresholds=t, **kw, **d),
            "sas": lambda **d: tm.SpecificityAtSensitivity(min_sensitivity=0.9, thresholds=t, **kw, **d),
            "hinge": lambda **d: tm.HingeLoss(**kw, **d),
            "ece": lambda **d: tm.CalibrationError(n_bins=15, **kw, **d),
        }
        # MCC and kappa share a 2x2 confusion matrix, specificity at sensitivity the binned AUROC's state;
        # the calibration error (list states, eager) and the hinge loss lead their own groups
        groups = [["acc", "f1", "precision", "recall", "specificity"], ["auroc", "rafp", "sas"], ["auroc_exact"],
                  ["ece"], ["hinge"], ["kappa", "mcc"]]
    else:
        label = "multilabel stream COCO-80 40504x80 T=200"
        batches = make_multilabel_stream(40504, 80, 4096, SEED)
        kw = {"task": "multilabel", "num_labels": 80, "ignore_index": -1, "validate_args": False}
        members = {
            "acc": lambda **d: tm.Accuracy(**kw, **d),
            "f1": lambda **d: tm.F1Score(average="macro", **kw, **d),
            "auroc": lambda **d: tm.AUROC(thresholds=t, **kw, **d),
            "precision": lambda **d: tm.Precision(average="macro", **kw, **d),
            "recall": lambda **d: tm.Recall(average="macro", **kw, **d),
            "hamming": lambda **d: tm.HammingDistance(average="macro", **kw, **d),
            "exact": lambda **d: tm.ExactMatch(**kw, **d),
            "jaccard": lambda **d: tm.JaccardIndex(**kw, **d),
            "pafr": lambda **d: tm.PrecisionAtFixedRecall(min_recall=0.5, thresholds=t, **kw, **d),
            "sas": lambda **d: tm.SpecificityAtSensitivity(min_sensitivity=0.5, thresholds=t, **kw, **d),
            "coverage": lambda **d: tm.MultilabelCoverageError(80, ignore_index=-1, validate_args=False, **d),
            "lrap": lambda **d: tm.MultilabelRankingAveragePrecision(80, ignore_index=-1, validate_args=False, **d),
            "lrl": lambda **d: tm.MultilabelRankingLoss(80, ignore_index=-1, validate_args=False, **d),
        }
        # exact match's correct/total, the per-label confusion matrices and each ranking metric's
        # score/total lead their own groups; specificity at sensitivity joins the binned AUROC's
        groups = [["acc", "f1", "hamming", "precision", "recall"], ["auroc", "pafr", "sas"], ["coverage"], ["exact"],
                  ["jaccard"], ["lrap"], ["lrl"]]

    def collection(device, fused=False):
        return MetricCollection({k: m(device=device) for k, m in members.items()}, fused_update=fused, device=device)

    dev_batches = [(torch.from_numpy(p).cuda(), torch.from_numpy(y).cuda()) for p, y in batches]
    col = collection("cuda")
    torch.cuda.synchronize()
    bc.launches = 0  # count only this path's launches
    update_ms = []
    for i, (preds, target) in enumerate(dev_batches):
        t0 = time.perf_counter()
        if i == 1:  # a steady update (leaders only): a host sync in it raises
            torch.cuda.set_sync_debug_mode("error")
            try:
                col.update(preds, target)
            finally:
                torch.cuda.set_sync_debug_mode(0)
        else:
            col.update(preds, target)
        torch.cuda.synchronize()
        update_ms.append((time.perf_counter() - t0) * 1e3)
    launches = bc.launches
    t0 = time.perf_counter()
    values = col.compute()
    torch.cuda.synchronize()
    compute_ms = (time.perf_counter() - t0) * 1e3

    found = [list(g) for g in col.compute_groups.values()]
    check(found == groups, f"{label}: compute groups {found}")
    # the first update also runs the fixed-point metrics' own binned updates; later ones only AUROC's group leader
    check(launches == len(batches) + 2, f"{label}: {launches} kernel launches for {len(batches)} updates")

    cpu = collection("cpu")
    for preds, target in batches:
        cpu.update(torch.from_numpy(preds), torch.from_numpy(target))
    cpu_values = cpu.compute()
    gpu_state = export_state(col)
    check_same_states(label, gpu_state, export_state(cpu))
    check_same_values(torch, label, values, cpu_values)

    probs = np.concatenate([b[0] for b in batches]).reshape(-1, 1 if task == "binary" else 80)
    target = np.concatenate([b[1] for b in batches]).reshape(probs.shape)
    valid = target != -1
    confmat = gpu_state["auroc"]["confmat"].reshape(t, probs.shape[1], 2, 2)
    tp, predpos = numpy_binned_counts(probs, target == 1, valid, col["auroc"].thresholds.cpu().numpy())
    check(np.array_equal(confmat[:, :, 1, 1], tp), f"{label}: AUROC tp counts differ from numpy")
    check(np.array_equal(confmat[:, :, 0, 1] + confmat[:, :, 1, 1], predpos), f"{label}: predicted positives differ")
    acc = float(np.mean(((probs > 0.5) == (target == 1))[valid]))
    check(abs(float(values["acc"]) - acc) <= 1e-6, f"{label}: acc {float(values['acc'])} vs numpy {acc}")
    # the new members against a float64 oracle from numpy counts of the same stream
    hit, pred = target == 1, probs > 0.5
    tp_, fp_, tn_, fn_ = ((m & valid).sum(axis=0) for m in (pred & hit, pred & ~hit, ~pred & ~hit, ~pred & hit))
    npos, thresholds = (hit & valid).sum(axis=0), col["auroc"].thresholds.cpu().numpy()
    nneg = (~hit & valid).sum(axis=0)
    if task == "binary":
        oracle = stat_oracle(tp_[0], fp_[0], tn_[0], fn_[0])
        del oracle["hamming"]
        cm = confmat_oracle([[tn_[0], fp_[0]], [fn_[0], tp_[0]]])
        oracle.update(mcc=cm["mcc"], kappa=cm["kappa"])
        oracle["rafp"] = fixed_point_oracle(tp, predpos, npos, thresholds, 0.5, "recall")
        oracle["sas"] = sas_oracle(tp, predpos, npos, nneg, thresholds, 0.9)
        oracle["hinge"] = hinge_oracle(probs[:, 0], target[:, 0])
        oracle["ece"] = ece_oracle(probs[:, 0], target[:, 0])
    else:
        oracle = stat_oracle(tp_, fp_, tn_, fn_, multilabel=True)
        del oracle["specificity"]
        oracle["exact"] = float(np.mean(np.all((pred == hit) | ~valid, axis=1)))
        oracle["jaccard"] = float(np.mean(sdiv(tp_, tp_ + fp_ + fn_)))
        oracle["pafr"] = fixed_point_oracle(tp, predpos, npos, thresholds, 0.5, "precision")
        oracle["sas"] = sas_oracle(tp, predpos, npos, nneg, thresholds, 0.5)
        # the ranking metrics reduce per update batch; their oracle sums per row, so any batching gives its value
        oracle.update(ranking_oracle(probs, target, valid))
    worst = check_oracle(label, values, oracle)
    new_values = " ".join(
        f"{k} {float(values[k][0].float().mean() if isinstance(values[k], tuple) else values[k]):.6f}" for k in oracle
    )
    ece = f", ece {ECE_ERR[label]:.3e} of tolerance {ORACLE_TOL_ECE}" if label in ECE_ERR else ""
    extra = f" {new_values} (float64 numpy oracle: worst difference {worst:.3e}{ece});"
    if task == "binary":
        ranked = rank_auroc(probs[:, 0], target[:, 0])
        exact = float(values["auroc_exact"])
        check(abs(exact - ranked) <= 1e-5, f"{label}: exact AUROC {exact} vs float64 rank statistic {ranked}")
        extra += f" exact auroc {exact:.7f} vs float64 rank statistic {ranked:.7f} (diff {abs(exact - ranked):.2e});"
    steady = update_ms[1:]
    print(
        f"task phase: {label}: {len(batches)} batches, states identical to the CPU run, binned counts equal to"
        f" numpy's, update 1 free of host syncs;{extra} acc {float(values['acc']):.6f} f1 {float(values['f1']):.6f}"
        f" auroc {float(values['auroc']):.6f}; first update {update_ms[0]:.3f} ms, later updates median"
        f" {np.median(steady):.3f} ms (min {min(steady):.3f}, max {max(steady):.3f}); compute {compute_ms:.3f} ms;"
        f" kernel launches {launches}",
        flush=True,
    )
    profile_step(torch, col, dev_batches[1], label)
    del col
    fused = fused_pair(torch, bc, label, lambda f: collection("cuda", f), dev_batches)
    eager = ["auroc_exact", "ece"] if task == "binary" else []
    check(fused["eager_leaders"] == eager, f"{label}: eager leaders {fused['eager_leaders']}, expected {eager}")
    return {"launches": launches, "update_ms": update_ms, "compute_ms": compute_ms, "fused": fused}


def make_groups(n: int, batch: int, seed: int):
    """Group ids of five groups with unequal shares (40/25/15/12/8 %), in batches."""
    groups = np.random.default_rng(seed).choice(5, size=n, p=[0.40, 0.25, 0.15, 0.12, 0.08])
    return [groups[i : i + batch] for i in range(0, n, batch)]


def fairness_oracle(probs: np.ndarray, target: np.ndarray, groups: np.ndarray, num_groups: int):
    """Per-group tp/fp/tn/fn (int64, numpy) and, in float64, each group's rates
    and the demographic-parity and equal-opportunity ratios under their keys."""
    pred, hit = probs > 0.5, target == 1
    stats = np.stack(
        [np.bincount(groups[m], minlength=num_groups) for m in (pred & hit, pred & ~hit, ~pred & ~hit, ~pred & hit)],
        axis=1,
    )
    values = {f"group_{g}": stats[g] / stats[g].sum() for g in range(num_groups)}
    tp, fp, tn, fn = stats.T.astype(np.float64)
    for prefix, rates in (("DP", sdiv(tp + fp, tp + fp + tn + fn)), ("EO", sdiv(tp, tp + fn))):
        lo, hi = int(np.argmin(rates)), int(np.argmax(rates))
        values[f"{prefix}_{lo}_{hi}"] = float(sdiv(rates[lo], rates[hi]))
    return stats, values


def fairness_phase(torch, bc) -> dict:
    """A fairness audit of the binary stream: ``BinaryFairness`` and
    ``BinaryGroupStatRates`` (one compute group) updated with ``(preds,
    target, groups)`` on the card and on the CPU; the per-group counts
    against numpy and the values against a float64 oracle; the histogram's
    device time; then the fused phase."""
    import tpumetrics_torch as tm
    from tpumetrics_torch import MetricCollection
    from tpumetrics_torch.functional.classification.group_fairness import _binary_groups_stat_scores
    from tpumetrics_torch.interop import export_state
    from tpumetrics_torch.utils.data import _bincount

    label, num_groups = "binary fairness audit 1000000 in 5 groups", 5
    batches = [(p, y, g) for (p, y), g in zip(make_binary_stream(1_000_000, 65536, SEED), make_groups(1_000_000, 65536, SEED + 1))]

    def collection(device, fused=False):
        kw = {"num_groups": num_groups, "validate_args": False, "device": device}
        return MetricCollection(
            {"fair": tm.BinaryFairness(**kw), "rates": tm.BinaryGroupStatRates(**kw)}, fused_update=fused, device=device
        )

    dev_batches = [tuple(torch.from_numpy(x).cuda() for x in b) for b in batches]
    col = collection("cuda")
    torch.cuda.synchronize()
    bc.launches = 0
    update_ms = []
    for i, batch in enumerate(dev_batches):
        t0 = time.perf_counter()
        if i == 1:  # a steady update: the group check is off (validate_args=False), so nothing may sync
            torch.cuda.set_sync_debug_mode("error")
            try:
                col.update(*batch)
            finally:
                torch.cuda.set_sync_debug_mode(0)
        else:
            col.update(*batch)
        torch.cuda.synchronize()
        update_ms.append((time.perf_counter() - t0) * 1e3)
    values = col.compute()
    found = [list(g) for g in col.compute_groups.values()]
    check(found == [["fair", "rates"]], f"{label}: compute groups {found}")
    check(bc.launches == 0, f"{label}: {bc.launches} binned_confusion launches, expected none")

    cpu = collection("cpu")
    for batch in batches:
        cpu.update(*(torch.from_numpy(x) for x in batch))
    gpu_state = export_state(col)
    check_same_states(label, gpu_state, export_state(cpu))
    check_same_values(torch, label, values, cpu.compute())
    stats, oracle = fairness_oracle(*(np.concatenate([b[k] for b in batches]) for k in range(3)), num_groups)
    got = np.stack([gpu_state["fair"][k] for k in ("tp", "fp", "tn", "fn")], axis=1)
    check(np.array_equal(got, stats), f"{label}: per-group counts {got.tolist()} vs numpy {stats.tolist()}")
    check(sorted(values) == sorted(oracle), f"{label}: keys {sorted(values)} vs oracle {sorted(oracle)}")
    worst = max(float(np.max(np.abs(values[k].cpu().double().numpy() - oracle[k]))) for k in oracle)
    check(worst <= ORACLE_TOL, f"{label}: values vs float64 oracle, worst difference {worst}")

    # the count's device time at one batch: the whole per-group count, and its 4*G+1-bucket histogram alone.
    # The count is some 20 small ops whose queueing outlasts one L2 flush, so four flushes run ahead of it
    preds, target, groups = dev_batches[0]
    flush = l2_flush(torch)
    count_ms, count_host_ms = cuda_ms(
        torch, lambda: _binary_groups_stat_scores(preds, target, groups, num_groups, validate_args=False), 30,
        lambda: [flush() for _ in range(4)],
    )
    key = (4 * groups + (preds > 0.5).long() * 2 + target).contiguous()
    hist_ms, _ = cuda_ms(torch, lambda: _bincount(key, minlength=4 * num_groups), 30, flush)
    del flush
    dp = [k for k in values if k.startswith("DP_")][0]
    eo = [k for k in values if k.startswith("EO_")][0]
    steady = update_ms[1:]
    print(
        f"fairness phase: {label}: {len(batches)} batches, per-group int32 counts identical to the CPU run and to"
        f" numpy's, values against a float64 oracle (worst difference {worst:.3e}); {dp} {float(values[dp]):.6f}"
        f" {eo} {float(values[eo]):.6f}; update 1 free of host syncs; first update {update_ms[0]:.3f} ms, later"
        f" updates median {np.median(steady):.3f} ms; per-group count of a 65536 batch {count_ms:.4f} ms on the"
        f" device ({count_host_ms:.4f} ms of host time), its {4 * num_groups + 1}-bucket index_add_ histogram alone"
        f" {hist_ms:.4f} ms",
        flush=True,
    )
    profile_step(torch, col, dev_batches[1], label)
    del col
    fused = fused_pair(torch, bc, label, lambda f: collection("cuda", f), dev_batches)
    check(fused["eager_leaders"] == [], f"{label}: eager leaders {fused['eager_leaders']}")
    return {"launches": 0, "update_ms": update_ms, "count_ms": count_ms, "hist_ms": hist_ms, "fused": fused}


# Cityscapes (Cordts et al. 2016) val geometry: 19 evaluation classes, 1024 x 2048 pixels, void label 255;
# the shares of the classes' pixels, roughly those of the val set (road, sidewalk, building, wall, fence,
# pole, traffic light, traffic sign, vegetation, terrain, sky, person, rider, car, truck, bus, train,
# motorcycle, bicycle)
SEG_CLASSES, SEG_VOID, SEG_BATCH, SEG_HW = 19, 255, 2, (1024, 2048)
SEG_SHARES = [0.33, 0.055, 0.2, 0.006, 0.008, 0.011, 0.002, 0.005, 0.15, 0.01, 0.035, 0.011, 0.002, 0.06,
              0.002, 0.002, 0.002, 0.001, 0.004]
SEG_BATCHES = 50  # 100 of the 500 val images, so the run stays within its time


def make_seg_batch(torch, index: int):
    """One batch made on the card from the seed: a label map of 32 x 32-pixel
    blocks drawn with the class shares, about 10% of the pixels void; logits
    ``(2, 19, 1024, 2048)`` of unit noise with 2.75 added at the true class
    (about 80% pixel accuracy), on a grid of 1/8 so that the argmax of the
    logits and of their softmax agree (ties go to the first class in both)."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED * 1_000_003 + index)
    h, w = SEG_HW
    shares = torch.tensor(SEG_SHARES, device="cuda")
    blocks = torch.multinomial(shares, SEG_BATCH * (h // 32) * (w // 32), replacement=True, generator=gen)
    target = blocks.reshape(SEG_BATCH, h // 32, w // 32).repeat_interleave(32, 1).repeat_interleave(32, 2)
    logits = torch.randn((SEG_BATCH, SEG_CLASSES, h, w), generator=gen, device="cuda")
    logits.scatter_add_(1, target[:, None], torch.full((SEG_BATCH, 1, h, w), 2.75, device="cuda"))
    logits = torch.round(logits * 8) / 8
    void = torch.rand((SEG_BATCH, h, w), generator=gen, device="cuda") < 0.1
    return logits, target.masked_fill(void, SEG_VOID)


class SegStream:
    """The segmentation batches, made one at a time as they are read (only
    the first is kept, as the fused phase's steady batch)."""

    def __init__(self, torch, n: int):
        self.torch, self.n, self.first = torch, n, None

    def __len__(self) -> int:
        return self.n

    def __iter__(self):
        return (self[i] for i in range(self.n))

    def __getitem__(self, i: int):
        if i != 0:
            return make_seg_batch(self.torch, i)
        if self.first is None:
            self.first = make_seg_batch(self.torch, 0)
        return self.first


def dice_macro(tp, fp, fn) -> float:
    """Macro Dice in float64 over the classes present in preds or target."""
    tp, fp, fn = (np.asarray(x, np.float64) for x in (tp, fp, fn))
    present = (tp + fp + fn) > 0
    return float(sdiv(2 * tp, 2 * tp + fp + fn)[present].mean())


def segmentation_phase(torch, bc) -> dict:
    """Semantic segmentation at Cityscapes val geometry (see the module
    note): mIoU, pixel accuracy and macro Dice on the card; the first 4
    batches against the CPU, the whole stream against numpy; then the fused
    phase."""
    import tpumetrics_torch as tm
    from tpumetrics_torch import MetricCollection
    from tpumetrics_torch.interop import export_state

    c = SEG_CLASSES
    label = f"segmentation Cityscapes val geometry {SEG_BATCHES * SEG_BATCH} images {c} classes 1024x2048"

    def collection(device, fused=False):
        kw = {"validate_args": False, "device": device}
        # Dice refuses ignore_index=255 with 19 classes: the void pixels reach it as zero target rows
        members = {
            "miou": tm.MulticlassJaccardIndex(c, ignore_index=SEG_VOID, **kw),
            "pixel_acc": tm.MulticlassAccuracy(c, average="micro", ignore_index=SEG_VOID, **kw),
            "dice": tm.Dice(num_classes=c, average="macro", mdmc_average="global", device=device),
        }
        return MetricCollection(members, fused_update=fused, device=device)

    stream = SegStream(torch, SEG_BATCHES)
    col, cpu = collection("cuda"), collection("cpu")
    bc.launches = 0
    cm = np.zeros((c, c), np.int64)
    dice_counts = np.zeros((3, c), np.float32)  # tp, fp, fn, accumulated in float32 per batch as the state is
    update_ms, cpu_ms, void_px, all_px = [], [], 0, 0
    for i, (logits, target) in enumerate(stream):
        t0 = time.perf_counter()
        if i == 1:  # a steady update: a host sync in it raises
            torch.cuda.set_sync_debug_mode("error")
            try:
                col.update(logits, target)
            finally:
                torch.cuda.set_sync_debug_mode(0)
        else:
            col.update(logits, target)
        torch.cuda.synchronize()
        update_ms.append((time.perf_counter() - t0) * 1e3)
        pred = logits.argmax(dim=1).to(torch.uint8).cpu().numpy().reshape(-1).astype(np.int64)
        tgt = target.cpu().numpy().reshape(-1)
        valid = tgt != SEG_VOID
        batch_cm = np.bincount(tgt[valid] * c + pred[valid], minlength=c * c).reshape(c, c)
        cm += batch_cm
        tp = np.diag(batch_cm)
        counts = np.stack([tp, np.bincount(pred, minlength=c) - tp, batch_cm.sum(1) - tp]).astype(np.float32)
        dice_counts = (dice_counts + counts).astype(np.float32)
        void_px, all_px = void_px + int((~valid).sum()), all_px + tgt.size
        if i < 4:
            t0 = time.perf_counter()
            cpu.update(logits.cpu(), target.cpu())
            cpu_ms.append((time.perf_counter() - t0) * 1e3)
        if i == 3:
            check_same_states(f"{label} after 4 updates", export_state(col), export_state(cpu))
            check_same_values(torch, f"{label} after 4 updates", col.compute(), cpu.compute())
        del logits, target
    values = col.compute()
    torch.cuda.synchronize()
    groups = [list(g) for g in col.compute_groups.values()]
    check(groups == [["dice"], ["miou"], ["pixel_acc"]], f"{label}: compute groups {groups}")
    check(bc.launches == 0, f"{label}: {bc.launches} binned_confusion launches, expected none")
    state = export_state(col)
    check(np.array_equal(state["miou"]["confmat"], cm), f"{label}: confusion matrix differs from numpy's int64")
    for k, name in enumerate(("tp", "fp", "fn")):
        got = state["dice"][name]
        check(got.dtype == np.float32 and np.array_equal(got, dice_counts[k]), f"{label}: Dice {name} differs from numpy")
    oracle = {
        "pixel_acc": float(np.trace(cm) / cm.sum()),
        "miou": confmat_oracle(cm)["jaccard"],
        "dice": dice_macro(*dice_counts),
    }
    worst = check_oracle(label, values, oracle)
    steady = update_ms[1:]
    print(
        f"segmentation phase: {label}: {SEG_BATCHES} batches of {SEG_BATCH}x{c}x1024x2048 logits made on the card,"
        f" void {100 * void_px / all_px:.2f}% of {all_px} pixels; first 4 batches identical to the CPU run"
        f" (CPU updates median {np.median(cpu_ms):.1f} ms); confusion matrix equal to numpy's int64 and Dice's"
        f" float32 counts to numpy's; mIoU {float(values['miou']):.6f} pixel accuracy"
        f" {float(values['pixel_acc']):.6f} Dice {float(values['dice']):.6f} (float64 oracle: worst difference"
        f" {worst:.3e}); update 1 free of host syncs; first update {update_ms[0]:.3f} ms, later updates median"
        f" {np.median(steady):.3f} ms (min {min(steady):.3f}, max {max(steady):.3f})",
        flush=True,
    )
    profile_step(torch, col, stream[0], label)
    del col, cpu
    fused = fused_pair(torch, bc, label, lambda f: collection("cuda", f), stream)
    check(fused["eager_leaders"] == [], f"{label}: eager leaders {fused['eager_leaders']}")
    return {"launches": 0, "update_ms": update_ms, "fused": fused}


def sync_phase(torch, bc, smi: str) -> dict:
    """The ImageNet-size collection synced over NCCL at world size 1 (see the module note)."""
    import tempfile

    import torch.distributed as dist
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from tpumetrics_torch import (
        CatMetric,
        MeanMetric,
        MetricCollection,
        MulticlassAccuracy,
        MulticlassAUROC,
        MulticlassF1Score,
    )
    from tpumetrics_torch.parallel import (
        NoOpBackend,
        TorchDistBackend,
        distributed_available,
        get_default_backend,
        set_default_backend,
    )

    class Forced(TorchDistBackend):
        """The NCCL group's backend, made to sync at world size 1 (where
        ``available()`` is false and a sync is skipped), counting what it sends."""

        def __init__(self):
            super().__init__()
            self.reset()

        def reset(self):
            self.reduces, self.gathers, self.wire, self.wire_bytes = [], 0, 0, 0

        def available(self):
            return True

        def all_reduce(self, x, op, group=None):
            self.reduces.append((op, str(x.dtype).replace("torch.", ""), x.numel()))
            self.wire += 1
            self.wire_bytes += x.numel() * x.element_size()
            return super().all_reduce(x, op, group)

        def all_gather(self, x, group=None):
            self.gathers += 1
            return super().all_gather(x, group)

        def _gather_equal(self, x, group):
            self.wire += 1
            self.wire_bytes += x.numel() * x.element_size()
            return super()._gather_equal(x, group)

    label = "ImageNet-1k val 50000x1000 T=200 + mean + cat, synced over NCCL"
    n, c, t, batch = 50000, 1000, 200, 8192
    batches = make_stream(n, c, batch, SEED)
    dev_batches = [(torch.from_numpy(p).cuda(), torch.from_numpy(y).cuda()) for p, y in batches]
    def collection(fused=False):
        return MetricCollection(
            {
                "acc": MulticlassAccuracy(c, average="micro", validate_args=False),
                "f1": MulticlassF1Score(c, average="macro", validate_args=False),
                "auroc": MulticlassAUROC(c, thresholds=t, validate_args=False),
                "mean": MeanMetric(),
                "cat": CatMetric(),
            },
            fused_update=fused,
        )

    def update_of(col, batch):
        preds, target = batch
        col.update(preds=preds, target=target, value=preds.max(dim=1).values.mean())

    col = collection()

    def update(preds, target):
        update_of(col, (preds, target))

    with tempfile.TemporaryDirectory() as tmp:
        torch.cuda.set_device(0)
        dist.init_process_group("nccl", store=dist.FileStore(os.path.join(tmp, "store"), 1), rank=0, world_size=1)
        forced = Forced()
        try:
            group_backend = dist.get_backend()
            check(group_backend == "nccl", f"{label}: process group backend {group_backend}")
            check(isinstance(get_default_backend(), NoOpBackend) and not distributed_available(), f"{label}: world 1 syncs")
            set_default_backend(forced)
            check(get_default_backend() is forced and distributed_available(), f"{label}: forced backend not in effect")

            bc.launches = 0  # count only this path's launches
            auroc = col._modules["auroc"]
            for i, (preds, target) in enumerate(dev_batches):
                if i == 1:  # a steady update: the binned AUROC leader's update must not sync with the host
                    plain = auroc.update

                    def guarded(*args, **kwargs):
                        torch.cuda.set_sync_debug_mode("error")
                        try:
                            plain(*args, **kwargs)
                        finally:
                            torch.cuda.set_sync_debug_mode(0)

                    auroc.update = guarded
                    update(preds, target)
                    auroc.update = plain
                else:
                    update(preds, target)
            torch.cuda.synchronize()
            launches = bc.launches
            groups = [list(g) for g in col.compute_groups.values()]
            check(groups == [["acc", "f1"], ["auroc"], ["cat"], ["mean"]], f"{label}: compute groups {groups}")
            check(launches == len(batches), f"{label}: {launches} kernel launches for {len(batches)} AUROC updates")

            leaders = [col._modules[g[0]] for g in col.compute_groups.values()]
            schedule = [e for m in leaders for e in m._sync_schedule()]
            classes = sorted({(op, dt.replace("torch.", "")) for _, op, dt, _ in schedule if op != "gather"})
            n_gathers = sum(op == "gather" for _, op, _, _ in schedule)
            own = {k: m._copy_state_dict() for k, m in col.items(keep_base=True, copy_state=False)}

            forced.reset()
            synced = col.compute()
            torch.cuda.synchronize()
            by_class = {}
            for op, dt, numel in forced.reduces:
                by_class[f"{op}:{dt}"] = by_class.get(f"{op}:{dt}", 0) + numel
            check(sorted(tuple(k.split(":")) for k in by_class) == classes and len(forced.reduces) == len(classes),
                  f"{label}: reduces {forced.reduces} for classes {classes}")
            check(forced.gathers == n_gathers and forced.wire == len(classes) + 2 * n_gathers,
                  f"{label}: {forced.gathers} gathers / {forced.wire} wire ops for {n_gathers} list states")
            for k, m in col.items(keep_base=True, copy_state=False):
                now = m._copy_state_dict()
                for name, val in own[k].items():
                    back = now[name]
                    same = all(a is b for a, b in zip(back, val)) and len(back) == len(val) if isinstance(val, list) else back is val
                    check(same and not m._is_synced, f"{label}: {k}.{name} is not its own state after compute()")

            # the same states computed unsynced: bit for bit the synced values at world size 1
            update(*dev_batches[0])
            set_default_backend(NoOpBackend())
            local_values = col.compute()
            for m in col.values(copy_state=False):
                m._computed = None  # compute the same states again, synced
            set_default_backend(forced)
            synced_again = col.compute()
            for key in synced:
                check(torch.equal(synced_again[key], local_values[key]), f"{label}: {key} synced != unsynced")
                val = synced[key].float()
                check(bool(torch.isfinite(val).all()), f"{label}: {key} = {val}")
            # and the synced states themselves, through the functional path
            state = {k: m._copy_state_dict() for k, m in zip([g[0] for g in col.compute_groups.values()], leaders)}
            synced_state = col.sync_states(state, forced)
            for leader, states in state.items():
                for name, val in states.items():
                    got = synced_state[leader][name]
                    if isinstance(val, list):
                        same = torch.equal(got[0], torch.cat([v.reshape(-1) for v in val]))
                    else:
                        same = got.dtype == val.dtype and torch.equal(got, val)
                    check(same, f"{label}: synced state {leader}.{name} differs from the unsynced one")

            # the collectives of one compute() as NCCL saw them (the c10d ops' profiler events)
            update(*dev_batches[0])
            torch.cuda.synchronize()
            forced.reset()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                col.compute()
                torch.cuda.synchronize()
            events = prof.events()
            tagged = [e for e in events if e.name.startswith(f"{group_backend}:")]  # "nccl:all_reduce", ...
            nccl_ops = outermost(e for e in tagged if e.device_type == DeviceType.CPU)
            nccl_kernels = [e.name for e in events if e.device_type == DeviceType.CUDA and "nccl" in e.name.lower()]
            wire, wire_bytes = forced.wire, forced.wire_bytes
            check(
                len(nccl_ops) == wire,
                f"{label}: profiler saw NCCL ops {nccl_ops} (all events: "
                f"{[(e.name, str(e.device_type), e.thread, e.time_range.start, e.time_range.end) for e in tagged]}),"
                f" the backend sent {wire}",
            )

            # the sync's host-clock cost per compute(): synced and unsynced in turns
            synced_ms, local_ms = [], []
            for _ in range(7):
                for backend, out in ((forced, synced_ms), (NoOpBackend(), local_ms)):
                    set_default_backend(backend)
                    update(*dev_batches[0])
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    col.compute()
                    torch.cuda.synchronize()
                    out.append((time.perf_counter() - t0) * 1e3)

            # the fused phase: every compute() synced over the NCCL group; the tensor
            # kwarg (value=) keys no graph, so every update after the first runs eagerly
            set_default_backend(forced)
            fused = fused_pair(torch, bc, label, collection, dev_batches, update_of)
            modes = fused["modes"]
            check(
                modes["unfused"] == sum(modes.values()) - modes["groups"] and modes["groups"] == 1 and fused["graphs"] == 0,
                f"{label}: fused updates by mode {modes}, {fused['graphs']} graphs; expected every update but the first unfused",
            )
        finally:
            set_default_backend(None)
            dist.destroy_process_group()
    sync_ms = float(np.median(synced_ms) - np.median(local_ms))
    print(
        f"sync phase: {label}: backend {group_backend} world 1 (forced); {len(batches)} batches, kernel launches"
        f" {launches}; binned AUROC update free of host syncs; values and synced states equal to the unsynced ones"
        f" bit for bit, states back to their own tensors after compute(); collectives per compute(): all_reduce"
        f" by class (elements) {by_class}, {n_gathers} list-state gathers, {wire} NCCL ops"
        f" ({len(classes)} + 2 x {n_gathers}), {wire_bytes} bytes sent by this rank; profiler: {len(nccl_ops)}"
        f" NCCL ops {sorted(set(nccl_ops))}, {len(nccl_kernels)} NCCL device kernels; compute() median"
        f" {np.median(synced_ms):.3f} ms synced vs {np.median(local_ms):.3f} ms unsynced (host clock, 7 each),"
        f" the sync {sync_ms:.3f} ms; card {smi}",
        flush=True,
    )
    return {
        "launches": launches, "sync_ms": sync_ms, "compute_ms": synced_ms, "local_compute_ms": local_ms,
        "wire": wire, "wire_bytes": wire_bytes, "by_class": by_class, "gathers": n_gathers, "fused": fused,
    }


def outermost(events) -> list:
    """Names of the events not nested in an earlier one of the same name on
    the same thread: a c10d all_gather records its profiling title twice,
    one range inside the other."""
    kept, seen = [], []
    for e in sorted(events, key=lambda e: (e.time_range.start, -e.time_range.end)):
        if not any(o.name == e.name and o.thread == e.thread and o.time_range.start <= e.time_range.start
                   and e.time_range.end <= o.time_range.end for o in seen):
            kept.append(e.name)
        seen.append(e)
    return kept


def busy_union_us(intervals) -> float:
    """Microseconds covered by the union of ``(start, end)`` intervals."""
    total, reach = 0.0, float("-inf")
    for start, end in sorted(intervals):
        if end > reach:
            total += end - max(start, reach)
            reach = end
    return total


def profile_step(torch, col, batch, label: str) -> None:
    """After every check: one steady (leaders-only) update and one compute,
    timed on the host clock, then each again under ``torch.profiler``. From
    that one profiled run: its wall time (host clock, from the call to the
    end of ``torch.cuda.synchronize()``), the union of its device activity
    intervals from the trace, their share of that wall time (the rest is the
    device idle, waiting on the host), and the kernels that take most."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def run(step: str) -> float:
        t0 = time.perf_counter()
        col.update(*batch) if step == "update" else col.compute()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    for step in ("update", "compute"):
        col.update(*batch)  # a fresh update, so compute is not served from its cache
        torch.cuda.synchronize()
        resident = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        wall_ms = run(step)
        scratch_mb = (torch.cuda.max_memory_allocated() - resident) / 2**20
        col.update(*batch)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            profiled_ms = run(step)
        device = [e for e in prof.events() if e.device_type == DeviceType.CUDA and e.time_range.end > e.time_range.start]
        busy_ms = busy_union_us([(e.time_range.start, e.time_range.end) for e in device]) / 1e3
        span_ms = (max(e.time_range.end for e in device) - min(e.time_range.start for e in device)) / 1e3 if device else 0.0
        kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA and e.device_time_total > 0]
        top = sorted(kernels, key=lambda e: e.device_time_total, reverse=True)[:5]
        parts = "; ".join(f"{e.key[:48]} x{e.count} {e.device_time_total:.1f} us" for e in top)
        ours = sum(e.device_time_total for e in kernels if "count_kernel" in e.key or "rank_kernel" in e.key)
        print(
            f"profile: {label}: steady {step} {wall_ms:.3f} ms wall unprofiled; profiled run {profiled_ms:.3f} ms wall,"
            f" device busy (union of {len(device)} device intervals) {busy_ms:.3f} ms"
            f" = {100 * busy_ms / profiled_ms:.1f}% of it, first-to-last device span {span_ms:.3f} ms;"
            f" peak device memory above resident {scratch_mb:.1f} MiB;"
            f" binned_confusion kernels (rank + count) {ours:.1f} us;"
            f" top: {parts or 'the profiler saw no device time'}",
            flush=True,
        )


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs a CUDA card")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        from tpumetrics_torch.ops import _build
        from tpumetrics_torch.ops import binned_confusion as bc
    except ImportError as err:
        fail(f"the port's package is not beside this script: {err}")
    torch.backends.cuda.matmul.allow_tf32 = False  # the plain version's einsum must count exactly
    torch.backends.cudnn.allow_tf32 = False

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    print(smi, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} device {kind}", flush=True)

    t0 = time.perf_counter()
    libs = _build.build()
    print(f"build: {sorted(libs)} in {time.perf_counter() - t0:.2f} s", flush=True)
    for lib in libs.values():
        log = lib.with_name(lib.name + ".log")
        if log.exists():
            lines = [line.strip() for line in log.read_text().splitlines() if "registers" in line or "spill" in line]
            for line in dict.fromkeys(lines):  # once each, in order
                print(f"build: {lib.name}: {line}", flush=True)

    kern = kernel_phase(torch, bc)
    paths = {
        "imagenet": slice_phase(
            torch, bc, "ImageNet-1k val 50000x1000 T=200, classification report", 50000, 1000, 200, 8192, extra=True
        ),
        "headline": slice_phase(torch, bc, "bench headline 40960x128 T=64", 5 * 8192, 128, 64, 8192),
        "binary": task_phase(torch, bc, "binary"),
        "fairness": fairness_phase(torch, bc),
        "multilabel": task_phase(torch, bc, "multilabel"),
        "segmentation": segmentation_phase(torch, bc),
        "sync": sync_phase(torch, bc, smi),
    }
    clocks = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw,power.limit,temperature.gpu", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    print(f"card after the runs (SM clock, power draw, power limit, temperature): {clocks}", flush=True)

    for path, p in paths.items():
        fused = p["fused"]
        if path != "sync":  # the synced stream's tensor kwarg keeps every update eager (checked in its phase)
            check(fused["modes"]["replayed"] >= 1 and fused["guarded_replay"], f"{path}: no checked graph replay")
    launches_by_path = {path: p["launches"] for path, p in paths.items()}
    for path, p in paths.items():
        launches_by_path[f"{path} fused phase, unfused"] = p["fused"]["launches_plain"]
        launches_by_path[f"{path} fused phase, fused (eager + replayed)"] = p["fused"]["launches_fused"]
    fused_report = {
        path: {k: p["fused"][k] for k in (
            "modes", "plain_ms", "fused_ms", "plain_ms_all", "fused_ms_all", "gc_ms", "gc_runs", "new_segments",
            "profile", "capture_s", "graphs", "launches_fused_eager", "launches_fused_replayed", "eager_leaders",
        )}
        for path, p in paths.items()
    }
    main_shape = kern["timed"]["main path 8192x1000x200"]
    report = {
        "kernels": [
            {
                "name": "binned_confusion_fused",
                "route": "cuda",
                "source": "tpumetrics_torch/csrc/binned_confusion.cu",
                "replaces": "tpumetrics/ops/binned_confusion.py:62",
                "launches": sum(launches_by_path.values()),
                "launches_by_path": launches_by_path,
                "max_abs_err": kern["max_abs_err"],
                "ms": main_shape["ms"],
                "plain_ms": main_shape["plain_ms"],
                "torch_ops_hist_ms": main_shape["torch_ops_hist_ms"],  # a composite of library calls, not a port
                "bound_ms": main_shape["bound_ms"],
                "bound_by": main_shape["bound_by"],
                "library_ms": None,  # no single PyTorch call computes these counts
                "shape": [main_shape["n"], main_shape["c"], main_shape["t"]],
                "timed_shapes": kern["timed"],
                "card": smi,
            }
        ],
        "fused_update": fused_report,
        "ece_err": ECE_ERR,
        "fairness_count_ms": {"per_group_count": paths["fairness"]["count_ms"], "histogram": paths["fairness"]["hist_ms"]},
    }
    print(json.dumps(report), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
