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
   auroc(T=200), ap(T=200), recall@precision(T=200), confmat, jaccard, mcc,
   kappa})``, on the card, held against the same stream on the CPU
   (identical int32 states, values within 1e-6), against numpy counts and,
   for the report's values, against a float64 numpy oracle, with one steady
   update run with host syncs made errors; its compute groups must be the
   three of the accuracy, AP and confusion-matrix leaders, and the kernel's
   launches are counted per update. The bench headline shape (N=8192,
   C=128, T=64, 5 batches; acc, f1 and auroc) runs the same way;
5. task phase: a binary stream (1,000,000 samples, batches of 65,536 and a
   ragged 16,960: a CTR or fraud classifier's eval shard) through
   ``Accuracy``, ``F1Score``, ``Precision``, ``Recall``, ``Specificity``,
   ``MatthewsCorrCoef``, ``CohenKappa``, binned and exact ``AUROC`` and
   binned ``RecallAtFixedPrecision`` with ``task="binary"``, and a
   multilabel stream at MS-COCO 2014 val size (40,504 images x 80 labels,
   batches of 4096 and a ragged 3640, about 1% of the targets ignored)
   through ``Accuracy``, macro ``F1Score``, ``Precision``, ``Recall`` and
   ``HammingDistance``, ``ExactMatch``, ``JaccardIndex``, binned ``AUROC``
   and binned ``PrecisionAtFixedRecall`` with ``task="multilabel"``. Each
   runs on the card and on the CPU: identical states (the exact AUROC's
   list states included), binned counts equal to numpy's, exact AUROC
   against a float64 rank statistic, the new values against a float64
   numpy oracle, one steady update run with host syncs made errors, and the
   kernel's launches counted;
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
7. fused phase, at the end of each of the five streams above: the stream's
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
    and specificity (in F1's compute group), binned AP and recall at
    precision 0.5 (in AUROC's), and the confusion matrix with the Jaccard
    index, MCC and Cohen's kappa (in its group)."""
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
        })
    return out


# The compute groups of the ImageNet-size collection: three leaders (acc, ap,
# confmat), as before the report's other members came, each with them inside.
IMAGENET_GROUPS = [
    ["acc", "f1", "precision", "recall", "specificity"],
    ["ap", "auroc", "rafp"],
    ["confmat", "jaccard", "kappa", "mcc"],
]
# float64 numpy oracle tolerances of the new values: absolute for the
# float32 ratios and averages, relative (to max(1, |value|)) for MCC and
# kappa, whose float32 sums of squared counts lose low bits at these sizes
ORACLE_TOL = 1e-6
ORACLE_RTOL_MCC_KAPPA = 1e-5


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
    difference (relative for MCC and kappa). A fixed-point value is checked
    with its threshold, which must be equal."""
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
            scale = max(1.0, abs(want)) if key in ("mcc", "kappa") else 1.0
            diff = abs(float(got) - want) / scale
            tol = ORACLE_RTOL_MCC_KAPPA if key in ("mcc", "kappa") else ORACLE_TOL
        check(diff <= tol, f"{label}: {key} = {got} vs float64 oracle {want} (diff {diff}, tolerance {tol})")
        worst = max(worst, diff)
    return worst


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
    check(leaders == (["acc", "ap", "confmat"] if extra else ["acc", "auroc"]), f"{label}: leaders {leaders}")
    # the first update runs every member: AP's and recall-at-precision's own launches beside AUROC's;
    # both then share AUROC's group, so a steady update launches the kernel once, as before
    first = 3 if extra else 1
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
        worst = check_oracle(label, values, oracle)
        report = (
            f" precision {float(values['precision']):.6f} recall {float(values['recall']):.6f}"
            f" specificity {float(values['specificity']):.6f} jaccard {float(values['jaccard']):.6f}"
            f" mcc {float(values['mcc']):.6f} kappa {float(values['kappa']):.6f}"
            f" recall@precision0.5 mean {float(values['rafp'][0].mean()):.6f};"
            f" new values against a float64 numpy oracle: worst difference {worst:.3e}"
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
    return {"launches": launches, "update_ms": update_ms, "compute_ms": compute_ms, "fused": fused}


def check_same_states(label: str, gpu_state: dict, cpu_state: dict) -> None:
    """The card's states equal the CPU's: int32 tensor states, and list states
    (the exact curve's float32 preds and int32 targets) entry by entry."""
    for leader, states in cpu_state.items():
        for name, arr in states.items():
            got = gpu_state[leader][name]
            if isinstance(arr, list):
                same = len(got) == len(arr) and all(
                    g.dtype == a.dtype and np.array_equal(g, a, equal_nan=True) for g, a in zip(got, arr)
                )
                check(same, f"{label}: list state {leader}.{name} differs card vs CPU")
                continue
            check(arr.dtype == np.int32, f"{label}: {leader}.{name} is {arr.dtype}, not int32")
            check(np.array_equal(got, arr), f"{label}: {leader}.{name} differs card vs CPU")


def check_same_values(torch, label: str, values: dict, cpu_values: dict) -> None:
    """Finite values of the CPU run's shapes, within 1e-6 of them (MCC and
    kappa: 1e-5 of max(1, |value|), float32 sums of squared counts taken in
    another order on the card)."""
    values, cpu_values = flat_values(values), flat_values(cpu_values)
    for key, val in values.items():
        val, ref = val.cpu(), cpu_values[key]
        check(bool(torch.isfinite(val).all()) and val.shape == ref.shape, f"{label}: {key} = {val}")
        diff = float((val - ref).abs().max())
        tol = ORACLE_RTOL_MCC_KAPPA * max(1.0, float(ref.abs().max())) if key in ("mcc", "kappa") else 1e-6
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
        }
        # one new leader: MCC and kappa share a 2x2 confusion matrix
        groups = [["acc", "f1", "precision", "recall", "specificity"], ["auroc", "rafp"], ["auroc_exact"],
                  ["kappa", "mcc"]]
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
        }
        # two new leaders: exact match's correct/total and the per-label confusion matrices
        groups = [["acc", "f1", "hamming", "precision", "recall"], ["auroc", "pafr"], ["exact"], ["jaccard"]]

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
    # the first update also runs the fixed-point metric's own binned update; later ones only AUROC's group leader
    check(launches == len(batches) + 1, f"{label}: {launches} kernel launches for {len(batches)} updates")

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
    if task == "binary":
        oracle = stat_oracle(tp_[0], fp_[0], tn_[0], fn_[0])
        del oracle["hamming"]
        cm = confmat_oracle([[tn_[0], fp_[0]], [fn_[0], tp_[0]]])
        oracle.update(mcc=cm["mcc"], kappa=cm["kappa"])
        oracle["rafp"] = fixed_point_oracle(tp, predpos, npos, thresholds, 0.5, "recall")
    else:
        oracle = stat_oracle(tp_, fp_, tn_, fn_, multilabel=True)
        del oracle["specificity"]
        oracle["exact"] = float(np.mean(np.all((pred == hit) | ~valid, axis=1)))
        oracle["jaccard"] = float(np.mean(sdiv(tp_, tp_ + fp_ + fn_)))
        oracle["pafr"] = fixed_point_oracle(tp, predpos, npos, thresholds, 0.5, "precision")
    worst = check_oracle(label, values, oracle)
    new_values = " ".join(
        f"{k} {float(values[k][0].float().mean() if isinstance(values[k], tuple) else values[k]):.6f}" for k in oracle
    )
    extra = f" {new_values} (float64 numpy oracle: worst difference {worst:.3e});"
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
    eager = ["auroc_exact"] if task == "binary" else []
    check(fused["eager_leaders"] == eager, f"{label}: eager leaders {fused['eager_leaders']}, expected {eager}")
    return {"launches": launches, "update_ms": update_ms, "compute_ms": compute_ms, "fused": fused}


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
        "multilabel": task_phase(torch, bc, "multilabel"),
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
    }
    print(json.dumps(report), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
