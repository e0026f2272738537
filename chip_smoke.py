#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``tpumetrics_torch``) on one CUDA card.

Run from the repository root, on a machine with an NVIDIA card and ``nvcc``::

    python3 chip_smoke.py

Phases, each of which passes or exits non-zero:

1. the card's name and power limit;
2. build every CUDA kernel of the port from ``tpumetrics_torch/csrc``
   (one ``nvcc`` for each source, all started together);
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
5c. regression streams, each on the card and on the CPU (states equal:
   int32 identical, float32 sums within 1e-6 relative), its values against
   float64 numpy/scipy oracles (sums and errors 1e-5 relative; Pearson,
   concordance, Spearman, Kendall's tau and cosine similarity 1e-5; Kendall's
   p-value 1e-6; the R2, RSE and explained-variance terms that divide by a
   variance taken as ``Σt² - (Σt)²/n`` also 1e-6 times its condition, and
   log-cosh one float32 step of its terms), one steady update with host syncs
   made errors but in the members named as reading the host (printed with
   their syncs and reasons), and the compute time:
   - ratings, at MovieLens-20M test-split size (2,000,026 ratings on the
     half-star grid, batches of 65,536 and a ragged 33,946): MSE, RMSE, MAE,
     MAPE, SMAPE, WMAPE, MSLE, log-cosh, Minkowski (p=3), Tweedie (power
     1.5), R2, explained variance, RSE, Pearson, concordance, Spearman,
     ``MinMaxMetric(MeanAbsoluteError())`` and ``BootStrapper(MeanSquaredError(),
     num_bootstraps=20)`` (its mean and std against a numpy replay of its
     draws); Spearman's 2M-element average-rank pass timed apart;
   - multi-output, at QM9 test-split size (10,831 molecules x 12 targets of
     unlike scales, batches of 1,024 and a ragged 591): a ``MetricTracker``
     over three epochs of shrinking error (its best step must be the last),
     then per-target MAE (``MultioutputWrapper``, ``remove_nans=False``), MSE,
     log-cosh, RSE, R2 in a ``ClasswiseWrapper``, explained variance,
     Pearson, Spearman, Kendall's tau-b with its p-value, cosine similarity,
     and a ``MultitaskWrapper`` beside them; Kendall's 12 x 22-chunk pass
     timed apart, and the host syncs of ``remove_nans=True`` printed;
5d. clustering phase, at ImageNet-1k val size as deep-clustering work
   evaluates it (50,000 images of 1000 classes, 1000 predicted clusters,
   2048-wide float32 embeddings made from the seed, batches of 4,096 and a
   ragged 848): mutual information, NMI, AMI, Rand, adjusted Rand,
   Fowlkes-Mallows, homogeneity, completeness and V-measure on (preds,
   target), Calinski-Harabasz, Davies-Bouldin and Dunn on (embeddings,
   preds), all on list states, and a capacity copy of MI, AMI, V-measure,
   adjusted Rand and Calinski-Harabasz whose live states are MaskedBuffers of
   the stream's rows; on the card and the CPU (labels, data and buffers
   identical), the values against float64 numpy/scipy oracles (1e-5
   relative, AMI 1e-5 absolute) and computed twice with identical results,
   one steady update with host syncs made errors, the compute time and the
   device time of its main parts (the contingency table, the expected-MI
   grid, the centroid sums and the centroid distances);
5e. nominal phase: UCI Adult (48,842 rows; 9 categorical columns of its
   cardinalities and missing shares, made from the seed) through Cramer's V,
   Tschuprow's T, Pearson's contingency coefficient and Theil's U of
   (occupation, education) and the four ``*_matrix`` functions over all
   nine columns (their host reads per column pair counted), and Fleiss
   kappa of CIFAR-10H's geometry (10,000 images, 10 classes, 50 raters) in
   ``counts`` and ``probs`` modes; on the card and the CPU (tables and count
   lists identical), against float64 oracles with float32 error bounds,
   one steady update with host syncs made errors;
5f. retrieval phase: MS MARCO passage re-ranking, dev (small) (6,980
   queries x 1,000 candidates, 6,980,000 rows made from the seed at the
   set's rates: 1.065 judged relevant passages a query, one among the
   candidates for 85.7% of the queries, scores on a 1/1024 grid with the
   relevant ones shifted to an MRR@10 near 0.36; batches of 65,536 in query
   order, each permuted, a ragged 33,184): MRR@10, nDCG@10, MAP, P@10,
   R@1000, HR@10, R-precision, fall-out@10, the PR curve and recall at
   precision 0.1 (max_k 100) on list states, and a capacity copy of MRR@10,
   MAP and nDCG@10 (``num_queries``, MaskedBuffers of the stream's rows);
   on the card and the CPU (lists and buffers identical, values within
   1e-6), against a float64 numpy oracle (1e-6), computed twice with
   identical bits, one steady update with host syncs made errors but in the
   two leaders' binary-target checks (counted), the device time of
   compute's parts (the two sorts, ``sort_queries``, a segment sum, the PR
   grid), and a graded stream at TREC DL 2019 passage geometry (43 x 1,000,
   grades 0-3) through nDCG@10;
5g. audio: the kernel phase of ``biquad_cascade`` (SRMR's IIR filterbanks,
   a chunked scan over T) held to its contract beside its plain torch
   version on the same inputs: against the cascade in float64 on the host,
   rel(kernel) <= 2 rel(plain) + 1e-6 (rel: a lane's max abs error over its
   peak, the worst lane), non-finite outputs where the plain loop's are,
   exact zeros on silent lanes, two calls bit for bit; at both call sites'
   shapes at T=2048 and 4096, at the chunk and tile edges (T = 15, 17,
   1000, 4095, 4096, 4097, 12293), at edge cases (T=1, one lane, silence,
   lanes driven into the clip, NaN and inf inputs), a graph replay bit for
   bit the eager call, and at the SRMR stream's full shapes (184 and 1,472
   lanes x 128,000 samples, the shapes its main path gives the kernel),
   with its time at those shapes (events, L2 flushed), a one-lane launch's
   at the full T (the carry chain's latency), the plain version's at the
   full shapes and at T=2048, and the bytes bound; then a separation
   stream at WSJ0-2mix test geometry (3,000 two-speaker mixtures of 4 s at
   8 kHz, made from the seed as speech-like modulated noise with estimates
   at 15 dB and the speakers swapped in about half; batches of 50; made
   with their float64 oracles in worker processes): speaker-wise PIT over
   SI-SDR on the raw estimates, a collection of SI-SNR, SNR, SA-SDR and SDR
   (512 taps) and C-SI-SNR of a 512-point STFT on the estimates that
   ``pit_permutate`` reorders; values against float64 oracles (brute-force
   PIT, ``scipy.linalg.solve_toeplitz`` SDR), the card against the CPU on
   the first 4 batches, every recovered permutation against the data's,
   host syncs of each member's steady update, three speakers eagerly (the
   Hungarian path, its host read let through) and under capture (the
   exhaustive path, the same result); and an SRMR stream at REVERB
   challenge geometry (64 reverberant utterances of 8 s at 16 kHz, batches
   of 8; ``norm=True`` over one batch): the card against the CPU on 2
   utterances of 2 s, clean utterances scoring above their reverberant
   copies, the kernel's launches (2 an update) and its share of the
   update's device time; each stream with its fused phase;
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
6b. pairwise phase: 768-d embeddings (BERT-base width, as dense retrievers
   such as DPR use): cosine, linear and euclidean of 6,980 queries against
   65,536 passages under each reduction and in the self case at 6,980 x
   6,980 (zero diagonal), manhattan and minkowski (p=3) at 4,096 x 4,096 in
   row chunks of at most 1 GiB of difference; every result against a
   float64 oracle on the card within its float32 error bound, once more
   under the caller's ``set_float32_matmul_precision("medium")``, with each
   function's device time and peak scratch;
7. fused phase, at the end of each of the streams above: the stream's
   collection twice, ``fused_update=False`` and ``True`` (CUDA graphs), fed
   update by update in turns: states bit for bit and ``compute()`` values
   equal after every update, the updates of each mode counted (a key's
   first sighting eager, its capture, its replays; the synced stream's
   tensor kwarg keeps every update eager), one replay with host syncs made
   errors (the ratings stream's ``BootStrapper``, an eager member that reads
   the host in every update, let through by name), 15 steady updates of
   each timed on the host clock in turns, one of each under
   ``torch.profiler`` (device union), the capture time, and
   each kernel's launches (eager calls plus each graph's replays times the
   calls it captured) equal to the unfused run's (the separation stream's
   SDR stays eager beside the graph: MAGMA's batched LU cannot be captured).

Run alone, a phase is a function of this module, called from a script that
guards its own entry point (``if __name__ == "__main__":``; the separation
phase starts worker processes with ``spawn``) after ``_build.build()``:
``chip_smoke.separation_phase(torch, bc)``, ``chip_smoke.srmr_phase(torch,
bc)``, ``chip_smoke.biquad_kernel_phase(torch, bq)``.

The line before the last is the kernel report (JSON); the last line is
``{"ok": true, "device": {...}}``. Without a card, or without the port's
package beside this file, it exits non-zero and prints no result.
"""

from __future__ import annotations

import gc
import json
import math
import multiprocessing
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
    fused = fused_pair(torch, label, lambda f: collection("cuda", f), dev_batches)
    if extra:
        check(fused["groups"] == want, f"{label}: fused compute groups {fused['groups']}")
        check(fused["eager_leaders"] == ["ece"], f"{label}: eager leaders {fused['eager_leaders']}, expected ['ece']")
    return {"launches": launches, "update_ms": update_ms, "compute_ms": compute_ms, "fused": fused}


# float32 states that hold sums of integer counts (Dice's): bit for bit card vs CPU;
# other float32 states are sums of floats, which the card adds in another order
COUNT_STATES = ("tp", "fp", "fn")
STATE_RTOL = 1e-6


def check_same_states(label: str, got, want, scales: dict = None, path: str = "") -> float:
    """The card's states equal the CPU's, through a wrapper's nested states
    (a dict, or a list of per-output states): int32 tensor states and float32
    count states (Dice's) bit for bit, list states (the exact curve's preds
    and targets, the calibration error's confidences and accuracies, the
    regression metrics' appended inputs, the clustering labels and data)
    entry by entry, MaskedBuffer states field by field, and float32 sums of
    floats (hinge, ranking, regression) within 1e-6 relative, with a floor of
    1e-6 times the sum of the absolute terms (``scales[path]``, see
    ``cancel_scales``) for a sum whose terms cancel. Returns the worst
    relative difference of the float sums."""
    scales = scales or {}
    if isinstance(want, dict):
        check(isinstance(got, dict) and got.keys() == want.keys(), f"{label}: {path} keys {sorted(got)} vs {sorted(want)}")
        return max([check_same_states(label, got[k], v, scales, f"{path}.{k}" if path else k) for k, v in want.items()] or [0.0])
    if isinstance(want, tuple):  # a MaskedBuffer state: values, count and requested, exact
        check(isinstance(got, tuple) and len(got) == len(want), f"{label}: {path} is not a buffer on the card")
        same = all(g.dtype == w.dtype and np.array_equal(g, w, equal_nan=True) for g, w in zip(got, want))
        check(same, f"{label}: buffer state {path} differs card vs CPU")
        return 0.0
    if isinstance(want, list):
        check(isinstance(got, list) and len(got) == len(want), f"{label}: {path} has {len(got)} entries, not {len(want)}")
        if all(isinstance(w, np.ndarray) for w in want):  # a list state
            same = all(g.dtype == w.dtype and np.array_equal(g, w, equal_nan=True) for g, w in zip(got, want))
            check(same, f"{label}: list state {path} differs card vs CPU")
            return 0.0
        # a wrapper's list of per-output states
        return max([check_same_states(label, g, w, scales, f"{path}[{i}]") for i, (g, w) in enumerate(zip(got, want))] or [0.0])
    check(want.dtype in (np.int32, np.float32) and got.dtype == want.dtype,
          f"{label}: {path} is {got.dtype} on the card, {want.dtype} on the CPU")
    if want.dtype == np.int32 or path.rsplit(".", 1)[-1] in COUNT_STATES:
        check(np.array_equal(got, want), f"{label}: {path} differs card vs CPU")
        return 0.0
    check(bool(np.all(np.isfinite(want))), f"{label}: {path} = {want} on the CPU")
    ref = want.astype(np.float64)
    diff = np.abs(got.astype(np.float64) - ref)
    floor = STATE_RTOL * np.asarray(scales.get(path, 0.0))
    check(bool(np.all(diff <= STATE_RTOL * np.abs(ref) + floor)), f"{label}: {path} card {got} vs CPU {want}")
    return float(np.max(diff / np.maximum(np.abs(ref), floor / STATE_RTOL + 1e-300)))


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


def check_identical_states(label: str, got, want, path: str = "") -> None:
    """Two collections' exported states bit for bit: every tensor state of
    one dtype and equal, list states entry by entry, MaskedBuffer states
    field by field, and a wrapper's nested state (a dict or a list of its
    children's) all the way down."""
    if isinstance(want, dict):
        check(isinstance(got, dict) and got.keys() == want.keys(), f"{label}: {path or 'leaders'} {sorted(got)} vs {sorted(want)}")
        for key, ref in want.items():
            check_identical_states(label, got[key], ref, f"{path}.{key}" if path else key)
        return
    if isinstance(want, (list, tuple)):  # a list state, a wrapper's per-output states, or a MaskedBuffer's fields
        check(isinstance(got, type(want)) and len(got) == len(want), f"{label}: {path} has {len(got)} entries, not {len(want)}")
        for i, (val, ref) in enumerate(zip(got, want)):
            check_identical_states(label, val, ref, f"{path}[{i}]")
        return
    same = got.dtype == want.dtype and np.array_equal(got, want, equal_nan=True)
    check(same, f"{label}: {path} differs fused vs unfused")


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


class host_readers_exempt:
    """Inside it, the named members of a collection update with host syncs
    allowed, while ``torch.cuda.set_sync_debug_mode("error")`` holds for the
    rest: the members documented to read the host in a steady update."""

    def __init__(self, torch, col, names):
        self.torch, self.members, self.saved = torch, [col._modules[n] for n in names], []

    def __enter__(self):
        torch = self.torch

        def allowed(update):
            def run(*args, **kwargs):
                mode = torch.cuda.get_sync_debug_mode()
                torch.cuda.set_sync_debug_mode(0)
                try:
                    return update(*args, **kwargs)
                finally:
                    torch.cuda.set_sync_debug_mode(mode)
            return run

        self.saved = [m.update for m in self.members]
        for m in self.members:
            object.__setattr__(m, "update", allowed(m.update))
        return self

    def __exit__(self, *exc):
        for m, update in zip(self.members, self.saved):
            object.__setattr__(m, "update", update)
        return False


def fused_pair(torch, label: str, make, dev_batches, update=None, rounds: int = 15, exempt=None) -> dict:
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
    replays times the kernel calls it captured. ``exempt`` names the eager
    members (with the reason) that read the host in every update; the
    guarded replay lets them, and holds every other member to no host sync."""
    from tpumetrics_torch.interop import export_state
    from tpumetrics_torch.ops import COUNTED_KERNELS

    update = update or (lambda col, batch: col.update(*batch))
    cols = {"plain": make(False), "fused": make(True)}
    launches = {kernel: {"plain": 0, "fused": 0} for kernel in COUNTED_KERNELS}
    modes = {"groups": 0, "eager": 0, "captured": 0, "replayed": 0, "unfused": 0}
    times = {"plain": [], "fused": []}

    def run(name, batch, guard=False):
        col = cols[name]
        step = col._fused_oo_step
        before = dict(step.counts) if step is not None else {}
        n0 = {kernel: wrapper.launches for kernel, wrapper in COUNTED_KERNELS.items()}
        t0 = time.perf_counter()
        if guard:
            torch.cuda.set_sync_debug_mode("error")
        try:
            with host_readers_exempt(torch, col, sorted(exempt or {}) if guard else []):
                update(col, batch)
        finally:
            if guard:
                torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        for kernel, wrapper in COUNTED_KERNELS.items():
            launches[kernel][name] += wrapper.launches - n0[kernel]
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
    replayed = step.kernel_launches() if step is not None else {}
    # each kernel's launches: unfused, and fused as eager calls plus the graphs' replays of the calls they captured
    kernel_launches = {
        kernel: {"plain": n["plain"], "fused": n["fused"] + replayed.get(kernel, 0), "fused_eager": n["fused"],
                 "fused_replayed": replayed.get(kernel, 0)}
        for kernel, n in launches.items()
    }
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
        "kernel_launches": kernel_launches,
        "groups": groups,
        "eager_leaders": [g[0] for g in groups if g[0] not in leaders],
    }
    for kernel, n in kernel_launches.items():
        check(n["fused"] == n["plain"], f"{label}: fused {kernel} launches {n['fused']} (eager {n['fused_eager']} +"
                                        f" replayed {n['fused_replayed']}) vs unfused {n['plain']}")
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
        f" capture {[round(x, 4) for x in out['capture_s']]} s; eager leaders {out['eager_leaders']}"
        + "".join(f"; {kernel} launches fused {n['fused']} ({n['fused_eager']} eager + {n['fused_replayed']}"
                  f" replayed) vs unfused {n['plain']}"
                  for kernel, n in kernel_launches.items() if kernel == "binned_confusion" or n["plain"])
        + "".join(f"; host syncs allowed in the guarded replay for {name}: {why}" for name, why in (exempt or {}).items()),
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
    import tpumetrics_torch.classification as tm
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
    fused = fused_pair(torch, label, lambda f: collection("cuda", f), dev_batches)
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
    import tpumetrics_torch.classification as tm
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
    fused = fused_pair(torch, label, lambda f: collection("cuda", f), dev_batches)
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
    import tpumetrics_torch.classification as tm
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
    fused = fused_pair(torch, label, lambda f: collection("cuda", f), stream)
    check(fused["eager_leaders"] == [], f"{label}: eager leaders {fused['eager_leaders']}")
    return {"launches": 0, "update_ms": update_ms, "fused": fused}


# ----------------------------------------------------------------- regression streams

# MovieLens-20M (Harper & Konstan 2015): 20,000,263 ratings on a half-star grid 0.5-5.0; a 10 % test split.
# The shares of the ten grid values are roughly those of the dataset's rating histogram.
RATINGS_N, RATINGS_BATCH = 2_000_026, 65_536
RATING_GRID = np.arange(1, 11) / 2
RATING_SHARES = np.array([1.1, 3.4, 1.4, 7.2, 4.4, 21.3, 10.6, 27.8, 7.7, 14.5])
RATING_NOISE = 0.85  # the predictions' error, about a good recommender's RMSE
EPS32 = float(np.finfo(np.float32).eps)
REG_RTOL = 1e-5  # sums and errors against float64 oracles
CORR_ATOL = 1e-5  # Pearson, concordance, Spearman, Kendall's tau, cosine similarity
PVALUE_ATOL = 1e-6  # Kendall's p-value


def make_ratings(seed: int):
    """The test split in batches: targets on the half-star grid, float32
    predictions the target plus noise, clipped to [0.5, 5]."""
    rng = np.random.default_rng(seed)
    target = rng.choice(RATING_GRID, size=RATINGS_N, p=RATING_SHARES / RATING_SHARES.sum()).astype(np.float32)
    preds = np.clip(target + RATING_NOISE * rng.standard_normal(RATINGS_N), 0.5, 5.0).astype(np.float32)
    return [(preds[i : i + RATINGS_BATCH], target[i : i + RATINGS_BATCH]) for i in range(0, RATINGS_N, RATINGS_BATCH)]


def count_host_syncs(torch, fn) -> int:
    """Host syncs of one call of ``fn``, as ``set_sync_debug_mode("warn")`` reports them."""
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    # the first non-zero debug mode of a process also warns that the mode is a prototype: not a sync
    return sum("synchroniz" in str(w.message) and "prototype" not in str(w.message) for w in caught)


def cancel_scales(p: np.ndarray, t: np.ndarray) -> dict:
    """For the float32 sums whose terms cancel, the float64 sum of the
    absolute values of the terms, per column, by state path: across
    elements (``Σ(t - p)``), or inside each element's formula (Tweedie's
    three powers, log-cosh's ``x + softplus(-2x) - log 2``, the log error's
    ``log1p(p) - log1p(t)``), where the card's and the CPU's ``pow``,
    ``exp`` and ``log`` differ in the last bits."""
    p, t = p.astype(np.float64), t.astype(np.float64)
    e = p - t
    out = {
        "ev.sum_error": np.abs(e).sum(0),
        "log_cosh.sum_log_cosh_error": (np.abs(e) + np.logaddexp(0.0, -2 * e) + np.log(2.0)).sum(0),
    }
    if (p > -1).all() and (t > -1).all():
        a, b = np.log1p(p), np.log1p(t)
        out["msle.sum_squared_log_error"] = (2 * np.abs(a - b) * (np.abs(a) + np.abs(b))).sum(0)
    if (p > 0).all() and (t >= 0).all():
        out["tweedie.sum_deviance_score"] = (2 * (4 * np.sqrt(t) + 2 * t / np.sqrt(p) + 2 * np.sqrt(p))).sum(0)
    return out


def check_values(label: str, values: dict, oracle: dict, tolerances: dict) -> dict:
    """Each value against its float64 oracle within ``tolerances[key]`` =
    ``(rtol, atol)`` (an atol may be per element); returns the worst
    difference relative to the tolerance by key."""
    worst = {}
    for key, want in oracle.items():
        got = np.asarray(values[key].cpu(), np.float64)
        want = np.asarray(want, np.float64)
        rtol, atol = tolerances[key]
        check(got.shape == want.shape and bool(np.all(np.isfinite(got))), f"{label}: {key} = {got} (oracle shape {want.shape})")
        allowed = rtol * np.abs(want) + atol
        diff = np.abs(got - want)
        check(bool(np.all(diff <= allowed)), f"{label}: {key} = {got} vs float64 oracle {want} (diff {diff}, tolerance {allowed})")
        worst[key] = float(np.max(diff / allowed))
    return worst


def regression_oracle(p: np.ndarray, t: np.ndarray) -> dict:
    """float64 values of the regression members over ``(N,)`` or ``(N, D)``
    data, per column, and the quantities the tolerances need."""
    import scipy.stats

    p, t = p.astype(np.float64), t.astype(np.float64)
    e = p - t
    n = t.shape[0]
    rss = (e * e).sum(0)
    tss = ((t - t.mean(0)) ** 2).sum(0)
    cols = [(p, t)] if p.ndim == 1 else [(p[:, i], t[:, i]) for i in range(p.shape[1])]
    squeeze = (lambda x: x[0]) if p.ndim == 1 else np.asarray
    spearman = squeeze([np.corrcoef(scipy.stats.rankdata(a), scipy.stats.rankdata(b))[0, 1] for a, b in cols])
    kendall = [scipy.stats.kendalltau(a, b) for a, b in cols]
    vx, vy = p.var(0, ddof=1), t.var(0, ddof=1)
    cov = ((p - p.mean(0)) * (t - t.mean(0))).sum(0) / (n - 1)
    return {
        "mse": (e * e).mean(0), "mae_all": np.abs(e).mean(), "mae_cols": np.abs(e).mean(0),
        "mape": (np.abs(e) / np.maximum(np.abs(t), 1.17e-6)).mean(),
        "smape": (2 * np.abs(e) / np.maximum(np.abs(t) + np.abs(p), 1.17e-6)).mean(),
        "wmape": np.abs(e).sum() / max(np.abs(t).sum(), 1.17e-6),
        "msle": ((np.log1p(p) - np.log1p(t)) ** 2).mean() if (p > -1).all() and (t > -1).all() else np.nan,
        "log_cosh": (np.abs(e) + np.log1p(np.exp(-2 * np.abs(e))) - np.log(2.0)).mean(0),
        "minkowski3": (np.abs(e) ** 3).sum() ** (1 / 3),
        "tweedie15": (2 * (np.maximum(t, 0) ** 0.5 / (-0.25) - t * p ** -0.5 / -0.5 + p**0.5 / 0.5)).mean()
        if (p > 0).all() else np.nan,
        "rss_over_tss": rss / tss, "kappa": (t * t).sum(0) / tss,
        "ev": 1 - e.var(0) / t.var(0), "ev_ratio": e.var(0) / t.var(0),
        "pearson": cov / np.sqrt(vx * vy),
        "ccc": 2 * cov / (vx + vy + (p.mean(0) - t.mean(0)) ** 2),
        "spearman": spearman,
        "kendall_tau": squeeze([k.statistic for k in kendall]), "kendall_p": squeeze([k.pvalue for k in kendall]),
        "cosine": ((p * t).sum(-1) / (np.linalg.norm(p, axis=-1) * np.linalg.norm(t, axis=-1))).mean() if p.ndim == 2 else np.nan,
    }


def cancel_atol(o: dict, ratio: np.ndarray) -> np.ndarray:
    """The float32 error of a value ``1 - ratio`` or ``ratio`` whose
    denominator is a variance taken as ``Σt² - (Σt)²/n``, the JAX package's
    formula: its two sums carry relative errors of a few 1e-7, so the
    difference carries 1e-6 times its condition ``κ = Σt² / Σ(t - t̄)²``,
    and the value that much times ``ratio``."""
    return 1e-6 * o["kappa"] * ratio


def log_cosh_atol(o: dict) -> np.ndarray:
    """The float32 resolution of log-cosh in the JAX package's stable form
    ``x + softplus(-2x) - log(2)``: every term is of size ``log(2) + |x|``
    before the subtraction, so a mean below one float32 step of that size
    (small errors, ``log cosh x ≈ x²/2``) is not resolved."""
    return EPS32 * (np.log(2.0) + o["mae_cols"])


def replay_bootstrap_mse(batches, num: int, seed: int) -> np.ndarray:
    """The bootstrapped MSEs of ``BootStrapper(MeanSquaredError(),
    num_bootstraps=num, seed=seed)`` in float64: the same draws from the
    same numpy generator, in the same order."""
    rng = np.random.default_rng(seed)
    sse, count = np.zeros(num), np.zeros(num)
    for p, t in batches:
        for b in range(num):
            idx = rng.integers(0, len(p), size=len(p))
            d = p[idx].astype(np.float64) - t[idx]
            sse[b] += d @ d
            count[b] += idx.size
    return sse / count


BOOTSTRAPS = 20
RATINGS_HOST_READERS = {
    "tweedie": "an eager update checks the power's domain on the host (skipped under capture)",
    "bootstrap_mse": "each copy's resample indices are copied to the card from pageable host memory",
}


def ratings_members(device) -> dict:
    import tpumetrics_torch.regression as reg
    from tpumetrics_torch.wrappers import BootStrapper, MinMaxMetric

    kw = {"device": device}
    return {
        "mse": reg.MeanSquaredError(**kw), "rmse": reg.MeanSquaredError(squared=False, **kw),
        "mae": reg.MeanAbsoluteError(**kw), "mape": reg.MeanAbsolutePercentageError(**kw),
        "smape": reg.SymmetricMeanAbsolutePercentageError(**kw),
        "wmape": reg.WeightedMeanAbsolutePercentageError(**kw), "msle": reg.MeanSquaredLogError(**kw),
        "log_cosh": reg.LogCoshError(**kw), "minkowski": reg.MinkowskiDistance(p=3, **kw),
        "tweedie": reg.TweedieDevianceScore(power=1.5, **kw), "r2": reg.R2Score(**kw),
        "ev": reg.ExplainedVariance(**kw), "rse": reg.RelativeSquaredError(**kw),
        "pearson": reg.PearsonCorrCoef(**kw), "ccc": reg.ConcordanceCorrCoef(**kw),
        "spearman": reg.SpearmanCorrCoef(**kw),
        "minmax_mae": MinMaxMetric(reg.MeanAbsoluteError(**kw)),
        "bootstrap_mse": BootStrapper(reg.MeanSquaredError(**kw), num_bootstraps=BOOTSTRAPS, seed=SEED),
    }


def ratings_phase(torch, bc) -> dict:
    """A recommender's rating-prediction eval at MovieLens-20M test-split size
    (see the module note): 18 regression members on the card and on the CPU,
    the states against each other, the values against float64 oracles, the
    bootstrap against a replay of its draws, the host syncs of the members
    that read the host, and the fused phase."""
    import copy

    from tpumetrics_torch import MetricCollection
    from tpumetrics_torch.functional.regression.spearman import _rank_data
    from tpumetrics_torch.interop import export_state

    label = f"ratings MovieLens-20M test split {RATINGS_N} ratings"
    batches = make_ratings(SEED + 7)

    def collection(device, fused=False):
        return MetricCollection(ratings_members(device), fused_update=fused, device=device)

    dev_batches = [tuple(torch.from_numpy(x).cuda() for x in b) for b in batches]
    col = collection("cuda")
    torch.cuda.synchronize()
    bc.launches = 0
    update_ms = []
    for i, batch in enumerate(dev_batches):
        t0 = time.perf_counter()
        if i == 1:  # a steady update: a host sync raises, but in the members named as reading the host
            syncs = {name: count_host_syncs(torch, lambda m=copy.deepcopy(col._modules[name]): m.update(*batch))
                     for name in RATINGS_HOST_READERS}
            t0 = time.perf_counter()
            torch.cuda.set_sync_debug_mode("error")
            try:
                with host_readers_exempt(torch, col, RATINGS_HOST_READERS):
                    col.update(*batch)
            finally:
                torch.cuda.set_sync_debug_mode(0)
        else:
            col.update(*batch)
        torch.cuda.synchronize()
        update_ms.append((time.perf_counter() - t0) * 1e3)
    t0 = time.perf_counter()
    values = col.compute()
    torch.cuda.synchronize()
    compute_ms = (time.perf_counter() - t0) * 1e3
    groups = sorted(sorted(g) for g in col.compute_groups.values())
    check(["ccc", "pearson"] in groups and ["mse", "rmse"] in groups and len(groups) == 16, f"{label}: compute groups {groups}")
    check(bc.launches == 0, f"{label}: {bc.launches} binned_confusion launches, expected none")

    cpu = collection("cpu")
    for batch in batches:
        cpu.update(*(torch.from_numpy(x) for x in batch))
    cpu.compute()  # MinMax's extrema refresh in compute, as they did on the card
    p_all = np.concatenate([b[0] for b in batches])
    t_all = np.concatenate([b[1] for b in batches])
    scales = cancel_scales(p_all, t_all)
    state_err = check_same_states(label, export_state(col), export_state(cpu), scales)

    o = regression_oracle(p_all, t_all)
    oracle = {
        "mse": o["mse"], "rmse": np.sqrt(o["mse"]), "mae": o["mae_all"], "mape": o["mape"], "smape": o["smape"],
        "wmape": o["wmape"], "msle": o["msle"], "log_cosh": o["log_cosh"], "minkowski": o["minkowski3"],
        "tweedie": o["tweedie15"], "r2": 1 - o["rss_over_tss"], "rse": o["rss_over_tss"], "ev": o["ev"],
        "pearson": o["pearson"], "ccc": o["ccc"], "spearman": o["spearman"],
        "raw": o["mae_all"], "max": o["mae_all"], "min": o["mae_all"],
    }
    tol = {k: (REG_RTOL, 0.0) for k in oracle}
    tol.update({k: (0.0, CORR_ATOL) for k in ("pearson", "ccc", "spearman")})
    tol["r2"] = tol["rse"] = (REG_RTOL, cancel_atol(o, o["rss_over_tss"]))
    tol["ev"] = (REG_RTOL, cancel_atol(o, o["ev_ratio"]))
    tol["log_cosh"] = (REG_RTOL, log_cosh_atol(o))
    check(set(values) == set(oracle) | {"mean", "std"}, f"{label}: keys {sorted(values)}")
    worst = check_values(label, values, oracle, tol)
    boot = replay_bootstrap_mse(batches, BOOTSTRAPS, SEED)
    check_values(f"{label} bootstrap", values, {"mean": boot.mean(), "std": boot.std(ddof=1)},
                 {"mean": (REG_RTOL, 0.0), "std": (REG_RTOL, 0.0)})

    # Spearman's compute is two sorts of the 2M ratings: one of them timed apart (device time, L2 flushed)
    flush = l2_flush(torch)
    all_preds = torch.from_numpy(p_all).cuda()
    rank_ms, rank_host_ms = cuda_ms(torch, lambda: _rank_data(all_preds), 10, flush)
    del flush, all_preds
    steady = update_ms[2:]
    print(
        f"ratings phase: {label}: {len(batches)} batches of {RATINGS_BATCH} (the last {len(batches[-1][0])}),"
        f" 18 members in {len(groups)} compute groups; states equal to the CPU run's (int32 identical, float32"
        f" sums worst {state_err:.2e} relative); values against float64 oracles, worst share of the tolerance"
        f" {max(worst.values()):.3f} ({max(worst, key=worst.get)}); RMSE {float(values['rmse']):.6f} R2"
        f" {float(values['r2']):.6f} Pearson {float(values['pearson']):.6f} Spearman {float(values['spearman']):.6f};"
        f" bootstrap mean {float(values['mean']):.6f} std {float(values['std']):.3e} equal to a numpy replay of"
        f" its draws; update 2 with host syncs made errors but in {sorted(RATINGS_HOST_READERS)}, whose host"
        f" syncs in one update are {syncs} ({'; '.join(f'{k}: {v}' for k, v in RATINGS_HOST_READERS.items())});"
        f" first update {update_ms[0]:.3f} ms, steady median {np.median(steady):.3f} ms; compute() {compute_ms:.3f}"
        f" ms, of it one 2M-element average-rank pass {rank_ms:.3f} ms on the device ({rank_host_ms:.3f} ms host)",
        flush=True,
    )
    profile_step(torch, col, dev_batches[2], label)
    del col, cpu
    fused = fused_pair(torch, label, lambda f: collection("cuda", f), dev_batches,
                       exempt={"bootstrap_mse": RATINGS_HOST_READERS["bootstrap_mse"]})
    check(fused["eager_leaders"] == ["bootstrap_mse", "minmax_mae", "spearman"], f"{label}: eager leaders {fused['eager_leaders']}")
    return {"launches": 0, "update_ms": update_ms, "compute_ms": compute_ms, "rank_2m_ms": rank_ms,
            "host_syncs": syncs, "oracle_worst": worst, "fused": fused}


# QM9 (Ramakrishnan et al. 2014; 130,831 molecules), DimeNet's split 110,000 / 10,000 / rest: the test set.
# The 12 targets and, per target, a mean and standard deviation of the dataset's order (its units);
# U, H and G follow U0 closely, as the four energies do.
QM9_TARGETS = ["mu", "alpha", "homo", "lumo", "gap", "r2", "zpve", "U0", "U", "H", "G", "Cv"]
QM9_MEAN = np.array([2.706, 75.19, -0.2400, 0.0112, 0.2511, 1189.5, 0.1485, -411.54, -411.53, -411.53, -411.57, 31.60])
QM9_STD = np.array([1.530, 8.188, 0.0221, 0.0469, 0.0475, 279.8, 0.0333, 40.06, 40.06, 40.06, 40.06, 4.062])
QM9_N, QM9_BATCH = 10_831, 1024
QM9_EPOCH_NOISE = [0.3, 0.1, 0.03]  # prediction error per epoch, in target standard deviations


def make_qm9(seed: int):
    """The test molecules' 12 targets (float32) and, per epoch, predictions
    with the epoch's error, in batches."""
    rng = np.random.default_rng(seed)
    z = rng.standard_normal((QM9_N, 12))
    z[:, 8:11] = z[:, 7:8] + 0.01 * rng.standard_normal((QM9_N, 3))
    target = (QM9_MEAN + QM9_STD * z).astype(np.float32)
    epochs = []
    for noise in QM9_EPOCH_NOISE:
        preds = (target + noise * QM9_STD * rng.standard_normal((QM9_N, 12))).astype(np.float32)
        epochs.append([(preds[i : i + QM9_BATCH], target[i : i + QM9_BATCH]) for i in range(0, QM9_N, QM9_BATCH)])
    return epochs


def qm9_members(device) -> dict:
    import tpumetrics_torch.regression as reg
    from tpumetrics_torch.wrappers import ClasswiseWrapper, MultioutputWrapper

    kw, d = {"device": device}, len(QM9_TARGETS)
    return {
        "mae_per_target": MultioutputWrapper(reg.MeanAbsoluteError(**kw), d, remove_nans=False),
        "mse": reg.MeanSquaredError(num_outputs=d, **kw), "log_cosh": reg.LogCoshError(num_outputs=d, **kw),
        "rse": reg.RelativeSquaredError(num_outputs=d, **kw),
        "r2": ClasswiseWrapper(reg.R2Score(num_outputs=d, multioutput="raw_values", **kw), labels=QM9_TARGETS),
        "ev": reg.ExplainedVariance(multioutput="raw_values", **kw),
        "pearson": reg.PearsonCorrCoef(num_outputs=d, **kw), "spearman": reg.SpearmanCorrCoef(num_outputs=d, **kw),
        "kendall": reg.KendallRankCorrCoef(num_outputs=d, variant="b", t_test=True, **kw),
        "cosine": reg.CosineSimilarity(reduction="mean", **kw),
    }


def qm9_multitask(device):
    import tpumetrics_torch.regression as reg
    from tpumetrics_torch.wrappers import MultitaskWrapper

    return MultitaskWrapper({"u0": reg.MeanAbsoluteError(device=device),
                             "all": reg.MeanSquaredError(num_outputs=len(QM9_TARGETS), device=device)})


def multitask_batch(p, t):
    u0 = QM9_TARGETS.index("U0")
    return {"u0": p[:, u0], "all": p}, {"u0": t[:, u0], "all": t}


def multioutput_phase(torch, bc) -> dict:
    """Molecular property regression at QM9 test size (see the module note):
    a ``MetricTracker`` over three epochs of shrinking error, then the last
    epoch through the stream's members and a ``MultitaskWrapper`` on the card
    and on the CPU, the states against each other, the values against
    float64 oracles, the host syncs, and the fused phase."""
    from tpumetrics_torch import MetricCollection
    from tpumetrics_torch.functional.regression import kendall_rank_corrcoef
    from tpumetrics_torch.interop import export_state
    from tpumetrics_torch.regression import MeanAbsoluteError, R2Score, RelativeSquaredError
    from tpumetrics_torch.wrappers import MetricTracker, MultioutputWrapper

    d = len(QM9_TARGETS)
    label = f"multi-output QM9 test split {QM9_N} molecules x {d} targets"
    epochs = make_qm9(SEED + 11)
    dev_epochs = [[tuple(torch.from_numpy(x).cuda() for x in b) for b in e] for e in epochs]

    tracker = MetricTracker(MetricCollection({"r2": R2Score(num_outputs=d, device="cuda"),
                                              "rse": RelativeSquaredError(num_outputs=d, device="cuda")}, device="cuda"),
                            maximize=[True, False])
    for dev_batches in dev_epochs:
        tracker.increment()
        for batch in dev_batches:
            tracker.update(*batch)
    best, best_step = tracker.best_metric(return_step=True)
    check(best_step == {"r2": 2, "rse": 2}, f"{label}: tracker's best steps {best_step}, expected the last epoch")

    batches, dev_batches = epochs[-1], dev_epochs[-1]

    def collection(device, fused=False):
        return MetricCollection(qm9_members(device), fused_update=fused, device=device)

    col, task = collection("cuda"), qm9_multitask("cuda")
    torch.cuda.synchronize()
    bc.launches = 0
    update_ms = []
    for i, (p, t) in enumerate(dev_batches):
        t0 = time.perf_counter()
        if i == 1:  # a steady update: no member may read the host
            torch.cuda.set_sync_debug_mode("error")
        try:
            col.update(p, t)
            task.update(*multitask_batch(p, t))
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        update_ms.append((time.perf_counter() - t0) * 1e3)
    t0 = time.perf_counter()
    values = col.compute()
    torch.cuda.synchronize()
    compute_ms = (time.perf_counter() - t0) * 1e3
    task_values = task.compute()
    groups = sorted(sorted(g) for g in col.compute_groups.values())
    check(["cosine", "kendall", "spearman"] in groups and len(groups) == 8, f"{label}: compute groups {groups}")
    check(bc.launches == 0, f"{label}: {bc.launches} binned_confusion launches, expected none")
    nan_rows = MultioutputWrapper(MeanAbsoluteError(device="cuda"), d)
    nan_row_syncs = count_host_syncs(torch, lambda: nan_rows.update(*dev_batches[1]))

    cpu, cpu_task = collection("cpu"), qm9_multitask("cpu")
    for p, t in batches:
        p, t = torch.from_numpy(p), torch.from_numpy(t)
        cpu.update(p, t)
        cpu_task.update(*multitask_batch(p, t))
    cpu.compute()
    p_all = np.concatenate([b[0] for b in batches])
    t_all = np.concatenate([b[1] for b in batches])
    p64, t64 = p_all.astype(np.float64), t_all.astype(np.float64)
    dx, dy = p64 - p64.mean(0), t64 - t64.mean(0)
    scales = {
        **cancel_scales(p_all, t_all), "ev.sum_target": np.abs(t64).sum(0), "r2.sum_error": np.abs(t64).sum(0),
        "rse.sum_obs": np.abs(t64).sum(0), "pearson.mean_x": np.abs(p64).mean(0), "pearson.mean_y": np.abs(t64).mean(0),
        "pearson.corr_xy": np.abs(dx * dy).sum(0),
    }
    state_err = check_same_states(label, export_state(col), export_state(cpu), scales)
    check_same_states(f"{label} multitask", export_state(task), export_state(cpu_task), {})

    o = regression_oracle(p_all, t_all)
    oracle = {
        "mae_per_target": o["mae_cols"], "mse": o["mse"], "log_cosh": o["log_cosh"], "rse": o["rss_over_tss"].mean(),
        "ev": o["ev"], "pearson": o["pearson"], "spearman": o["spearman"], "kendall[0]": o["kendall_tau"],
        "kendall[1]": o["kendall_p"], "cosine": o["cosine"],
        **{f"r2score_{name}": 1 - o["rss_over_tss"][i] for i, name in enumerate(QM9_TARGETS)},
    }
    tol = {k: (REG_RTOL, 0.0) for k in oracle}
    tol.update({k: (0.0, CORR_ATOL) for k in ("pearson", "spearman", "kendall[0]", "cosine")})
    tol["kendall[1]"] = (0.0, PVALUE_ATOL)
    tol["rse"] = (REG_RTOL, cancel_atol(o, o["rss_over_tss"]).mean())
    tol["ev"] = (REG_RTOL, cancel_atol(o, o["ev_ratio"]))
    tol["log_cosh"] = (REG_RTOL, log_cosh_atol(o))
    for i, name in enumerate(QM9_TARGETS):
        tol[f"r2score_{name}"] = (REG_RTOL, cancel_atol(o, o["rss_over_tss"])[i])
    check(set(flat_values(values)) == set(oracle), f"{label}: keys {sorted(flat_values(values))}")
    worst = check_values(label, flat_values(values), oracle, tol)
    u0 = QM9_TARGETS.index("U0")
    check_values(f"{label} multitask", task_values, {"u0": o["mae_cols"][u0], "all": o["mse"]},
                 {"u0": (REG_RTOL, 0.0), "all": (REG_RTOL, 0.0)})

    # Kendall's compute apart: 12 columns, each 22 chunks of 512 rows against all 10,831 (host clock)
    all_p, all_t = torch.from_numpy(p_all).cuda(), torch.from_numpy(t_all).cuda()
    kendall_ms = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        kendall_rank_corrcoef(all_p, all_t, t_test=True)
        torch.cuda.synchronize()
        kendall_ms.append((time.perf_counter() - t0) * 1e3)
    steady = update_ms[1:-1]
    r2 = flat_values(values)
    print(
        f"multi-output phase: {label}: {len(batches)} batches of {QM9_BATCH} (the last {len(batches[-1][0])}),"
        f" {len(qm9_members('cpu'))} members in {len(groups)} compute groups and a MultitaskWrapper (u0 MAE, per-target"
        f" MSE); tracker over {len(epochs)} epochs of error {QM9_EPOCH_NOISE} std: best {best} at steps {best_step};"
        f" states equal to the CPU run's (int32 identical, float32 sums worst {state_err:.2e} relative); values"
        f" against float64 oracles, worst share of the tolerance {max(worst.values()):.3f} ({max(worst, key=worst.get)});"
        f" R2 U0 {float(r2['r2score_U0']):.6f} homo {float(r2['r2score_homo']):.6f}; Kendall tau-b"
        f" {[round(float(x), 4) for x in values['kendall'][0].cpu()]}; update 2 free of host syncs (with the"
        f" MultitaskWrapper); MultioutputWrapper(remove_nans=True) reads the host {nan_row_syncs} times in one update"
        f" (NaN-row removal by boolean indexing, twice per output); first update {update_ms[0]:.3f} ms, steady median"
        f" {np.median(steady):.3f} ms; compute() {compute_ms:.3f} ms, of it Kendall's 12 x 22-chunk pass"
        f" {np.median(kendall_ms):.3f} ms (host clock, median of 3)",
        flush=True,
    )
    profile_step(torch, col, dev_batches[1], label)
    del col, cpu
    fused = fused_pair(torch, label, lambda f: collection("cuda", f), dev_batches)
    check(fused["eager_leaders"] == ["cosine", "mae_per_target", "r2"], f"{label}: eager leaders {fused['eager_leaders']}")
    return {"launches": 0, "update_ms": update_ms, "compute_ms": compute_ms, "kendall_ms": float(np.median(kendall_ms)),
            "nan_row_syncs": nan_row_syncs, "tracker_steps": best_step, "oracle_worst": worst, "fused": fused}


# ImageNet-1k val (50,000 images, 50 per class) at the size deep-clustering work evaluates on (SCAN, Van
# Gansbeke et al., ECCV 2020, Table 5: 1000 clusters, NMI/AMI/ARI over 2048-wide ResNet-50 pooled features).
CLUSTER_N, CLUSTER_K, CLUSTER_D, CLUSTER_BATCH = 50_000, 1000, 2048, 4096
CLUSTER_REASSIGNED = 0.45  # share of points given a random cluster: NMI about 0.70, ARI about 0.30 (SCAN: 0.72, 0.28)
CLUSTER_RTOL = 1e-5  # MI and Rand families and the intrinsic metrics against float64 oracles (float32 sums)
CLUSTER_AMI_ATOL = 1e-5  # AMI: MI's float32 error over the normalizer less E[MI]
EMI_BUDGET = 1 << 23  # the port's n_ij chunking of the expected-MI grid, which the oracle follows
CLUSTER_GROUPS = [  # the list members share their states, the capacity copies theirs
    ["ami", "ari", "completeness", "fmi", "homogeneity", "mi", "nmi", "rand", "v_measure"],
    ["cap_ami", "cap_ari", "cap_mi", "cap_v_measure"], ["cap_ch"], ["ch", "db", "dunn"],
]


def make_clustering(seed: int):
    """Targets (50 per class, shuffled), predicted clusters (the targets
    under a random relabelling, ``CLUSTER_REASSIGNED`` of them moved to a
    random cluster) and float32 embeddings (a Gaussian mean per class plus
    unit noise), in batches of ``CLUSTER_BATCH``."""
    rng = np.random.default_rng(seed)
    target = rng.permutation(np.repeat(np.arange(CLUSTER_K), CLUSTER_N // CLUSTER_K))
    preds = rng.permutation(CLUSTER_K)[target]
    moved = rng.random(CLUSTER_N) < CLUSTER_REASSIGNED
    preds[moved] = rng.integers(0, CLUSTER_K, int(moved.sum()))
    emb = rng.standard_normal((CLUSTER_N, CLUSTER_D), dtype=np.float32)
    emb += rng.standard_normal((CLUSTER_K, CLUSTER_D), dtype=np.float32)[target]
    return preds, target, emb


def emi_oracle(a: np.ndarray, b: np.ndarray, n: float) -> float:
    """Expected mutual information of two clusterings with marginals ``a``
    and ``b``, in float64 (scipy's ``gammaln``), over the n_ij grid in the
    port's chunks; each distinct (a_i, b_j) pair is evaluated once and
    weighted by how often it occurs, the same sum in other order."""
    from scipy.special import gammaln

    av, ac = np.unique(a[a > 0], return_counts=True)
    bv, bc_ = np.unique(b[b > 0], return_counts=True)
    m = int(max(a.max(), b.max())) + 1
    chunk = max(1, min(m, EMI_BUDGET // (a.size * b.size)))
    A, B = av[:, None, None], bv[None, :, None]
    weight = (ac[:, None] * bc_[None, :]).astype(np.float64)[:, :, None]
    total = 0.0
    for lo in range(0, m, chunk):
        nij = np.arange(lo, min(lo + chunk, m), dtype=np.float64)[None, None, :]
        mask = (nij >= np.maximum(1.0, A + B - n)) & (nij < np.minimum(A, B) + 1)
        s = np.where(mask, nij, 1.0)
        gln = (gammaln(A + 1) + gammaln(B + 1) + gammaln(n - A + 1) + gammaln(n - B + 1) - gammaln(s + 1)
               - gammaln(n + 1) - gammaln(np.where(mask, A - s + 1, 1.0)) - gammaln(np.where(mask, B - s + 1, 1.0))
               - gammaln(np.where(mask, n - A - B + s + 1, 1.0)))
        with np.errstate(over="ignore", invalid="ignore"):  # off the mask only, where the terms are dropped
            terms = s / n * (np.log(n * s) - np.log(A) - np.log(B)) * np.exp(gln)
            total += float(np.sum(np.where(mask, terms * weight, 0.0)))
    return total


def label_pair_oracle(preds: np.ndarray, target: np.ndarray) -> dict:
    """float64 values of the label-pair members (sklearn's formulas, in numpy)."""
    k = int(max(preds.max(), target.max())) + 1
    table = np.bincount(target * k + preds, minlength=k * k).reshape(k, k).astype(np.float64)
    n = table.sum()
    a, b = table.sum(1), table.sum(0)
    nz = table > 0
    mi = float(np.sum(table[nz] / n * (np.log(n * table[nz]) - np.log(np.outer(a, b)[nz]))))
    h_t = float(-np.sum(a[a > 0] / n * np.log(a[a > 0] / n)))
    h_p = float(-np.sum(b[b > 0] / n * np.log(b[b > 0] / n)))
    emi = emi_oracle(a, b, n)
    sum_ij, sum_a, sum_b, pairs = (table * (table - 1)).sum() / 2, (a * (a - 1)).sum() / 2, (b * (b - 1)).sum() / 2, n * (n - 1) / 2
    expected = sum_a * sum_b / pairs
    hom, com = mi / h_t, mi / h_p
    return {
        "mi": mi, "nmi": mi / ((h_t + h_p) / 2), "ami": (mi - emi) / ((h_t + h_p) / 2 - emi),
        "rand": 1 + (2 * sum_ij - sum_a - sum_b) / pairs, "ari": (sum_ij - expected) / ((sum_a + sum_b) / 2 - expected),
        "fmi": sum_ij / np.sqrt(sum_a * sum_b), "homogeneity": hom, "completeness": com,
        "v_measure": 2 * hom * com / (hom + com), "emi": emi,
    }


def intrinsic_oracle(emb: np.ndarray, labels: np.ndarray) -> dict:
    """float64 Calinski-Harabasz, Davies-Bouldin and Dunn (p=2) of the
    embeddings' clustering: centroids from sorted segment sums, distances to
    centroids in row chunks, centroid distances from the float64 Gram matrix."""
    order = np.argsort(labels, kind="stable")
    counts = np.bincount(labels, minlength=CLUSTER_K)
    live = np.flatnonzero(counts)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])[live]
    centroids = np.add.reduceat(emb[order].astype(np.float64), starts, axis=0) / counts[live, None]
    slot = np.full(CLUSTER_K, -1)
    slot[live] = np.arange(live.size)
    dist = np.concatenate([
        np.linalg.norm(emb[i : i + 8192].astype(np.float64) - centroids[slot[labels[i : i + 8192]]], axis=1)
        for i in range(0, emb.shape[0], 8192)
    ])
    mean = emb.astype(np.float64).mean(0)
    k, n = live.size, emb.shape[0]
    between = float((counts[live] * ((centroids - mean) ** 2).sum(1)).sum())
    within = float((dist**2).sum())
    sq = (centroids**2).sum(1)
    cdist = np.sqrt(np.maximum(sq[:, None] + sq[None, :] - 2 * centroids @ centroids.T, 0.0))
    intra = np.bincount(slot[labels], weights=dist, minlength=k) / counts[live]
    ratio = (intra[:, None] + intra[None, :]) / np.where(np.eye(k, dtype=bool), np.inf, cdist)
    return {
        "ch": between * (n - k) / (within * (k - 1)), "db": float(ratio.max(1).mean()),
        "dunn": float(cdist[np.triu_indices(k, 1)].min() / dist.max()),
    }


def pair_members(device) -> dict:
    """The label-pair members: nine on list states (class spaces from the
    data) and a capacity copy of four (declared class spaces, live
    MaskedBuffers of the whole stream's rows)."""
    import tpumetrics_torch.clustering as cl

    kw = {"device": device}
    spaces = {"num_classes_preds": CLUSTER_K, "num_classes_target": CLUSTER_K, **kw}
    return {
        "mi": cl.MutualInfoScore(**kw), "nmi": cl.NormalizedMutualInfoScore(**kw),
        "ami": cl.AdjustedMutualInfoScore(**kw), "rand": cl.RandScore(**kw), "ari": cl.AdjustedRandScore(**kw),
        "fmi": cl.FowlkesMallowsIndex(**kw), "homogeneity": cl.HomogeneityScore(**kw),
        "completeness": cl.CompletenessScore(**kw), "v_measure": cl.VMeasureScore(**kw),
        "cap_mi": buffered(cl.MutualInfoScore(**spaces)), "cap_ami": buffered(cl.AdjustedMutualInfoScore(**spaces)),
        "cap_v_measure": buffered(cl.VMeasureScore(**spaces)), "cap_ari": buffered(cl.AdjustedRandScore(**spaces)),
    }


def intrinsic_members(device) -> dict:
    """Calinski-Harabasz, Davies-Bouldin and Dunn (p=2) on list states, and a
    capacity copy of Calinski-Harabasz (declared 1000 clusters)."""
    import tpumetrics_torch.clustering as cl

    kw = {"device": device}
    return {
        "ch": cl.CalinskiHarabaszScore(**kw), "db": cl.DaviesBouldinScore(**kw), "dunn": cl.DunnIndex(p=2, **kw),
        "cap_ch": buffered(cl.CalinskiHarabaszScore(num_labels=CLUSTER_K, **kw)),
    }


def buffered(metric, rows: int = CLUSTER_N):
    """``metric`` with its list states in MaskedBuffers of ``rows`` rows (the
    stream's), installed as its live states: its update appends to them with
    no host read, and a fused collection captures it."""
    from tpumetrics_torch.interop import load_state

    for name in metric._defaults:
        metric.set_state_capacity(name, rows, feature_shape=(CLUSTER_D,) if name == "data" else ())
    load_state(metric, metric.init_state())
    return metric


def clustering_phase(torch, bc) -> dict:
    """ImageNet-size clustering evaluation (see the module note): the
    label-pair and intrinsic collections on the card and on the CPU, their
    states against each other, the values against float64 oracles, a
    steady update free of host syncs, the compute time and the device time of
    its main parts, and the fused phase of each collection."""
    import importlib

    from tpumetrics_torch import MetricCollection
    from tpumetrics_torch.functional.clustering.utils import (
        _centroid_distances,
        _cluster_centroids,
        calculate_contingency_matrix,
    )
    from tpumetrics_torch.interop import export_state

    ami_mod = importlib.import_module("tpumetrics_torch.functional.clustering.adjusted_mutual_info_score")
    label = f"clustering ImageNet-1k val {CLUSTER_N} x {CLUSTER_K} clusters x {CLUSTER_D}-d"
    preds, target, emb = make_clustering(SEED + 17)
    spans = range(0, CLUSTER_N, CLUSTER_BATCH)
    pair_batches = [(preds[i : i + CLUSTER_BATCH], target[i : i + CLUSTER_BATCH]) for i in spans]
    emb_batches = [(emb[i : i + CLUSTER_BATCH], preds[i : i + CLUSTER_BATCH]) for i in spans]
    dev_pairs = [tuple(torch.from_numpy(x).cuda() for x in b) for b in pair_batches]
    dev_embs = [tuple(torch.from_numpy(x).cuda() for x in b) for b in emb_batches]

    def pair_collection(device, fused=False):
        return MetricCollection(pair_members(device), fused_update=fused, device=device)

    def intrinsic_collection(device, fused=False):
        return MetricCollection(intrinsic_members(device), fused_update=fused, device=device)

    pairs, intrinsic = pair_collection("cuda"), intrinsic_collection("cuda")
    torch.cuda.synchronize()
    bc.launches = 0
    update_ms = []
    for i, (pb, eb) in enumerate(zip(dev_pairs, dev_embs)):
        t0 = time.perf_counter()
        if i == 1:  # a steady update: no member may read the host
            torch.cuda.set_sync_debug_mode("error")
        try:
            pairs.update(*pb)
            intrinsic.update(*eb)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        update_ms.append((time.perf_counter() - t0) * 1e3)
    compute_ms, values = {}, {}
    for name, col in (("pairs", pairs), ("intrinsic", intrinsic)):
        t0 = time.perf_counter()
        values.update(col.compute())
        torch.cuda.synchronize()
        compute_ms[name] = (time.perf_counter() - t0) * 1e3
    for col in (pairs, intrinsic):  # the same states computed again: the same values, bit for bit
        for m in col._modules.values():
            m._computed = None
    again = {**pairs.compute(), **intrinsic.compute()}
    check(all(torch.equal(again[k], v) for k, v in values.items()), f"{label}: a second compute gave other values")
    groups = sorted(sorted(g) for col in (pairs, intrinsic) for g in col.compute_groups.values())
    check(groups == CLUSTER_GROUPS, f"{label}: compute groups {groups}")
    check(bc.launches == 0, f"{label}: {bc.launches} binned_confusion launches, expected none")

    cpu_pairs, cpu_intrinsic = pair_collection("cpu"), intrinsic_collection("cpu")
    for pb, eb in zip(pair_batches, emb_batches):
        cpu_pairs.update(*(torch.from_numpy(x) for x in pb))
        cpu_intrinsic.update(*(torch.from_numpy(x) for x in eb))
    for col, cpu in ((pairs, cpu_pairs), (intrinsic, cpu_intrinsic)):
        check_same_states(label, export_state(col), export_state(cpu))
    del cpu_pairs, cpu_intrinsic

    o = {**label_pair_oracle(preds, target), **intrinsic_oracle(emb, preds)}
    oracle = {k: o[k] for k in ("mi", "nmi", "ami", "rand", "ari", "fmi", "homogeneity", "completeness", "v_measure", "ch", "db", "dunn")}
    oracle.update({f"cap_{k}": o[k] for k in ("mi", "ami", "v_measure", "ari", "ch")})
    tol = {k: (CLUSTER_RTOL, 0.0) for k in oracle}
    tol["ami"] = tol["cap_ami"] = (0.0, CLUSTER_AMI_ATOL)
    check(set(values) == set(oracle), f"{label}: keys {sorted(values)}")
    worst = check_values(label, values, oracle, tol)

    # compute's main parts on the device (CUDA events, L2 flushed): the EMI grid, the centroid sums, the distances
    flush = l2_flush(torch)
    all_p, all_t = torch.from_numpy(preds).cuda(), torch.from_numpy(target).cuda()
    all_e = torch.from_numpy(emb).cuda()
    table = calculate_contingency_matrix(all_p, all_t, None, CLUSTER_K, CLUSTER_K)
    emi = ami_mod.expected_mutual_info_score(table, table.sum())
    check(abs(float(emi) - o["emi"]) <= 1e-6 * abs(o["emi"]), f"{label}: E[MI] {float(emi)} vs float64 oracle {o['emi']}")
    parts = {
        "contingency": cuda_ms(torch, lambda: calculate_contingency_matrix(all_p, all_t, None, CLUSTER_K, CLUSTER_K), 5, flush),
        "emi_grid": cuda_ms(torch, lambda: ami_mod.expected_mutual_info_score(table, table.sum()), 3, flush),
        "centroid_sums": cuda_ms(torch, lambda: _cluster_centroids(all_e, all_p, CLUSTER_K), 3, flush),
    }
    centroids, _ = _cluster_centroids(all_e, all_p, CLUSTER_K)
    parts["centroid_distances"] = cuda_ms(torch, lambda: _centroid_distances(centroids, 2), 3, flush)
    del flush, all_e, centroids
    steady = update_ms[1:-1]
    print(
        f"clustering phase: {label}: {len(pair_batches)} batches of {CLUSTER_BATCH} (the last {len(pair_batches[-1][0])}),"
        f" {CLUSTER_REASSIGNED:.0%} of the points reassigned at random; reduced: none; {len(pairs._modules)} label-pair"
        f" and {len(intrinsic._modules)} intrinsic members in {len(groups)} compute groups; states equal to the CPU"
        f" run's (labels, data and buffers identical); values against float64 numpy/scipy oracles, worst share of the"
        f" tolerance {max(worst.values()):.3f} ({max(worst, key=worst.get)}); NMI {float(values['nmi']):.6f} AMI"
        f" {float(values['ami']):.6f} ARI {float(values['ari']):.6f} V {float(values['v_measure']):.6f}"
        f" CH {float(values['ch']):.4f} DB {float(values['db']):.6f} Dunn {float(values['dunn']):.6f};"
        f" E[MI] {float(emi):.6f} (oracle {o['emi']:.6f}); a second compute identical; update 2 free of host syncs;"
        f" first update {update_ms[0]:.3f} ms, steady median {np.median(steady):.3f} ms; compute() pairs"
        f" {compute_ms['pairs']:.3f} ms, intrinsic {compute_ms['intrinsic']:.3f} ms (host clock); device time of one"
        f" call (median, L2 flushed; host time to make it): "
        + ", ".join(f"{k} {v[0]:.3f} ms ({v[1]:.3f} ms)" for k, v in parts.items()),
        flush=True,
    )
    profile_step(torch, pairs, dev_pairs[1], f"{label} label pairs")
    profile_step(torch, intrinsic, dev_embs[1], f"{label} intrinsic")
    del pairs, intrinsic
    fused = fused_pair(torch, f"{label} label pairs", lambda f: pair_collection("cuda", f), dev_pairs)
    list_leader = [g[0] for g in fused["groups"] if not g[0].startswith("cap_")]  # the list states' group: eager
    check(fused["eager_leaders"] == list_leader, f"{label}: eager leaders {fused['eager_leaders']}")
    fused_intrinsic = fused_pair(torch, f"{label} intrinsic", lambda f: intrinsic_collection("cuda", f), dev_embs)
    check(fused_intrinsic["modes"]["replayed"] >= 1 and fused_intrinsic["guarded_replay"], f"{label} intrinsic: no checked graph replay")
    list_leader = [g[0] for g in fused_intrinsic["groups"] if not g[0].startswith("cap_")]
    check(fused_intrinsic["eager_leaders"] == list_leader, f"{label}: intrinsic eager leaders {fused_intrinsic['eager_leaders']}")
    return {"launches": 0, "update_ms": update_ms, "compute_ms": compute_ms, "parts_ms": parts, "oracle_worst": worst,
            "values": {k: float(v) for k, v in values.items()}, "fused": fused, "fused_intrinsic": fused_intrinsic}


# UCI Adult (Becker & Kohavi 1996; train and test, 48,842 rows): its nine categorical columns, their
# cardinalities, and the shares of missing values ("?") in three of them.
ADULT_N, ADULT_BATCH = 48_842, 4096
ADULT_COLUMNS = [("workclass", 9), ("education", 16), ("marital-status", 7), ("occupation", 15),
                 ("relationship", 6), ("race", 5), ("sex", 2), ("native-country", 42), ("income", 2)]
ADULT_MISSING = {"workclass": 0.0573, "occupation": 0.0575, "native-country": 0.0175}
ADULT_UNKNOWN = 15.0  # a missing occupation is its own category, the 16th of the pair's class space
# CIFAR-10H (Peterson et al., ICCV 2019): 10,000 CIFAR-10 test images, 10 classes, about 50 human labels each
RATERS_N, RATERS_K, RATERS, RATERS_BATCH = 10_000, 10, 50, 1024
RATER_ACCURACY = 0.95  # the human labels' accuracy, about CIFAR-10H's
NOMINAL_RTOL = 1e-5  # float32 chi-squared, entropies and kappa against float64 oracles
THEIL_ATOL = 5e-6  # U's two entropies (up to log 42) round to a few 1e-7 each before their difference


def make_adult(seed: int) -> np.ndarray:
    """``(48,842, 9)`` float32 category codes: each column's categories with
    geometric shares in a random order, occupation following education in
    half the rows, NaN at each column's missing share."""
    rng = np.random.default_rng(seed)
    cols = []
    for _, k in ADULT_COLUMNS:
        shares = 0.7 ** rng.permutation(k)
        cols.append(rng.choice(k, size=ADULT_N, p=shares / shares.sum()))
    edu, occ = 1, 3
    follows = rng.random(ADULT_N) < 0.5
    cols[occ] = np.where(follows, rng.integers(0, 15, 16)[cols[edu]], cols[occ])
    out = np.stack(cols, 1).astype(np.float32)
    for j, (name, _) in enumerate(ADULT_COLUMNS):
        out[rng.random(ADULT_N) < ADULT_MISSING.get(name, 0.0), j] = np.nan
    return out


def make_raters(seed: int):
    """CIFAR-10H's geometry: 1000 images per class, each labelled by 50
    raters who are right at ``RATER_ACCURACY`` and else pick another class;
    as ``(N, 10)`` int32 counts and as ``(N, 10, 50)`` float32 scores whose
    argmax per rater is that rater's label."""
    rng = np.random.default_rng(seed)
    truth = rng.permutation(np.repeat(np.arange(RATERS_K), RATERS_N // RATERS_K))
    wrong = (truth[:, None] + rng.integers(1, RATERS_K, (RATERS_N, RATERS))) % RATERS_K
    choice = np.where(rng.random((RATERS_N, RATERS)) < RATER_ACCURACY, truth[:, None], wrong)
    counts = np.zeros((RATERS_N, RATERS_K), np.int32)
    np.add.at(counts, (np.arange(RATERS_N)[:, None], choice), 1)
    scores = (rng.random((RATERS_N, RATERS_K, RATERS), dtype=np.float32) * 0.5)
    scores[np.arange(RATERS_N)[:, None], choice, np.arange(RATERS)[None, :]] += 0.5
    return counts, scores


def sqrt_tol(value: float, err: float, denom: float) -> float:
    """Tolerance of ``value = sqrt(x / denom)`` when ``x`` carries an
    absolute error ``err``: ``NOMINAL_RTOL`` relative, plus the bound
    ``|sqrt(a) - sqrt(b)| <= min(sqrt(|a - b|), |a - b| / sqrt(a))``."""
    e = err / denom
    return NOMINAL_RTOL * value + (np.sqrt(e) if value == 0 else min(np.sqrt(e), e / value))


def association_oracle(x: np.ndarray, y: np.ndarray) -> dict:
    """float64 Cramer's V and Tschuprow's T (with and without Bergsma's bias
    correction, Yates' at one degree of freedom), Pearson's C and Theil's
    U(x | y) of two code columns (negative codes dropped), each with its
    tolerance. phi² in float32 carries the rounding of each expected count
    (a few float32 steps of E in each ``(O - E)²/E``, so about 5e-7 of
    ``Σ|O - E|``) and 1e-6 of chi² from the sum; a bias-corrected phi² also
    1e-6 of the term it subtracts (``sqrt_tol``)."""
    keep = (x >= 0) & (y >= 0)
    x, y = x[keep].astype(np.int64), y[keep].astype(np.int64)
    k = int(max(x.max(), y.max())) + 1
    table = np.bincount(y * k + x, minlength=k * k).reshape(k, k).astype(np.float64)
    n = table.sum()
    rows, cols = table.sum(1), table.sum(0)
    r, c = float((rows > 0).sum()), float((cols > 0).sum())
    expected = np.outer(rows, cols) / n
    pos = expected > 0
    out, tol = {}, {}
    for bias in (False, True):
        obs = table
        if bias and (r - 1) * (c - 1) == 1:
            obs = table + np.sign(expected - table) * np.minimum(0.5, np.abs(expected - table))
        chi2 = float(((obs - expected)[pos] ** 2 / expected[pos]).sum())
        phi2 = chi2 / n
        err = (5e-7 * float(np.abs(obs - expected)[pos].sum()) + 1e-6 * chi2) / n
        if bias:
            sub = (r - 1) * (c - 1) / (n - 1)
            phi2c, rc, cc = max(0.0, phi2 - sub), r - (r - 1) ** 2 / (n - 1), c - (c - 1) ** 2 / (n - 1)
            for key, d in (("cramers_v_bc", min(rc - 1, cc - 1)), ("tschuprows_t_bc", np.sqrt((rc - 1) * (cc - 1)))):
                out[key] = np.sqrt(phi2c / d)
                tol[key] = sqrt_tol(out[key], err + 1e-6 * sub, d)
        else:
            for key, d in (("cramers_v", min(r - 1, c - 1)), ("tschuprows_t", np.sqrt((r - 1) * (c - 1)))):
                out[key] = np.sqrt(phi2 / d)
                tol[key] = sqrt_tol(out[key], err, d)
            out["pearson"] = np.sqrt(phi2 / (1 + phi2))
            tol["pearson"] = sqrt_tol(out["pearson"], err, 1.0)
    p_xy, p_y, p_x = table / n, rows / n, cols / n
    nz = p_xy > 0
    h_x = -float((p_x[p_x > 0] * np.log(p_x[p_x > 0])).sum())
    h_xy = float((p_xy[nz] * (np.log(np.broadcast_to(p_y[:, None], p_xy.shape)[nz]) - np.log(p_xy[nz]))).sum())
    out["theils_u"] = (h_x - h_xy) / h_x
    tol["theils_u"] = NOMINAL_RTOL * abs(out["theils_u"]) + THEIL_ATOL
    return {"values": out, "tol": tol}


def fleiss_oracle(counts: np.ndarray) -> float:
    """float64 Fleiss kappa, with the JAX package's 1e-5 in the denominator."""
    c = counts.astype(np.float64)
    raters = c.sum(1).max()
    p_i = c.sum(0) / (c.shape[0] * raters)
    p_j = ((c**2).sum(1) - raters) / (raters * (raters - 1))
    pe = (p_i**2).sum()
    return (p_j.mean() - pe) / (1 - pe + 1e-5)


def adult_members(device) -> dict:
    import tpumetrics_torch.nominal as nom

    kw = {"num_classes": 16, "nan_strategy": "replace", "nan_replace_value": ADULT_UNKNOWN, "device": device}
    return {
        "cramers_v": nom.CramersV(**kw), "tschuprows_t": nom.TschuprowsT(**kw),
        "pearson": nom.PearsonsContingencyCoefficient(**kw), "theils_u": nom.TheilsU(**kw),
    }


def nominal_phase(torch, bc) -> dict:
    """Association at the size of the datasets it is run on (see the module
    note): the (occupation, education) pair of UCI Adult through the four
    association metrics and all nine columns through the four ``*_matrix``
    functions, and Fleiss kappa of CIFAR-10H's raters in both modes; on the
    card and on the CPU, against float64 oracles, with a steady update free
    of host syncs, the host reads of the matrix loops, and the fused phase."""
    from tpumetrics_torch import MetricCollection
    from tpumetrics_torch.functional import nominal as fn
    from tpumetrics_torch.interop import export_state
    from tpumetrics_torch.nominal import FleissKappa

    label = f"association UCI Adult {ADULT_N} x {len(ADULT_COLUMNS)}, CIFAR-10H {RATERS_N} x {RATERS_K} x {RATERS} raters"
    adult = make_adult(SEED + 19)
    occ, edu = adult[:, 3], adult[:, 1]
    batches = [(occ[i : i + ADULT_BATCH], edu[i : i + ADULT_BATCH]) for i in range(0, ADULT_N, ADULT_BATCH)]
    dev_batches = [tuple(torch.from_numpy(np.ascontiguousarray(x)).cuda() for x in b) for b in batches]

    def collection(device, fused=False):
        return MetricCollection(adult_members(device), fused_update=fused, device=device)

    col = collection("cuda")
    torch.cuda.synchronize()
    bc.launches = 0
    update_ms = []
    for i, batch in enumerate(dev_batches):
        t0 = time.perf_counter()
        if i == 1:  # a steady update: no member may read the host
            torch.cuda.set_sync_debug_mode("error")
        try:
            col.update(*batch)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        update_ms.append((time.perf_counter() - t0) * 1e3)
    t0 = time.perf_counter()
    values = col.compute()
    torch.cuda.synchronize()
    compute_ms = (time.perf_counter() - t0) * 1e3
    groups = sorted(sorted(g) for g in col.compute_groups.values())
    check(groups == [["cramers_v", "pearson", "theils_u", "tschuprows_t"]], f"{label}: compute groups {groups}")
    cpu = collection("cpu")
    for batch in batches:
        cpu.update(*(torch.from_numpy(np.ascontiguousarray(x)) for x in batch))
    got, want = export_state(col), export_state(cpu)
    check(all(np.array_equal(got[k]["confmat"], want[k]["confmat"]) and got[k]["confmat"].dtype == np.float32 for k in want),
          f"{label}: the contingency table differs card vs CPU")

    pair = association_oracle(np.nan_to_num(occ, nan=ADULT_UNKNOWN), edu)  # edu's NaNs: none
    check(not np.isnan(edu).any(), f"{label}: education has missing values")
    oracle = {"cramers_v": pair["values"]["cramers_v_bc"], "tschuprows_t": pair["values"]["tschuprows_t_bc"],
              "pearson": pair["values"]["pearson"], "theils_u": pair["values"]["theils_u"]}
    tol = {"cramers_v": (0.0, pair["tol"]["cramers_v_bc"]), "tschuprows_t": (0.0, pair["tol"]["tschuprows_t_bc"]),
           "pearson": (0.0, pair["tol"]["pearson"]), "theils_u": (0.0, pair["tol"]["theils_u"])}
    worst = check_values(label, values, oracle, tol)

    # the nine columns through the *_matrix functions: missing values replaced by -1, which every table drops
    matrix = torch.from_numpy(adult).cuda()
    codes = np.nan_to_num(adult, nan=-1.0)
    pair_oracles = {(i, j): association_oracle(codes[:, i], codes[:, j])
                    for i in range(adult.shape[1]) for j in range(adult.shape[1]) if i != j}
    matrix_fns = {
        "cramers_v_matrix": (fn.cramers_v_matrix, "cramers_v_bc"), "tschuprows_t_matrix": (fn.tschuprows_t_matrix, "tschuprows_t_bc"),
        "pearsons_contingency_coefficient_matrix": (fn.pearsons_contingency_coefficient_matrix, "pearson"),
        "theils_u_matrix": (fn.theils_u_matrix, "theils_u"),
    }
    matrix_ms, matrix_syncs, matrix_worst, matrix_busy_ms = {}, {}, {}, {}
    for name, (f, key) in matrix_fns.items():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = f(matrix, nan_replace_value=-1.0)
        torch.cuda.synchronize()
        matrix_ms[name] = (time.perf_counter() - t0) * 1e3
        pairs_n = len(pair_oracles) if name == "theils_u_matrix" else len(pair_oracles) // 2
        matrix_syncs[name] = count_host_syncs(torch, lambda: f(matrix, nan_replace_value=-1.0)) / pairs_n
        matrix_busy_ms[name] = profile_update(torch, lambda: f(matrix, nan_replace_value=-1.0))["busy_ms"]
        got = got.cpu().numpy().astype(np.float64)
        check(bool(np.all(np.diag(got) == 1.0)), f"{label}: {name} diagonal {np.diag(got)}")
        share = 0.0
        for (i, j), o in pair_oracles.items():
            if name != "theils_u_matrix" and i > j:
                continue
            want, allowed = o["values"][key], o["tol"][key]
            check(abs(got[i, j] - want) <= allowed, f"{label}: {name}[{i}, {j}] = {got[i, j]} vs float64 oracle {want} (tolerance {allowed})")
            if name != "theils_u_matrix":
                check(got[j, i] == got[i, j], f"{label}: {name} is not symmetric at ({i}, {j})")
            share = max(share, abs(got[i, j] - want) / allowed)
        matrix_worst[name] = share

    counts, scores = make_raters(SEED + 23)
    kappa_want = fleiss_oracle(counts)
    fleiss = {}
    for mode, data in (("counts", counts), ("probs", scores)):
        parts = [data[i : i + RATERS_BATCH] for i in range(0, RATERS_N, RATERS_BATCH)]
        dev = [torch.from_numpy(x).cuda() for x in parts]
        metric, cpu_metric = FleissKappa(mode, device="cuda"), FleissKappa(mode, device="cpu")
        for i, x in enumerate(dev):
            if i == 1:
                torch.cuda.set_sync_debug_mode("error")
            try:
                metric.update(x)
            finally:
                torch.cuda.set_sync_debug_mode(0)
        for x in parts:
            cpu_metric.update(torch.from_numpy(x))
        check_same_states(f"{label} Fleiss kappa ({mode})", export_state(metric), export_state(cpu_metric))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        kappa = metric.compute()
        torch.cuda.synchronize()
        fleiss[mode] = {"value": float(kappa), "compute_ms": (time.perf_counter() - t0) * 1e3}
        fleiss[mode]["worst"] = check_values(f"{label} Fleiss kappa ({mode})", {"kappa": kappa}, {"kappa": kappa_want},
                                             {"kappa": (NOMINAL_RTOL, 0.0)})["kappa"]
    check(bc.launches == 0, f"{label}: {bc.launches} binned_confusion launches, expected none")
    steady = update_ms[1:-1]
    print(
        f"nominal phase: {label}: Adult (occupation, education) in {len(batches)} batches of {ADULT_BATCH} (the last"
        f" {len(batches[-1][0])}), missing occupations as category {int(ADULT_UNKNOWN)}; reduced: none (Adult),"
        f" a fixed {RATERS} raters per image (CIFAR-10H has 47-63); 4 members in one compute group, the table"
        f" identical to the CPU's; values against float64 oracles, worst share of the tolerance {max(worst.values()):.3f}"
        f" ({max(worst, key=worst.get)}): Cramer's V {float(values['cramers_v']):.6f} Tschuprow's T"
        f" {float(values['tschuprows_t']):.6f} Pearson's C {float(values['pearson']):.6f} Theil's U"
        f" {float(values['theils_u']):.6f}; update 2 free of host syncs; first update {update_ms[0]:.3f} ms, steady"
        f" median {np.median(steady):.3f} ms; compute() {compute_ms:.3f} ms; the *_matrix functions over the 9 columns"
        f" (host clock, device union of a profiled call, host reads per column pair, worst share of the tolerance): "
        + ", ".join(f"{k} {matrix_ms[k]:.3f} ms, {matrix_busy_ms[k]:.3f} ms, {matrix_syncs[k]:.2f}, {matrix_worst[k]:.3f}"
                    for k in matrix_fns)
        + f"; Fleiss kappa counts {fleiss['counts']['value']:.6f}, probs {fleiss['probs']['value']:.6f} (oracle"
        f" {kappa_want:.6f}), states identical to the CPU's, update 2 free of host syncs",
        flush=True,
    )
    profile_step(torch, col, dev_batches[1], label)
    del col, cpu
    fused = fused_pair(torch, label, lambda f: collection("cuda", f), dev_batches)
    check(fused["eager_leaders"] == [], f"{label}: eager leaders {fused['eager_leaders']}")
    return {"launches": 0, "update_ms": update_ms, "compute_ms": compute_ms, "oracle_worst": worst,
            "matrix_ms": matrix_ms, "matrix_busy_ms": matrix_busy_ms, "matrix_host_reads_per_pair": matrix_syncs,
            "matrix_worst": matrix_worst,
            "fleiss": fleiss, "fused": fused}


# MS MARCO passage ranking, dev (small) (Nguyen et al. 2016; Nogueira & Cho 2019): 6,980 queries, the top 1000
# BM25 candidates of each re-ranked; 7,437 relevance judgments; BM25's recall@1000 0.857; monoBERT's MRR@10 about 0.36.
MSMARCO_Q, MSMARCO_CANDIDATES = 6980, 1000
MSMARCO_BATCH = 65_536
MSMARCO_RELEVANT = ([1, 2, 3, 4], [0.945, 0.047, 0.006, 0.002])  # judged relevant passages per query: 1.065 on average
MSMARCO_RECALL = 0.857  # share of queries with a relevant passage among their candidates
MSMARCO_SHIFT = 2.7  # the relevant passages' score shift over unit-normal negatives: MRR@10 about 0.36
SCORE_GRID = 1024  # scores rounded to multiples of 1/1024, so that scores tie within a query
TRECDL_Q, TRECDL_GRADES = 43, [0.905, 0.037, 0.042, 0.016]  # TREC DL 2019 passage: 43 queries, graded 0-3
RETRIEVAL_ATOL = 1e-6  # values against the float64 oracle, and card against CPU


def make_msmarco(seed: int, queries: int, graded: bool = False):
    """``(indexes, scores, targets)`` in query order, 1000 candidates a query:
    binary targets at MS MARCO dev's rates, or grades 0-3 at TREC DL 2019's,
    float32 scores on a 1/1024 grid (a relevant passage's shifted up)."""
    rng = np.random.default_rng(seed)
    n = queries * MSMARCO_CANDIDATES
    idx = np.repeat(np.arange(queries, dtype=np.int64), MSMARCO_CANDIDATES)
    if graded:
        target = rng.choice(4, n, p=TRECDL_GRADES).astype(np.int64)
        shift = MSMARCO_SHIFT * target / 3
    else:
        nrel = rng.choice(MSMARCO_RELEVANT[0], queries, p=MSMARCO_RELEVANT[1]) * (rng.random(queries) < MSMARCO_RECALL)
        # each query's relevant passages at distinct random candidate slots
        slots = np.argsort(rng.random((queries, MSMARCO_CANDIDATES)), axis=1)[:, :4]
        rel = np.zeros((queries, MSMARCO_CANDIDATES), bool)
        for j in range(4):
            rows = np.nonzero(nrel > j)[0]
            rel[rows, slots[rows, j]] = True
        target = rel.reshape(-1).astype(np.int64)
        shift = MSMARCO_SHIFT * target
    scores = (np.round((rng.standard_normal(n) + shift) * SCORE_GRID) / SCORE_GRID).astype(np.float32)
    return idx, scores, target


def msmarco_batches(idx, scores, target, seed: int):
    """Rows in query order, in batches of 65,536 (queries straddle batch
    edges), each batch's rows permuted."""
    rng = np.random.default_rng(seed)
    out = []
    for lo in range(0, idx.size, MSMARCO_BATCH):
        perm = lo + rng.permutation(min(MSMARCO_BATCH, idx.size - lo))
        out.append((scores[perm], target[perm], idx[perm]))
    return out


def retrieval_oracle(idx: np.ndarray, scores: np.ndarray, target: np.ndarray, queries: int) -> dict:
    """float64 values of the members under ``empty_target_action="neg"``
    (FallOut "pos"): each query ranked by a stable sort of ``-score``, ties
    in the order the rows were appended; nDCG tie-averaged."""
    order = np.lexsort((-scores.astype(np.float64), idx))
    q, s, t = idx[order], scores[order].astype(np.float64), target[order].astype(np.float64)
    counts = np.bincount(q, minlength=queries)
    starts = np.cumsum(counts) - counts
    rank = np.arange(q.size) - starts[q]
    npos = np.bincount(q, weights=t, minlength=queries)
    found = npos > 0
    rel = t > 0

    def per_query(w):
        return np.bincount(q, weights=w, minlength=queries)

    first = np.full(queries, np.iinfo(np.int64).max)
    np.minimum.at(first, q[rel], rank[rel])
    out = {"mrr10": np.where(first < 10, 1.0 / (first + 1.0), 0.0).mean()}
    cum = np.cumsum(t)
    cum_in_query = cum - (cum[starts] - t[starts])[q]
    ap = per_query(t * cum_in_query / (rank + 1)) / np.maximum(npos, 1)
    out["map"] = np.where(found, ap, 0.0).mean()
    out["p10"] = np.where(found, per_query(t * (rank < 10)) / 10, 0.0).mean()
    out["r1000"] = np.where(found, per_query(t * (rank < 1000)) / np.maximum(npos, 1), 0.0).mean()
    out["hr10"] = np.where(found, per_query(t * (rank < 10)) > 0, 0.0).mean()
    out["rprec"] = np.where(found, per_query(t * (rank < npos[q])) / np.maximum(npos, 1), 0.0).mean()
    neg = 1.0 - t
    out["fallout10"] = (per_query(neg * (rank < 10)) / np.maximum(per_query(neg), 1)).mean()
    # tie-averaged DCG@10: each row counts its tie group's mean target
    new_group = np.r_[True, (q[1:] != q[:-1]) | (s[1:] != s[:-1])]
    gid = np.cumsum(new_group) - 1
    avg = (np.bincount(gid, weights=t) / np.bincount(gid))[gid]
    disc = np.where(rank < 10, 1.0 / np.log2(rank + 2.0), 0.0)
    dcg = per_query(avg * disc)
    ideal = np.lexsort((-t, q))
    idcg = per_query(t[ideal] * disc)  # the ideal order: same query runs, ranks unchanged
    out["ndcg10"] = np.where(idcg > 0, dcg / np.where(idcg > 0, idcg, 1.0), 0.0).mean()
    # the PR curve and recall at precision 0.1, max_k = 100
    grid = np.zeros((queries, 100))
    keep = rank < 100
    np.add.at(grid, (q[keep], rank[keep]), t[keep])
    rel_cum = np.cumsum(grid, axis=1)
    precision = (rel_cum / np.arange(1, 101)).mean(0)
    recall = (rel_cum / np.maximum(npos, 1)[:, None]).mean(0)
    out["prc"] = (precision, recall)
    ok = precision >= 0.1
    best = np.where(ok, recall, -np.inf)
    max_recall = best.max() if ok.any() else 0.0
    best_k = int(np.nonzero(ok & (best == max_recall))[0].max() + 1) if ok.any() and max_recall > 0 else 100
    out["rafp"] = (max_recall, best_k)
    return out


RETRIEVAL_GROUPS = [
    ["cap_map", "cap_mrr10", "cap_ndcg10"],
    ["fallout10", "hr10", "map", "mrr10", "ndcg10", "p10", "prc", "r1000", "rafp", "rprec"],
]
# the two groups' leaders (a collection orders its members by name): their eager updates read the host once
RETRIEVAL_HOST_READERS = {
    "cap_map": "an eager update checks the targets are binary on the host (skipped under capture)",
    "fallout10": "an eager update checks the targets are binary on the host (skipped under capture)",
}


def steady_host_syncs(torch, metric, batch) -> int:
    """Host syncs of a steady update of a copy of ``metric``: the copy's
    first update runs before the count (the first call of an op in a process
    may initialize something on the host)."""
    import copy

    m = copy.deepcopy(metric)
    m.update(*batch)
    torch.cuda.synchronize()
    return count_host_syncs(torch, lambda: m.update(*batch))


def retrieval_members(device) -> dict:
    """The MS MARCO report: ten members on list states, and a capacity copy
    of MRR@10, MAP and nDCG@10 on MaskedBuffers of the stream's rows."""
    import tpumetrics_torch.retrieval as rt

    kw = {"device": device}
    n = MSMARCO_Q * MSMARCO_CANDIDATES
    spaces = {"num_queries": MSMARCO_Q, **kw}
    return {
        "mrr10": rt.RetrievalMRR(top_k=10, **kw), "ndcg10": rt.RetrievalNormalizedDCG(top_k=10, **kw),
        "map": rt.RetrievalMAP(**kw), "p10": rt.RetrievalPrecision(top_k=10, **kw),
        "r1000": rt.RetrievalRecall(top_k=1000, **kw), "hr10": rt.RetrievalHitRate(top_k=10, **kw),
        "rprec": rt.RetrievalRPrecision(**kw), "fallout10": rt.RetrievalFallOut(top_k=10, **kw),
        "prc": rt.RetrievalPrecisionRecallCurve(max_k=100, **kw),
        "rafp": rt.RetrievalRecallAtFixedPrecision(min_precision=0.1, max_k=100, **kw),
        "cap_mrr10": buffered(rt.RetrievalMRR(top_k=10, **spaces), n), "cap_map": buffered(rt.RetrievalMAP(**spaces), n),
        "cap_ndcg10": buffered(rt.RetrievalNormalizedDCG(top_k=10, **spaces), n),
    }


def retrieval_phase(torch, bc) -> dict:
    """MS MARCO passage re-ranking (see the module note): the report on the
    card and on the CPU, states against each other, values against a
    float64 oracle, a second compute identical, the host syncs of a steady
    update, compute's parts on the device, the graded TREC DL stream, and the
    fused phase."""
    from tpumetrics_torch import MetricCollection
    from tpumetrics_torch.functional.retrieval import _grouped as grouped
    from tpumetrics_torch.interop import export_state
    from tpumetrics_torch.retrieval import RetrievalNormalizedDCG

    n = MSMARCO_Q * MSMARCO_CANDIDATES
    label = f"retrieval MS MARCO dev {MSMARCO_Q} queries x {MSMARCO_CANDIDATES} candidates"
    idx, scores, target = make_msmarco(SEED + 23, MSMARCO_Q)
    batches = msmarco_batches(idx, scores, target, SEED + 24)

    def collection(device, fused=False):
        return MetricCollection(retrieval_members(device), fused_update=fused, device=device)

    dev_batches = [tuple(torch.from_numpy(x).cuda() for x in b) for b in batches]
    col = collection("cuda")
    torch.cuda.synchronize()
    bc.launches = 0
    update_ms = []
    for i, batch in enumerate(dev_batches):
        t0 = time.perf_counter()
        if i == 1:  # a steady update: a host sync raises, but in the leaders' binary-target checks
            syncs = {name: steady_host_syncs(torch, col._modules[name], batch) for name in RETRIEVAL_HOST_READERS}
            t0 = time.perf_counter()
            torch.cuda.set_sync_debug_mode("error")
            try:
                with host_readers_exempt(torch, col, RETRIEVAL_HOST_READERS):
                    col.update(*batch)
            finally:
                torch.cuda.set_sync_debug_mode(0)
        else:
            col.update(*batch)
        torch.cuda.synchronize()
        update_ms.append((time.perf_counter() - t0) * 1e3)
    t0 = time.perf_counter()
    values = col.compute()
    torch.cuda.synchronize()
    compute_ms = (time.perf_counter() - t0) * 1e3
    for m in col._modules.values():
        m._computed = None
    t0 = time.perf_counter()
    again = col.compute()
    torch.cuda.synchronize()
    compute2_ms = (time.perf_counter() - t0) * 1e3
    flat, flat_again = flat_values(values), flat_values(again)
    check(all(torch.equal(flat_again[k], v) for k, v in flat.items()), f"{label}: a second compute gave other bits")
    groups = sorted(sorted(g) for g in col.compute_groups.values())
    check(groups == RETRIEVAL_GROUPS, f"{label}: compute groups {groups}")
    check(bc.launches == 0, f"{label}: {bc.launches} binned_confusion launches, expected none")
    check(all(v == 1 for v in syncs.values()), f"{label}: host syncs of one eager update {syncs}, expected one each")

    cpu = collection("cpu")
    for batch in batches:
        cpu.update(*(torch.from_numpy(x) for x in batch))
    check_same_states(label, export_state(col), export_state(cpu))
    check_same_values(torch, label, values, cpu.compute())
    del cpu

    o = retrieval_oracle(np.concatenate([b[2] for b in batches]), np.concatenate([b[0] for b in batches]),
                         np.concatenate([b[1] for b in batches]), MSMARCO_Q)
    oracle = {k: v for k, v in o.items() if k not in ("prc", "rafp")}
    oracle.update({f"cap_{k}": o[k] for k in ("mrr10", "map", "ndcg10")})
    oracle.update({"prc[0]": o["prc"][0], "prc[1]": o["prc"][1], "prc[2]": np.arange(1, 101),
                   "rafp[0]": o["rafp"][0], "rafp[1]": o["rafp"][1]})
    check(set(flat) == set(oracle), f"{label}: keys {sorted(flat)}")
    worst = check_values(label, flat, oracle, {k: (0.0, RETRIEVAL_ATOL) for k in oracle})

    # compute's parts on the device (CUDA events, L2 flushed): the two sorts, one segment sum, the PR grid
    flush = l2_flush(torch)
    all_idx = torch.from_numpy(np.concatenate([b[2] for b in batches])).cuda().to(torch.int32)
    all_s = torch.from_numpy(np.concatenate([b[0] for b in batches])).cuda()
    all_t = torch.from_numpy(np.concatenate([b[1] for b in batches])).cuda().float()
    sq = grouped.sort_queries(all_idx, all_s, all_t, MSMARCO_Q)
    parts = {
        "two_sorts": cuda_ms(torch, lambda: grouped._ranked_order(all_idx, all_s), 5, flush),
        "sort_queries": cuda_ms(torch, lambda: grouped.sort_queries(all_idx, all_s, all_t, MSMARCO_Q), 5, flush),
        "segment_sum": cuda_ms(torch, lambda: grouped._segment_sum(sq.target, sq), 5, flush),
        "pr_grid": cuda_ms(torch, lambda: grouped.grouped_precision_recall_curve(sq, 100), 5, flush),
    }
    # the graded stream: TREC DL 2019 passage geometry through nDCG@10 on the card and the CPU
    g_idx, g_scores, g_target = make_msmarco(SEED + 25, TRECDL_Q, graded=True)
    g_batches = msmarco_batches(g_idx, g_scores, g_target, SEED + 26)
    graded = {d: RetrievalNormalizedDCG(top_k=10, device=d) for d in ("cuda", "cpu")}
    for b in g_batches:
        graded["cuda"].update(*(torch.from_numpy(x).cuda() for x in b))
        graded["cpu"].update(*(torch.from_numpy(x) for x in b))
    g_value, g_cpu = graded["cuda"].compute(), graded["cpu"].compute()
    g_oracle = retrieval_oracle(np.concatenate([b[2] for b in g_batches]), np.concatenate([b[0] for b in g_batches]),
                                np.concatenate([b[1] for b in g_batches]), TRECDL_Q)["ndcg10"]
    check(abs(float(g_value) - float(g_cpu)) <= RETRIEVAL_ATOL, f"{label}: graded nDCG@10 card {g_value} vs CPU {g_cpu}")
    check(abs(float(g_value) - g_oracle) <= RETRIEVAL_ATOL, f"{label}: graded nDCG@10 {g_value} vs oracle {g_oracle}")
    del flush, sq, all_idx, all_s, all_t
    steady = update_ms[2:-1]
    print(
        f"retrieval phase: {label}: {n} rows in {len(batches)} batches of {MSMARCO_BATCH} (the last {len(batches[-1][0])},"
        f" rows permuted in each), {int(target.sum())} relevant, {int((np.bincount(idx, weights=target) > 0).sum())}"
        f" queries with one; reduced: none; {len(col._modules)} members in {len(groups)} compute groups; states"
        f" identical to the CPU run's (lists and buffers), values within {RETRIEVAL_ATOL} of it; against a float64"
        f" oracle, worst share of the tolerance {max(worst.values()):.3f} ({max(worst, key=worst.get)}); MRR@10"
        f" {float(values['mrr10']):.6f} nDCG@10 {float(values['ndcg10']):.6f} MAP {float(values['map']):.6f}"
        f" P@10 {float(values['p10']):.6f} R@1000 {float(values['r1000']):.6f} HR@10 {float(values['hr10']):.6f}"
        f" R-prec {float(values['rprec']):.6f} fall-out@10 {float(values['fallout10']):.3e}; recall at precision 0.1"
        f" {float(values['rafp'][0]):.6f} at k {int(values['rafp'][1])}; a second compute identical; update 2 with"
        f" host syncs made errors but in {sorted(RETRIEVAL_HOST_READERS)}, whose host syncs in one update are {syncs};"
        f" first update {update_ms[0]:.3f} ms, steady median {np.median(steady):.3f} ms; compute() {compute_ms:.3f} ms"
        f" first, {compute2_ms:.3f} ms again (host clock); device time of one call over the {n} rows (median, L2"
        f" flushed; host time to make it): " + ", ".join(f"{k} {v[0]:.3f} ms ({v[1]:.3f} ms)" for k, v in parts.items())
        + f"; graded TREC DL 2019 geometry ({TRECDL_Q} x {MSMARCO_CANDIDATES}, grades 0-3): nDCG@10"
        f" {float(g_value):.6f}, CPU {float(g_cpu):.6f}, oracle {g_oracle:.6f}",
        flush=True,
    )
    profile_step(torch, col, dev_batches[2], label)
    del col
    fused = fused_pair(torch, label, lambda f: collection("cuda", f), dev_batches,
                       exempt={"fallout10": RETRIEVAL_HOST_READERS["fallout10"]})
    check(fused["eager_leaders"] == ["fallout10"], f"{label}: eager leaders {fused['eager_leaders']}")
    return {"launches": 0, "update_ms": update_ms, "compute_ms": [compute_ms, compute2_ms], "parts_ms": parts,
            "host_syncs": syncs, "oracle_worst": worst, "graded_ndcg10": float(g_value),
            "values": {k: float(v) for k, v in flat.items() if v.numel() == 1}, "fused": fused}


# dense retrieval at BERT-base width (DPR-style bi-encoders): MS MARCO dev's 6,980 query embeddings against one
# 65,536-passage block of the corpus, 768-d float32; the L1 and L3 distances at 4,096 x 4,096
EMB_D, EMB_QUERIES, EMB_PASSAGES, EMB_LP = 768, 6980, 65_536, 4096
U32 = 2.0**-24  # float32's unit roundoff
REDUCE_DEPTH = 128  # a bound on the float32 additions in a row of torch's sum over 65,536 columns


def pairwise_phase(torch, bc) -> dict:
    """Embedding similarity at 768-d (see the module note): cosine, linear
    and euclidean of 6,980 x 65,536 under each reduction and in the self case
    at 6,980 x 6,980, manhattan and minkowski (p=3) at 4,096 x 4,096 in row
    chunks; every result against a float64 oracle on the card within its
    float32 error bound, again under the caller's
    ``set_float32_matmul_precision("medium")``; times and peak scratch."""
    import tpumetrics_torch.functional.pairwise as pw
    from tpumetrics_torch.functional.pairwise import helpers

    bc.launches = 0
    g = torch.Generator(device="cuda").manual_seed(SEED + 29)
    mean = 0.3 * torch.randn(EMB_D, device="cuda", generator=g)
    q = (mean + 0.5 * torch.randn(EMB_QUERIES, EMB_D, device="cuda", generator=g)).contiguous()
    p = (mean + 0.5 * torch.randn(EMB_PASSAGES, EMB_D, device="cuda", generator=g)).contiguous()
    label = f"pairwise {EMB_QUERIES} x {EMB_PASSAGES} x {EMB_D}-d"

    def oracle_rows(name, x, y, lo, hi):
        """float64 results and absolute tolerances of rows ``lo:hi`` (unreduced)."""
        x64, y64 = x[lo:hi].double(), y.double()
        if name == "cosine":  # the float32 norms add a relative error of (D/2 + 2)u per row
            xn = x64 / x64.norm(dim=1, keepdim=True)
            yn = y64 / y64.norm(dim=1, keepdim=True)
            return xn @ yn.T, (2 * EMB_D + 8) * U32 * (xn.abs() @ yn.abs().T)
        if name == "linear":
            return x64 @ y64.T, (EMB_D + 8) * U32 * (x64.abs() @ y64.abs().T)
        c = x.double().mean(0)
        xc, yc = x64 - c, y64 - c
        xs, ys = (xc * xc).sum(1), (yc * yc).sum(1)
        d = torch.sqrt(torch.clamp(xs[:, None] + ys[None, :] - 2 * xc @ yc.T, min=0.0))
        # the float32 squared distance is off by e at most; the distance by sqrt(d^2 + e) - d
        e = 2 * (EMB_D + 8) * U32 * (xs[:, None] + ys[None, :])
        tol = torch.sqrt(d * d + e) - d + 2 * U32 * (xs.sqrt()[:, None] + ys.sqrt()[None, :] + d)
        return d, tol

    def check_fn(name, fn, x, y, reduction, zero_diag):
        got = fn(x, y, reduction=reduction)
        worst = 0.0
        rows = 1024
        yy = x if y is None else y
        for lo in range(0, x.shape[0], rows):
            want, tol = oracle_rows(name, x, yy, lo, min(lo + rows, x.shape[0]))
            if zero_diag:
                eye = torch.zeros_like(want, dtype=torch.bool)
                r = torch.arange(want.shape[0], device=want.device)
                eye[r, lo + r] = True
                want = torch.where(eye, 0.0, want)
                tol = torch.where(eye, 0.0, tol)
            if reduction in ("sum", "mean"):
                scale = 1.0 / want.shape[1] if reduction == "mean" else 1.0
                tol = (tol.sum(1) + REDUCE_DEPTH * U32 * want.abs().sum(1)) * scale
                want = want.sum(1) * scale
            diff = (got[lo : lo + rows].double() - want).abs()
            check(bool((diff <= tol).all()), f"{label}: {name} {reduction} rows {lo}+: worst diff {float(diff.max())}"
                  f" over tolerance {float((diff / tol.clamp(min=1e-300)).max())}x")
            worst = max(worst, float((diff / tol.clamp(min=1e-300)).max()))
        if zero_diag and reduction is None:
            check(bool((torch.diagonal(got) == 0).all()), f"{label}: {name} self case: the diagonal is not zero")
        return worst

    fns = {"cosine": pw.pairwise_cosine_similarity, "linear": pw.pairwise_linear_similarity,
           "euclidean": pw.pairwise_euclidean_distance}
    worst, times, scratch = {}, {}, {}
    for precision in ("highest", "medium"):
        torch.set_float32_matmul_precision(precision)
        try:
            for name, fn in fns.items():
                for reduction in (None, "mean", "sum"):
                    worst[f"{name} {reduction} {precision}"] = check_fn(name, fn, q, p, reduction, False)
                worst[f"{name} self {precision}"] = check_fn(name, fn, q, None, None, True)
        finally:
            torch.set_float32_matmul_precision("highest")
    torch.backends.cuda.matmul.allow_tf32 = False

    # manhattan and minkowski (p=3), 4,096 x 4,096 x 768: at least two chunks of at most 1 GiB of difference
    x, y = q[:EMB_LP], p[:EMB_LP]
    rows = helpers._DIFF_BUDGET_BYTES // (EMB_LP * EMB_D * 4)
    check(rows < EMB_LP, f"{label}: one chunk of {rows} rows holds all {EMB_LP}")
    lp = {"manhattan": (lambda a, b: pw.pairwise_manhattan_distance(a, b), 1.0),
          "minkowski3": (lambda a, b: pw.pairwise_minkowski_distance(a, b, exponent=3), 3.0)}
    for name, (fn, power) in lp.items():
        got = fn(x, y)
        for lo in range(0, EMB_LP, 64):
            diff = (x[lo : lo + 64, None, :].double() - y[None, :, :].double()).abs()
            want = diff.pow(power).sum(-1).pow(1.0 / power)
            err = (got[lo : lo + 64].double() - want).abs()
            rtol = (EMB_D + 16) * U32
            check(bool((err <= rtol * want).all()), f"{label}: {name} rows {lo}+ worst relative {float((err / want).max())}")
            worst[name] = max(worst.get(name, 0.0), float((err / (rtol * want)).max()))
        del diff, want, err

    flush = l2_flush(torch)
    for name, fn in fns.items():
        for reduction in (None, "mean", "sum"):
            key = f"{name} {reduction}"
            times[key] = cuda_ms(torch, lambda: fn(q, p, reduction=reduction), 3, flush)
            torch.cuda.synchronize()
            resident = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            out = fn(q, p, reduction=reduction)
            torch.cuda.synchronize()
            scratch[key] = (torch.cuda.max_memory_allocated() - resident - out.numel() * 4) / 2**20
            del out
    for name, (fn, _) in lp.items():
        times[name] = cuda_ms(torch, lambda: fn(x, y), 3, flush)
        resident = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        out = fn(x, y)
        torch.cuda.synchronize()
        scratch[name] = (torch.cuda.max_memory_allocated() - resident - out.numel() * 4) / 2**20
        del out
    del flush
    check(bc.launches == 0, f"{label}: binned_confusion launched {bc.launches} times")
    print(
        f"pairwise phase: {label}: cosine, linear and euclidean under each reduction and in the self case"
        f" ({EMB_QUERIES} x {EMB_QUERIES}, zero diagonal), manhattan and minkowski (p=3) at {EMB_LP} x {EMB_LP} in"
        f" {-(-EMB_LP // rows)} chunks of {rows} rows; every result within its float32 bound of a float64 oracle on the"
        f" card, with set_float32_matmul_precision 'highest' and 'medium'; worst share of the bound "
        + ", ".join(f"{k} {v:.3f}" for k, v in worst.items())
        + "; device time of one call (median, L2 flushed; host time to make it) and peak scratch beyond the"
        " result: " + ", ".join(f"{k} {v[0]:.3f} ms ({v[1]:.3f} ms), {scratch[k]:.0f} MiB" for k, v in times.items()),
        flush=True,
    )
    return {"launches": 0, "oracle_worst": worst, "ms": {k: v[0] for k, v in times.items()}, "scratch_mib": scratch}


# ----------------------------------------------------------------- audio: the IIR kernel and two streams

SRMR_FS, SRMR_UTTERANCES, SRMR_SECONDS, SRMR_BATCH = 16_000, 64, 8, 8
SRMR_T = SRMR_FS * SRMR_SECONDS  # 128,000 samples an utterance
GAMMATONE_CHANNELS, MOD_BANDS = 23, 8


def biquad_bound(lanes: int, t: int, stages: int, clamp: bool) -> dict:
    """Least time for the cascade on an H100 SXM: x read once and the output
    written once (and the coefficients read once) over the memory rate,
    against its operations (5 products and 4 sums or differences a stage and
    step, 2 comparisons with ``clamp``) at the fp32 rate outside the tensor
    cores. A parallel scan over T needs no sequential chain, so the chain of
    this design is no part of the bound."""
    nbytes = 2 * lanes * t * 4 + 2 * stages * lanes * 3 * 4
    ops = (9 + (2 if clamp else 0)) * stages * lanes * t
    bytes_ms = nbytes / H100_BYTES_PER_S * 1e3
    ops_ms = ops / H100_FP32_OPS_PER_S * 1e3
    return {
        "bytes": nbytes, "ops": ops, "bytes_ms": bytes_ms, "ops_ms": ops_ms,
        "bound_ms": max(bytes_ms, ops_ms), "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
    }


def biquad_call_inputs(torch, kind: str, batch: int, t: int, seed: int):
    """``(x, b, a, clamp)`` on the card as SRMR's two call sites give them at
    16 kHz: the gammatone bank (4 stages, clipped, ``batch x 23`` lanes of
    one waveform each) or the modulation bank (1 stage, ``batch x 23 x 8``
    lanes of envelopes)."""
    from tpumetrics_torch.functional.audio import srmr

    rng = np.random.default_rng(seed)
    const = srmr._constants(SRMR_FS, GAMMATONE_CHANNELS, 125.0, 4.0, 128.0, torch.device("cuda"))
    if kind == "gammatone":
        wave = rng.uniform(-1, 1, (batch, t)).astype(np.float32)
        x = torch.from_numpy(wave).cuda()[:, None, :].expand(batch, GAMMATONE_CHANNELS, t).reshape(-1, t)
        return x.contiguous(), const["as_"].repeat(1, batch, 1), const["bs"].repeat(1, batch, 1), True
    env = np.abs(rng.standard_normal((batch * GAMMATONE_CHANNELS, t))).astype(np.float32) * 1e-3
    x = torch.from_numpy(env).cuda()[:, None, :].expand(-1, MOD_BANDS, t).reshape(-1, t)
    lanes = batch * GAMMATONE_CHANNELS
    return x.contiguous(), const["mb"].repeat(lanes, 1)[None], const["ma"].repeat(lanes, 1)[None], False


BIQUAD_CHUNK, BIQUAD_TILE = 16, 4096  # samples a thread and a block of the kernel run (csrc/biquad_cascade.cu)


def biquad_check(torch, bq, label: str, x, b, a, clamp: bool, want=None) -> dict:
    """One case of the kernel's contract on the card: two calls bit for bit
    equal, the non-finite outputs where the plain loop's are, exact zeros on
    silent lanes, and ``rel(kernel) <= REL_SLACK rel(plain) + REL_FLOOR``
    against the float64 reference on the host (``bq.biquad_cascade_reference``).
    ``want`` is the plain loop's output when the caller has it."""
    got = bq.biquad_cascade(x, b, a, clamp)
    again = bq.biquad_cascade(x, b, a, clamp)
    torch.cuda.synchronize()
    check(same_bits(torch, got, again), f"biquad_cascade at {label}: two calls differ")
    if want is None:
        want = bq.biquad_cascade_plain(x, b, a, clamp)
    bad_got, bad_want = ~torch.isfinite(got), ~torch.isfinite(want)
    check(torch.equal(bad_got, bad_want), f"biquad_cascade at {label}: non-finite outputs at other positions than the"
          f" plain loop's ({int(bad_got.sum())} against {int(bad_want.sum())})")
    kinds_differ = int((torch.isnan(got) != torch.isnan(want)).sum())  # NaN in one where the other has +-inf
    silent = (x == 0).all(dim=1)
    check(bool((got[silent] == 0).all()), f"biquad_cascade at {label}: a silent lane gave a non-zero output")
    ref = bq.biquad_cascade_reference(x, b, a, clamp)
    rel, rel_plain = bq.relative_error(got, ref), bq.relative_error(want, ref)
    check(rel <= bq.REL_SLACK * rel_plain + bq.REL_FLOOR,
          f"biquad_cascade at {label}: rel {rel:.3e} against the float64 reference, the plain loop's {rel_plain:.3e}")
    fin = ~bad_got & ~bad_want
    max_abs = float((got[fin] - want[fin]).abs().max()) if bool(fin.any()) else 0.0
    return {"rel": rel, "rel_plain": rel_plain, "max_abs_err": max_abs, "nonfinite": int(bad_got.sum()),
            "nan_vs_inf": kinds_differ, "silent_lanes": int(silent.sum())}


def same_bits(torch, u, v) -> bool:
    """The same float32 bits (NaN payloads and signed zeros included)."""
    return bool(torch.equal(u.view(torch.int32), v.view(torch.int32)))


def biquad_kernel_phase(torch, bq) -> dict:
    """``biquad_cascade`` on the card held to its contract (``biquad_check``)
    beside its plain version on the same inputs: both call sites' shapes at
    short T, the chunk and tile edges, edge cases (T=1, one lane, silence,
    lanes driven into the clip, NaN and inf), a graph replay against the eager
    call bit for bit, and the SRMR stream's full shapes (the shapes its main
    path gives the kernel, on the inputs that are timed); its time at the full
    shapes, a one-lane launch's at the full T (the carry chain's latency), and
    the plain version's at the full T (one call) and at T=2048."""
    cases = []
    for kind in ("gammatone", "modulation"):
        for t in (2048, 4096):
            cases.append((f"{kind} {SRMR_BATCH} utterances T={t}", biquad_call_inputs(torch, kind, SRMR_BATCH, t, SEED + t)))
    # the chunk and tile edges (T % 4 != 0 takes the kernel's 4-byte loads), both banks
    edges = (BIQUAD_CHUNK - 1, BIQUAD_CHUNK + 1, 1000, BIQUAD_TILE - 1, BIQUAD_TILE, BIQUAD_TILE + 1, 3 * BIQUAD_TILE + 5)
    for t in edges:
        cases.append((f"gammatone T={t}", biquad_call_inputs(torch, "gammatone", SRMR_BATCH, t, SEED + 5)))
    for t in (BIQUAD_CHUNK + 1, BIQUAD_TILE - 1, BIQUAD_TILE + 1, 3 * BIQUAD_TILE + 5):
        cases.append((f"modulation T={t}", biquad_call_inputs(torch, "modulation", 1, t, SEED + 6)))
    x, b, a, _ = biquad_call_inputs(torch, "gammatone", SRMR_BATCH, 4096, SEED + 1)
    cases.append(("gammatone T=1", (x[:, :1].contiguous(), b, a, True)))
    cases.append(("gammatone one lane L=1", (x[:1].contiguous(), b[:, :1].contiguous(), a[:, :1].contiguous(), True)))
    cases.append(("gammatone all zeros", (torch.zeros_like(x), b, a, True)))
    loud = x.clone()
    loud[::7] *= 3e4  # every 7th lane drives its stages past [-1, 1]: the clip between them acts
    cases.append(("gammatone lanes driven into the clamp", (loud, b, a, True)))
    nan = x.clone()
    nan[3, 100] = float("nan")
    nan[10, 4000:] = float("nan")
    nan[11, 0] = float("inf")
    nan[12] = 0.0  # a silent lane beside them
    cases.append(("gammatone NaN and inf inputs", (nan, b, a, True)))
    xm, bm, am, _ = biquad_call_inputs(torch, "modulation", 1, 4096, SEED + 2)
    xm = xm.clone()
    xm[5, 2000] = float("nan")
    xm[6, 3000] = float("-inf")
    cases.append(("modulation NaN and inf inputs", (xm, bm, am, False)))
    max_err, worst, results = 0.0, {}, {}
    for label, (x, b, a, clamp) in cases:
        res = biquad_check(torch, bq, label, x, b, a, clamp)
        results[label] = res
        max_err = max(max_err, res["max_abs_err"])
        kind = label.split()[0]
        worst[kind] = max(worst.get(kind, 0.0), res["rel"] / (bq.REL_SLACK * res["rel_plain"] + bq.REL_FLOOR))
        loud_case = label.endswith("driven into the clamp")
        if loud_case:  # the clip between the stages acts where the reference differs from the unclipped cascade's
            check(not np.array_equal(bq.biquad_cascade_reference(x, b, a, True), bq.biquad_cascade_reference(x, b, a, False)),
                  f"biquad_cascade at {label}: the clip never acted")
        print(f"kernel phase: biquad_cascade {label} ({tuple(x.shape)}, {b.shape[0]} stages, clamp {clamp}):"
              f" rel {res['rel']:.3e} against the float64 reference, plain loop {res['rel_plain']:.3e}; max abs"
              f" difference from the plain loop {res['max_abs_err']:.3e}; non-finite outputs {res['nonfinite']} where"
              f" the plain loop's are ({res['nan_vs_inf']} NaN against +-inf); silent lanes {res['silent_lanes']}"
              f" exact zeros; two calls bit for bit{', the clip between the stages acting' if loud_case else ''}",
              flush=True)
    # a graph replay gives the eager call's bits; its scratch is zeroed inside the graph
    x, b, a, clamp = cases[0][1]
    eager = bq.biquad_cascade(x, b, a, clamp)
    captured_before = bq.captured
    graph, side = torch.cuda.CUDAGraph(), torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        bq.biquad_cascade(x, b, a, clamp)  # warm the allocator on the side stream
    torch.cuda.current_stream().wait_stream(side)
    with torch.cuda.graph(graph):
        replayed = bq.biquad_cascade(x, b, a, clamp)
    for _ in range(3):
        graph.replay()
        torch.cuda.synchronize()
        check(same_bits(torch, replayed, eager), f"biquad_cascade at {cases[0][0]}: a graph replay differs from the eager call")
    check(bq.captured == captured_before + 1, f"biquad_cascade: {bq.captured - captured_before} calls captured, expected 1")
    print(f"kernel phase: biquad_cascade {cases[0][0]}: three graph replays bit for bit the eager call", flush=True)
    del cases, x, b, a, loud, nan, xm, bm, am, eager, replayed, graph
    flush = l2_flush(torch)
    timed = {}
    for kind, lanes in (("gammatone", SRMR_BATCH * GAMMATONE_CHANNELS), ("modulation", SRMR_BATCH * GAMMATONE_CHANNELS * MOD_BANDS)):
        x, b, a, clamp = biquad_call_inputs(torch, kind, SRMR_BATCH, SRMR_T, SEED + 3)
        ms, host_ms = cuda_ms(torch, lambda: bq.biquad_cascade(x, b, a, clamp), reps=5, ahead=flush)
        one_ms, _ = cuda_ms(torch, lambda: bq.biquad_cascade(x[:1], b[:, :1], a[:, :1], clamp), reps=3, ahead=flush)
        # the main path's shape: the plain loop's full call on the timed inputs, then the contract against both
        flush()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        want = bq.biquad_cascade_plain(x, b, a, clamp)
        end.record()
        end.synchronize()
        plain_full_ms, plain_full_wall_s = start.elapsed_time(end), time.perf_counter() - t0
        res = biquad_check(torch, bq, f"the {kind} main-path shape", x, b, a, clamp, want=want)
        max_err = max(max_err, res["max_abs_err"])
        worst[kind] = max(worst[kind], res["rel"] / (bq.REL_SLACK * res["rel_plain"] + bq.REL_FLOOR))
        print(f"kernel phase: biquad_cascade {kind} at the main path's shape ({tuple(x.shape)}, {b.shape[0]} stages,"
              f" clamp {clamp}): rel {res['rel']:.3e} against the float64 reference, the plain loop's"
              f" {res['rel_plain']:.3e} (tolerance {bq.REL_SLACK:g} x plain + {bq.REL_FLOOR:g}); max abs difference"
              f" from the plain loop {res['max_abs_err']:.3e}; two calls bit for bit; plain loop {plain_full_ms:.1f} ms"
              f" of device time, {plain_full_wall_s:.1f} s on the host clock", flush=True)
        del want
        xs, bs, as_ = x[:, :2048].contiguous(), b, a
        plain_ms, _ = cuda_ms(torch, lambda: bq.biquad_cascade_plain(xs, bs, as_, clamp), reps=1, ahead=flush)
        kern_short_ms, _ = cuda_ms(torch, lambda: bq.biquad_cascade(xs, bs, as_, clamp), reps=5, ahead=flush)
        bound = biquad_bound(lanes, SRMR_T, b.shape[0], clamp)
        timed[kind] = {"lanes": lanes, "t": SRMR_T, "stages": b.shape[0], "ms": ms, "host_ms": host_ms,
                       "one_lane_ms": one_ms, "plain_ms": plain_full_ms, "plain_ms_t2048": plain_ms,
                       "ms_t2048": kern_short_ms, "rel": res["rel"], "rel_plain": res["rel_plain"],
                       "max_abs_err": res["max_abs_err"], **bound}
        print(
            f"kernel phase: biquad_cascade {kind} {lanes} lanes x {SRMR_T} samples, {b.shape[0]} stages:"
            f" kernel {ms:.4f} ms on the device ({ms / bound['bound_ms']:.2f}x its bound; {host_ms:.4f} ms of host"
            f" time to make the call; 4 device launches: the wrapper's two divisions by a0, the scratch's zero fill"
            f" and the scan); plain {plain_full_ms:.1f} ms; one lane at the full T {one_ms:.4f} ms (the carry chain's"
            f" latency); at T=2048 kernel {kern_short_ms:.4f} ms, plain {plain_ms:.1f} ms; bound {bound['bound_ms']:.4f} ms by"
            f" {bound['bound_by']} (bytes {bound['bytes']} -> {bound['bytes_ms']:.4f} ms at 3.35 TB/s;"
            f" ops {bound['ops']} -> {bound['ops_ms']:.4f} ms at 67 TFLOP/s fp32); library call: none",
            flush=True,
        )
        del x, b, a, xs, bs, as_
        torch.cuda.empty_cache()
    return {"max_abs_err": max_err, "worst_share": worst, "cases": results, "timed": timed}


# WSJ0-2mix (Hershey et al. 2016), its test set as Conv-TasNet (Luo & Mesgarani 2019) evaluates it: 3,000
# two-speaker mixtures at 8 kHz, the speakers within +-2.5 dB of each other; made from the seed as speech-like
# modulated noise, the estimates the sources plus noise at 15 dB, the speakers swapped in half the mixtures
WSJ_FS, WSJ_MIXTURES, WSJ_T, WSJ_BATCH, WSJ_EST_SNR_DB = 8000, 3000, 32_000, 50, 15.0
WSJ_CPU_BATCHES = 4  # the batches held card against CPU (the CPU's LU solves are too slow for the whole set)
STFT_N, STFT_HOP = 512, 128  # C-SI-SNR on a 512-point STFT: 257 bins
AUDIO_RTOL = 1e-5  # SNR family, SI-SDR, SA-SDR, C-SI-SNR means against float64 oracles (float32 sums)
SDR_ATOL_DB = 5e-3  # SDR against a float64 Toeplitz solve: the float32 LU of a 512-tap system, in dB per value
AUDIO_STATE_RTOL = {"sdr": 1e-4}  # card vs CPU sums: the LU solves (MAGMA / LAPACK) round apart; the rest 1e-5
SEPARATION_EAGER = {
    "sdr": "its batched LU solve (torch's default for 100 systems of 512 on a card, MAGMA's batched getrf)"
           " cannot be captured, so it stays eager beside the graph",
}


def speech_like(rng, n: int, t: int, fs: int) -> np.ndarray:
    """``n`` signals of ``t`` samples, float64 of unit power: noise with a
    speech-like spectral tilt (a one-pole low-pass) under a syllabic
    envelope of 3-6 Hz with short pauses."""
    from scipy.signal import lfilter

    x = lfilter([1.0], [1.0, -0.9], rng.standard_normal((n, t)), axis=-1)
    time_s = np.arange(t) / fs
    rate, phase = rng.uniform(3, 6, (n, 1)), rng.uniform(0, 2 * np.pi, (n, 1))
    x = x * (np.maximum(np.sin(2 * np.pi * rate * time_s + phase), 0.0) ** 2 + 0.05)
    return x / np.sqrt(np.mean(x**2, axis=-1, keepdims=True))


def make_separation_batch(index: int, n: int = WSJ_BATCH, spk: int = 2):
    """Estimates ``(n, spk, T)`` float32, sources ``(n, spk, T)`` float32 and
    the permutation each estimate slot was given (slot j holds source
    ``perm[j]``; for two speakers, swapped in about half of the mixtures)."""
    rng = np.random.default_rng(SEED + 1000 + index)
    src = speech_like(rng, n * spk, WSJ_T, WSJ_FS).reshape(n, spk, WSJ_T)
    src *= 10 ** (rng.uniform(-2.5, 2.5, (n, spk, 1)) / 20)
    power = np.mean(src**2, axis=-1, keepdims=True)
    est = src + rng.standard_normal(src.shape) * np.sqrt(power) * 10 ** (-WSJ_EST_SNR_DB / 20)
    perm = np.stack([rng.permutation(spk) for _ in range(n)])
    est = np.take_along_axis(est, perm[:, :, None], axis=1)
    return est.astype(np.float32), src.astype(np.float32), perm


def sdr_from_gram(pp, tt, pt, eps: float) -> np.ndarray:
    """SI-SDR in dB from the float64 inner products of an estimate and its
    target (``|p|^2``, ``|t|^2``, ``p.t``), with the metric's own eps:
    ``alpha = (p.t + eps) / (|t|^2 + eps)``, the scaled target's power
    ``alpha^2 |t|^2`` over the residual's ``alpha^2 |t|^2 - 2 alpha p.t + |p|^2``."""
    alpha = (pt + eps) / (tt + eps)
    signal = alpha**2 * tt
    return 10 * np.log10((signal + eps) / (signal - 2 * alpha * pt + pp + eps))


def stft_oracle(x: np.ndarray) -> np.ndarray:
    """``torch.stft``'s 512-point STFT in float64 numpy: centred (reflection
    padding), a periodic Hann window, hop 128, one-sided."""
    pad = np.pad(x, [(0, 0)] * (x.ndim - 1) + [(STFT_N // 2, STFT_N // 2)], mode="reflect")
    frames = 1 + (pad.shape[-1] - STFT_N) // STFT_HOP
    idx = np.arange(frames)[:, None] * STFT_HOP + np.arange(STFT_N)[None, :]
    win = 0.5 - 0.5 * np.cos(2 * np.pi * np.arange(STFT_N) / STFT_N)
    return np.swapaxes(np.fft.rfft(pad[..., idx] * win, axis=-1), -1, -2)  # (..., 257, frames)


def separation_oracle(est: np.ndarray, src: np.ndarray) -> dict:
    """Per-mixture values in float64: PIT's best mean SI-SDR over all
    permutations (brute force) and the permutation, then on the estimates
    it reorders SI-SNR, SNR, SA-SDR, SDR (filter 512 with the metric's 1e-6
    diagonal loading, by ``scipy.linalg.solve_toeplitz``) and C-SI-SNR of
    their STFTs. Every energy comes from float64 inner products."""
    from itertools import permutations as perms

    import scipy.fft
    from scipy.linalg import solve_toeplitz

    p, t = est.astype(np.float64), src.astype(np.float64)
    eps = float(np.finfo(np.float32).eps)
    n, spk, length = p.shape
    gram_pt = np.einsum("bis,bjs->bij", p, t)  # [b, i, j] = p_i . t_j
    pp, tt = np.einsum("bis,bis->bi", p, p), np.einsum("bjs,bjs->bj", t, t)
    cand = np.asarray(list(perms(range(spk))))
    rows = np.arange(spk)
    scores = np.stack([sdr_from_gram(pp[:, c], tt, gram_pt[:, c, rows], eps).mean(-1) for c in cand], axis=1)
    best = np.argmax(scores, axis=1)
    perm = cand[best]
    q = np.take_along_axis(p, perm[:, :, None], axis=1)
    qq, qt = np.take_along_axis(pp, perm, axis=1), np.einsum("bis,bis->bi", q, t)
    snr = 10 * np.log10((tt + eps) / (tt - 2 * qt + qq + eps))
    sa_alpha = (qt.sum(-1) + eps) / (tt.sum(-1) + eps)
    sa_signal = sa_alpha**2 * tt.sum(-1)
    sa = 10 * np.log10((sa_signal + eps) / (sa_signal - 2 * sa_alpha * qt.sum(-1) + qq.sum(-1) + eps))
    qc, tc = q - q.mean(-1, keepdims=True), t - t.mean(-1, keepdims=True)
    si_snr = sdr_from_gram(np.einsum("bis,bis->bi", qc, qc), np.einsum("bis,bis->bi", tc, tc),
                           np.einsum("bis,bis->bi", qc, tc), eps)
    tn = t / np.maximum(np.sqrt(tt), 1e-6)[..., None]
    qn = q / np.maximum(np.sqrt(qq), 1e-6)[..., None]
    n_fft = 2 ** math.ceil(math.log2(2 * length - 1))
    t_fft = scipy.fft.rfft(tn, n_fft, workers=-1)
    q_fft = scipy.fft.rfft(qn, n_fft, workers=-1)
    r0 = scipy.fft.irfft(np.abs(t_fft) ** 2, n_fft, workers=-1)[..., :512]
    r0[..., 0] += 1e-6
    b = scipy.fft.irfft(np.conj(t_fft) * q_fft, n_fft, workers=-1)[..., :512]
    coh = np.asarray([[b[i, s] @ solve_toeplitz(r0[i, s], b[i, s]) for s in range(spk)] for i in range(n)])
    out = {"pit": scores[np.arange(n), best], "perm": perm, "si_snr": si_snr, "snr": snr, "sa_sdr": sa,
           "sdr": 10 * np.log10(coh / (1 - coh))}
    # C-SI-SNR: SI-SDR of the spectra with real and imaginary parts as coordinates
    ze, zs = stft_oracle(q).reshape(n, spk, -1), stft_oracle(t).reshape(n, spk, -1)
    out["c_si_snr"] = sdr_from_gram(np.sum(np.abs(ze) ** 2, -1), np.sum(np.abs(zs) ** 2, -1),
                                    np.sum(ze * np.conj(zs), -1).real, eps)
    return out


def separation_batch(index: int, n: int = WSJ_BATCH, spk: int = 2):
    """One batch of the stream and its float64 oracle (run in worker processes)."""
    est, src, perm = make_separation_batch(index, n, spk)
    return est, src, perm, separation_oracle(est, src)


def separation_members(device) -> dict:
    import tpumetrics_torch.audio as au

    return {"si_snr": au.ScaleInvariantSignalNoiseRatio(device=device), "snr": au.SignalNoiseRatio(device=device),
            "sa_sdr": au.SourceAggregatedSignalDistortionRatio(device=device),
            "sdr": au.SignalDistortionRatio(filter_length=512, device=device)}


def stft(torch, x):
    """512-point STFT (Hann window, hop 128) of ``(..., T)`` signals: ``(..., 257, frames)`` complex64."""
    win = torch.hann_window(STFT_N, device=x.device)
    spec = torch.stft(x.reshape(-1, x.shape[-1]), STFT_N, hop_length=STFT_HOP, window=win, return_complex=True)
    return spec.reshape(*x.shape[:-1], *spec.shape[-2:])


def audio_states(metric) -> dict:
    return {name: np.asarray(getattr(metric, name).cpu()) for name in metric._defaults}


def check_audio_states(label: str, got: dict, want: dict, rtol: float) -> float:
    """Sum states within ``rtol`` relative, count states exact."""
    worst = 0.0
    for name, ref in want.items():
        val = got[name]
        check(val.dtype == ref.dtype and val.shape == ref.shape, f"{label}: {name} {val.dtype} vs {ref.dtype}")
        if name in ("total", "num"):
            check(np.array_equal(val, ref), f"{label}: {name} card {val} vs CPU {ref}")
            continue
        diff = float(np.abs(val.astype(np.float64) - ref.astype(np.float64)).max())
        check(diff <= rtol * abs(float(ref)), f"{label}: {name} card {val} vs CPU {ref} (diff {diff})")
        worst = max(worst, diff / abs(float(ref)))
    return worst


def separation_phase(torch, bc) -> dict:
    """Speech separation scored as separation papers report it, at WSJ0-2mix
    test geometry (see the module note): PIT on the raw estimates, then a
    collection of SI-SNR, SNR, SA-SDR and SDR and a C-SI-SNR on the
    estimates that ``pit_permutate`` reorders; float64 oracles, the card
    against the CPU on the first batches, the recovered permutation against
    the one the data was made with, host syncs, three speakers both ways,
    and the fused phase."""
    import copy

    import tpumetrics_torch.audio as au
    from tpumetrics_torch import MetricCollection
    from tpumetrics_torch.functional.audio import (
        permutation_invariant_training,
        pit_permutate,
        scale_invariant_signal_distortion_ratio,
    )
    from tpumetrics_torch.ops import biquad as bq

    label = f"separation WSJ0-2mix test {WSJ_MIXTURES} mixtures x 2 speakers x {WSJ_T} samples at 8 kHz"
    num_batches = WSJ_MIXTURES // WSJ_BATCH

    def collection(device, fused=False):
        return MetricCollection(separation_members(device), fused_update=fused, device=device)

    pit = au.PermutationInvariantTraining(scale_invariant_signal_distortion_ratio, mode="speaker-wise",
                                          eval_func="max", device="cuda")
    col = collection("cuda")
    csisnr = au.ComplexScaleInvariantSignalNoiseRatio(device="cuda")
    oracle = {k: [] for k in ("pit", "si_snr", "snr", "sa_sdr", "sdr", "c_si_snr")}
    raw, ordered, perms_ok, update_ms = [], [], 0, []
    host_batches = []
    # the batches and their float64 oracles come from worker processes (numpy is single-threaded), in order
    workers = min(8, os.cpu_count() or 1)
    t_gen = time.perf_counter()
    with multiprocessing.get_context("spawn").Pool(workers) as pool:
        made = pool.imap(separation_batch, range(num_batches))
        torch.cuda.synchronize()
        bc.launches, bq.launches = 0, 0
        for i, (est, src, perm, o) in enumerate(made):
            preds, target = torch.from_numpy(est).cuda(), torch.from_numpy(src).cuda()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            pit.update(preds, target)
            _, best_perm = permutation_invariant_training(preds, target, scale_invariant_signal_distortion_ratio)
            reordered = pit_permutate(preds, best_perm)
            col.update(reordered, target)
            csisnr.update(stft(torch, reordered), stft(torch, target))
            torch.cuda.synchronize()
            update_ms.append((time.perf_counter() - t0) * 1e3)
            for k in oracle:
                oracle[k].append(o[k])
            got_perm = best_perm.cpu().numpy()
            check(np.array_equal(o["perm"], np.argsort(perm, axis=1)), f"{label}: the oracle's permutation is not the data's")
            check(np.array_equal(got_perm, o["perm"]), f"{label} batch {i}: PIT's permutation differs from the data's")
            perms_ok += len(got_perm)
            raw.append((preds, target))
            ordered.append((reordered, target))
            if i < WSJ_CPU_BATCHES:
                host_batches.append((est, src))
        pool.close()
        pool.join()
    t_gen = time.perf_counter() - t_gen
    values = {"pit": pit.compute(), **col.compute(), "c_si_snr": csisnr.compute()}
    check(bc.launches == 0 and bq.launches == 0, f"{label}: kernel launches {bc.launches}, {bq.launches}, expected none")
    means = {k: float(np.mean(np.concatenate(v))) for k, v in oracle.items()}
    tol = {k: (AUDIO_RTOL, 0.0) for k in means}
    tol["sdr"] = (0.0, SDR_ATOL_DB)
    worst = check_values(label, values, means, tol)
    sdr_worst = float(np.max(np.abs(np.concatenate(oracle["sdr"]))))  # for the record: the SDR range

    # the card against the CPU on the first batches: states within float32 rounding, counts exact
    cpu = {"pit": au.PermutationInvariantTraining(scale_invariant_signal_distortion_ratio, device="cpu"),
           "col": collection("cpu"), "c_si_snr": au.ComplexScaleInvariantSignalNoiseRatio(device="cpu")}
    card = {"pit": copy.deepcopy(pit), "col": collection("cuda"), "c_si_snr": au.ComplexScaleInvariantSignalNoiseRatio(device="cuda")}
    card["pit"].reset()
    for est, src in host_batches:
        for dev, m in (("cpu", cpu), ("cuda", card)):
            p, t = torch.from_numpy(est).to(dev), torch.from_numpy(src).to(dev)
            m["pit"].update(p, t)
            _, bp = permutation_invariant_training(p, t, scale_invariant_signal_distortion_ratio)
            q = pit_permutate(p, bp)
            m["col"].update(q, t)
            m["c_si_snr"].update(stft(torch, q), stft(torch, t))
    state_err = {"pit": check_audio_states(f"{label} pit", audio_states(card["pit"]), audio_states(cpu["pit"]), 1e-5),
                 "c_si_snr": check_audio_states(f"{label} c_si_snr", audio_states(card["c_si_snr"]),
                                                audio_states(cpu["c_si_snr"]), 1e-5)}
    for name in separation_members("cpu"):
        state_err[name] = check_audio_states(f"{label} {name}", audio_states(card["col"][name]),
                                             audio_states(cpu["col"][name]), AUDIO_STATE_RTOL.get(name, 1e-5))
    del cpu, card

    # host syncs of a steady update of each member (a warmed copy's)
    b0 = ordered[0]
    syncs = {"pit": steady_host_syncs(torch, pit, raw[0]), "c_si_snr": steady_host_syncs(
        torch, csisnr, (stft(torch, b0[0]), stft(torch, b0[1])))}
    syncs.update({name: steady_host_syncs(torch, col[name], b0) for name in separation_members("cpu")})
    unexpected = {k: v for k, v in syncs.items() if v}
    check(not unexpected, f"{label}: host syncs in a steady update of {unexpected}")

    # three speakers: eagerly the Hungarian assignment (a host read, let through), under capture the exhaustive search
    est3, src3, perm3 = make_separation_batch(num_batches, n=10, spk=3)
    p3, t3 = torch.from_numpy(est3).cuda(), torch.from_numpy(src3).cuda()
    hung_syncs = count_host_syncs(torch, lambda: permutation_invariant_training(p3, t3, scale_invariant_signal_distortion_ratio))
    hung_metric, hung_perm = permutation_invariant_training(p3, t3, scale_invariant_signal_distortion_ratio)
    graph = torch.cuda.CUDAGraph()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm the side stream's allocator before the capture
        permutation_invariant_training(p3, t3, scale_invariant_signal_distortion_ratio)
    torch.cuda.current_stream().wait_stream(side)
    with torch.cuda.graph(graph):
        cap_metric, cap_perm = permutation_invariant_training(p3, t3, scale_invariant_signal_distortion_ratio)
    graph.replay()
    torch.cuda.synchronize()
    o3 = separation_oracle(est3, src3)
    check(np.array_equal(hung_perm.cpu().numpy(), np.argsort(perm3, axis=1)), f"{label}: 3 speakers, Hungarian permutation")
    check(torch.equal(cap_perm, hung_perm), f"{label}: 3 speakers, captured exhaustive vs Hungarian permutation")
    diff3 = float((cap_metric - hung_metric).abs().max())
    check(diff3 <= 1e-6 * float(hung_metric.abs().max()), f"{label}: 3 speakers, best metric captured {cap_metric} vs eager {hung_metric}")
    check(bool(np.allclose(hung_metric.cpu().numpy(), o3["pit"], rtol=AUDIO_RTOL, atol=0)), f"{label}: 3 speakers vs oracle")
    check(hung_syncs >= 1, f"{label}: 3 speakers, the Hungarian path read nothing on the host")
    del graph

    steady = update_ms[2:]
    print(
        f"separation phase: {label}: {num_batches} batches of {WSJ_BATCH} (made from the seed with their float64"
        f" oracles in {workers} worker processes, the stream in {t_gen:.1f} s); reduced: every mixture a fixed 4 s; PIT (speaker-wise SI-SDR, max) recovered the"
        f" data's permutation for all {perms_ok} mixtures; values against float64 oracles (brute-force PIT,"
        f" scipy solve_toeplitz SDR), worst share of the tolerance {max(worst.values()):.3f} ({max(worst, key=worst.get)}):"
        + "".join(f" {k} {float(values[k]):.4f} dB (oracle {means[k]:.4f})" for k in means)
        + f"; card vs CPU on {WSJ_CPU_BATCHES} batches, sums worst {max(state_err.values()):.2e} relative"
        f" ({max(state_err, key=state_err.get)}), counts exact; host syncs in a steady update {syncs}"
        f" (none expected; eager beside the fused graph: {'; '.join(f'{k}, {v}' for k, v in SEPARATION_EAGER.items())});"
        f" three speakers (10 mixtures):"
        f" the Hungarian path eagerly ({hung_syncs} host syncs, let through), the exhaustive one under capture,"
        f" the same permutations and best metric within {diff3:.1e}; update (PIT, reorder, collection, 2 STFTs,"
        f" C-SI-SNR) first {update_ms[0]:.3f} ms, steady median {np.median(steady):.3f} ms",
        flush=True,
    )
    profile_step(torch, col, ordered[2], label)
    del col
    fused = fused_pair(torch, label, lambda f: collection("cuda", f), ordered,
                       exempt={"sdr": SEPARATION_EAGER["sdr"]})
    check(fused["eager_leaders"] == ["sdr"], f"{label}: eager leaders {fused['eager_leaders']}")
    return {"launches": 0, "biquad_launches": 0, "update_ms": update_ms, "oracle_worst": worst, "state_err": state_err,
            "host_syncs": syncs, "three_speakers": {"hungarian_syncs": hung_syncs, "captured_diff": diff3},
            "values": {k: float(v) for k, v in values.items()}, "oracle": means, "sdr_range": sdr_worst,
            "reduced": "every mixture a fixed 4 s (32,000 samples); WSJ0-2mix's test mixtures vary in length",
            "fused": fused}


# REVERB challenge geometry (Kinoshita et al. 2016): 16 kHz utterances of a dereverberation evaluation, each 8 s,
# made from the seed as speech-like modulated noise convolved with an exponentially decaying room response
SRMR_RT60 = (0.4, 0.7)  # seconds, about the challenge's medium and large rooms (RT60 0.5 and 0.7 s)
SRMR_CPU_SECONDS, SRMR_CPU_UTTERANCES = 2, 2
SRMR_CPU_RTOL = 1e-3  # card vs CPU: cuFFT and pocketfft round the Hilbert envelope apart, and the
# modulation filters' poles near 1 carry that difference along T (see the phase's printed measurement)


def make_utterances(seed: int, n: int = SRMR_UTTERANCES, t: int = SRMR_T):
    """Clean and reverberant utterances ``(n, t)`` float32: the clean speech-like
    signal at a level below full scale, and its convolution with a room
    response (a direct path and an exponentially decaying noise tail of RT60
    in ``SRMR_RT60``)."""
    from scipy.signal import fftconvolve

    rng = np.random.default_rng(seed)
    clean = 0.05 * speech_like(rng, n, t, SRMR_FS)
    rir_t = np.arange(int(0.6 * SRMR_FS)) / SRMR_FS
    rt60 = rng.uniform(*SRMR_RT60, (n, 1))
    rir = rng.standard_normal((n, rir_t.size)) * np.exp(-6.908 * rir_t / rt60) * 0.3
    rir[:, 0] = 1.0
    reverb = np.stack([fftconvolve(c, r)[:t] for c, r in zip(clean, rir)])
    return clean.astype(np.float32), reverb.astype(np.float32)


def srmr_phase(torch, bc) -> dict:
    """SRMR over a dereverberation evaluation's utterances (see the module
    note): ``norm=False`` over the stream and ``norm=True`` over one batch;
    the card against the CPU on short utterances, a clean signal against its
    reverberant copy, host syncs, the kernel's launches and its share of the
    update's device time, and the fused phase."""
    from tpumetrics_torch import MetricCollection
    from tpumetrics_torch.audio import SpeechReverberationModulationEnergyRatio as SRMR
    from tpumetrics_torch.functional.audio import speech_reverberation_modulation_energy_ratio as srmr_fn
    from tpumetrics_torch.ops import biquad as bq

    label = f"SRMR REVERB-like {SRMR_UTTERANCES} utterances x {SRMR_T} samples at 16 kHz"
    t0 = time.perf_counter()
    clean, reverb = make_utterances(SEED + 11)
    t_gen = time.perf_counter() - t0
    dev_batches = [(torch.from_numpy(reverb[i : i + SRMR_BATCH]).cuda(),) for i in range(0, SRMR_UTTERANCES, SRMR_BATCH)]

    def collection(device, fused=False):
        return MetricCollection({"srmr": SRMR(SRMR_FS, device=device)}, fused_update=fused, device=device)

    col = collection("cuda")
    metric_norm = SRMR(SRMR_FS, norm=True, device="cuda")
    torch.cuda.synchronize()
    bc.launches, bq.launches = 0, 0
    update_ms, scores = [], []
    for i, (batch,) in enumerate(dev_batches):
        t1 = time.perf_counter()
        col.update(batch)
        torch.cuda.synchronize()
        update_ms.append((time.perf_counter() - t1) * 1e3)
    value = col.compute()["srmr"]
    metric_norm.update(dev_batches[0][0])
    value_norm = metric_norm.compute()
    launches = bq.launches
    check(bc.launches == 0, f"{label}: {bc.launches} binned_confusion launches, expected none")
    check(launches == 2 * (len(dev_batches) + 1), f"{label}: {launches} biquad_cascade launches, expected 2 per update")
    per_utt = torch.cat([srmr_fn(b, SRMR_FS) for (b,) in dev_batches]).cpu().numpy()
    check(bool(np.all(np.isfinite(per_utt))) and per_utt.shape == (SRMR_UTTERANCES,), f"{label}: scores {per_utt}")
    check(abs(float(value) - float(np.mean(per_utt, dtype=np.float64))) <= 1e-5 * abs(float(value)),
          f"{label}: the metric {float(value)} vs the mean of its scores {per_utt.mean()}")
    clean_scores = srmr_fn(torch.from_numpy(clean[:SRMR_BATCH]).cuda(), SRMR_FS).cpu().numpy()
    check(bool(np.all(clean_scores > per_utt[:SRMR_BATCH])),
          f"{label}: clean {clean_scores} not above reverberant {per_utt[:SRMR_BATCH]}")

    # the card against the CPU on short utterances, both normalisations
    short = reverb[:SRMR_CPU_UTTERANCES, : SRMR_CPU_SECONDS * SRMR_FS]
    cpu_rel = {}
    for norm in (False, True):
        got = srmr_fn(torch.from_numpy(short).cuda(), SRMR_FS, norm=norm).cpu().numpy().astype(np.float64)
        want = srmr_fn(torch.from_numpy(short), SRMR_FS, norm=norm).numpy().astype(np.float64)
        cpu_rel[f"norm={norm}"] = float(np.max(np.abs(got - want) / np.abs(want)))
        check(cpu_rel[f"norm={norm}"] <= SRMR_CPU_RTOL, f"{label}: card {got} vs CPU {want} (norm={norm})")

    syncs = steady_host_syncs(torch, col["srmr"], dev_batches[0])
    check(syncs == 0, f"{label}: {syncs} host syncs in a steady update")
    print(
        f"srmr phase: {label}: {len(dev_batches)} batches of {SRMR_BATCH} (made on the host from the seed in"
        f" {t_gen:.1f} s, RT60 {SRMR_RT60} s); reduced: {SRMR_UTTERANCES} utterances at a fixed 8 s, a subset of"
        f" the evaluation set; SRMR (norm=False) {float(value):.6f} (per utterance {per_utt.min():.4f} to"
        f" {per_utt.max():.4f}), norm=True on one batch {float(value_norm):.6f}; clean above reverberant in every"
        f" utterance of a batch (clean {clean_scores.mean():.4f} vs {per_utt[:SRMR_BATCH].mean():.4f}); card vs CPU on"
        f" {SRMR_CPU_UTTERANCES} utterances of {SRMR_CPU_SECONDS} s, worst relative difference {cpu_rel} (tolerance"
        f" {SRMR_CPU_RTOL}); biquad_cascade launches {launches} (2 per update); host syncs in a steady update"
        f" {syncs}; update first {update_ms[0]:.3f} ms, steady median {np.median(update_ms[1:]):.3f} ms",
        flush=True,
    )
    profile_step(torch, col, dev_batches[1], label)
    del col
    fused = fused_pair(torch, label, lambda f: collection("cuda", f), dev_batches)
    return {"launches": 0, "biquad_launches": launches, "update_ms": update_ms, "value": float(value),
            "value_norm": float(value_norm), "clean_vs_reverb": [float(clean_scores.mean()), float(per_utt[:SRMR_BATCH].mean())],
            "cpu_rel": cpu_rel, "host_syncs": syncs,
            "reduced": f"{SRMR_UTTERANCES} utterances of a fixed 8 s, a subset of the evaluation set", "fused": fused}


def sync_phase(torch, bc, smi: str) -> dict:
    """The ImageNet-size collection synced over NCCL at world size 1 (see the module note)."""
    import tempfile

    import torch.distributed as dist
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from tpumetrics_torch import CatMetric, MeanMetric, MetricCollection
    from tpumetrics_torch.classification import MulticlassAccuracy, MulticlassAUROC, MulticlassF1Score
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
            fused = fused_pair(torch, label, collection, dev_batches, update_of)
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
        iir = sum(e.device_time_total for e in kernels if "biquad_cascade_kernel" in e.key)
        iir_n = sum(e.count for e in kernels if "biquad_cascade_kernel" in e.key)
        iir_part = f" biquad_cascade kernels x{iir_n} {iir:.1f} us ({iir / 10 / busy_ms:.1f}% of the union);" if iir else ""
        print(
            f"profile: {label}: steady {step} {wall_ms:.3f} ms wall unprofiled; profiled run {profiled_ms:.3f} ms wall,"
            f" device busy (union of {len(device)} device intervals) {busy_ms:.3f} ms"
            f" = {100 * busy_ms / profiled_ms:.1f}% of it, first-to-last device span {span_ms:.3f} ms;"
            f" peak device memory above resident {scratch_mb:.1f} MiB;"
            f" binned_confusion kernels (rank + count) {ours:.1f} us;{iir_part}"
            f" top: {parts or 'the profiler saw no device time'}",
            flush=True,
        )


def main() -> None:
    import torch

    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs a CUDA card")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        from tpumetrics_torch.ops import _build
        from tpumetrics_torch.ops import binned_confusion as bc
        from tpumetrics_torch.ops import biquad as bq
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
    iir = biquad_kernel_phase(torch, bq)
    paths = {
        "imagenet": slice_phase(
            torch, bc, "ImageNet-1k val 50000x1000 T=200, classification report", 50000, 1000, 200, 8192, extra=True
        ),
        "headline": slice_phase(torch, bc, "bench headline 40960x128 T=64", 5 * 8192, 128, 64, 8192),
        "binary": task_phase(torch, bc, "binary"),
        "fairness": fairness_phase(torch, bc),
        "multilabel": task_phase(torch, bc, "multilabel"),
        "segmentation": segmentation_phase(torch, bc),
        "ratings": ratings_phase(torch, bc),
        "multioutput": multioutput_phase(torch, bc),
        "clustering": clustering_phase(torch, bc),
        "nominal": nominal_phase(torch, bc),
        "retrieval": retrieval_phase(torch, bc),
        "separation": separation_phase(torch, bc),
        "srmr": srmr_phase(torch, bc),
        "sync": sync_phase(torch, bc, smi),
    }
    pairwise = pairwise_phase(torch, bc)
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
        launches_by_path[f"{path} fused phase, unfused"] = p["fused"]["kernel_launches"]["binned_confusion"]["plain"]
        launches_by_path[f"{path} fused phase, fused (eager + replayed)"] = p["fused"]["kernel_launches"]["binned_confusion"]["fused"]
    fused_report = {
        path: {k: p["fused"][k] for k in (
            "modes", "plain_ms", "fused_ms", "plain_ms_all", "fused_ms_all", "gc_ms", "gc_runs", "new_segments",
            "profile", "capture_s", "graphs", "kernel_launches", "eager_leaders",
        )}
        for path, p in paths.items()
    }
    main_shape = kern["timed"]["main path 8192x1000x200"]
    iir_by_path = {path: p.get("biquad_launches", 0) for path, p in paths.items()}
    for path, p in paths.items():
        iir_by_path[f"{path} fused phase, unfused"] = p["fused"]["kernel_launches"]["biquad_cascade"]["plain"]
        iir_by_path[f"{path} fused phase, fused (eager + replayed)"] = p["fused"]["kernel_launches"]["biquad_cascade"]["fused"]
    iir_shape = iir["timed"]["gammatone"]
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
            },
            {
                "name": "biquad_cascade",
                "route": "cuda",
                "source": "tpumetrics_torch/csrc/biquad_cascade.cu",
                "replaces": "tpumetrics/functional/audio/srmr.py:143",
                "launches": sum(iir_by_path.values()),
                "launches_by_path": {k: v for k, v in iir_by_path.items() if v},
                "max_abs_err": iir["max_abs_err"],  # against the plain loop, over every case (a scan reassociates)
                "rel": iir_shape["rel"],  # against the float64 reference: at most 2 x rel_plain + 1e-6
                "rel_plain": iir_shape["rel_plain"],
                "rel_worst_share": iir["worst_share"],  # rel over its tolerance, the worst case of each bank
                "ms": iir_shape["ms"],
                "plain_ms": iir_shape["plain_ms"],  # the plain loop at the same shape, one call: a launch per op and step
                "bound_ms": iir_shape["bound_ms"],
                "bound_by": iir_shape["bound_by"],
                "one_lane_ms": iir_shape["one_lane_ms"],  # one lane at the full T: the carry chain's latency
                "library_ms": None,  # no PyTorch call runs an IIR recurrence (torchaudio's lfilter is not installed)
                "shape": [iir_shape["lanes"], iir_shape["t"], iir_shape["stages"]],
                "timed_shapes": iir["timed"],
                "card": smi,
            },
        ],
        "fused_update": fused_report,
        "ece_err": ECE_ERR,
        "fairness_count_ms": {"per_group_count": paths["fairness"]["count_ms"], "histogram": paths["fairness"]["hist_ms"]},
        "regression": {
            "ratings": {k: paths["ratings"][k] for k in ("compute_ms", "rank_2m_ms", "host_syncs", "oracle_worst")},
            "multioutput": {k: paths["multioutput"][k] for k in (
                "compute_ms", "kendall_ms", "nan_row_syncs", "tracker_steps", "oracle_worst")},
        },
        "clustering": {
            **{k: paths["clustering"][k] for k in ("compute_ms", "parts_ms", "oracle_worst", "values")},
            "fused_intrinsic": {k: paths["clustering"]["fused_intrinsic"][k] for k in (
                "modes", "plain_ms", "fused_ms", "capture_s", "graphs", "eager_leaders")},
            "reduced": "none",
        },
        "nominal": {
            **{k: paths["nominal"][k] for k in (
                "compute_ms", "oracle_worst", "matrix_ms", "matrix_busy_ms", "matrix_host_reads_per_pair", "matrix_worst",
                "fleiss")},
            "reduced": f"CIFAR-10H: a fixed {RATERS} raters per image (the dataset has 47-63)",
        },
        "retrieval": {
            **{k: paths["retrieval"][k] for k in ("compute_ms", "parts_ms", "host_syncs", "oracle_worst", "values",
                                                  "graded_ndcg10")},
            "reduced": "none",
        },
        "pairwise": pairwise,
        "audio": {
            "separation": {k: paths["separation"][k] for k in (
                "oracle_worst", "state_err", "host_syncs", "three_speakers", "values", "oracle", "reduced")},
            "srmr": {k: paths["srmr"][k] for k in (
                "value", "value_norm", "clean_vs_reverb", "cpu_rel", "host_syncs", "reduced")},
        },
    }
    print(f"script wall time: {time.perf_counter() - t_start:.1f} s", flush=True)
    print(json.dumps(report), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
