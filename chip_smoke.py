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
   lanes x 128,000 samples, the shapes its main path gives the kernel:
   every lane against float64, the plain loop on one lane of each filter
   at the full T in worker processes started with the script), with its
   time at those shapes (events, L2 flushed), a one-lane launch's at the
   full T (the carry chain's latency), the plain version's at T=2048, and
   the bytes bound; the phase runs after the separation phase; then a separation
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
5h. image streams, each inside torch's own TF32 defaults (cuDNN may run
   float32 convolutions in TF32; the library must keep its own in full
   float32): a restoration stream at DIV2K validation size as NTIRE, EDSR
   and SwinIR evaluate it (100 8-bit RGB images of a fixed 2040 x 1356,
   made from the seed as 1/f textures in worker processes; each prediction
   its target blurred and noisy; batches of 4) through an RGB collection
   (PSNR, SSIM, MS-SSIM, UQI, VIF), the predictions' total variation, and a
   BT.601 Y collection (PSNR, SSIM, PSNR-B); each of the first two batches
   on the card against the port's CPU path in a worker process (float32
   sums within CANCEL_EPS of their cancelling moments' terms carried
   through each score, counts exact), the values on the first two images
   against float64 numpy/scipy oracles (worker processes), host syncs of
   each member's steady update, the convolutions' share of an update's
   device time; and a pan-sharpening stream at PanCollection's WorldView-3
   test geometry: 20 reduced-resolution images (8 x 256 x 256) through
   ERGAS (ratio 4), SAM and its capacity copy, RASE and RMSE-SW (window 8),
   and 20 full-resolution outputs (8 x 512 x 512) against their 8 x 128 x
   128 multispectral inputs through D-lambda and its capacity copy; the
   same checks; each collection with its fused phase;
5i. monitoring phase: a CTR model's online monitor over the Criteo display-advertising challenge training
   log (Kaggle, 2014: 45,840,617 rows over 7 days; 13 integer count features with missing values), made on
   the card from the seed in bulk and served in 700 updates of 65,536 rows (a ragged last 30,953, padded and
   masked): a fused collection of the model's scores (``SketchQuantiles`` over a 100-update window in 10
   panes and over all rows, PSI, KL and KS drift monitors against 1,000,000 training scores, windowed mean,
   sum, max and min, a decayed mean), a fused collection of serving latencies (windowed quantiles, mean,
   max) and 13 unfused PSI monitors of I1-I13 against day 1; from update 400 the scores' logits shift by 0.3
   and I4's counts double; ``compute()`` every 10 updates under ``stream_scope("criteo-ctr")`` inside a
   ledger capture. Checked against oracles on the card in float64/int64 (the bucket index by
   ``searchsorted`` over the level bounds, itself held to the numpy ``sketch_index_oracle``, as the port's
   index is): every window's and the cumulative sketch's counts bit for bit at every refresh, the quantiles
   equal to the oracle sketch's and within 1/capacity of the exact ones, windowed sums within 1e-6, the
   decayed mean within 1e-5, PSI/KL/KS within 1e-6; each monitor alerts once per crossing at the refresh
   the oracle's latch predicts, as ``drift_alert`` ledger events and Prometheus series under the stream's
   label that ``release_stream`` removes; the same stream on the CPU path in five worker processes fed
   the card's data (sketches and counts identical, float sums within 1e-6; cut to the first 450 updates
   and printed as reduced if it would take longer than 45 s); host syncs of every member's steady update;
   and each collection's fused phase;
5j. the image metrics that run a backbone, with torch's TF32 defaults (the library keeps its own convolutions
   and products in full float32): a generative stream at CIFAR-10 FID geometry (fid50k_full's 50,000 real and
   50,000 generated 32 x 32 uint8 images, made on the card from the seed; FID over the first 5,000 of each, at
   299 x 299 through InceptionV3 at full width with ``random_inception_params``, in batches of 256) through
   ``FrechetInceptionDistance`` (its update one CUDA graph per batch signature; its extractor also sums the
   features' float64 moments: FID against a float64 scipy ``sqrtm`` oracle within a bound scaled by the moments'
   cancellation), and ``KernelInceptionDistance`` (100 subsets of 1,000), MiFID and ``InceptionScore`` over the
   first 1,250 of each set on the one resident 2048-tap handle (KID and IS against float64 oracles on the card
   over the same draws); the card's features for 32 images against the port's CPU path (a worker), streaming
   against a single pass, host syncs, update and compute times, the bfloat16 policy's rate and gates; and a
   perceptual stream: ``LearnedPerceptualImagePatchSimilarity`` over the restoration stream's 100 DIV2K pairs
   (AlexNet; VGG-16 and SqueezeNet on the first 10; random convs, the bundled heads), the first 2 pairs against
   the port's float64 CPU path (workers), and ``PerceptualPathLength`` at the JAX defaults (10,000 samples,
   epsilon 1e-4, resize 64, VGG-16) over a seeded generator of 3 x 256 x 256 images, its first 256 distances
   against a float64 oracle of the definition on the same latents;
5k. detection phase, at COCO val2017 size as every detection paper evaluates it (the COCO detection protocol,
   pycocotools' ``COCOeval`` defaults): 5,000 images of 640 x 480, 80 classes (person about 30 %), 36,781-like
   ground truths (about 7.3 an image, to 60; 41/34/24 % small/medium/large, 1 % crowds, instance areas of 0.5-0.9
   of their boxes and 0 on a tenth) and a detector's top-100 an image (jittered copies over IoU 0.3-0.98, class
   confusions, background; float32 scores, a fifth on a 1/1024 grid, some -0.0 and 0.0; integer boxes with IoUs
   exactly 0.5 and 0.75 on 5 % of the images), made from the seed: ``MeanAveragePrecision`` list-of-dicts (32
   images an update) and packed (``pack_detection_batch``, 128/64 slots, MaskedBuffer rows of 524,288 / 65,536,
   in a fused collection: the ragged last batch eager, the rest replayed, one under host-sync errors), and micro
   with ``class_metrics``; each ``compute()`` timed by stage; the card's float64 precision/recall arrays and
   every summary value bit for bit the numpy protocol's over all images, the per-cell reference's over the
   first 500 (worker processes started with the perceptual phase, the macro protocol split by class), list and packed equal, a planted dropped match
   caught; ``coco_greedy_match`` at the stream's one call (every cell, events, L2 flushed) against its bound and
   its plain version, with its grids, its cells by path as the kernel counted them and its host time (and no host sync), and bit for bit
   the plain version there, on the first 500 images' cells (also on the CPU) and at its edge shapes; the IoU family on the first 500 images against float64 oracles (1e-5) and panoptic
   quality on 200 COCO-panoptic-shaped images (133 categories), its states on the card against the CPU path's
   (worker processes started with the script, a batch each, summed in order; counts exact,
   ``iou_sum`` within one float32 ulp);
5l. text phases, at the end of the run: ``token_nll`` (perplexity's token NLL, one read of the logits) held
   beside its plain version on the same inputs to a float64 reference, row by row: row_error(kernel) <= 2
   row_error(plain) + 1e-6 (absolute below one nat, relative above), NaN where the plain version has NaN, the
   call's total within 1e-6 of float64; at Llama 3's shape (8 x 2,048 x 128,256, bf16 and float32), GPT-2's (8 x
   1,024 x 50,257: rows not 16-byte aligned) and its shifted ``logits[:, :-1]``, Llama 2's (V = 32,000), V = 1,
   a ragged fp16 shape, an all-ignored batch, targets past V, wrapped and -100 unignored (NaN where JAX gives
   NaN), two calls and three graph replays bit for bit, the backward against the plain version's autograd
   gradient; timed (events, L2 flushed) at the Llama 3 and GPT-2 shapes beside its bytes bound, the plain
   version, ``cross_entropy`` and each one's peak memory above its inputs. Then a perplexity stream: WikiText-103's
   test split (245,569 tokens) as 15 updates of 8 x 2,048 bf16 logits at V = 128,256 made on the card from the
   seed, N(0, 2) with the target's logit at N(11, 2) (a mean NLL near 3 nats), -100 past the last token, through
   ``Perplexity(ignore_index=-100)``: the value within 1e-6 of a float64 oracle built in chunks, the kernel's
   launches, an update's peak memory against the plain path's, and its fused phase. Then four string streams at
   their datasets' shapes, made from the seed and cut to a prefix (``TEXT_STREAMS``; one host thread): MT at WMT14
   newstest2014 En-De (BLEU, SacreBLEU 13a and intl, chrF, chrF++, TER, EED), ASR at LibriSpeech test-clean
   (WER, CER, MER, WIL, WIP, EditDistance), SQuAD v1.1 dev, and CNN/DailyMail test (ROUGE-1/2/L/Lsum); each
   collection's states on the card bit for bit the port's CPU path's (two niced spawn workers started with the
   script), its values in their seeded ranges;
5m. encoder phases, after the text phases, on random weights at the published widths made on the card from the
   seed (no checkpoint is in the repository; words hashed into each model's vocabulary): ``bert_greedy_match``
   (BERTScore's greedy cosine matching, the similarity matrix kept on the chip) held beside its plain version to a
   float64 reference, cell by cell: |kernel - ref| <= 2 |plain - ref| + 1e-6, two calls bit for bit; at the MT
   stream's call (3,003 pairs, L = 1, D = 1,024), at ``all_layers`` (64 x 25 x 512 x 512 x 1,024) and at edge
   cases (every real similarity negative, Sp != St, one token, rows of zero weight, D = 100, tile edges, maxima past
   48 KB of shared memory); timed (events, L2 flushed) beside its bound, the plain version, the composite torch ops
   and each one's peak memory. Then BERTScore over WMT14 newstest2014 En-De's 3,003 pairs on RoBERTa-large (batch
   64; compute-time with idf off and on, stream-time through a ``backbone=`` handle), the matcher's launches counted;
   stream-time against compute-time, the first 64 pairs against a float64 run of the encoder (and a planted fault,
   one target's words reversed, that the check catches), the stream's scoring against float64 scoring of its own
   embeddings. InfoLM (KL with idf at temperature 0.25, twice bit for bit; an alpha-divergence) on BERT-base-uncased's
   masked LM over the first 96 pairs, the first 8 against float64. CLIPScore over 1,000 MS-COCO val2017-shaped
   images and captions on CLIP ViT-L/14, then CLIP-IQA (quality, sharpness, a custom pair) on the same images, the
   first 8 against float64;
6. sync phase: the ImageNet-size stream again, through the collection of
   the slice phase with a ``MeanMetric`` and a ``CatMetric`` of per-batch
   values added, its ``compute()`` synced over a real NCCL process group of
   world size 1 (one card) through ``MetricCollection``'s fused sync:
   values and synced states bit for bit equal to the unsynced ones, every
   state back to its own tensor after ``compute()``, the collectives of one
   ``compute()`` (one ``all_reduce`` per (op, dtype) class of the group
   leaders' states, two gathers per list state) counted by a wrapper around
   the backend and in ``torch.profiler``, and in a ledger capture (the same
   collectives and bytes, the members' tags), the binned update free of host
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
bc)``, ``chip_smoke.biquad_kernel_phase(torch, bq, chip_smoke.biquad_plain_start())``,
``chip_smoke.restoration_phase(torch, bc)``,
``chip_smoke.pansharpening_phase(torch, bc)``, ``chip_smoke.criteo_phase(torch, bc)``,
``chip_smoke.generative_phase(torch, bc)`` and ``chip_smoke.perceptual_phase(torch, bc)`` (no build needed; they
start worker processes with ``spawn``; run alone, the perceptual phase makes its DIV2K pairs anew), and
``chip_smoke.detection_phase(torch, chip_smoke.detection_oracle_start())`` (after the build);
``chip_smoke.text_kernel_phase(torch, tn)``, ``chip_smoke.perplexity_phase(torch, tn)`` (with ``from
tpumetrics_torch.ops import token_nll as tn``, after the build) and ``chip_smoke.text_phase(torch,
chip_smoke.text_cpu_start())`` (spawn workers); ``chip_smoke.bert_kernel_phase(torch, bm)`` and
``chip_smoke.bertscore_phase(torch, bm)`` (with ``from tpumetrics_torch.ops import bert_match as bm``, after the
build), ``chip_smoke.infolm_phase(torch)`` and ``chip_smoke.clip_phase(torch)``.

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
import queue
import subprocess
import sys
import threading
import time
import warnings
import zlib

import numpy as np

H100_BYTES_PER_S = 3.35e12  # HBM3, H100 SXM data sheet
H100_FP32_OPS_PER_S = 67e12  # fp32 outside the tensor cores, H100 SXM data sheet
H100_FP64_OPS_PER_S = 34e12  # fp64 outside the tensor cores, H100 SXM data sheet
IOU_FAMILY_ATOL = 1e-5  # IoU, GIoU, DIoU, CIoU means (float32 entries, float32 sums) against float64
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


def buffered(metric, rows: int = CLUSTER_N, shapes: dict = None):
    """``metric`` with its list states in MaskedBuffers of ``rows`` rows (the
    stream's) of ``shapes[state]`` (every state, the clustering data's rows
    ``CLUSTER_D`` wide and the rest scalars, when omitted), installed as its
    live states: its update appends to them with no host read, and a fused
    collection captures it."""
    from tpumetrics_torch.interop import load_state

    if shapes is None:
        shapes = {name: (CLUSTER_D,) if name == "data" else () for name in metric._defaults}
    for name, shape in shapes.items():
        metric.set_state_capacity(name, rows, feature_shape=shape)
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


def biquad_call_inputs(torch, kind: str, batch: int, t: int, seed: int, device: str = "cuda"):
    """``(x, b, a, clamp)`` on ``device`` as SRMR's two call sites give them at
    16 kHz: the gammatone bank (4 stages, clipped, ``batch x 23`` lanes of
    one waveform each) or the modulation bank (1 stage, ``batch x 23 x 8``
    lanes of envelopes)."""
    from tpumetrics_torch.functional.audio import srmr

    rng = np.random.default_rng(seed)
    const = srmr._constants(SRMR_FS, GAMMATONE_CHANNELS, 125.0, 4.0, 128.0, torch.device(device))
    if kind == "gammatone":
        wave = rng.uniform(-1, 1, (batch, t)).astype(np.float32)
        x = torch.from_numpy(wave).to(device)[:, None, :].expand(batch, GAMMATONE_CHANNELS, t).reshape(-1, t)
        return x.contiguous(), const["as_"].repeat(1, batch, 1), const["bs"].repeat(1, batch, 1), True
    env = np.abs(rng.standard_normal((batch * GAMMATONE_CHANNELS, t))).astype(np.float32) * 1e-3
    x = torch.from_numpy(env).to(device)[:, None, :].expand(-1, MOD_BANDS, t).reshape(-1, t)
    lanes = batch * GAMMATONE_CHANNELS
    return x.contiguous(), const["mb"].repeat(lanes, 1)[None], const["ma"].repeat(lanes, 1)[None], False


BIQUAD_CHUNK, BIQUAD_TILE = 16, 4096  # samples a thread and a block of the kernel run (csrc/biquad_cascade.cu)
# the lanes of the main-path shapes the plain loop runs on at the full T (one of each filter: the first utterance's
# 23 gammatone channels; its first three channels' 8 modulation bands), on the host in a worker: on the card the loop
# is a launch per op and time step whatever the lanes, 74.3 s and 16.2 s at the full shapes on a slow host
BIQUAD_PLAIN_LANES = {"gammatone": list(range(GAMMATONE_CHANNELS)), "modulation": list(range(3 * MOD_BANDS))}


def biquad_plain_worker(kind: str) -> tuple:
    """The plain loop on ``BIQUAD_PLAIN_LANES[kind]`` of the main-path shape's inputs, on the CPU (the same float32
    ops as on the card, so the same values): ``(output, seconds)``."""
    import torch

    from tpumetrics_torch.ops import biquad as bq

    torch.set_num_threads(1)
    x, b, a, clamp = biquad_call_inputs(torch, kind, SRMR_BATCH, SRMR_T, SEED + 3, device="cpu")
    lanes = BIQUAD_PLAIN_LANES[kind]
    t0 = time.perf_counter()
    out = bq.biquad_cascade_plain(x[lanes].contiguous(), b[:, lanes].contiguous(), a[:, lanes].contiguous(), clamp)
    return out.numpy(), time.perf_counter() - t0


def biquad_plain_start():
    """The plain loops of ``biquad_plain_worker`` in two niced spawn workers, started with the script."""
    pool = multiprocessing.get_context("spawn").Pool(2, initializer=os.nice, initargs=(19,))
    return pool, {kind: pool.apply_async(biquad_plain_worker, (kind,)) for kind in ("gammatone", "modulation")}


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


def biquad_kernel_phase(torch, bq, plain_cpu) -> dict:
    """``biquad_cascade`` on the card held to its contract (``biquad_check``)
    beside its plain version on the same inputs: both call sites' shapes at
    short T, the chunk and tile edges, edge cases (T=1, one lane, silence,
    lanes driven into the clip, NaN and inf), a graph replay against the eager
    call bit for bit, and the SRMR stream's full shapes (the shapes its main
    path gives the kernel, on the inputs that are timed): there every lane
    against the float64 reference, the plain loop on ``BIQUAD_PLAIN_LANES``
    (``plain_cpu``: ``biquad_plain_start``'s workers); its time at the full
    shapes, a one-lane launch's at the full T (the carry chain's latency), and
    the plain version's at T=2048 on the card."""
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
    for kind, n_lanes in (("gammatone", SRMR_BATCH * GAMMATONE_CHANNELS), ("modulation", SRMR_BATCH * GAMMATONE_CHANNELS * MOD_BANDS)):
        x, b, a, clamp = biquad_call_inputs(torch, kind, SRMR_BATCH, SRMR_T, SEED + 3)
        ms, host_ms = cuda_ms(torch, lambda: bq.biquad_cascade(x, b, a, clamp), reps=5, ahead=flush)
        one_ms, _ = cuda_ms(torch, lambda: bq.biquad_cascade(x[:1], b[:, :1], a[:, :1], clamp), reps=3, ahead=flush)
        # the main path's shape: the kernel on every lane against float64, the plain loop (its worker's output) on
        # one lane of each filter, rel(kernel) <= 2 rel(plain) + 1e-6 over those lanes and over every lane
        got = bq.biquad_cascade(x, b, a, clamp)
        again = bq.biquad_cascade(x, b, a, clamp)
        torch.cuda.synchronize()
        check(same_bits(torch, got, again), f"biquad_cascade at the {kind} main-path shape: two calls differ")
        lanes = BIQUAD_PLAIN_LANES[kind]
        t0 = time.perf_counter()
        plain_out, plain_cpu_s = plain_cpu[1][kind].get(timeout=900)
        waited = time.perf_counter() - t0
        want = torch.from_numpy(plain_out).cuda()
        check(torch.equal(~torch.isfinite(got[lanes]), ~torch.isfinite(want)),
              f"biquad_cascade at the {kind} main-path shape: non-finite outputs apart from the plain loop's")
        ref = bq.biquad_cascade_reference(x, b, a, clamp)
        rel, rel_lanes = bq.relative_error(got, ref), bq.relative_error(got[lanes], ref[lanes])
        rel_plain = bq.relative_error(want, ref[lanes])
        check(max(rel, rel_lanes) <= bq.REL_SLACK * rel_plain + bq.REL_FLOOR,
              f"biquad_cascade at the {kind} main-path shape: rel {rel:.3e} (its lanes {rel_lanes:.3e}) against the"
              f" float64 reference, the plain loop's {rel_plain:.3e} on {len(lanes)} lanes")
        fin = torch.isfinite(got[lanes]) & torch.isfinite(want)
        res = {"rel": rel, "rel_lanes": rel_lanes, "rel_plain": rel_plain,
               "max_abs_err": float((got[lanes] - want)[fin].abs().max()) if bool(fin.any()) else 0.0}
        max_err = max(max_err, res["max_abs_err"])
        worst[kind] = max(worst[kind], rel / (bq.REL_SLACK * rel_plain + bq.REL_FLOOR))
        print(f"kernel phase: biquad_cascade {kind} at the main path's shape ({tuple(x.shape)}, {b.shape[0]} stages,"
              f" clamp {clamp}): rel {rel:.3e} over every lane against the float64 reference ({rel_lanes:.3e} on the"
              f" plain loop's {len(lanes)}), the plain loop's {rel_plain:.3e} (tolerance {bq.REL_SLACK:g} x plain +"
              f" {bq.REL_FLOOR:g}); max abs difference from the plain loop {res['max_abs_err']:.3e}; two calls bit for"
              f" bit; the plain loop on {len(lanes)} lanes at the full T {plain_cpu_s:.1f} s on the host (a worker;"
              f" waited {waited:.1f} s)", flush=True)
        del got, again, want, ref
        xs, bs, as_ = x[:, :2048].contiguous(), b, a
        plain_ms, _ = cuda_ms(torch, lambda: bq.biquad_cascade_plain(xs, bs, as_, clamp), reps=1, ahead=flush)
        kern_short_ms, _ = cuda_ms(torch, lambda: bq.biquad_cascade(xs, bs, as_, clamp), reps=5, ahead=flush)
        bound = biquad_bound(n_lanes, SRMR_T, b.shape[0], clamp)
        timed[kind] = {"lanes": n_lanes, "t": SRMR_T, "stages": b.shape[0], "ms": ms, "host_ms": host_ms,
                       "one_lane_ms": one_ms, "plain_ms_t2048": plain_ms, "plain_cpu_s": plain_cpu_s,
                       "plain_cpu_lanes": len(lanes), "ms_t2048": kern_short_ms, "rel": res["rel"],
                       "rel_plain": res["rel_plain"], "max_abs_err": res["max_abs_err"], **bound}
        print(
            f"kernel phase: biquad_cascade {kind} {n_lanes} lanes x {SRMR_T} samples, {b.shape[0]} stages:"
            f" kernel {ms:.4f} ms on the device ({ms / bound['bound_ms']:.2f}x its bound; {host_ms:.4f} ms of host"
            f" time to make the call; 4 device launches: the wrapper's two divisions by a0, the scratch's zero fill"
            f" and the scan); one lane at the full T {one_ms:.4f} ms (the carry chain's"
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


# ---------------------------------------------------------------------------------------------------- image streams

# DIV2K validation (Agustsson & Timofte 2017), as NTIRE, EDSR and SwinIR evaluate it: 100 8-bit RGB HR images;
# made from the seed as 1/f-spectrum textures (natural images' amplitude spectrum), each at a fixed 2040 x 1356,
# and each prediction its target blurred (a seeded Gaussian) with Gaussian noise of 0.02, clipped, stored as 8-bit
DIV2K_IMAGES, DIV2K_H, DIV2K_W, DIV2K_BATCH = 100, 1356, 2040, 4
DIV2K_NOISE, DIV2K_BLUR = 0.02, (0.6, 1.2)  # the noise's sigma; the range of the blur's sigma in pixels
DIV2K_ORACLE_IMAGES = 2  # the images held against the float64 oracle (its separable correlations take seconds each)
DIV2K_CPU_BATCHES = 2  # the batches held card against CPU, one CPU worker each (full-size depthwise convolutions)
BT601 = (16.0, 65.481, 128.553, 24.966)  # the Y of BT.601 on [0, 1] RGB, as SR papers' rgb2ycbcr takes it
# WorldView-3 at the geometry of PanCollection's test sets (Deng et al., IEEE GRSM 2022): 20 reduced-resolution
# images (8 bands x 256 x 256 ground truth) and 20 full-resolution ones (8 x 512 x 512 fused outputs, 8 x 128 x 128
# multispectral inputs), made from the seed as band-correlated smooth fields with a band-correlated error
WV3_IMAGES, WV3_BANDS, WV3_RR, WV3_FR, WV3_MS, WV3_BATCH = 20, 8, 256, 512, 128, 4
WV3_RATIO = 4  # the pan / multispectral resolution ratio: ERGAS's ratio
# values against the float64 oracles (absolute in their own units, or relative)
IMAGE_ORACLE_TOL = {
    "psnr": (0.0, 1e-4), "psnr_y": (0.0, 1e-4), "psnrb_y": (0.0, 1e-4),  # dB
    "ssim": (0.0, 1e-5), "ssim_y": (0.0, 1e-5), "ms_ssim": (0.0, 1e-5), "uqi": (0.0, 1e-5), "d_lambda": (0.0, 1e-5),
    "vif": (1e-4, 0.0), "tv": (1e-5, 0.0), "ergas": (1e-5, 0.0), "rase": (1e-5, 0.0), "rmse_sw": (1e-5, 0.0),
    "sam": (1e-5, 0.0), "cap_sam": (1e-5, 0.0), "cap_d_lambda": (0.0, 1e-5),
}
CANCEL_EPS = 1e-6  # card vs CPU: a moment E[x²] - mu² differs by up to this share of its terms (the port's rule)
F32_U = 2.0**-24  # float32's unit roundoff: SSIM-type scores against float64 within one of it in their moments' terms
F32_EPS = float(np.finfo(np.float32).eps)  # UQI's stabilizer, the float32 machine epsilon in both packages


def natural_field(rng, h: int, w: int) -> np.ndarray:
    """A float32 ``(h, w)`` field of unit variance with a 1/f amplitude spectrum (made on an FFT-friendly
    grid, then cropped)."""
    from scipy import fft

    fh, fw = fft.next_fast_len(h, real=True), fft.next_fast_len(w, real=True)
    fy = np.fft.fftfreq(fh).astype(np.float32)[:, None]
    fx = np.fft.rfftfreq(fw).astype(np.float32)[None, :]
    f = np.sqrt(fx * fx + fy * fy)
    f[0, 0] = 1.0
    amp = 1.0 / f
    amp[0, 0] = 0.0
    spec = (rng.standard_normal(amp.shape, dtype=np.float32) + 1j * rng.standard_normal(amp.shape, dtype=np.float32))
    x = fft.irfft2((spec * amp).astype(np.complex64), s=(fh, fw))[:h, :w]
    return ((x - x.mean()) / x.std()).astype(np.float32)


def div2k_image(index: int):
    """Image ``index`` of the stream: the target and the prediction, ``(3, H, W)`` uint8."""
    from scipy.ndimage import gaussian_filter

    rng = np.random.default_rng([SEED + 31, index])
    lum = natural_field(rng, DIV2K_H, DIV2K_W)
    chroma = [natural_field(rng, DIV2K_H, DIV2K_W) for _ in range(2)]
    mix = rng.uniform(-0.35, 0.35, (3, 2)).astype(np.float32)
    level = rng.uniform(0.4, 0.6, 3).astype(np.float32)
    contrast = np.float32(rng.uniform(0.09, 0.14))
    rgb = level[:, None, None] + contrast * (lum[None] + np.einsum("cj,jhw->chw", mix, np.stack(chroma)))
    target = np.round(np.clip(rgb, 0, 1) * 255).astype(np.uint8)
    blur = rng.uniform(*DIV2K_BLUR)
    pred = gaussian_filter(target.astype(np.float32) / 255, sigma=(0, blur, blur), mode="reflect")
    pred += DIV2K_NOISE * rng.standard_normal(pred.shape, dtype=np.float32)
    return target, np.round(np.clip(pred, 0, 1) * 255).astype(np.uint8)


def div2k_batch(index: int):
    """Batch ``index``: preds and targets ``(B, 3, H, W)`` uint8 (run in worker processes)."""
    pairs = [div2k_image(index * DIV2K_BATCH + i) for i in range(DIV2K_BATCH)]
    return np.stack([p for _, p in pairs]), np.stack([t for t, _ in pairs])


def gauss64(n: int, sigma: float) -> np.ndarray:
    x = np.arange(n) - (n - 1) / 2
    g = np.exp(-((x / sigma) ** 2) / 2)
    return g / g.sum()


def corr_valid(x: np.ndarray, k: np.ndarray, axis: int) -> np.ndarray:
    """Valid correlation of ``x`` with the odd-length 1-D ``k`` along ``axis``, float64, as direct sums
    (``scipy.ndimage.correlate1d``, its border cut off)."""
    from scipy.ndimage import correlate1d

    half = k.size // 2
    out = correlate1d(np.asarray(x, np.float64), k, axis=axis, mode="constant")
    keep = [slice(None)] * x.ndim
    keep[axis] = slice(half, x.shape[axis] - half)
    return out[tuple(keep)]


def blur64(x: np.ndarray, k: np.ndarray) -> np.ndarray:
    """The separable valid correlation of ``(..., H, W)`` with ``k`` along both axes."""
    return corr_valid(corr_valid(x, k, -2), k, -1)


def moments64(p: np.ndarray, t: np.ndarray, sigma: float = 1.5) -> tuple:
    """``((mu_p, mu_t, var_p, var_t, cov), border)`` of ``(..., H, W)`` float64 images over the Gaussian window
    of SSIM (and UQI's default, the same), after a reflect border of the window's half width."""
    pad = int(3.5 * sigma + 0.5)
    k = gauss64(2 * pad + 1, sigma)
    width = [(0, 0)] * (p.ndim - 2) + [(pad, pad), (pad, pad)]
    p, t = np.pad(p, width, mode="reflect"), np.pad(t, width, mode="reflect")
    mu_p, mu_t = blur64(p, k), blur64(t, k)
    var_p, var_t = blur64(p * p, k) - mu_p**2, blur64(t * t, k) - mu_t**2
    return (mu_p, mu_t, var_p, var_t, blur64(p * t, k) - mu_p * mu_t), pad


def ssim_from64(moments: tuple, pad: int, data_range: float = 1.0) -> tuple:
    """SSIM and contrast sensitivity, the means of their maps cropped by the border as the port crops them."""
    mu_p, mu_t, var_p, var_t, cov = moments
    c1, c2 = (0.01 * data_range) ** 2, (0.03 * data_range) ** 2
    cs = (2 * cov + c2) / (var_p + var_t + c2)
    ssim = (2 * mu_p * mu_t + c1) / (mu_p**2 + mu_t**2 + c1) * cs
    crop = (Ellipsis, slice(pad, -pad), slice(pad, -pad))
    return float(ssim[crop].mean()), float(cs[crop].mean())


def condition64(moments: tuple, pad: int, c: float) -> float:
    """The mean over the cropped map of K = (E[p²] + mu_p² + E[t²] + mu_t² + 2|E[pt]| + 2|mu_p mu_t|) /
    (var_p + var_t + c): what an SSIM-type score (c = c2, or UQI's epsilon) moves by per unit of relative
    error in its moments' terms."""
    mu_p, mu_t, var_p, var_t, cov = moments
    terms = var_p + 2 * mu_p**2 + var_t + 2 * mu_t**2 + 2 * np.abs(cov + mu_p * mu_t) + 2 * np.abs(mu_p * mu_t)
    return float((terms / (var_p + var_t + c))[..., pad:-pad, pad:-pad].mean())


def ssim64(p: np.ndarray, t: np.ndarray) -> tuple:
    """SSIM and contrast sensitivity of one ``(C, H, W)`` float64 image (data range 1)."""
    return ssim_from64(*moments64(p, t))


def uqi_from64(moments: tuple, pad: int) -> np.ndarray:
    """The UQI map from the moments, cropped by the border."""
    mu_p, mu_t, var_p, var_t, cov = moments
    q = (2 * mu_p * mu_t) * (2 * cov) / ((mu_p**2 + mu_t**2) * (var_p + var_t + F32_EPS))
    return q[..., pad:-pad, pad:-pad]


def uqi_map64(p: np.ndarray, t: np.ndarray) -> np.ndarray:
    """The UQI map of ``(..., H, W)`` float64 images (window 11, sigma 1.5)."""
    return uqi_from64(*moments64(p, t))


def ms_ssim64(p: np.ndarray, t: np.ndarray, first: tuple, betas=(0.0448, 0.2856, 0.3001, 0.2363, 0.1333)) -> float:
    """MS-SSIM (relu-normalized, data range 1) of one ``(C, H, W)`` image, 2x2 means between scales;
    ``first`` is scale 0's ``(ssim, cs)``."""
    value = 1.0
    for i, beta in enumerate(betas):
        ssim, cs = first if i == 0 else ssim64(p, t)
        value *= max(ssim if i == len(betas) - 1 else cs, 0.0) ** beta
        h, w = p.shape[1] // 2 * 2, p.shape[2] // 2 * 2
        p, t = (x[:, :h, :w].reshape(x.shape[0], h // 2, 2, w // 2, 2).mean(axis=(2, 4)) for x in (p, t))
    return value


def vif64(p: np.ndarray, t: np.ndarray, sigma_n_sq: float = 2.0) -> float:
    """Pixel-domain VIF of one ``(H, W)`` float64 channel over four scales."""
    eps = 1e-10
    num = den = 0.0
    for scale in range(4):
        n = 2 ** (4 - scale) + 1
        k = gauss64(n, n / 5)  # exp(-(x² + y²) / 2s²) normalized is the outer product of this with itself
        if scale > 0:
            p, t = blur64(p, k)[::2, ::2], blur64(t, k)[::2, ::2]
        mu_p, mu_t = blur64(p, k), blur64(t, k)
        var_t = np.maximum(blur64(t * t, k) - mu_t**2, 0.0)
        var_p = np.maximum(blur64(p * p, k) - mu_p**2, 0.0)
        cov = blur64(t * p, k) - mu_t * mu_p
        g = cov / (var_t + eps)
        var_v = var_p - g * cov
        low_t, low_p = var_t < eps, var_p < eps
        g = np.where(low_t | low_p, 0.0, g)
        var_v = np.where(low_t, var_p, var_v)
        var_t = np.where(low_t, 0.0, var_t)
        var_v = np.where(low_p, 0.0, var_v)
        neg = g < 0
        var_v = np.maximum(np.where(neg, var_p, var_v), eps)
        g = np.where(neg, 0.0, g)
        num += np.log10(1.0 + g**2 * var_t / (var_v + sigma_n_sq)).sum()
        den += np.log10(1.0 + var_t / sigma_n_sq).sum()
    return num / den


def luma64(rgb: np.ndarray) -> np.ndarray:
    """BT.601 Y of ``(..., 3, H, W)`` RGB in [0, 1], keeping the channel axis."""
    off, r, g, b = BT601
    return (off + r * rgb[..., 0:1, :, :] + g * rgb[..., 1:2, :, :] + b * rgb[..., 2:3, :, :]) / 255.0


def psnrb64(p: np.ndarray, t: np.ndarray, block: int = 8) -> float:
    """PSNR-B of one grayscale batch ``(B, 1, H, W)`` in float64, its blocked effect over the batch as the port
    takes it (one update)."""
    h, w = p.shape[-2:]
    dh = (p[..., :, :-1] - p[..., :, 1:]) ** 2
    dv = (p[..., :-1, :] - p[..., 1:, :]) ** 2
    on_h = np.arange(w - 1) % block == block - 1
    on_v = np.arange(h - 1) % block == block - 1
    d_b = dh[..., on_h].sum() + dv[..., on_v, :].sum()
    d_bc = dh[..., ~on_h].sum() + dv[..., ~on_v, :].sum()
    n_hb, n_vb = h * (w / block) - 1, w * (h / block) - 1
    d_b /= n_hb + n_vb
    d_bc /= h * (w - 1) - n_hb + w * (h - 1) - n_vb
    bef = (np.log2(block) / np.log2(min(h, w)) if d_b > d_bc else 0.0) * (d_b - d_bc)
    mse = ((p - t) ** 2).mean() + bef
    data_range = t.max() - t.min()
    return float(10 * np.log10((data_range**2 if data_range > 2 else 1.0) / mse))


def restoration_oracle(index: int) -> dict:
    """float64 values of the restoration members over image ``index`` alone (run in worker processes)."""
    target, pred = (x.astype(np.float64) / 255 for x in div2k_image(index))
    moments, pad = moments64(pred, target)  # SSIM's, MS-SSIM's first scale's and UQI's: one window
    first = ssim_from64(moments, pad)
    uqi = uqi_from64(moments, pad)
    k_ssim, k_uqi = condition64(moments, pad, 0.03**2), condition64(moments, pad, F32_EPS)
    del moments
    py, ty = luma64(pred), luma64(target)
    moments_y, _ = moments64(py, ty)
    return {
        "k_ssim": k_ssim, "k_uqi": k_uqi, "ssim_y": ssim_from64(moments_y, pad)[0],
        "k_ssim_y": condition64(moments_y, pad, 0.03**2),
        "sse": float(((pred - target) ** 2).sum()), "n": pred.size, "ssim": first[0],
        "ms_ssim": ms_ssim64(pred, target, first), "uqi_sum": float(uqi.sum()), "uqi_n": uqi.size,
        "vif": [vif64(pred[c], target[c]) for c in range(3)],
        "tv": float(np.abs(np.diff(pred, axis=1)).sum() + np.abs(np.diff(pred, axis=2)).sum()),
        "sse_y": float(((py - ty) ** 2).sum()), "n_y": py.size,
        "y": (py, ty),
    }


def restoration_oracle_tolerances(parts: list) -> dict:
    """``IMAGE_ORACLE_TOL`` with the SSIM-type scores' bounds widened to one float32 rounding of their moments'
    terms carried through the score, ``F32_U x`` the images' mean condition (``condition64``), where that is
    wider: the float32 formula's own error (MS-SSIM takes its first scale's)."""
    tol = dict(IMAGE_ORACLE_TOL)
    for key, cond in (("ssim", "k_ssim"), ("ms_ssim", "k_ssim"), ("uqi", "k_uqi"), ("ssim_y", "k_ssim_y")):
        tol[key] = (0.0, max(tol[key][1], F32_U * float(np.mean([o[cond] for o in parts]))))
    return tol


def restoration_oracle_values(parts: list) -> dict:
    """The oracle's values over the images of ``parts`` as one batch (PSNR-B's blocked effect is per update)."""
    py = np.concatenate([o["y"][0][None] for o in parts])
    ty = np.concatenate([o["y"][1][None] for o in parts])
    return {
        "psnr": 10 * np.log10(sum(o["n"] for o in parts) / sum(o["sse"] for o in parts)),
        "ssim": np.mean([o["ssim"] for o in parts]), "ms_ssim": np.mean([o["ms_ssim"] for o in parts]),
        "uqi": sum(o["uqi_sum"] for o in parts) / sum(o["uqi_n"] for o in parts),
        "vif": np.mean([v for o in parts for v in o["vif"]]), "tv": sum(o["tv"] for o in parts),
        "psnr_y": 10 * np.log10(sum(o["n_y"] for o in parts) / sum(o["sse_y"] for o in parts)),
        "ssim_y": np.mean([o["ssim_y"] for o in parts]), "psnrb_y": psnrb64(py, ty),
    }


def restoration_members(device) -> dict:
    """The three collections of the restoration stream: RGB pairs, the predictions alone (total variation
    takes one image batch, so it cannot share the pairs' positional arguments) and Y pairs."""
    import tpumetrics_torch.image as im

    return {
        "rgb": {"psnr": im.PeakSignalNoiseRatio(data_range=1.0, device=device),
                "ssim": im.StructuralSimilarityIndexMeasure(data_range=1.0, device=device),
                "ms_ssim": im.MultiScaleStructuralSimilarityIndexMeasure(data_range=1.0, device=device),
                "uqi": im.UniversalImageQualityIndex(device=device),
                "vif": im.VisualInformationFidelity(device=device)},
        # TotalVariation registers a per-image list state even under reduction="sum", where it stays empty; held
        # in a MaskedBuffer it keeps TV out of the eager list leaders, so a fused collection captures it
        "pred": {"tv": buffered(im.TotalVariation(device=device), DIV2K_IMAGES, {"score_list": ()})},
        "y": {"psnr_y": im.PeakSignalNoiseRatio(data_range=1.0, device=device),
              "ssim_y": im.StructuralSimilarityIndexMeasure(data_range=1.0, device=device),
              "psnrb_y": im.PeakSignalNoiseRatioWithBlockedEffect(device=device)},
    }


def image_batch(torch, preds_u8, target_u8, device):
    """The float32 RGB pair in [0, 1] and its BT.601 Y pair, on ``device``: ``{"rgb": (p, t), "pred": (p,),
    "y": (py, ty)}``. Y is taken in float64 and rounded once, so the card and the CPU get the same bits."""
    off, r, g, b = BT601
    out = {}
    for name, u8 in (("p", preds_u8), ("t", target_u8)):
        x = torch.from_numpy(u8).to(device)
        out[name] = x.float() / 255
        x64 = x.double()
        out[name + "y"] = ((off + (r * x64[:, 0:1] + g * x64[:, 1:2] + b * x64[:, 2:3]) / 255) / 255).float()
    return {"rgb": (out["p"], out["t"]), "pred": (out["p"],), "y": (out["py"], out["ty"])}


def restoration_cpu_states(index: int) -> dict:
    """The port's CPU path over batch ``index`` alone: each collection's exported states and values (run in
    worker processes, a few threads each)."""
    import torch

    from tpumetrics_torch import MetricCollection
    from tpumetrics_torch.interop import export_state

    torch.set_num_threads(4)
    data = image_batch(torch, *div2k_batch(index), "cpu")
    out = {}
    for kind, members in restoration_members("cpu").items():
        col = MetricCollection(members, device="cpu")
        col.update(*data[kind])
        out[kind] = {"states": {name: export_state(m) for name, m in col.items()},
                     "values": {k: v.numpy() for k, v in col.compute().items()}}
    return out


def moment_condition(torch, p, t, c: float, pad: int = 5, sigma: float = 1.5) -> tuple:
    """How far an SSIM-type score moves per unit of relative error in its moments' terms, on the card in
    float32: per pixel K = (E[p²] + mu_p² + E[t²] + mu_t² + 2|E[pt]| + 2|mu_p mu_t|) / (var_p + var_t + c) + 4
    (the structure term's derivative, and at most 4 from the luminance term's), over the cropped maps of
    ``(B, C, H, W)``: the sum over images of each one's mean, and the sum over pixels."""
    from tpumetrics_torch.functional.image.helper import _depthwise_conv2d, _gaussian_kernel_2d, _reflect_pad_2d

    k = _gaussian_kernel_2d(p.shape[1], (2 * pad + 1,) * 2, (sigma,) * 2, device=p.device)
    pp, tt = _reflect_pad_2d(p, pad, pad), _reflect_pad_2d(t, pad, pad)
    mu_p, mu_t, e_pp, e_tt, e_pt = _depthwise_conv2d(torch.cat((pp, tt, pp * pp, tt * tt, pp * tt)), k).split(p.shape[0])
    terms = e_pp + mu_p**2 + e_tt + mu_t**2 + 2 * e_pt.abs() + 2 * (mu_p * mu_t).abs()
    cond = (terms / ((e_pp - mu_p**2) + (e_tt - mu_t**2) + c) + 4)[..., pad:-pad, pad:-pad].double()
    return float(cond.reshape(p.shape[0], -1).mean(1).sum()), float(cond.sum())


def blocked_effect_terms(torch, x) -> float:
    """PSNR-B's ``t (d_b + d_bc)`` of a grayscale batch in float64: the terms its blocked effect
    ``t (d_b - d_bc)`` takes the difference of."""
    h, w = x.shape[-2:]
    x = x.double()
    dh = (x[..., :, :-1] - x[..., :, 1:]) ** 2
    dv = (x[..., :-1, :] - x[..., 1:, :]) ** 2
    on_h = torch.arange(w - 1, device=x.device) % 8 == 7
    on_v = (torch.arange(h - 1, device=x.device) % 8 == 7)[:, None]
    n_hb, n_vb = h * (w / 8) - 1, w * (h / 8) - 1
    d_b = float(torch.where(on_h, dh, 0.0).sum() + torch.where(on_v, dv, 0.0).sum()) / (n_hb + n_vb)
    d_bc = float(torch.where(on_h, 0.0, dh).sum() + torch.where(on_v, 0.0, dv).sum()) / (
        h * (w - 1) - n_hb + w * (h - 1) - n_vb)
    return math.log2(8) / math.log2(min(h, w)) * (d_b + d_bc)


def restoration_tolerances(torch, data: dict) -> dict:
    """Card-vs-CPU bounds of one batch's float32 sum states, by collection, member and state (the rest of the
    states, counts and tracked extrema, must be equal): the port's rule on cancelling sums, CANCEL_EPS of
    their terms, carried through each score. SSIM's per-image sum: CANCEL_EPS x the sum of per-image mean K
    (``moment_condition``, c = c2); MS-SSIM twice that (its five factors' exponents sum to 1 and each factor
    stays above one half: an assumption, printed with the measured error); UQI's sum over pixels: CANCEL_EPS x
    the sum of K with c = the float32 epsilon; PSNR-B's blocked effect: CANCEL_EPS x its two means' terms; VIF
    1e-4 relative (its gain and noise variances come from cancelling moments, through clips and masks);
    sums of squares and of absolute differences 1e-6 relative."""
    p, t = data["rgb"]
    py, ty = data["y"]
    k_rgb, _ = moment_condition(torch, p, t, 0.03**2)
    _, k_uqi = moment_condition(torch, p, t, F32_EPS)
    k_y, _ = moment_condition(torch, py, ty, 0.03**2)
    rel = ("rel", 1e-6)
    return {
        "rgb": {"psnr": {"sum_squared_error": rel}, "ssim": {"similarity": ("abs", CANCEL_EPS * k_rgb)},
                "ms_ssim": {"similarity": ("abs", 2 * CANCEL_EPS * k_rgb)}, "uqi": {"sum_uqi": ("abs", CANCEL_EPS * k_uqi)},
                "vif": {"vif_score": ("rel", 1e-4)}},
        "pred": {"tv": {"score": rel}},
        "y": {"psnr_y": {"sum_squared_error": rel}, "ssim_y": {"similarity": ("abs", CANCEL_EPS * k_y)},
              "psnrb_y": {"sum_squared_error": rel, "bef": ("abs", CANCEL_EPS * blocked_effect_terms(torch, py))}},
    }


class tf32_defaults:
    """Inside it, torch's own TF32 defaults (cuDNN convolutions may run in TF32, cuBLAS matmuls not), whatever
    the script set for the phases before; the script's settings come back on exit."""

    def __init__(self, torch):
        self.torch, self.saved = torch, None

    def __enter__(self):
        b = self.torch.backends
        self.saved = (b.cudnn.allow_tf32, b.cuda.matmul.allow_tf32)
        b.cudnn.allow_tf32, b.cuda.matmul.allow_tf32 = True, False
        return self

    def __exit__(self, *exc):
        b = self.torch.backends
        b.cudnn.allow_tf32, b.cuda.matmul.allow_tf32 = self.saved
        return False


def check_image_states(label: str, got: dict, want: dict, tol: dict) -> float:
    """One collection's states (by member) on the card against the CPU's: the float32 sums named in ``tol``
    (``(member: {state: ("rel" | "abs", bound)})``) within their bounds, every other state (counts, tracked
    extrema, list states) equal. Returns the worst share of a bound used."""
    worst = 0.0
    for member, states in want.items():
        check(sorted(got[member]) == sorted(states), f"{label}: {member} states {sorted(got[member])}")
        for name, ref in states.items():
            val = got[member][name]
            if isinstance(ref, (list, tuple)):  # a list state, or a MaskedBuffer's fields: the inputs, exactly
                check(type(val) is type(ref) and len(val) == len(ref) and all(
                    v.dtype == r.dtype and np.array_equal(v, r) for v, r in zip(val, ref)),
                      f"{label}: list state {member}.{name} differs card vs CPU")
                continue
            check(val.dtype == ref.dtype and val.shape == ref.shape, f"{label}: {member}.{name} {val.dtype} vs {ref.dtype}")
            if name not in tol.get(member, {}):
                check(np.array_equal(val, ref), f"{label}: {member}.{name} card {val} vs CPU {ref}")
                continue
            kind, bound = tol[member][name]
            allowed = bound * float(np.abs(ref).max()) if kind == "rel" else bound
            diff = float(np.abs(val.astype(np.float64) - ref.astype(np.float64)).max())
            check(diff <= allowed, f"{label}: {member}.{name} card {val} vs CPU {ref} (diff {diff:.3e}, bound {allowed:.3e})")
            worst = max(worst, diff / allowed)
    return worst


def conv_kernels(prof) -> tuple:
    """Device time (us) and count of the convolution kernels (cuDNN's, or torch's own depthwise ones) in a profile."""
    import re

    from torch.autograd import DeviceType

    pattern = re.compile(r"conv|cudnn|xmma|implicit|depthwise|winograd|fprop", re.IGNORECASE)
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA and pattern.search(e.key)]
    return sum(e.device_time_total for e in kernels), sum(e.count for e in kernels), sorted({e.key[:60] for e in kernels})


def restoration_phase(torch, bc) -> dict:
    """Image restoration scored as SR papers report it, at DIV2K validation size (see the module note), with
    torch's TF32 defaults: an RGB collection, the predictions' total variation and a Y collection on the card;
    each batch's states against the CPU path's for the first batches; the values on the first images against
    float64 oracles; host syncs; the convolutions' share of an update's device time; and the fused phases."""
    import contextlib
    from unittest import mock

    from tpumetrics_torch import MetricCollection
    from tpumetrics_torch.functional.image import helper
    from tpumetrics_torch.functional.image import structural_similarity_index_measure as ssim_fn
    from tpumetrics_torch.interop import export_state
    from tpumetrics_torch.ops import biquad as bq

    label = f"restoration DIV2K val {DIV2K_IMAGES} x 3 x {DIV2K_H} x {DIV2K_W}"
    num_batches = DIV2K_IMAGES // DIV2K_BATCH

    def collections():
        return {kind: MetricCollection(m, device="cuda") for kind, m in restoration_members("cuda").items()}

    def states(cols):
        return {kind: {name: export_state(m) for name, m in col.items()} for kind, col in cols.items()}

    with tf32_defaults(torch):
        check(torch.backends.cudnn.allow_tf32 and not torch.backends.cuda.matmul.allow_tf32,
              f"{label}: torch's TF32 defaults are not in force")
        cols = collections()
        dev, card_single, syncs, u8 = [], [], {}, []
        update_ms = {kind: [] for kind in cols}
        workers = min(8, os.cpu_count() or 1)
        t_gen = time.perf_counter()
        with multiprocessing.get_context("spawn").Pool(workers) as pool:
            # the CPU path of the first batches and the oracle's images first, so they run beside the stream
            cpu_jobs = [pool.apply_async(restoration_cpu_states, (i,)) for i in range(DIV2K_CPU_BATCHES)]
            oracle_jobs = [pool.apply_async(restoration_oracle, (i,)) for i in range(DIV2K_ORACLE_IMAGES)]
            made = pool.imap(div2k_batch, range(num_batches))
            torch.cuda.synchronize()
            bc.launches, bq.launches = 0, 0
            for i, batch in enumerate(made):
                data = image_batch(torch, *batch, "cuda")
                u8.append(tuple(torch.from_numpy(x).to("cuda") for x in batch))  # the perceptual phase's pairs
                torch.cuda.synchronize()
                if i < DIV2K_CPU_BATCHES:  # this batch alone on the card, for the CPU worker's states
                    single = collections()
                    for kind, col in single.items():
                        col.update(*data[kind])
                    card_single.append((states(single), restoration_tolerances(torch, data)))
                    del single
                if i == 2:  # each member's steady update, on a warmed copy
                    syncs = {name: steady_host_syncs(torch, m, data[kind])
                             for kind, col in cols.items() for name, m in col.items()}
                for kind, col in cols.items():
                    t0 = time.perf_counter()
                    if i == 1:  # a steady update with host syncs made errors
                        torch.cuda.set_sync_debug_mode("error")
                    try:
                        col.update(*data[kind])
                    finally:
                        torch.cuda.set_sync_debug_mode(0)
                    torch.cuda.synchronize()
                    update_ms[kind].append((time.perf_counter() - t0) * 1e3)
                dev.append(data)
            t_stream = time.perf_counter() - t_gen
            cpu = [job.get() for job in cpu_jobs]
            oracle_parts = [job.get() for job in oracle_jobs]
            pool.close()
            pool.join()
        t_gen = time.perf_counter() - t_gen
        t0 = time.perf_counter()
        values = {k: v for col in cols.values() for k, v in col.compute().items()}
        torch.cuda.synchronize()
        compute_ms = (time.perf_counter() - t0) * 1e3
        check(bc.launches == 0 and bq.launches == 0, f"{label}: kernel launches {bc.launches}, {bq.launches}, expected none")
        check(all(bool(torch.isfinite(v).all()) and v.ndim == 0 for v in values.values()), f"{label}: values {values}")
        check(not any(syncs.values()), f"{label}: host syncs in a steady update {syncs}")

        # each of the first batches on the card against the CPU path
        state_worst = {}
        for i, ((card, tol), ref) in enumerate(zip(card_single, cpu)):
            for kind in card:
                share = check_image_states(f"{label} batch {i} {kind}", card[kind], ref[kind]["states"], tol[kind])
                state_worst[kind] = max(state_worst.get(kind, 0.0), share)

        # the first images against the float64 oracle, as one batch
        oracle = restoration_oracle_values(oracle_parts)
        first = {kind: tuple(x[:DIV2K_ORACLE_IMAGES] for x in args) for kind, args in dev[0].items()}
        small = collections()
        for kind, col in small.items():
            col.update(*first[kind])
        got = {k: v for col in small.values() for k, v in col.compute().items()}
        oracle_tol = restoration_oracle_tolerances(oracle_parts)
        oracle_worst = check_values(label, got, oracle, oracle_tol)
        # the same SSIM with the library's float32 guard taken out: what TF32 would cost, if cuDNN uses it here
        with mock.patch.object(helper, "_ieee_float32", lambda *backends: contextlib.nullcontext()):
            unguarded = float(ssim_fn(*first["rgb"], data_range=1.0))
        unguarded_err = abs(unguarded - oracle["ssim"])
        del small

        print(
            f"restoration phase: {label}: {num_batches} batches of {DIV2K_BATCH} (8-bit, made from the seed in"
            f" {workers} worker processes beside the stream, {t_stream:.1f} s to the last update); reduced: every image"
            f" a fixed {DIV2K_W} x {DIV2K_H} (DIV2K's heights vary); TF32 at torch's defaults (cudnn.allow_tf32"
            f" {torch.backends.cudnn.allow_tf32}); values: " + ", ".join(f"{k} {float(v):.6f}" for k, v in values.items())
            + f"; against float64 oracles on {DIV2K_ORACLE_IMAGES} images, worst share of the tolerance"
            f" {max(oracle_worst.values()):.3f} ({max(oracle_worst, key=oracle_worst.get)}): "
            + ", ".join(f"{k} {float(got[k]):.6f} (oracle {oracle[k]:.6f})" for k in oracle)
            + f"; SSIM with the float32 guard taken out: {unguarded:.8f}, {unguarded_err:.2e} from the oracle;"
            f" card vs CPU on {DIV2K_CPU_BATCHES} batches, worst share of a bound {state_worst}; host syncs in a steady"
            f" update {syncs}; update median (first, steady) by collection: "
            + ", ".join(f"{k} {v[0]:.3f} / {np.median(v[2:]):.3f} ms" for k, v in update_ms.items())
            + f"; compute() {compute_ms:.3f} ms",
            flush=True,
        )
        prof = {kind: profile_step(torch, col, dev[2][kind], f"{label} {kind}") for kind, col in cols.items()}
        del cols
        fused = {kind: fused_pair(torch, f"{label} {kind}",
                                  lambda f, kind=kind: MetricCollection(restoration_members("cuda")[kind], fused_update=f,
                                                                        device="cuda"),
                                  [d[kind] for d in dev])
                 for kind in ("rgb", "pred", "y")}
        del dev
        torch.cuda.empty_cache()
    for kind, f in fused.items():
        check(f["eager_leaders"] == [], f"{label} {kind}: eager leaders {f['eager_leaders']}")
        check(f["modes"]["replayed"] >= 1 and f["guarded_replay"], f"{label} {kind}: no checked graph replay")
        check(not any(n["plain"] or n["fused"] for n in f["kernel_launches"].values()), f"{label} {kind}: kernel launches")
    return {"launches": 0, "update_ms": update_ms, "compute_ms": compute_ms, "values": {k: float(v) for k, v in values.items()},
            "oracle": oracle, "oracle_tol": {k: oracle_tol[k] for k in oracle}, "oracle_worst": oracle_worst,
            "state_worst": state_worst, "host_syncs": syncs, "unguarded_ssim_err": unguarded_err, "profile": prof, "seconds": t_gen,
            "reduced": f"every image a fixed {DIV2K_W} x {DIV2K_H}; DIV2K's heights vary", "fused": fused["rgb"],
            "fused_all": fused, "div2k_u8": u8}


def wv3_image(index: int, full: bool):
    """Image ``index`` of a PanCollection-like WorldView-3 test set, float32: ``(fused, ground truth)`` at
    8 x 256 x 256 (reduced resolution), or ``(fused 8 x 512 x 512, multispectral input 8 x 128 x 128)``
    (full resolution, the input the ground truth's 4 x 4 means)."""
    rng = np.random.default_rng([SEED + 37, index, int(full)])
    size = WV3_FR if full else WV3_RR
    # reflectance-like bands: a shared brightness field and a vegetation field, mixed by band signatures
    bright, veg, err = (natural_field(rng, size, size) for _ in range(3))
    base = np.array([0.18, 0.16, 0.15, 0.16, 0.15, 0.22, 0.30, 0.28], np.float32)
    veg_sig = np.array([-0.02, -0.02, 0.01, -0.01, -0.04, 0.08, 0.15, 0.14], np.float32)
    err_sig = rng.uniform(0.6, 1.4, WV3_BANDS).astype(np.float32)
    truth = base[:, None, None] * (1 + 0.35 * bright) + veg_sig[:, None, None] * veg
    truth = np.maximum(truth, 0.01).astype(np.float32)
    noise = 0.004 * rng.standard_normal(truth.shape, dtype=np.float32)
    fused = np.maximum(truth + 0.012 * err_sig[:, None, None] * err + noise, 0.005).astype(np.float32)
    if not full:
        return fused, truth
    r = WV3_RATIO
    return fused, truth.reshape(WV3_BANDS, WV3_MS, r, WV3_MS, r).mean(axis=(2, 4)).astype(np.float32)


def wv3_batches(full: bool) -> list:
    out = []
    for start in range(0, WV3_IMAGES, WV3_BATCH):
        pairs = [wv3_image(i, full) for i in range(start, start + WV3_BATCH)]
        out.append((np.stack([p for p, _ in pairs]), np.stack([t for _, t in pairs])))
    return out


def uniform_filter64(x: np.ndarray, size: int) -> np.ndarray:
    """scipy's mean filter over the last two axes (reflect border), float64."""
    from scipy.ndimage import uniform_filter

    return uniform_filter(x.astype(np.float64), size=(1,) * (x.ndim - 2) + (size, size), mode="reflect")


def pansharpening_oracle(_: int = 0) -> dict:
    """float64 values of the pan-sharpening members over the first images (run in a worker process)."""
    n = DIV2K_ORACLE_IMAGES
    pairs = [wv3_image(i, False) for i in range(n)]
    p = np.stack([x for x, _ in pairs]).astype(np.float64)
    t = np.stack([y for _, y in pairs]).astype(np.float64)
    rmse_band = np.sqrt(((p - t) ** 2).mean(axis=(2, 3)))
    ergas = 100 * WV3_RATIO * np.sqrt(((rmse_band / t.mean(axis=(2, 3))) ** 2).mean(axis=1))
    cos = (p * t).sum(1) / (np.linalg.norm(p, axis=1) * np.linalg.norm(t, axis=1))
    sam = np.arccos(np.clip(cos, -1, 1))
    rmse_map = np.sqrt(uniform_filter64((p - t) ** 2, 8))
    crop = round(8 / 2)
    target_mean = (uniform_filter64(t, 8) / 64).mean(axis=0).mean(axis=0)
    rase_map = 100 / target_mean * np.sqrt((rmse_map.mean(axis=0) ** 2).mean(axis=0))
    fr = [wv3_image(i, True) for i in range(n)]
    fused = np.stack([x for x, _ in fr]).astype(np.float64)
    ms = np.stack([y for _, y in fr]).astype(np.float64)
    bands = fused.shape[1]
    ii, jj = np.triu_indices(bands, 1)
    q_fused = np.array([uqi_map64(fused[:, i], fused[:, j]).mean() for i, j in zip(ii, jj)])
    q_ms = np.array([uqi_map64(ms[:, i], ms[:, j]).mean() for i, j in zip(ii, jj)])
    return {
        "ergas": ergas.mean(), "sam": sam.mean(),
        "rmse_sw": rmse_map[:, :, crop:-crop, crop:-crop].mean(axis=(1, 2, 3)).mean(),
        "rase": rase_map[crop:-crop, crop:-crop].mean(),
        "d_lambda": 2 * np.abs(q_fused - q_ms).sum() / (bands * (bands - 1)),
    }


def pansharpening_members(device) -> dict:
    """The reduced-resolution collection (ERGAS, SAM and its capacity copy, RASE, RMSE-SW) and the
    full-resolution one (D-lambda and its capacity copy)."""
    import tpumetrics_torch.image as im

    rr = (WV3_BANDS, WV3_RR, WV3_RR)
    return {
        "reduced": {"ergas": im.ErrorRelativeGlobalDimensionlessSynthesis(ratio=WV3_RATIO, device=device),
                    "sam": im.SpectralAngleMapper(device=device),
                    "cap_sam": buffered(im.SpectralAngleMapper(reduction="none", device=device), WV3_IMAGES,
                                             {"preds": rr, "target": rr}),
                    "rase": im.RelativeAverageSpectralError(device=device),
                    "rmse_sw": im.RootMeanSquaredErrorUsingSlidingWindow(window_size=8, device=device)},
        "full": {"d_lambda": im.SpectralDistortionIndex(device=device),
                 "cap_d_lambda": buffered(im.SpectralDistortionIndex(device=device), WV3_IMAGES,
                                               {"preds": (WV3_BANDS, WV3_FR, WV3_FR), "target": (WV3_BANDS, WV3_MS, WV3_MS)})},
    }


def pansharpening_phase(torch, bc) -> dict:
    """Pan-sharpening scored as PanCollection reports it, with WorldView-3's geometry (see the module note), with
    torch's TF32 defaults: the reduced- and full-resolution collections on the card, their states against the
    CPU path's on the first batches, the values on the first images against float64 oracles, host syncs, and
    the fused phases (the full-resolution one on the capacity copy, whose state stays at the set's 20 images)."""
    from tpumetrics_torch import MetricCollection
    from tpumetrics_torch.functional.image.sam import _sam_compute
    from tpumetrics_torch.interop import export_state
    from tpumetrics_torch.ops import biquad as bq

    label = f"pansharpening WorldView-3 {WV3_IMAGES} x {WV3_BANDS} x {WV3_RR}^2 and {WV3_IMAGES} x {WV3_BANDS} x {WV3_FR}^2"
    with tf32_defaults(torch):
        with multiprocessing.get_context("spawn").Pool(1) as pool:
            oracle_job = pool.apply_async(pansharpening_oracle, (0,))
            t0 = time.perf_counter()
            host = {"reduced": wv3_batches(False), "full": wv3_batches(True)}
            t_gen = time.perf_counter() - t0
            dev = {k: [tuple(torch.from_numpy(x).cuda() for x in b) for b in v] for k, v in host.items()}
            cols = {k: MetricCollection(m, device="cuda") for k, m in pansharpening_members("cuda").items()}
            torch.cuda.synchronize()
            bc.launches, bq.launches = 0, 0
            update_ms = {k: [] for k in cols}
            syncs = {}
            for kind, col in cols.items():
                for i, batch in enumerate(dev[kind]):
                    if i == 2:
                        syncs.update({name: steady_host_syncs(torch, m, batch) for name, m in col.items()})
                    t1 = time.perf_counter()
                    if i == 1:
                        torch.cuda.set_sync_debug_mode("error")
                    try:
                        col.update(*batch)
                    finally:
                        torch.cuda.set_sync_debug_mode(0)
                    torch.cuda.synchronize()
                    update_ms[kind].append((time.perf_counter() - t1) * 1e3)
            t1 = time.perf_counter()
            values = {k: v for col in cols.values() for k, v in col.compute().items()}
            torch.cuda.synchronize()
            compute_ms = (time.perf_counter() - t1) * 1e3
            check(bc.launches == 0 and bq.launches == 0, f"{label}: kernel launches {bc.launches}, {bq.launches}")
            check(not any(syncs.values()), f"{label}: host syncs in a steady update {syncs}")
            check(torch.equal(values["cap_d_lambda"], values["d_lambda"]), f"{label}: the capacity copy's D-lambda differs")
            check(torch.equal(values["cap_sam"].mean(), _sam_compute(*(torch.cat([b[i] for b in dev["reduced"]]) for i in (0, 1)),
                                                                     "elementwise_mean")), f"{label}: the capacity SAM differs")
            values["cap_sam"] = values["cap_sam"].mean()  # the per-pixel angles' mean, SAM's value

            # the first batches on the card against the CPU path (D-lambda's states are its inputs: exact)
            t_cpu = time.perf_counter()
            state_worst = 0.0
            for i in range(2):
                card = {k: MetricCollection(m, device="cuda") for k, m in pansharpening_members("cuda").items()}
                cpu = {k: MetricCollection(m, device="cpu") for k, m in pansharpening_members("cpu").items()}
                for kind in card:
                    card[kind].update(*dev[kind][i])
                    cpu[kind].update(*(torch.from_numpy(x) for x in host[kind][i]))
                p, t = dev["reduced"][i]
                cos = (p * t).sum(1) / (torch.linalg.norm(p, dim=1) * torch.linalg.norm(t, dim=1))
                sam_cond = float((1 / torch.sqrt(torch.clamp(1 - cos.double() ** 2, min=1e-30))).sum())
                tol = {"reduced": {"sam": {"sum_sam": ("abs", CANCEL_EPS * sam_cond)},
                                   "rmse_sw": {"rmse_val_sum": ("rel", 1e-6)}}, "full": {}}
                for kind in card:
                    share = check_image_states(f"{label} batch {i} {kind}", {n: export_state(m) for n, m in card[kind].items()},
                                               {n: export_state(m) for n, m in cpu[kind].items()}, tol[kind])
                    state_worst = max(state_worst, share)
            del card, cpu
            t_cpu = time.perf_counter() - t_cpu

            # the first images against the float64 oracle
            oracle = oracle_job.get()
            pool.close()
            pool.join()
        n = DIV2K_ORACLE_IMAGES
        small = {k: MetricCollection(m, device="cuda") for k, m in pansharpening_members("cuda").items()}
        for kind, col in small.items():
            col.update(*(x[:n] for x in dev[kind][0]))
        got = {k: v for col in small.values() for k, v in col.compute().items()}
        got["cap_sam"] = got["cap_sam"].mean()
        oracle_values = {k: oracle[k.removeprefix("cap_")] for k in got}
        oracle_worst = check_values(label, got, oracle_values, IMAGE_ORACLE_TOL)
        del small
        print(
            f"pansharpening phase: {label}: batches of {WV3_BATCH} (made from the seed on the host in {t_gen:.1f} s);"
            f" reduced: none (PanCollection's WorldView-3 test sets hold 20 images of each kind); values: "
            + ", ".join(f"{k} {float(v):.6f}" for k, v in values.items())
            + f"; against float64 oracles on {n} images, worst share of the tolerance {max(oracle_worst.values()):.3f}"
            f" ({max(oracle_worst, key=oracle_worst.get)}): "
            + ", ".join(f"{k} {float(got[k]):.6f} (oracle {oracle_values[k]:.6f})" for k in oracle_values)
            + f"; card vs CPU on 2 batches each ({t_cpu:.1f} s), worst share of a bound {state_worst:.3f}; host syncs in a steady"
            f" update {syncs}; update first / steady median: "
            + ", ".join(f"{k} {v[0]:.3f} / {np.median(v[1:]):.3f} ms" for k, v in update_ms.items())
            + f"; compute() {compute_ms:.3f} ms",
            flush=True,
        )
        prof = {kind: profile_step(torch, col, dev[kind][1], f"{label} {kind}") for kind, col in cols.items()}
        del cols
        fused = {
            "reduced": fused_pair(torch, f"{label} reduced", lambda f: MetricCollection(
                pansharpening_members("cuda")["reduced"], fused_update=f, device="cuda"), dev["reduced"]),
            "full": fused_pair(torch, f"{label} full (capacity copy)", lambda f: MetricCollection(
                {"cap_d_lambda": pansharpening_members("cuda")["full"]["cap_d_lambda"]}, fused_update=f, device="cuda"),
                dev["full"]),
        }
        del dev
        torch.cuda.empty_cache()
    check(fused["reduced"]["eager_leaders"] == ["ergas"], f"{label}: eager leaders {fused['reduced']['eager_leaders']}")
    for kind, f in fused.items():
        check(f["modes"]["replayed"] >= 1 and f["guarded_replay"], f"{label} {kind}: no checked graph replay")
        check(not any(n["plain"] or n["fused"] for n in f["kernel_launches"].values()), f"{label} {kind}: kernel launches")
    return {"launches": 0, "update_ms": update_ms, "compute_ms": compute_ms, "values": {k: float(v) for k, v in values.items()},
            "oracle": oracle_values, "oracle_worst": oracle_worst, "state_worst": state_worst, "host_syncs": syncs,
            "profile": prof, "reduced": "none", "fused": fused["reduced"], "fused_all": fused}


def sketch_index_oracle(values, levels: int = 44, capacity: int = 64, unit=None) -> np.ndarray:
    """The monitoring sketch's flat bucket index of each value, by its documented math in float64 numpy, in a
    formulation of its own: the level is the number of level bounds ``unit * 2**k`` (k = 0 .. levels-2) at or
    below ``|x|``, found by ``searchsorted``; the bucket ``floor((|x| - lo) * capacity / width)`` within it,
    clipped to ``[0, capacity)`` (``+-inf`` to the top); negative values (not -0.0) on the mirrored side;
    NaN as 0."""
    unit = 2.0 ** (24 - levels) if unit is None else float(unit)
    x = np.asarray(values, dtype=np.float64)
    a = np.abs(x)
    a = np.where(np.isnan(a), 0.0, a)
    level = np.searchsorted(np.ldexp(unit, np.arange(levels - 1)), a, side="right")
    lo = np.where(level == 0, 0.0, np.ldexp(unit, np.maximum(level - 1, 0)))
    width = np.where(level == 0, unit, lo)
    with np.errstate(invalid="ignore"):
        j = np.clip(np.floor((a - lo) * capacity / width), 0, capacity - 1).astype(np.int64)
    flat = level * capacity + j
    return np.where(x < 0, flat + levels * capacity, flat)


CRITEO_ROWS = 45_840_617  # the Criteo display-advertising challenge training log (Kaggle, 2014): 7 days
CRITEO_BATCH = 65_536
CRITEO_UPDATES = -(-CRITEO_ROWS // CRITEO_BATCH)  # 700: 699 full batches and a ragged one, padded and masked
CRITEO_LAST = CRITEO_ROWS - (CRITEO_UPDATES - 1) * CRITEO_BATCH  # 30,953 rows
CRITEO_SHIFT_AT = 400  # the update from which the scores' logits shift and one feature's counts double
CRITEO_LOGIT = (-1.2, 0.6, 0.3)  # the model's latent: mean, sd (a click rate near 0.25) and the shift
CRITEO_LATENCY = (math.log(12.0), 0.35, 1e-3, 20.0)  # serving latency (ms): log-median, log-sd, outliers, their factor
# I1-I13: missing share, and the log-mean and log-sd of the counts (floor of a log-normal: heavy-tailed integers)
CRITEO_FEATURES = [
    (0.454, 0.6, 1.2), (0.0, 2.5, 1.8), (0.217, 1.8, 1.6), (0.224, 1.5, 1.0), (0.026, 7.5, 1.9),
    (0.223, 3.5, 1.7), (0.043, 1.3, 1.5), (0.0005, 2.5, 1.0), (0.043, 3.9, 1.3), (0.454, 0.3, 0.6),
    (0.043, 0.8, 1.0), (0.765, 0.2, 1.0), (0.224, 1.5, 1.1),
]
CRITEO_DRIFTED = 3  # I4: its counts double from CRITEO_SHIFT_AT on
CRITEO_REF_SCORES = 1_000_000  # the drift monitors' reference: training scores
CRITEO_REF_ROWS = 1_000_000  # the feature monitors' reference: day 1's first rows
CRITEO_WINDOW, CRITEO_SLOTS, CRITEO_REFRESH = 100, 10, 10  # about a day in 10 panes; a dashboard refresh
CRITEO_THRESHOLD, CRITEO_HYSTERESIS = 0.1, 0.02
CRITEO_SCORE_QS, CRITEO_ALL_QS, CRITEO_LATENCY_QS = (0.5, 0.9, 0.99, 0.999), (0.5, 0.99), (0.5, 0.99, 0.999)
CRITEO_STREAM = "criteo-ctr"
CRITEO_CHECKPOINTS = (450, CRITEO_UPDATES)  # where the card's states are held against the CPU path's
CRITEO_CPU_BUDGET_S = 45.0  # a CPU path projected to take longer for 700 updates stops at 450
# the CPU path's worker processes (one thread each): the two collections, and the feature monitors in four groups
CRITEO_CPU_PARTS = ("collections", (0, 1, 2), (3, 4, 5), (6, 7, 8), (9, 10, 11, 12))
CRITEO_SCORE_RTOL = 1e-6  # windowed sums (float32 slots) against float64
CRITEO_DECAYED_RTOL = 1e-5  # the decayed mean: 700 float32 multiply-adds against float64
CRITEO_DRIFT_ATOL = 1e-6  # PSI, KL, KS against the float64 oracle


def criteo_members(device, reference, window: int = None, slots: int = None) -> dict:
    """The score and latency collections' members (the score collection's drift monitors against
    ``reference``); the ring is ``CRITEO_WINDOW`` and ``CRITEO_SLOTS`` unless given."""
    from tpumetrics_torch import monitoring as mon

    window, slots = window or CRITEO_WINDOW, slots or CRITEO_SLOTS
    ring = {"window": window, "slots": slots}
    drift = {**ring, "threshold": CRITEO_THRESHOLD, "hysteresis": CRITEO_HYSTERESIS, "device": device}
    return {
        "score": {
            "quantiles": mon.SketchQuantiles(CRITEO_SCORE_QS, **ring, device=device),
            "quantiles_all": mon.SketchQuantiles(CRITEO_ALL_QS, device=device),
            "psi": mon.PSI(reference, name="score_psi", **drift),
            "kl": mon.KLDrift(reference, name="score_kl", **drift),
            "ks": mon.KSDistance(reference, name="score_ks", **drift),
            "mean": mon.WindowedMean(window, slots=slots, device=device),
            "sum": mon.WindowedSum(window, slots=slots, device=device),
            "max": mon.WindowedMax(window, slots=slots, device=device),
            "min": mon.WindowedMin(window, slots=slots, device=device),
            "decayed": mon.DecayedMean(half_life=50, device=device),
        },
        "latency": {
            "quantiles": mon.SketchQuantiles(CRITEO_LATENCY_QS, **ring, device=device),
            "mean": mon.WindowedMean(window, slots=slots, device=device),
            "max": mon.WindowedMax(window, slots=slots, device=device),
        },
    }


def criteo_feature_monitor(j: int, reference, device, window: int = None, slots: int = None):
    from tpumetrics_torch import monitoring as mon

    return mon.PSI(reference, name=f"I{j + 1}", window=window or CRITEO_WINDOW, slots=slots or CRITEO_SLOTS,
                   threshold=CRITEO_THRESHOLD, hysteresis=CRITEO_HYSTERESIS, device=device)


def criteo_data(torch, device="cuda") -> dict:
    """The whole log on the card, made from the seed in bulk: per update ``(CRITEO_BATCH,)`` scores, latencies
    and a float valid mask (the ragged last batch's padding 0), ``(13, CRITEO_BATCH)`` integer counts with NaN
    where missing; the training scores of the reference."""
    g = torch.Generator(device=device)
    g.manual_seed(SEED + 15)
    u, b = CRITEO_UPDATES, CRITEO_BATCH
    mu, sd, shift = CRITEO_LOGIT
    drifted = (torch.arange(u, device=device) >= CRITEO_SHIFT_AT)[:, None]
    latent = mu + sd * torch.randn((u, b), generator=g, device=device) + shift * drifted
    scores = torch.sigmoid(latent)
    lmu, lsd, share, factor = CRITEO_LATENCY
    latency = torch.exp(lmu + lsd * torch.randn((u, b), generator=g, device=device))
    latency = torch.where(torch.rand((u, b), generator=g, device=device) < share, latency * factor, latency)
    miss, fmu, fsd = (torch.tensor([f[k] for f in CRITEO_FEATURES], device=device)[None, :, None] for k in range(3))
    feats = torch.floor(torch.exp(fmu + fsd * torch.randn((u, 13, b), generator=g, device=device)))
    feats[:, CRITEO_DRIFTED] = torch.where(drifted, 2 * feats[:, CRITEO_DRIFTED], feats[:, CRITEO_DRIFTED])
    feats = torch.where(torch.rand((u, 13, b), generator=g, device=device) < miss, float("nan"), feats)
    valid = torch.ones((u, b), device=device)
    valid[-1, CRITEO_LAST:] = 0.0
    reference = torch.sigmoid(mu + sd * torch.randn(CRITEO_REF_SCORES, generator=g, device=device))
    return {"scores": scores, "latency": latency, "features": feats, "valid": valid, "reference": reference}


def criteo_cpu_worker(part, spec: dict, inbox, outbox, threads: int) -> None:
    """One part of the stream's CPU path, in a worker process: the score and latency collections
    (``"collections"``) or the feature monitors of the given columns, fed the card's data batch by batch from
    ``inbox`` (a pipe's receiving end); their states at each checkpoint go to ``outbox``. Past the first checkpoint, a run projected to
    take longer than ``spec["budget_s"]`` for all ``spec["updates"]`` stops (the rest of the batches are
    drained). ``spec`` also holds the ``checkpoints`` and the ``window`` and ``slots``."""
    import torch

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from tpumetrics_torch import MetricCollection
    from tpumetrics_torch.interop import export_state

    torch.set_num_threads(threads)
    _, refs = inbox.recv()
    ring = {"window": spec["window"], "slots": spec["slots"]}
    if part == "collections":
        members = criteo_members("cpu", torch.from_numpy(refs), **ring)
        metrics = {k: MetricCollection(m, fused_update=True, device="cpu") for k, m in members.items()}
    else:
        metrics = {f"I{j + 1}": criteo_feature_monitor(j, torch.from_numpy(r), "cpu", **ring) for j, r in zip(part, refs)}
    t0, done, states, stopped = time.perf_counter(), 0, {}, False
    while True:
        msg = inbox.recv()
        if msg[0] == "end":
            break
        for cols in msg[1]:
            if stopped:
                continue
            valid = torch.from_numpy(cols["valid"])
            if part == "collections":
                metrics["score"].update(torch.from_numpy(cols["scores"]), valid)
                metrics["latency"].update(torch.from_numpy(cols["latency"]), valid)
            else:
                for j, x in zip(part, cols["features"]):
                    metrics[f"I{j + 1}"].update(torch.from_numpy(x), valid)
            done += 1
            if done in spec["checkpoints"]:  # copies: on the CPU an export views the fused step's own buffers
                states[done] = flat_states({k: export_state(m) for k, m in metrics.items()}, copy=True)
            if done == spec["checkpoints"][0]:
                stopped = (time.perf_counter() - t0) * spec["updates"] / done > spec["budget_s"]
    outbox.put({"part": part, "states": states, "updates": done, "seconds": time.perf_counter() - t0})


def flat_states(tree, prefix: str = "", copy: bool = False) -> dict:
    """``{"a.b.c": array}`` of a nested dict of exported states (the arrays copied with ``copy``)."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat_states(v, f"{prefix}{k}.", copy))
        else:
            out[f"{prefix}{k}"] = np.array(v) if copy else np.asarray(v)
    return out


def sketch_index_oracle_torch(torch, x, levels: int = 44, capacity: int = 64):
    """``sketch_index_oracle`` on the card, in float64 (the same formulation, held to the numpy one in the
    phase)."""
    unit = 2.0 ** (24 - levels)
    bounds = torch.from_numpy(np.ldexp(unit, np.arange(levels - 1))).to(x.device)
    a = x.double().abs()
    a = torch.where(torch.isnan(a), 0.0, a)
    level = torch.searchsorted(bounds, a, right=True)
    lo = torch.where(level == 0, 0.0, bounds[torch.clamp(level - 1, min=0)])
    width = torch.where(level == 0, unit, lo)
    j = torch.clamp(torch.floor((a - lo) * capacity / width), 0, capacity - 1).long()
    flat = level * capacity + j
    return torch.where(x < 0, flat + levels * capacity, flat)


def ordered64(counts: np.ndarray, side: int) -> np.ndarray:
    """Flat sketch counts (both signs) in ascending value order."""
    return np.concatenate([counts[..., side:2 * side][..., ::-1], counts[..., :side]], axis=-1)


def sketch_reps32(levels: int = 44, capacity: int = 64) -> np.ndarray:
    """Each bucket's midpoint in ascending value order (float32), from the documented geometry."""
    unit = 2.0 ** (24 - levels)
    flat = np.arange(levels * capacity)
    level, j = flat // capacity, flat % capacity
    lo = np.where(level == 0, 0.0, np.ldexp(unit, np.maximum(level - 1, 0)))
    width = np.where(level == 0, unit, lo)
    reps = (lo + (j + 0.5) * width / capacity).astype(np.float32)
    return np.concatenate([-reps[::-1], reps])


def quantile_oracle(ordered: np.ndarray, total32: np.float32, lo: float, hi: float, qs, reps: np.ndarray) -> np.ndarray:
    """The sketch's estimates from exact ordered counts: the first bucket whose cumulative count reaches
    ``q * total`` (float32, as the sketch takes it), its midpoint clamped into [min, max]."""
    rank = (np.float32(qs) * np.float32(total32)).astype(np.float64)
    idx = np.clip(np.searchsorted(np.cumsum(ordered).astype(np.float64), rank, side="left"), 0, len(reps) - 1)
    return np.minimum(np.maximum(reps[idx], np.float32(lo)), np.float32(hi))


def drift_oracle(ref_ordered: np.ndarray, live_ordered: np.ndarray, bins: int = 10, eps: float = 1e-6) -> dict:
    """PSI, KL and KS (float64) of exact live counts against exact reference counts, with the drift monitors'
    documented score bins (equal reference mass, the midpoint-CDF rule over float32 masses)."""
    ref_pmf = (ref_ordered.astype(np.float32) / np.float32(ref_ordered.sum())).astype(np.float32)
    mid = np.cumsum(ref_pmf, dtype=np.float64) - 0.5 * ref_pmf
    assign = np.clip((mid * bins).astype(np.int32), 0, bins - 1)
    q = np.clip(np.bincount(assign, weights=ref_pmf, minlength=bins).astype(np.float32).astype(np.float64), eps, 1.0)
    total = max(float(live_ordered.sum()), 1.0)
    p = np.clip(np.bincount(assign, weights=live_ordered.astype(np.float64), minlength=bins) / total, eps, 1.0)
    ks = np.abs(np.cumsum(live_ordered) / total - np.cumsum(ref_pmf, dtype=np.float64)).max()
    if live_ordered.sum() == 0:
        return {"psi": 0.0, "kl": 0.0, "ks": 0.0}
    return {"psi": float(((p - q) * np.log(p / q)).sum()), "kl": float((p * np.log(p / q)).sum()), "ks": float(ks)}


def latch_oracle(scores, threshold: float, hysteresis: float) -> tuple:
    """The refreshes (0-based) at which a hysteresis latch fires on ``scores``, and those whose score lies
    within CRITEO_DRIFT_ATOL of a latch bound (where the port and the oracle may fairly differ)."""
    fired, close, active = [], [], False
    for i, s in enumerate(scores):
        if min(abs(s - threshold), abs(s - (threshold - hysteresis))) <= CRITEO_DRIFT_ATOL:
            close.append(i)
        if s >= threshold and not active:
            active = True
            fired.append(i)
        elif active and s < threshold - hysteresis:
            active = False
    return fired, close


def criteo_phase(torch, bc, device: str = "cuda") -> dict:
    """The Criteo CTR monitoring stream (see the module note): the score and latency collections fused, the 13
    feature monitors unfused, ``compute()`` every 10 updates under ``stream_scope``, against exact oracles,
    the CPU path, the alerts in a ledger capture and the Prometheus text, then the fused phases. With
    ``device="cpu"`` (a rehearsal at a smaller size, with the module's sizes patched) the card-only parts, host
    syncs, the profile and the fused phases, are left out."""
    from tpumetrics_torch import MetricCollection
    from tpumetrics_torch import monitoring as mon
    from tpumetrics_torch import telemetry
    from tpumetrics_torch.interop import export_state
    from tpumetrics_torch.ops import biquad as bq

    label = f"Criteo CTR monitoring {CRITEO_ROWS} rows in {CRITEO_UPDATES} updates of {CRITEO_BATCH}"
    t_phase = time.perf_counter()
    on_card = device == "cuda"
    check(CRITEO_WINDOW // CRITEO_SLOTS == CRITEO_REFRESH, f"{label}: the oracles read the windows pane by pane")

    def sync():
        if on_card:
            torch.cuda.synchronize()

    data = criteo_data(torch, device)
    sync()
    t_gen = time.perf_counter() - t_phase
    feats = data["features"]
    feat_refs = feats[: -(-CRITEO_REF_ROWS // CRITEO_BATCH)].transpose(0, 1).reshape(13, -1)[:, :CRITEO_REF_ROWS]
    host = {k: data[k].cpu().numpy() for k in ("scores", "latency", "features", "valid")}

    # the CPU path, in worker processes beside the stream, fed the card's data batch by batch through
    # pipes by a thread of this process (joined below; a worker that dies breaks its pipe and is reported)
    ctx = multiprocessing.get_context("spawn")
    outbox = ctx.Queue()
    pipes, workers = [], []
    spec = {"updates": CRITEO_UPDATES, "checkpoints": CRITEO_CHECKPOINTS, "budget_s": CRITEO_CPU_BUDGET_S,
            "window": CRITEO_WINDOW, "slots": CRITEO_SLOTS}
    for part in CRITEO_CPU_PARTS:
        inbox, pipe = ctx.Pipe(duplex=False)
        proc = ctx.Process(target=criteo_cpu_worker, args=(part, spec, inbox, outbox, 1), daemon=True)
        proc.start()
        inbox.close()  # the worker's end
        pipes.append(pipe)
        workers.append(proc)
    refs = {part: data["reference"].cpu().numpy() if part == "collections" else [feat_refs[j].cpu().numpy() for j in part]
            for part in CRITEO_CPU_PARTS}

    def feed():
        try:
            for part, pipe in zip(CRITEO_CPU_PARTS, pipes):
                pipe.send(("refs", refs[part]))
            for start in range(0, CRITEO_UPDATES, 25):
                for part, pipe in zip(CRITEO_CPU_PARTS, pipes):
                    chunk = []
                    for b in range(start, min(start + 25, CRITEO_UPDATES)):
                        cols = {"valid": host["valid"][b]}
                        if part == "collections":
                            cols.update(scores=host["scores"][b], latency=host["latency"][b])
                        else:
                            cols["features"] = host["features"][b][list(part)]
                        chunk.append(cols)
                    pipe.send(("batches", chunk))
            for pipe in pipes:
                pipe.send(("end",))
        except OSError:  # a worker died: its exit code is read while waiting for the results
            pass

    feeder = threading.Thread(target=feed, daemon=True)
    feeder.start()

    members = criteo_members(device, data["reference"])
    cols = {k: MetricCollection(m, fused_update=True, device=device) for k, m in members.items()}
    monitors = [criteo_feature_monitor(j, feat_refs[j], device) for j in range(13)]
    refresh_values, rows, events_at, snaps, compute_ms = [], [], [], {}, []
    bc.launches, bq.launches = 0, 0
    sync()
    t_stream = time.perf_counter()
    with telemetry.capture() as led, mon.stream_scope(CRITEO_STREAM):
        for b in range(CRITEO_UPDATES):
            valid = data["valid"][b]
            cols["score"].update(data["scores"][b], valid)
            cols["latency"].update(data["latency"][b], valid)
            for j, m in enumerate(monitors):
                m.update(feats[b, j], valid)
            if (b + 1) % CRITEO_REFRESH == 0:
                n_events = len(led.records)
                t1 = time.perf_counter()
                values = {f"score_{k}": v for k, v in cols["score"].compute().items()}
                values.update({f"latency_{k}": v for k, v in cols["latency"].compute().items()})
                values.update({m.monitor_name: m.compute() for m in monitors})
                sync()
                compute_ms.append((time.perf_counter() - t1) * 1e3)
                refresh_values.append({k: v.double().cpu().numpy() for k, v in values.items()})
                rows.append({
                    "score": cols["score"]["quantiles"].merged_row().clone(),
                    "score_all": cols["score"]["quantiles_all"].merged_row().clone(),
                    "latency": cols["latency"]["quantiles"].merged_row().clone(),
                    **{m.monitor_name: m.merged_row().clone() for m in monitors},
                })
                events_at.append([(r.extra["monitor"], r.extra["stream"]) for r in led.records[n_events:]
                                  if r.kind == "drift_alert"])
            if b + 1 in CRITEO_CHECKPOINTS:
                snaps[b + 1] = flat_states({**{k: export_state(c) for k, c in cols.items()},
                                            **{m.monitor_name: export_state(m) for m in monitors}}, copy=True)
    sync()
    stream_s = time.perf_counter() - t_stream
    check(bc.launches == 0 and bq.launches == 0, f"{label}: kernel launches {bc.launches}, {bq.launches}")
    steps = {k: dict(c._fused_oo_step.counts) for k, c in cols.items()}
    check(all(s["replayed"] == CRITEO_UPDATES - 3 for s in steps.values()), f"{label}: fused updates by mode {steps}")
    groups = [list(g) for g in cols["score"].compute_groups.values()]
    check(["kl", "ks", "psi", "quantiles"] in [sorted(g) for g in groups], f"{label}: compute groups {groups}")

    # the alerts: ledger events, Prometheus series, release
    summary = led.summary()
    text = telemetry.prometheus_text()
    names = ["score_psi", "score_kl", "score_ks"] + [m.monitor_name for m in monitors]
    for name in names:
        check(f'tpumetrics_drift_score{{stream="{CRITEO_STREAM}",monitor="{name}"}}' in text,
              f"{label}: no gauge series for {name} in prometheus_text()")
    alerted = sorted({m for at in events_at for m, _ in at})
    for name in alerted:
        check(f'tpumetrics_drift_alerts_total{{stream="{CRITEO_STREAM}",monitor="{name}"}} 1' in text,
              f"{label}: alert counter of {name} not 1 in prometheus_text()")
    check(all(s == CRITEO_STREAM for at in events_at for _, s in at), f"{label}: an alert outside the stream's scope")
    mon.release_stream(cols["score"], CRITEO_STREAM)
    for m in monitors:
        mon.release_stream(m, CRITEO_STREAM)
    check(f'stream="{CRITEO_STREAM}"' not in telemetry.prometheus_text(), f"{label}: series left after release_stream")

    # the exact oracles, on the card in float64 / int64 from the same data
    t_oracle = time.perf_counter()
    layout = members["score"]["quantiles"]._sketch_layout
    side, reps = layout.side, sketch_reps32()
    for name, x in (("scores", data["scores"][0]), ("latency", data["latency"][0]), ("I4", feats[0, 3]),
                    ("I5", feats[0, 4]), ("edges", torch.from_numpy(np.concatenate([np.arange(70_000), -np.ldexp(
                        1.0, np.arange(-22, 26)), np.ldexp(1.0, np.arange(-22, 26)), [np.inf, -0.0, np.nan]]).astype(
                        np.float32)).to(device))):
        want = sketch_index_oracle(x.cpu().numpy())
        check(np.array_equal(sketch_index_oracle_torch(torch, x).cpu().numpy(), want),
              f"{label}: the card's float64 oracle index differs from numpy's on {name}")
        check(np.array_equal(layout.bucket_index(x).cpu().numpy(), want),
              f"{label}: the port's bucket index on the card differs from the numpy oracle on {name}")
    columns = {"score": data["scores"], "latency": data["latency"], **{f"I{j + 1}": feats[:, j] for j in range(13)}}
    panes = CRITEO_UPDATES // CRITEO_REFRESH
    pane_counts = {k: [] for k in columns}
    pane_stats = {k: [] for k in ("score", "latency")}
    batch_total32 = []
    for p in range(panes):
        sl = slice(p * CRITEO_REFRESH, (p + 1) * CRITEO_REFRESH)
        live = data["valid"][sl] > 0
        for k, x in columns.items():
            keep = live & ~torch.isnan(x[sl])
            idx = sketch_index_oracle_torch(torch, x[sl][keep])
            pane_counts[k].append(torch.bincount(idx, minlength=2 * side).cpu().numpy())
            if k in pane_stats:
                v = x[sl].double()
                pane_stats[k].append((
                    (v * keep).sum(dim=1).cpu().numpy(), keep.sum(dim=1).cpu().numpy(),
                    torch.where(keep, v, -math.inf).amax(dim=1).cpu().numpy(),
                    torch.where(keep, v, math.inf).amin(dim=1).cpu().numpy()))
        batch_total32.extend(live.sum(dim=1).cpu().numpy().tolist())
    cum = {k: np.cumsum(np.stack(v), axis=0) for k, v in pane_counts.items()}

    def window(k, r):  # exact counts of the window at refresh r (1-based), ordered
        lo = max(0, r - CRITEO_SLOTS)
        return ordered64(cum[k][r - 1] - (cum[k][lo - 1] if lo else 0), side)

    ref_counts = {"score": ordered64(np.bincount(sketch_index_oracle_torch(torch, data["reference"]).cpu().numpy(),
                                                 minlength=2 * side), side)}
    for j in range(13):
        r = feat_refs[j][~torch.isnan(feat_refs[j])]
        ref_counts[f"I{j + 1}"] = ordered64(np.bincount(sketch_index_oracle_torch(torch, r).cpu().numpy(),
                                                        minlength=2 * side), side)
    worst = {"drift": 0.0, "window_sum": 0.0, "decayed": 0.0, "quantile_rel": 0.0, "quantile_all_rel": 0.0}
    oracle_scores = {k: [] for k in names}
    all_scores = data["scores"][:, :]
    total32 = np.float32(0.0)
    decayed_sum, decayed_weight, alpha = 0.0, 0.0, 2.0 ** (-1.0 / 50)
    stats = {k: [np.concatenate(x) for x in zip(*v)] for k, v in pane_stats.items()}  # per batch: sum, n, max, min
    for r in range(1, panes + 1):
        got = refresh_values[r - 1]
        row = {k: v.cpu().numpy() for k, v in rows[r - 1].items()}
        for b in range((r - 1) * CRITEO_REFRESH, r * CRITEO_REFRESH):
            total32 = np.float32(total32 + np.float32(batch_total32[b]))
            decayed_sum = decayed_sum * alpha + stats["score"][0][b]
            decayed_weight = decayed_weight * alpha + stats["score"][1][b]
        first = max(0, r - CRITEO_SLOTS) * CRITEO_REFRESH
        for k, key in (("score", "score"), ("latency", "latency"), *((f"I{j + 1}", f"I{j + 1}") for j in range(13))):
            want = window(k, r)
            have = ordered64(row[key][: 2 * side].astype(np.int64), side)
            check(np.array_equal(have, want) and row[key][2 * side] == want.sum(),
                  f"{label}: refresh {r}: the {k} window's sketch differs from the oracle's counts")
        all_want = ordered64(cum["score"][r - 1], side)
        check(np.array_equal(ordered64(row["score_all"][: 2 * side].astype(np.int64), side), all_want)
              and row["score_all"][2 * side] == total32,
              f"{label}: refresh {r}: the cumulative sketch differs from the oracle's counts (total {row['score_all'][2 * side]}"
              f" vs {total32})")
        for k, qs, key in (("score", CRITEO_SCORE_QS, "score_quantiles"), ("latency", CRITEO_LATENCY_QS, "latency_quantiles")):
            s, n, hi, lo = (v[first: r * CRITEO_REFRESH] for v in stats[k])
            est = quantile_oracle(window(k, r), np.float32(n.sum()), lo.min(), hi.max(), qs, reps)
            check(np.array_equal(got[key].astype(np.float32), est), f"{label}: refresh {r}: {key} {got[key]} vs the oracle sketch's {est}")
            vals = columns[k][first: r * CRITEO_REFRESH][data["valid"][first: r * CRITEO_REFRESH] > 0]
            srt = torch.sort(vals).values.double().cpu().numpy()
            exact = srt[np.maximum(np.ceil(np.array(qs) * srt.size).astype(np.int64) - 1, 0)]
            rel = float(np.max(np.abs(got[key] - exact) / np.abs(exact)))
            worst["quantile_rel"] = max(worst["quantile_rel"], rel)
            check(rel <= 1 / layout.capacity, f"{label}: refresh {r}: {key} {got[key]} vs exact {exact}: rel {rel}")
            wsum, wn = s.sum(), n.sum()
            for member, want in (("mean", wsum / wn), ("sum", wsum), ("max", hi.max()), ("min", lo.min())):
                name = f"{k}_{member}"
                if name in got:
                    if member in ("max", "min"):
                        check(float(got[name]) == float(np.float32(want)), f"{label}: refresh {r}: {name} {got[name]} vs {want}")
                    else:
                        err = abs(float(got[name]) - want) / abs(want)
                        worst["window_sum"] = max(worst["window_sum"], err)
                        check(err <= CRITEO_SCORE_RTOL, f"{label}: refresh {r}: {name} {got[name]} vs {want} (rel {err:.2e})")
        est = quantile_oracle(all_want, total32, stats["score"][3][: r * CRITEO_REFRESH].min(),
                              stats["score"][2][: r * CRITEO_REFRESH].max(), CRITEO_ALL_QS, reps)
        check(np.array_equal(got["score_quantiles_all"].astype(np.float32), est),
              f"{label}: refresh {r}: quantiles_all {got['score_quantiles_all']} vs the oracle sketch's {est}")
        if r % 10 == 0:  # the exact quantiles of everything so far
            srt = torch.sort(all_scores[: r * CRITEO_REFRESH][data["valid"][: r * CRITEO_REFRESH] > 0]).values.double().cpu().numpy()
            exact = srt[np.maximum(np.ceil(np.array(CRITEO_ALL_QS) * srt.size).astype(np.int64) - 1, 0)]
            rel = float(np.max(np.abs(got["score_quantiles_all"] - exact) / exact))
            worst["quantile_all_rel"] = max(worst["quantile_all_rel"], rel)
            check(rel <= 1 / layout.capacity, f"{label}: refresh {r}: quantiles_all vs exact {exact}: rel {rel}")
        err = abs(float(got["score_decayed"]) - decayed_sum / decayed_weight) / (decayed_sum / decayed_weight)
        worst["decayed"] = max(worst["decayed"], err)
        check(err <= CRITEO_DECAYED_RTOL, f"{label}: refresh {r}: decayed mean rel err {err:.2e}")
        drift = drift_oracle(ref_counts["score"], window("score", r))
        for k in ("psi", "kl", "ks"):
            oracle_scores[f"score_{k}"].append(drift[k])
            e = abs(float(got[f"score_{k}"]) - drift[k])
            worst["drift"] = max(worst["drift"], e)
            check(e <= CRITEO_DRIFT_ATOL, f"{label}: refresh {r}: score_{k} {got[f'score_{k}']} vs oracle {drift[k]}")
        for j in range(13):
            name = f"I{j + 1}"
            want = drift_oracle(ref_counts[name], window(name, r))["psi"]
            oracle_scores[name].append(want)
            e = abs(float(got[name]) - want)
            worst["drift"] = max(worst["drift"], e)
            check(e <= CRITEO_DRIFT_ATOL, f"{label}: refresh {r}: {name} PSI {got[name]} vs oracle {want}")
    alerts = {}
    for name in names:
        fired = [i for i, at in enumerate(events_at) for m, _ in at if m == name]
        want, close = latch_oracle(oracle_scores[name], CRITEO_THRESHOLD, CRITEO_HYSTERESIS)
        alerts[name] = {"refreshes": [(i + 1) * CRITEO_REFRESH for i in fired], "oracle": [(i + 1) * CRITEO_REFRESH for i in want],
                        "close": close}
        check(fired == want or set(fired) ^ set(want) <= set(close),
              f"{label}: {name} alerted at updates {alerts[name]['refreshes']}, the oracle predicts {alerts[name]['oracle']}")
    check(summary["drift_alerts"] == sum(len(a["refreshes"]) for a in alerts.values()),
          f"{label}: {summary['drift_alerts']} drift_alert events in the capture")
    for name in ("score_psi", "score_kl", "score_ks", f"I{CRITEO_DRIFTED + 1}"):
        check(len(alerts[name]["refreshes"]) == 1, f"{label}: {name} alerts {alerts[name]}: expected one crossing")
    t_oracle = time.perf_counter() - t_oracle

    # the CPU path: states at the checkpoints it reached
    t_wait = time.perf_counter()
    results = []
    while len(results) < len(workers):
        try:
            results.append(outbox.get(timeout=5))
        except queue.Empty:
            dead = [p.exitcode for p in workers if not p.is_alive() and p.exitcode]
            check(not dead and time.perf_counter() - t_wait < 300, f"{label}: CPU path workers failed {dead}")
    feeder.join(30)
    for pipe in pipes:
        pipe.close()
    for proc in workers:
        proc.join(30)
    t_wait = time.perf_counter() - t_wait
    cpu_updates = min(res["updates"] for res in results)
    reduced = "none" if cpu_updates == CRITEO_UPDATES else (
        f"the CPU path ran the first {cpu_updates} of {CRITEO_UPDATES} updates (day 1 to past the shift)")
    check(cpu_updates >= CRITEO_CHECKPOINTS[0], f"{label}: the CPU path ran {cpu_updates} updates")
    state_worst = 0.0
    for at in CRITEO_CHECKPOINTS:
        if at > cpu_updates:
            continue
        cpu_states = {k: v for res in results for k, v in res["states"][at].items()}
        for name, v in snaps[at].items():
            w = cpu_states[name]
            if v.dtype.kind != "f" or name.endswith(("sketch", "slot_max", "slot_min")):
                check(np.array_equal(v, w), f"{label}: update {at}: {name} on the card differs from the CPU's")
            else:
                err = float(np.max(np.abs(v - w.astype(np.float64)) / np.maximum(np.abs(w), 1e-30)))
                state_worst = max(state_worst, err)
                check(err <= STATE_RTOL, f"{label}: update {at}: {name} card vs CPU rel {err:.2e}")
    cpu_s = max(res["seconds"] for res in results)

    # host syncs of steady updates: every member of both collections and every feature monitor, unfused
    syncs = {}
    if on_card:
        fresh = criteo_members(device, data["reference"])
        syncs = {f"score.{n}": steady_host_syncs(torch, m, (data["scores"][5], data["valid"][5]))
                 for n, m in fresh["score"].items()}
        syncs.update({f"latency.{n}": steady_host_syncs(torch, m, (data["latency"][5], data["valid"][5]))
                      for n, m in fresh["latency"].items()})
        syncs.update({m.monitor_name: steady_host_syncs(torch, m, (feats[5, j], data["valid"][5]))
                      for j, m in enumerate(monitors)})
    check(not any(syncs.values()), f"{label}: host syncs in a steady update {syncs}")
    print(
        f"criteo phase: {label} (the last {CRITEO_LAST} rows, padded and masked); data made on the card from the seed in"
        f" {t_gen:.2f} s; stream {stream_s:.2f} s ({1e3 * stream_s / CRITEO_UPDATES:.3f} ms an update: two fused"
        f" collections and 13 unfused feature monitors), fused updates by mode {steps}; compute() of everything"
        f" every {CRITEO_REFRESH} updates under stream_scope({CRITEO_STREAM!r}): median {np.median(compute_ms):.3f} ms"
        f" (first {compute_ms[0]:.1f} ms); sketches at all {panes} refreshes bit for bit the exact oracle's counts"
        f" (windows, the cumulative one with its float32 total {float(total32):.0f} of {CRITEO_ROWS} rows), quantiles"
        f" equal to the oracle sketch's and within {worst['quantile_rel']:.5f} (windows) and"
        f" {worst['quantile_all_rel']:.5f} (all rows) of the exact ones (bound {1 / layout.capacity}), windowed sums"
        f" within {worst['window_sum']:.2e}, decayed mean {worst['decayed']:.2e}, drift scores {worst['drift']:.2e} of"
        f" float64 (oracles {t_oracle:.1f} s); alerts (update: oracle) "
        + ", ".join(f"{k} {v['refreshes']}: {v['oracle']}" for k, v in alerts.items() if v["refreshes"] or v["oracle"])
        + f"; {summary['drift_alerts']} drift_alert ledger events, Prometheus series under stream={CRITEO_STREAM!r}"
        f" present and gone after release_stream; CPU path ({len(workers)} worker processes, {cpu_s:.1f} s, waited"
        f" {t_wait:.1f} s): reduced: {reduced}; card vs CPU at {[a for a in CRITEO_CHECKPOINTS if a <= cpu_updates]}:"
        f" sketches, counts and extrema identical, float sums within {state_worst:.2e}; host syncs in a steady"
        f" update {sum(syncs.values())} over {len(syncs)} members",
        flush=True,
    )
    out = {"launches": 0, "stream_s": stream_s, "compute_ms": compute_ms, "alerts": alerts, "worst": worst,
           "state_worst": state_worst, "cpu_updates": cpu_updates, "cpu_s": cpu_s, "reduced": reduced,
           "host_syncs": syncs}
    if not on_card:
        return out
    score_batches = [(data["scores"][b], data["valid"][b]) for b in (0, 1, 2)]
    latency_batches = [(data["latency"][b], data["valid"][b]) for b in (0, 1, 2)]
    prof = {"score": profile_step(torch, cols["score"], score_batches[1], f"{label} score collection"),
            "latency": profile_step(torch, cols["latency"], latency_batches[1], f"{label} latency collection")}
    del cols, monitors
    ref = data["reference"]
    fused = {
        "score": fused_pair(torch, f"{label} score collection", lambda f: MetricCollection(
            criteo_members("cuda", ref)["score"], fused_update=f, device="cuda"), score_batches),
        "latency": fused_pair(torch, f"{label} latency collection", lambda f: MetricCollection(
            criteo_members("cuda", ref)["latency"], fused_update=f, device="cuda"), latency_batches),
    }
    for kind, f in fused.items():
        check(f["modes"]["replayed"] >= 1 and f["guarded_replay"] and not f["eager_leaders"],
              f"{label} {kind}: fused phase {f['modes']}, eager leaders {f['eager_leaders']}")
    del data, feats, feat_refs
    torch.cuda.empty_cache()
    print(f"criteo phase: {time.perf_counter() - t_phase:.1f} s in all", flush=True)
    return {**out, "profile": prof, "fused": fused["score"], "fused_all": fused, "phase_s": time.perf_counter() - t_phase}


def sync_phase(torch, bc, smi: str) -> dict:
    """The ImageNet-size collection synced over NCCL at world size 1 (see the module note)."""
    import tempfile

    import torch.distributed as dist
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from tpumetrics_torch import CatMetric, MeanMetric, MetricCollection, telemetry
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
            with telemetry.capture() as led:
                synced = col.compute()
            torch.cuda.synchronize()
            # the ledger of that compute() against what the backend counted: every wire call one record
            # ("backend" source), the bytes it sent, the ring model's wire bytes (0 at world 1), the members' tags
            ledger = led.summary()
            wire_records = [r for r in led.records if r.source == "backend"]
            check(ledger["collectives_issued"] == forced.wire == len(wire_records)
                  and ledger["payload_bytes_total"] == forced.wire_bytes
                  and ledger["wire_bytes_total"] == sum(telemetry.reduce_wire_bytes(r.payload_bytes, 1) if r.kind == "all_reduce"
                                                        else telemetry.gather_wire_bytes(r.payload_bytes, 1) for r in wire_records),
                  f"{label}: ledger {ledger} vs the backend's {forced.wire} wire ops, {forced.wire_bytes} bytes")
            ledger["backend_wire"], ledger["backend_bytes"] = forced.wire, forced.wire_bytes
            tags = sorted({r.tag for r in led.records if r.source in ("backend", "reducer")})
            member_tags = ["acc/MulticlassAccuracy", "auroc/MulticlassAUROC", "cat/CatMetric", "mean/MeanMetric"]
            check(all(any(t in tag.split("+") for tag in tags) for t in member_tags) and ledger["flush_count"] == 1,
                  f"{label}: ledger tags {tags}, flushes {ledger['flush_count']}")
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
        f" ({len(classes)} + 2 x {n_gathers}), {wire_bytes} bytes sent by this rank; the ledger of one compute():"
        f" {ledger['collectives_issued']} collectives and {ledger['payload_bytes_total']} payload bytes (the backend"
        f" counted {ledger['backend_wire']} and {ledger['backend_bytes']}), {ledger['wire_bytes_total']} wire bytes"
        f" (ring model, world 1), tags {tags}; profiler: {len(nccl_ops)}"
        f" NCCL ops {sorted(set(nccl_ops))}, {len(nccl_kernels)} NCCL device kernels; compute() median"
        f" {np.median(synced_ms):.3f} ms synced vs {np.median(local_ms):.3f} ms unsynced (host clock, 7 each),"
        f" the sync {sync_ms:.3f} ms; card {smi}",
        flush=True,
    )
    return {
        "launches": launches, "sync_ms": sync_ms, "compute_ms": synced_ms, "local_compute_ms": local_ms,
        "wire": wire, "wire_bytes": wire_bytes, "by_class": by_class, "gathers": n_gathers, "fused": fused,
        "ledger": {k: ledger[k] for k in ("collectives_issued", "payload_bytes_total", "wire_bytes_total", "flush_count",
                                          "backend_wire", "backend_bytes")},
    }


# ------------------------------------------------------------------- the image metrics that run a backbone
# CIFAR-10 FID-50k, the protocol of Heusel et al. 2017 and StyleGAN2-ADA's fid50k_full: 50,000 generated images
# against CIFAR-10's 50,000 training images, 32 x 32 uint8 RGB, made on the card from the seed (smooth 1/f fields
# plus pixel noise; the generated set with a steeper spectrum and more noise), resized to 299 by the TF1 resize
# and run through InceptionV3 at full width with random_inception_params(SEED) (the pretrained weights are not in
# the repository: the values mean nothing, the times do), in batches of 256 and a ragged last 80
CIFAR_IMAGES, CIFAR_BATCH, CIFAR_SIDE = 50_000, 256, 32
# FID over the first 5,000 of each set: on an H100 the full 2 x 50,000 took 57.5 s of a 111.6 s phase (1,741
# images/s), past the phase's 90 s; 25,000 a set left the script at 607.5 s and 658 s, 20,000 a set with the
# detection phase after it at 685 and 745 s, and 10,000 a set at 581.7-596.5 s and 743.0 s (the earlier phases
# vary by tens of seconds between runs, over a hundred between hosts); the resolution and the width stay whole
CIFAR_FID_IMAGES = 5_000
CIFAR_SUBSET = 1_250  # KID (subsets of 1,000), MiFID and IS over the first 1,250 of each set
KID_SUBSETS, KID_SUBSET_SIZE = 100, 1000
CIFAR_CPU_IMAGES = 32  # held card against the port's CPU path in a worker process
INCEPTION_CPU_RTOL = 1e-5  # card vs CPU features, of the largest: float32 sums in another order (TF32 would not hold)
# the float32 additions behind one entry of FID's moment sums: a batch product's 256 terms, then the batches
FID_SUM_DEPTH = CIFAR_BATCH + -(-CIFAR_FID_IMAGES // CIFAR_BATCH)
# KID's mean and std against a float64 MMD on the card over the same subsets, each of its own size (both float64,
# their sums in another order); IS's mean and std against a float64 oracle on the card over the same split, of the
# mean. Each check must also tell the metric's draws from another seed's (``draw_sensitivity``)
KID_RTOL = 1e-6
IS_RTOL = 1e-5
# the phase's Inception weights: random_inception_params(SEED) with He's gain sqrt(2) on every convolution. The
# draws alone (1 / sqrt(fan_in)) halve the signal's variance at each ReLU while every folded BN adds its shift, so
# the features of all images agree to about 0.2 % and a third of them are 0 on every image
# (scripts/inception_feature_spread.py): FID, KID and IS then sit at the size of their own float32 error and no
# check on their values can fail. The times do not depend on the values
INCEPTION_CONV_GAIN = float(np.sqrt(2.0))
BF16_GATES = {"fid": (0.05, 0.10), "kid": (0.005, 0.25), "lpips": (0.01, 0.05)}  # max(abs, rel * |fp32|)
LPIPS_SMALL_PAIRS = 10  # vgg and squeeze run on the first 10 DIV2K pairs
LPIPS_CPU_PAIRS = 2  # held against the port's float64 CPU path in worker processes
LPIPS_CPU_RTOL = 1e-5  # card (float32) vs CPU (float64) per pair: one float32 rounding per layer (TF32 would not hold)
# PerceptualPathLength at the JAX package's defaults (num_samples 10,000, epsilon 1e-4, resize 64, lerp) with
# VGG-16 LPIPS, over a seeded generator from 512-d latents to 3 x 256 x 256 images (StyleGAN's output size)
PPL_SAMPLES, PPL_BATCH, PPL_LATENT, PPL_SIDE, PPL_ORACLE = 10_000, 128, 512, 256, 256
# a pair's distance vs float64: float32 rounds t + 1e-4 (t up to 1: the step off by up to 6e-4 of itself, the squared
# distance by 1.2e-3) and the two images' difference, whose 1e-4 step it carries with ~1e-3 of its size
PPL_RTOL = 1e-2


def mem(torch) -> dict:
    """The card's allocated and reserved memory and the allocated peak, GiB."""
    g = 2.0**30
    return {"allocated": torch.cuda.memory_allocated() / g, "reserved": torch.cuda.memory_reserved() / g,
            "peak": torch.cuda.max_memory_allocated() / g}


def cifar_images(torch, which: int, n: int = CIFAR_IMAGES, device: str = "cuda"):
    """``n`` uint8 ``(3, 32, 32)`` images made on ``device`` from the seed: 1/f fields, a level per channel and pixel
    noise; set 0 stands for CIFAR-10's training images, set 1 for a generator's (a steeper spectrum, more noise)."""
    g = torch.Generator(device=device).manual_seed(SEED + 71 + which)
    fy = torch.fft.fftfreq(CIFAR_SIDE, device=device)[:, None]
    fx = torch.fft.rfftfreq(CIFAR_SIDE, device=device)[None, :]
    f = torch.sqrt(fx * fx + fy * fy)
    amp = torch.where(f > 0, f.clamp(min=1e-6) ** -(1.0 + 0.4 * which), 0.0)
    out = torch.empty((n, 3, CIFAR_SIDE, CIFAR_SIDE), dtype=torch.uint8, device=device)
    for lo in range(0, n, 10_000):
        m = min(10_000, n - lo)
        shape = (m, 3, CIFAR_SIDE, CIFAR_SIDE // 2 + 1)
        spec = torch.complex(torch.randn(shape, generator=g, device=device), torch.randn(shape, generator=g, device=device))
        x = torch.fft.irfft2(spec * amp, s=(CIFAR_SIDE, CIFAR_SIDE))
        x = (x - x.mean((2, 3), keepdim=True)) / x.std((2, 3), keepdim=True)
        level = 0.25 + 0.5 * torch.rand((m, 3, 1, 1), generator=g, device=device)
        x = level + 0.15 * x + (0.02 + 0.03 * which) * torch.randn(x.shape, generator=g, device=device)
        out[lo:lo + m] = (x.clamp(0, 1) * 255).round().to(torch.uint8)
    return out


def generative_inception_params(conv_gain: float = INCEPTION_CONV_GAIN) -> dict:
    """random_inception_params(SEED) with every convolution's weights times ``conv_gain`` (float32)."""
    from tpumetrics_torch.image._inception import random_inception_params

    return {k: v * np.float32(conv_gain) if k.endswith("conv.weight") else v
            for k, v in random_inception_params(SEED).items()}


def inception_cpu_features(imgs: np.ndarray) -> np.ndarray:
    """The port's CPU path: the float32 2048-d features of uint8 ``imgs`` under the phase's weights
    (``generative_inception_params``; run in a worker process)."""
    import torch

    from tpumetrics_torch.image._inception import inception_v3_features

    torch.set_num_threads(4)
    params = {k: torch.from_numpy(v) for k, v in generative_inception_params().items()}
    return inception_v3_features(params, ("2048",))(torch.from_numpy(imgs))[0].numpy()


class FeatureTap:
    """FID's extractor in the CIFAR-10 FID stream: the shared Inception handle, whose features' float64 moments (sums,
    products, and the same of their magnitudes: the oracle's inputs and its error bound's) it adds to sums on the
    card in place, so FID's captured update records them beside the forward. It holds one reference on the handle,
    which FID adopts (``key``, ``close``) and releases; ``generation`` is the handle's, for the update's graphs."""

    def __init__(self, torch, handle, dim: int = 2048):
        self.torch, self.handle, self.key = torch, handle.acquire(), handle.key
        zeros = lambda *shape: torch.zeros(shape, dtype=torch.float64, device="cuda")  # noqa: E731
        self.sums = {"n": zeros(), "s": zeros(dim), "abs_s": zeros(dim), "c": zeros(dim, dim), "abs_c": zeros(dim, dim)}

    @property
    def generation(self) -> int:
        return self.handle.generation

    def __call__(self, x):
        f = self.handle(x)
        f64 = f.double()
        a64 = f64.abs()
        s = self.sums
        s["n"].add_(f.shape[0])
        s["s"].add_(f64.sum(0))
        s["abs_s"].add_(a64.sum(0))
        s["c"].addmm_(f64.T, f64)
        s["abs_c"].addmm_(a64.T, a64)
        return f

    def take(self) -> dict:
        """The sums so far, on the host, and the card's sums zeroed in place (the graphs keep their addresses)."""
        out = {k: v.cpu().numpy() for k, v in self.sums.items()}
        for v in self.sums.values():
            v.zero_()
        out["n"] = float(out["n"])
        return out

    def close(self) -> None:
        self.handle.close()


def fid_oracle(real: dict, fake: dict, depth: int = FID_SUM_DEPTH) -> dict:
    """FID in float64 (``scipy.linalg.sqrtm``) from the float64 moments of the card's own features, and bounds on
    the port's float32 error. A covariance entry ``(S - n mu mu^T) / (n - 1)`` in float32 is within
    ``(depth + 8) u`` of its terms' magnitudes ``(|f|^T|f| + 3 n a a^T) / (n - 1)`` (``a`` the mean magnitudes:
    the cancellation's scale, as ``condition64`` is SSIM's), a mean within ``(depth + 2) u a``. A feature that is
    0 on every image of a set (a channel no image excites) is exactly 0 in both computations, and
    ``tr sqrt(S1 S2)`` depends only on the block ``L`` of the features live in both sets; there the error is carried
    to FID through its derivative, ``dFID = <G1, dS1> + <G2, dS2>``, ``G1 = I - (S2 M^-1)^T``,
    ``G2 = I - (M^-1 S1)^T``, ``M = sqrtm(S1 S2)``; elsewhere through the traces. Plus ``2 |mu1 - mu2| . (dmu1 +
    dmu2)`` and the float32 sums of FID's last step. ``bound``: the whole of FID's float32 path, its moment sums
    ``depth`` additions deep; ``bound_compute``: ``compute()`` alone, from its float32 states (``depth`` 0)."""
    from scipy import linalg

    t0 = time.perf_counter()
    mus, covs, scales, mags, live = [], [], [], [], []
    for m in (real, fake):
        n = m["n"]
        mu, a = m["s"] / n, m["abs_s"] / n
        mus.append(mu)
        covs.append((m["c"] - n * np.outer(mu, mu)) / (n - 1))
        scales.append(F32_U * (m["abs_c"] + 3 * n * np.outer(a, a)) / (n - 1))
        mags.append(F32_U * a)
        live.append(a > 0)
    both = live[0] & live[1]
    s1, s2 = covs[0][np.ix_(both, both)], covs[1][np.ix_(both, both)]
    root = np.real(linalg.sqrtm(s1 @ s2))
    diff = mus[0] - mus[1]
    traces = np.trace(covs[0]) + np.trace(covs[1])
    fid = float(diff @ diff + traces - 2 * np.trace(root))
    inv = np.linalg.inv(root)
    eye = np.eye(root.shape[0])
    g1, g2 = np.abs(eye - (s2 @ inv).T), np.abs(eye - (inv @ s1).T)
    dim = covs[0].shape[0]
    last = dim * F32_U * (diff @ diff + abs(traces)) + 4 * F32_U * (diff @ diff + abs(traces) + 2 * abs(np.trace(root)))
    # per unit of (depth + 8) for the covariances and of (depth + 2) for the means
    cov_part = (g1 * scales[0][np.ix_(both, both)]).sum() + (g2 * scales[1][np.ix_(both, both)]).sum() + sum(
        np.diag(e)[lv & ~both].sum() for e, lv in zip(scales, live))  # live in one set: the trace alone
    mu_part = 2 * (np.abs(diff) * (mags[0] + mags[1])).sum()
    bound_at = lambda d: float((d + 8) * cov_part + (d + 2) * mu_part + last)  # noqa: E731
    return {"fid": fid, "bound": bound_at(depth), "bound_compute": bound_at(0), "live": [int(lv.sum()) for lv in live],
            "live_both": int(both.sum()), "seconds": time.perf_counter() - t0}


def fid_from64(torch, mu1, s1, mu2, s2) -> float:
    """FID of float64 means and covariances on the card: ``tr sqrt(S1 S2)`` as the trace of the square root of the
    symmetric ``S1^1/2 S2 S1^1/2`` (two ``eigh``)."""
    w, v = torch.linalg.eigh(s1)
    half = (v * w.clamp(min=0).sqrt()) @ v.T
    root = torch.linalg.eigvalsh(half @ s2 @ half).clamp(min=0).sqrt().sum()
    return float(((mu1 - mu2) ** 2).sum() + torch.trace(s1) + torch.trace(s2) - 2 * root)


def fid64_of_states(torch, metric) -> float:
    """FID in float64 on the card from a FID metric's own float32 states (its covariances formed in float64)."""
    def moments(prefix):
        n = getattr(metric, f"{prefix}_features_num_samples").double()
        mu = getattr(metric, f"{prefix}_features_sum").double() / n
        return mu, (getattr(metric, f"{prefix}_features_cov_sum").double() - n * torch.outer(mu, mu)) / (n - 1)

    return fid_from64(torch, *moments("real"), *moments("fake"))


def fid_state_check(metric, prefix: str, sums: dict, depth: int = FID_SUM_DEPTH) -> dict:
    """FID's float32 states of one set (``prefix``), entry by entry, against the float64 sums of the same features
    (``FeatureTap.take``): the count exact, each entry of the feature sum and of the product sum within
    ``(depth + 2) u`` of the sum of its terms' magnitudes (any order of ``depth``-deep float32 additions). Returns
    the worst error over its bound per state (``n``: 0 or inf)."""
    n = float(getattr(metric, f"{prefix}_features_num_samples"))
    out = {"n": 0.0 if n == sums["n"] else float("inf")}
    for name, want, mag in (("sum", sums["s"], sums["abs_s"]), ("cov_sum", sums["c"], sums["abs_c"])):
        got = getattr(metric, f"{prefix}_features_{name}").double().cpu().numpy()
        bound = (depth + 2) * F32_U * mag
        out[name] = float((np.abs(got - want) / np.maximum(bound, np.finfo(np.float64).tiny)).max())
    return out


def resize_matrix64(n_in: int, n_out: int) -> np.ndarray:
    """The ``(n_out, n_in)`` weights of a half-pixel bilinear resize, antialiased when it shrinks, written out in
    float64: output pixel ``i`` is centred at ``(i + 0.5) n_in / n_out - 0.5`` input pixels, its weights a triangle
    of half-width ``max(1, n_in / n_out)`` input pixels around that centre, each row normalised to 1 (the definition
    of ``jax.image.resize(..., "bilinear")``, which PPL's resize follows)."""
    scale = n_out / n_in
    centre = (np.arange(n_out) + 0.5) / scale - 0.5
    w = np.maximum(0.0, 1.0 - np.abs(np.arange(n_in)[None, :] - centre[:, None]) * min(scale, 1.0))
    return w / w.sum(1, keepdims=True)


LPIPS_SHIFT, LPIPS_SCALE = (-0.030, -0.088, -0.188), (0.458, 0.448, 0.450)  # the LPIPS reference's ScalingLayer


def vgg_lpips64(torch, a, b, convs: list, heads: list):
    """Per-pair LPIPS-VGG of image batches in [-1, 1], written out from the definition with the port's functions
    left out (float64 tensors on their device): the ScalingLayer; VGG-16's 13 3 x 3 convolutions (``convs``, the
    ``(weight, bias)`` pairs) each with a ReLU, a 2 x 2 max pool before blocks 2-5, the features at each block's
    end; each unit-normalised along the channels (``sqrt(1e-8 + sum f^2)``), their squared difference weighted per
    channel by ``heads``, summed over the channels, averaged over the pixels and summed over the five layers."""
    fn = torch.nn.functional
    shift = torch.tensor(LPIPS_SHIFT, dtype=torch.float64, device=a.device).reshape(1, 3, 1, 1)
    scale = torch.tensor(LPIPS_SCALE, dtype=torch.float64, device=a.device).reshape(1, 3, 1, 1)

    def layers(x):
        h, outs, i = (x - shift) / scale, [], 0
        for block, depth in enumerate((2, 2, 3, 3, 3)):
            if block:
                h = fn.max_pool2d(h, 2, 2)
            for _ in range(depth):
                h = torch.relu(fn.conv2d(h, convs[i][0], convs[i][1], padding=1))
                i += 1
            outs.append(h)
        return outs

    total = torch.zeros(a.shape[0], dtype=torch.float64, device=a.device)
    for fa, fb, w in zip(layers(a), layers(b), heads):
        ua = fa / torch.sqrt(1e-8 + (fa * fa).sum(1, keepdim=True))
        ub = fb / torch.sqrt(1e-8 + (fb * fb).sum(1, keepdim=True))
        total = total + ((ua - ub) ** 2 * w.reshape(1, -1, 1, 1)).sum(1).mean((1, 2))
    return total


def ppl_oracle64(torch, generate64, key, batches: int, convs: list, heads: list, epsilon: float = 1e-4,
                 size: int = 64):
    """PPL's first ``batches * PPL_BATCH`` distances from the definition in float64 on the card, with the port's
    functions left out: the latents drawn from ``key`` as the metric draws them (z1, z2, t per batch), the lerp
    ``z1 + (z2 - z1) t`` and at ``t + epsilon``, the images resized by ``resize_matrix64``'s weights, the
    pair's ``vgg_lpips64`` over ``epsilon^2``."""
    out = []
    for _ in range(batches):
        z1 = torch.randn((PPL_BATCH, PPL_LATENT), generator=key, device="cuda").double()
        z2 = torch.randn((PPL_BATCH, PPL_LATENT), generator=key, device="cuda").double()
        t = torch.rand((PPL_BATCH, 1), generator=key, device="cuda").double()
        imgs = [generate64(z1 + (z2 - z1) * s) for s in (t, t + epsilon)]
        w = torch.from_numpy(resize_matrix64(imgs[0].shape[-1], size)).cuda()
        a, b = (torch.einsum("oh,nchw,pw->ncop", w, x, w) for x in imgs)
        out.append(vgg_lpips64(torch, a, b, convs, heads) / epsilon**2)
    return torch.cat(out).cpu().numpy()


def draw_sensitivity(got, other) -> float:
    """How far a metric's (mean, std) is from an oracle's over another seed's draws, of the oracle's mean."""
    return max(abs(a - b) for a, b in zip(got, other)) / abs(other[0])


def kid_oracle(torch, real, fake, subsets: int, size: int, seed: int) -> tuple:
    """KID's mean and std in float64 on the card over the subsets KID draws (numpy's ``default_rng(seed)``
    permutations, real then generated, per subset)."""
    rng = np.random.default_rng(seed)
    r, f = real.double(), fake.double()
    gamma = 1.0 / r.shape[1]
    scores = []
    for _ in range(subsets):
        a = r[torch.from_numpy(rng.permutation(r.shape[0])[:size]).cuda()]
        b = f[torch.from_numpy(rng.permutation(f.shape[0])[:size]).cuda()]
        k11, k22, k12 = ((x @ y.T * gamma + 1.0) ** 3 for x, y in ((a, a), (b, b), (a, b)))
        within = (k11.sum() - k11.diagonal().sum()) + (k22.sum() - k22.diagonal().sum())
        scores.append(within / (size * (size - 1)) - 2 * k12.sum() / size**2)
    s = torch.stack(scores)
    return float(s.mean()), float(s.std(correction=0))


def is_oracle(torch, logits, splits: int, seed: int) -> tuple:
    """Inception Score in float64 on the card over the permutation and splits IS draws."""
    perm = torch.from_numpy(np.random.default_rng(seed).permutation(logits.shape[0])).cuda()
    x = logits.double()[perm]
    p, log_p = torch.softmax(x, 1), torch.log_softmax(x, 1)
    chunk = -(-x.shape[0] // splits)
    kl = []
    for lo in range(0, x.shape[0], chunk):
        q, lq = p[lo:lo + chunk], log_p[lo:lo + chunk]
        kl.append(torch.exp(torch.where(q > 0, q * (lq - torch.log(q.mean(0, keepdim=True))), 0.0).sum(1).mean()))
    k = torch.stack(kl)
    return float(k.mean()), float(k.std(correction=0))


def fid64(torch, real, fake) -> float:
    """FID of two feature sets in float64 on the card."""
    r, f = real.double(), fake.double()
    return fid_from64(torch, r.mean(0), torch.cov(r.T), f.mean(0), torch.cov(f.T))


def gate(kind: str, low: float, full: float) -> dict:
    atol, rtol = BF16_GATES[kind]
    bound = max(atol, rtol * abs(full))
    return {"fp32": full, "bf16": low, "gap": abs(low - full), "bound": bound, "share": abs(low - full) / bound}


def generative_phase(torch, bc) -> dict:
    """CIFAR-10 FID (fid50k_full's protocol, its sets cut to 5,000: see the note above the constants) on the card,
    with torch's TF32 defaults and the He-scaled random Inception (``generative_inception_params``): FID over both
    sets through a captured update whose extractor also sums the float64 moments of the same features (FID's float32
    states against them entry by entry, a check that must reject two planted faults; FID against a float64 scipy
    oracle within a bound scaled by the moments' cancellation), KID (100 subsets of 1,000), MiFID and IS over the
    first 1,250 of each set on the one resident 2048-tap handle (KID and IS against float64 oracles on the card
    over the same draws, each check shown to tell them from another seed's), the card's features for 32 images
    against the port's CPU path (a worker), streaming against a single pass, host syncs, update and compute times,
    and the bfloat16 policy's extraction rate and FID/KID gaps against their gates."""
    import contextlib
    import tempfile
    import threading
    from unittest import mock

    from tpumetrics_torch.backbones import get_backbone, registry_stats
    from tpumetrics_torch.image import (
        FrechetInceptionDistance, InceptionScore, KernelInceptionDistance,
        MemorizationInformedFrechetInceptionDistance,
    )
    from tpumetrics_torch.image import _inception
    from tpumetrics_torch.image._inception import inception_v3_features
    from tpumetrics_torch.ops import biquad as bq

    label = f"generative CIFAR-10 FID over {CIFAR_FID_IMAGES} of {CIFAR_IMAGES} a set"
    t_phase = time.perf_counter()
    parts, marks = {}, [t_phase]

    def lap() -> float:  # seconds since the last mark
        marks.append(time.perf_counter())
        return marks[-1] - marks[-2]

    params = generative_inception_params()
    workdir = tempfile.mkdtemp(prefix="inception_")
    path = os.path.join(workdir, "inception.npz")
    np.savez(path, **params)
    out = {}
    with tf32_defaults(torch), multiprocessing.get_context("spawn").Pool(1) as pool:
        real_imgs, fake_imgs = cifar_images(torch, 0), cifar_images(torch, 1)
        torch.cuda.synchronize()
        cpu_job = pool.apply_async(inception_cpu_features, (real_imgs[:CIFAR_CPU_IMAGES].cpu().numpy(),))
        torch.cuda.synchronize()
        bc.launches, bq.launches = 0, 0
        kw = dict(feature_extractor_weights_path=path, device="cuda")
        kid = KernelInceptionDistance(feature=2048, subsets=KID_SUBSETS, subset_size=KID_SUBSET_SIZE, seed=SEED, **kw)
        handle = kid.inception
        tap = FeatureTap(torch, handle)
        fid = FrechetInceptionDistance(feature=tap, num_features=2048, device="cuda")
        mifid = MemorizationInformedFrechetInceptionDistance(feature=2048, **kw)
        inc = InceptionScore(feature=2048, splits=10, seed=SEED, **kw)
        check(fid.backbone_key == kid.backbone_key == mifid.backbone_key == inc.backbone_key,
              f"{label}: the metrics hold different backbones")
        stats = registry_stats()
        check(len(stats) == 1 and stats[handle.key]["refs"] == 4, f"{label}: registry {stats}")
        out["registry"] = stats[handle.key]

        # FID: both sets through the captured update; the tap's sums are the oracle's
        t0 = time.perf_counter()
        oracle_moments = {}
        for name, imgs in (("real", real_imgs), ("fake", fake_imgs)):
            for lo in range(0, CIFAR_FID_IMAGES, CIFAR_BATCH):
                fid.update(imgs[lo:min(lo + CIFAR_BATCH, CIFAR_FID_IMAGES)], real=name == "real")
            oracle_moments[name] = tap.take()
        torch.cuda.synchronize()
        out["fid_stream_s"] = time.perf_counter() - t0
        parts["images_and_fid_stream"] = lap()
        out["fid_images_per_s"] = 2 * CIFAR_FID_IMAGES / out["fid_stream_s"]
        out["fid_modes"] = dict(fid._jit_accum.counts)
        print(f"generative phase: FID stream {out['fid_stream_s']:.1f} s ({out['fid_images_per_s']:.0f} images/s),"
              f" modes {out['fid_modes']}; device memory {mem(torch)}", flush=True)
        check(out["fid_modes"]["replayed"] >= 2 * (CIFAR_FID_IMAGES // CIFAR_BATCH) - 3 and not fid._jit_accum.eager_mode,
              f"{label}: FID's update modes {out['fid_modes']}")
        # FID's states entry by entry against the float64 sums of the same features; the check must reject the
        # other set's sums and a stream that lost half of one batch (its float64 sums less the lost 128 images')
        states = {name: fid_state_check(fid, name, oracle_moments[name]) for name in ("real", "fake")}
        check(all(v <= 1.0 for st in states.values() for v in st.values()), f"{label}: FID's states {states}")
        lost = handle(real_imgs[CIFAR_BATCH // 2:CIFAR_BATCH]).double()
        m = oracle_moments["real"]
        half = {**m, "n": m["n"] - lost.shape[0], "s": m["s"] - lost.sum(0).cpu().numpy(),
                "c": m["c"] - (lost.T @ lost).cpu().numpy()}
        faults = {"other_set": fid_state_check(fid, "real", oracle_moments["fake"]),
                  "half_batch_lost": fid_state_check(fid, "real", half)}
        check(all(f[k] > 1.0 for f in faults.values() for k in ("sum", "cov_sum")),
              f"{label}: the state check let a planted fault through {faults}")
        out["fid_states"], out["fid_state_faults"] = states, faults
        del lost
        parts["state_checks"] = lap()
        oracle = {}
        worker = threading.Thread(target=lambda: oracle.update(fid_oracle(oracle_moments["real"], oracle_moments["fake"])))
        worker.start()  # scipy's sqrtm on the host beside the card's work below

        # KID, MiFID and IS over the first CIFAR_SUBSET of each set, each through the handle's bucketed graphs
        t0 = time.perf_counter()
        for name, imgs in (("real", real_imgs), ("fake", fake_imgs)):
            for lo in range(0, CIFAR_SUBSET, CIFAR_BATCH):
                batch = imgs[lo:min(lo + CIFAR_BATCH, CIFAR_SUBSET)]
                kid.update(batch, real=name == "real")
                mifid.update(batch, real=name == "real")
                if name == "fake":
                    inc.update(batch)
        torch.cuda.synchronize()
        out["subset_stream_s"] = time.perf_counter() - t0
        parts["subset_stream"] = lap()

        # compute() of each, FID's and MiFID's host eigenvalues (numpy's eigvals of a 2048 x 2048 product) timed apart
        compute_ms, values, eig_ms = {}, {}, []
        eigvals = np.linalg.eigvals

        def timed_eigvals(a):
            t0 = time.perf_counter()
            try:
                return eigvals(a)
            finally:
                eig_ms.append((time.perf_counter() - t0) * 1e3)

        with mock.patch.object(np.linalg, "eigvals", timed_eigvals):
            for name, metric in (("fid", fid), ("kid", kid), ("mifid", mifid), ("is", inc)):
                t0 = time.perf_counter()
                val = metric.compute()
                torch.cuda.synchronize()
                compute_ms[name] = (time.perf_counter() - t0) * 1e3
                values[name] = [float(v) for v in val] if isinstance(val, tuple) else float(val)
        check(all(np.isfinite(v).all() for v in values.values()), f"{label}: values {values}")
        out["fid_eig_ms"] = eig_ms[0]
        parts["compute"] = lap()

        # KID and IS against float64 oracles on the card over the same draws, from the metrics' own features
        kid_want = kid_oracle(torch, torch.cat(kid.real_features), torch.cat(kid.fake_features), KID_SUBSETS,
                              KID_SUBSET_SIZE, SEED)
        kid_err = max(abs(a - b) / abs(b) for a, b in zip(values["kid"], kid_want))  # each of its own size
        check(kid_err <= KID_RTOL, f"{label}: KID {values['kid']} vs float64 {kid_want} ({kid_err:.3e})")
        is_want = is_oracle(torch, torch.cat(inc.features), 10, SEED)
        is_err = max(abs(a - b) for a, b in zip(values["is"], is_want)) / is_want[0]  # of the score
        check(is_err <= IS_RTOL, f"{label}: IS {values['is']} vs float64 {is_want} ({is_err:.3e})")
        # each check tells the metric's draws from another seed's
        sens = {"kid": draw_sensitivity(values["kid"], kid_oracle(
                    torch, torch.cat(kid.real_features), torch.cat(kid.fake_features), KID_SUBSETS, KID_SUBSET_SIZE,
                    SEED + 1)),
                "is": draw_sensitivity(values["is"], is_oracle(torch, torch.cat(inc.features), 10, SEED + 1))}
        check(sens["kid"] > KID_RTOL and sens["is"] > IS_RTOL, f"{label}: another seed's draws pass the checks {sens}")
        out["kid_oracle"], out["kid_err"], out["is_oracle"], out["is_err"] = kid_want, kid_err, is_want, is_err
        out["draw_sensitivity"] = sens
        parts["kid_is_oracles"] = lap()

        # the card's features for 32 images against the CPU path; the same forward with the float32 guard out
        first = real_imgs[:CIFAR_CPU_IMAGES]
        card = handle(first).cpu().numpy()
        with mock.patch.object(_inception, "_ieee_float32", lambda *b: contextlib.nullcontext()):
            unguarded = inception_v3_features(handle.params, ("2048",))(first)[0].cpu().numpy()
        cpu = cpu_job.get()
        scale = float(np.abs(cpu).max())
        feat_err = float(np.abs(card - cpu).max()) / scale
        feat_err_tf32 = float(np.abs(unguarded - cpu).max()) / scale
        check(feat_err <= INCEPTION_CPU_RTOL, f"{label}: card vs CPU features {feat_err:.3e} of the largest")
        out["features_vs_cpu"] = {"rel": feat_err, "rel_unguarded": feat_err_tf32, "tol": INCEPTION_CPU_RTOL}
        parts["cpu_features"] = lap()

        # streaming equals a single pass: 512 images in one update and in two of 256
        one = FrechetInceptionDistance(feature=2048, **kw)
        two = FrechetInceptionDistance(feature=2048, **kw)
        one.update(real_imgs[:512], real=True)
        two.update(real_imgs[:256], real=True)
        two.update(real_imgs[256:512], real=True)
        check(float(one.real_features_num_samples) == float(two.real_features_num_samples) == 512.0,
              f"{label}: streaming counts")
        stream_err = {}
        for s in ("sum", "cov_sum"):
            a, b = getattr(one, f"real_features_{s}"), getattr(two, f"real_features_{s}")
            stream_err[s] = float((a - b).abs().max() / b.abs().max())
            check(stream_err[s] <= 1e-5, f"{label}: streaming {s} differs from a single pass by {stream_err[s]:.3e}")
        out["stream_vs_single"] = stream_err
        parts["streaming"] = lap()

        # update times in turns: the replayed graph, the eager fallback (the engine's graph of the forward and the
        # moments op by op), and the forward alone op by op; host syncs; one profiled replay
        batch = real_imgs[:CIFAR_BATCH]
        eager = FrechetInceptionDistance(feature=2048, **kw)
        for _ in range(2):
            one.update(batch, real=False)
            eager.update(batch, real=False)
        eager._jit_accum.eager_mode = True
        forward = inception_v3_features(handle.params, ("2048",))
        times = {"replayed": [], "eager": [], "forward_op_by_op": []}
        runs = {"replayed": lambda: one.update(batch, real=False), "eager": lambda: eager.update(batch, real=False),
                "forward_op_by_op": lambda: forward(batch)}
        for _ in range(5):
            for name, fn in runs.items():
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                times[name].append((time.perf_counter() - t0) * 1e3)
        out["update_ms"] = {k: float(np.median(v)) for k, v in times.items()}
        out["host_syncs"] = {"fid_replayed": count_host_syncs(torch, runs["replayed"]),
                             "kid_update": count_host_syncs(torch, lambda: kid.update(batch, real=True))}
        check(not any(out["host_syncs"].values()), f"{label}: host syncs in a steady update {out['host_syncs']}")
        out["profile"] = {"replayed": profile_update(torch, runs["replayed"])}
        out["memory_after_timing"] = mem(torch)
        parts["update_timing"] = lap()

        # the bfloat16 policy: extraction rate (float input, so the convolutions run in bfloat16) against float32,
        # in turns, and the FID and KID gaps over the first CIFAR_SUBSET of each set against their gates
        h16 = get_backbone("inception:2048", params, dtype_policy="bfloat16", device="cuda")
        xs = [real_imgs[lo:lo + CIFAR_BATCH].float() for lo in range(0, 5 * CIFAR_BATCH, CIFAR_BATCH)]
        for h in (handle, h16):
            for x in xs[:2]:
                h(x)
        rate = {"float32": [], "bfloat16": []}
        for name in ("float32", "bfloat16", "bfloat16", "float32"):
            h = handle if name == "float32" else h16
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for x in xs:
                h(x)
            torch.cuda.synchronize()
            rate[name].append(len(xs) * CIFAR_BATCH / (time.perf_counter() - t0))
        out["images_per_s"] = {k: float(np.mean(v)) for k, v in rate.items()}
        feats16 = {name: torch.cat([h16(imgs[lo:lo + CIFAR_BATCH].float())
                                    for lo in range(0, CIFAR_SUBSET, CIFAR_BATCH)])[:CIFAR_SUBSET]
                   for name, imgs in (("real", real_imgs), ("fake", fake_imgs))}
        feats32 = {"real": torch.cat(kid.real_features)[:CIFAR_SUBSET], "fake": torch.cat(kid.fake_features)[:CIFAR_SUBSET]}
        gates = {"fid": gate("fid", fid64(torch, feats16["real"], feats16["fake"]),
                             fid64(torch, feats32["real"], feats32["fake"])),
                 "kid": gate("kid", kid_oracle(torch, feats16["real"], feats16["fake"], 10, KID_SUBSET_SIZE, SEED)[0],
                             kid_oracle(torch, feats32["real"], feats32["fake"], 10, KID_SUBSET_SIZE, SEED)[0])}
        check(all(g["gap"] <= g["bound"] for g in gates.values()), f"{label}: bfloat16 gates {gates}")
        out["bf16_gates"] = gates
        h16.close()
        parts["bf16"] = lap()

        worker.join()
        parts["join"] = lap()
        fid_err = abs(values["fid"] - oracle["fid"])
        check(fid_err <= oracle["bound"], f"{label}: FID {values['fid']} vs float64 {oracle['fid']} ({fid_err:.3e},"
                                          f" bound {oracle['bound']:.3e})")
        # compute() alone: against FID in float64 from its own float32 states, within the bound of that step
        fid_states64 = fid64_of_states(torch, fid)
        compute_err = abs(values["fid"] - fid_states64)
        check(compute_err <= oracle["bound_compute"], f"{label}: FID's compute() {values['fid']} vs float64 of its"
                                                      f" states {fid_states64} ({compute_err:.3e},"
                                                      f" bound {oracle['bound_compute']:.3e})")
        check(oracle_moments["real"]["n"] == oracle_moments["fake"]["n"] == CIFAR_FID_IMAGES, f"{label}: tap counts")
        out["fid_oracle"] = {**oracle, "err": fid_err, "share": fid_err / oracle["bound"],
                             "bound_of_fid": oracle["bound"] / abs(oracle["fid"]), "states64": fid_states64,
                             "compute_err": compute_err, "compute_share": compute_err / oracle["bound_compute"]}
        parts["checks"] = lap()
        check(bc.launches == 0 and bq.launches == 0, f"{label}: kernel launches {bc.launches}, {bq.launches}")
        out["launches"] = {"binned_confusion": bc.launches, "biquad_cascade": bq.launches}
        out["registry_after"] = registry_stats()[handle.key]
        for m in (fid, kid, mifid, inc, one, two, eager):
            m.release_backbones()
            m.release_backbones()  # idempotent
        check(not registry_stats(), f"{label}: handles left after release {registry_stats()}")
        del real_imgs, fake_imgs, kid, fid, mifid, inc, one, two, eager, xs, feats16, feats32, tap, handle
        pool.close()
        pool.join()
    os.remove(path)
    os.rmdir(workdir)
    torch.cuda.empty_cache()
    out.update(values=values, compute_ms=compute_ms, phase_s=time.perf_counter() - t_phase, parts_s=parts,
               reduced=f"FID over the first {CIFAR_FID_IMAGES:,} and KID/MiFID/IS over the first {CIFAR_SUBSET:,} of each"
                       f" set of {CIFAR_IMAGES:,} (the script's 600 s);"
                       " 299 x 299 at full width; random weights, He-scaled (no pretrained file)")
    o = out
    print(
        f"generative phase: {label}: {2 * CIFAR_FID_IMAGES} images in batches of {CIFAR_BATCH} through FID's"
        f" captured update in {o['fid_stream_s']:.1f} s ({o['fid_images_per_s']:.0f} images/s; modes {o['fid_modes']});"
        f" KID/MiFID/IS over {CIFAR_SUBSET} a set in {o['subset_stream_s']:.1f} s; values {values}; FID vs float64"
        f" sqrtm {o['fid_oracle']['fid']:.6f}: {o['fid_oracle']['err']:.3e} of a bound {o['fid_oracle']['bound']:.3e}"
        f" (sqrtm {o['fid_oracle']['seconds']:.1f} s; live features {o['fid_oracle']['live']}); compute() vs float64 of"
        f" its states {o['fid_oracle']['compute_err']:.3e} of a bound {o['fid_oracle']['bound_compute']:.3e}; FID's states over their"
        f" bounds {o['fid_states']}, planted faults {o['fid_state_faults']}; KID vs float64 {o['kid_err']:.2e}"
        f" (tolerance {KID_RTOL}), IS {o['is_err']:.2e} (tolerance {IS_RTOL}), another seed's draws"
        f" {o['draw_sensitivity']};"
        f" card vs CPU features {o['features_vs_cpu']['rel']:.2e} of the largest (tolerance {INCEPTION_CPU_RTOL},"
        f" with the float32 guard out {o['features_vs_cpu']['rel_unguarded']:.2e}); streaming vs single pass"
        f" {o['stream_vs_single']}; update ms (median of 5, in turns) {o['update_ms']}; device union replayed"
        f" {o['profile']['replayed']['busy_ms']:.3f} of {o['profile']['replayed']['wall_ms']:.3f} ms; compute ms {compute_ms}"
        f" (FID's host eigenvalues {o['fid_eig_ms']:.1f} ms of it); host syncs {o['host_syncs']}; extraction images/s"
        f" {o['images_per_s']}; bf16 gates {gates}; registry {o['registry']}; phase {o['phase_s']:.1f} s (parts, s:"
        f" {o['parts_s']})",
        flush=True,
    )
    return out


def ppl_generator(torch, dtype, seed: int = SEED):
    """A seeded generator from 512-d latents to ``(3, 256, 256)`` images in [-1, 1]: two dense layers to a 16 x 16
    RGB field, a bilinear upsampling and a tanh (smooth images, as a GAN's are)."""
    g = np.random.default_rng([seed, 97])
    w1 = torch.from_numpy((g.standard_normal((PPL_LATENT, 768)) / np.sqrt(PPL_LATENT)).astype(np.float32))
    w2 = torch.from_numpy((g.standard_normal((768, 3 * 16 * 16)) * 1.5 / np.sqrt(768)).astype(np.float32))
    w1, w2 = w1.to("cuda", dtype), w2.to("cuda", dtype)  # the same float32 weights at either precision

    def generate(z):
        h = torch.tanh(z.to(dtype) @ w1) @ w2
        h = torch.nn.functional.interpolate(h.reshape(-1, 3, 16, 16), size=(PPL_SIDE, PPL_SIDE), mode="bilinear",
                                            align_corners=False)
        return torch.tanh(h)

    return generate


def lpips_cpu_values(net: str, p64: list, t64: list) -> np.ndarray:
    """The port's float64 CPU path: per-pair LPIPS of ``net`` (random convs from the seed, the bundled heads) over
    [0, 1] images (a worker process)."""
    import torch

    from tpumetrics_torch.functional.image.lpips import learned_perceptual_image_patch_similarity, lpips_head_weights
    from tpumetrics_torch.image._backbones import lpips_backbone, lpips_conv_params, random_lpips_params

    torch.set_num_threads(4)
    backbone = lpips_backbone(net, lpips_conv_params(random_lpips_params(net, SEED), "cpu", torch.float64))
    heads = [torch.from_numpy(w).double() for w in lpips_head_weights(net)]
    p, t = torch.from_numpy(np.stack(p64)), torch.from_numpy(np.stack(t64))
    return learned_perceptual_image_patch_similarity(p, t, backbone, heads, normalize=True, reduction="none").numpy()


def lpips_cpu_start(torch, pairs) -> tuple:
    """Start the port's float64 CPU path of LPIPS on the first DIV2K pairs (AlexNet and SqueezeNet) in two worker
    processes; it runs beside the phases between, and ``perceptual_phase`` collects it. Returns (pool, jobs,
    the first pairs on the card as [0, 1] floats)."""
    first = tuple(x[:LPIPS_CPU_PAIRS].float().div(255) for x in pairs[0])
    p64, t64 = (list(x.double().cpu().numpy()) for x in first)
    pool = multiprocessing.get_context("spawn").Pool(2)
    return pool, {net: pool.apply_async(lpips_cpu_values, (net, p64, t64)) for net in ("alex", "squeeze")}, first


def perceptual_phase(torch, bc, pairs=None, cpu=None) -> dict:
    """LPIPS over the DIV2K restoration pairs (``pairs``: the restoration phase's uint8 batches on the card, made
    anew when None) with AlexNet (all 100, the LPIPS authors' default), VGG-16 and SqueezeNet (the first 10), with
    torch's TF32 defaults; each net's first pairs against the port's float64 CPU path in workers; the bfloat16
    LPIPS gap; then PerceptualPathLength with VGG-16 LPIPS at the JAX defaults, its first 256 distances against a
    float64 oracle of the definition written out without the port's functions (``ppl_oracle64``) on the same
    latents, and its discarding against numpy's. ``cpu``: what
    ``lpips_cpu_start`` returned, started earlier (started here when None)."""
    import contextlib
    from unittest import mock

    from tpumetrics_torch.backbones import registry_stats
    from tpumetrics_torch.functional.image.lpips import learned_perceptual_image_patch_similarity, lpips_head_weights
    from tpumetrics_torch.image import LearnedPerceptualImagePatchSimilarity, PerceptualPathLength
    from tpumetrics_torch.image import _backbones
    from tpumetrics_torch.image._backbones import lpips_backbone, random_lpips_params
    from tpumetrics_torch.ops import biquad as bq

    label = f"perceptual DIV2K {DIV2K_IMAGES} pairs of {DIV2K_W} x {DIV2K_H}, PPL {PPL_SAMPLES}"
    t_phase = time.perf_counter()
    out = {"ms_per_pair": {}, "values": {}, "cpu_rel": {}, "cpu_rel_unguarded": {}}
    if pairs is None:  # run alone: the pairs made anew, in worker processes
        with multiprocessing.get_context("spawn").Pool(min(8, os.cpu_count() or 1)) as gen:
            pairs = [tuple(torch.from_numpy(x).to("cuda") for x in b)
                     for b in gen.imap(div2k_batch, range(DIV2K_IMAGES // DIV2K_BATCH))]
    pool, cpu_jobs, first_pairs = cpu if cpu is not None else lpips_cpu_start(torch, pairs)
    first = [first_pairs]
    with tf32_defaults(torch), pool:
        params = {net: random_lpips_params(net, SEED) for net in ("alex", "vgg", "squeeze")}
        pending = {}
        torch.cuda.synchronize()
        bc.launches, bq.launches = 0, 0
        for net in ("alex", "vgg", "squeeze"):
            batches = pairs if net == "alex" else [tuple(x[i:i + 2] for x in b) for b in pairs[:LPIPS_SMALL_PAIRS // 4 + 1]
                                                     for i in (0, 2)][: LPIPS_SMALL_PAIRS // 2]
            metric = LearnedPerceptualImagePatchSimilarity(net_type=net, normalize=True, backbone_params=params[net],
                                                           device="cuda")
            times = []
            for p, t in batches:
                p, t = p.float().div(255), t.float().div(255)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                metric.update(p, t)
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1e3 / p.shape[0])
            out["ms_per_pair"][net] = {"first": times[0], "steady": float(np.median(times[2:])), "modes": dict(metric._jit_loss.counts)}
            out["values"][net] = float(metric.compute())
            check(np.isfinite(out["values"][net]) and out["values"][net] > 0, f"{label}: LPIPS {net} {out['values'][net]}")
            check(metric._jit_loss.counts["replayed"] >= 1, f"{label}: LPIPS {net} never replayed")
            if net == "alex":
                out["host_syncs"] = count_host_syncs(torch, lambda: metric.update(*first[0]))
                check(out["host_syncs"] == 0, f"{label}: host syncs in a steady LPIPS update")
                out["profile"] = profile_update(torch, lambda: metric.update(p, t))
                # the bfloat16 policy on the first 8 pairs against float32
                lows = LearnedPerceptualImagePatchSimilarity(net_type=net, normalize=True, backbone_params=params[net],
                                                             backbone_dtype_policy="bfloat16", device="cuda")
                full = LearnedPerceptualImagePatchSimilarity(net_type=net, normalize=True, backbone_params=params[net],
                                                             device="cuda")
                for p8, t8 in pairs[: LPIPS_SMALL_PAIRS // 4]:
                    lows.update(p8.float().div(255), t8.float().div(255))
                    full.update(p8.float().div(255), t8.float().div(255))
                out["bf16_gate"] = gate("lpips", float(lows.compute()), float(full.compute()))
                check(out["bf16_gate"]["gap"] <= out["bf16_gate"]["bound"], f"{label}: bf16 gate {out['bf16_gate']}")
                lows.release_backbones()
                full.release_backbones()
            if net in cpu_jobs:  # the first pairs on the card, held against the CPU path after PPL
                card = learned_perceptual_image_patch_similarity(*first[0], metric.net, metric.layer_weights,
                                                                 normalize=True, reduction="none").cpu().numpy()
                with mock.patch.object(_backbones, "_ieee_float32", lambda *b: contextlib.nullcontext()):
                    loose = learned_perceptual_image_patch_similarity(
                        *first[0], lpips_backbone(net, metric.net.params), metric.layer_weights, normalize=True,
                        reduction="none").cpu().numpy()
                pending[net] = (card, loose)
            metric.release_backbones()

        # PPL at the JAX defaults with VGG-16 LPIPS
        generate = ppl_generator(torch, torch.float32)
        ppl = PerceptualPathLength(num_samples=PPL_SAMPLES, epsilon=1e-4, resize=64, sim_net="vgg",
                                   interpolation_method="lerp", latent_dim=PPL_LATENT, backbone_params=params["vgg"],
                                   device="cuda")
        ppl.update(generate)
        t0 = time.perf_counter()
        mean, std, dist = ppl.compute()
        torch.cuda.synchronize()
        out["ppl_compute_s"] = time.perf_counter() - t0
        out["ppl"] = {"mean": float(mean), "std": float(std)}
        check(dist.shape == (PPL_SAMPLES,) and bool(torch.isfinite(dist).all()), f"{label}: PPL distances")
        # its discarding against numpy's on the same distances
        d64 = dist.double().cpu().numpy()
        lo, hi = np.quantile(d64, 0.01), np.quantile(d64, 0.99)
        kept = d64[(d64 >= lo) & (d64 <= hi)]
        want = (kept.mean(), np.sqrt(((kept - kept.mean()) ** 2).mean()))
        disc_err = max(abs(float(mean) - want[0]) / want[0], abs(float(std) - want[1]) / want[1])
        check(disc_err <= 1e-5, f"{label}: PPL discarding {float(mean)}, {float(std)} vs numpy {want}")
        # the first 256 distances against the definition, written out in float64 on the same latents
        convs64 = [tuple(torch.from_numpy(np.asarray(x)).to("cuda", torch.float64) for x in wb) for wb in params["vgg"]]
        heads = [torch.from_numpy(w).to("cuda", torch.float64) for w in lpips_head_weights("vgg")]
        ref = ppl_oracle64(torch, ppl_generator(torch, torch.float64), torch.Generator(device="cuda").manual_seed(0),
                           PPL_ORACLE // PPL_BATCH, convs64, heads)
        ppl_err = np.abs(d64[:PPL_ORACLE] - ref) / np.abs(ref)
        out["ppl_oracle"] = {"worst_rel": float(ppl_err.max()), "median_rel": float(np.median(ppl_err)),
                             "mean64": float(ref.mean()), "mean32": float(d64[:PPL_ORACLE].mean()), "tol": PPL_RTOL}
        check(ppl_err.max() <= PPL_RTOL, f"{label}: PPL vs float64 {out['ppl_oracle']}")
        out["discard_err"] = disc_err
        out["registry"] = registry_stats()
        ppl.release_backbones()
        t0 = time.perf_counter()
        for net, (card, loose) in pending.items():
            cpu = cpu_jobs[net].get()
            out["cpu_rel"][net] = float(np.max(np.abs(card - cpu) / np.abs(cpu)))
            out["cpu_rel_unguarded"][net] = float(np.max(np.abs(loose - cpu) / np.abs(cpu)))
            check(out["cpu_rel"][net] <= LPIPS_CPU_RTOL, f"{label}: {net} card {card} vs CPU float64 {cpu}")
        out["cpu_wait_s"] = time.perf_counter() - t0
        check(not registry_stats(), f"{label}: handles left after release {registry_stats()}")
        check(bc.launches == 0 and bq.launches == 0, f"{label}: kernel launches {bc.launches}, {bq.launches}")
        out["launches"] = {"binned_confusion": bc.launches, "biquad_cascade": bq.launches}
        pool.close()
        pool.join()
    torch.cuda.empty_cache()
    out.update(phase_s=time.perf_counter() - t_phase,
               reduced="none: LPIPS-Alex on all 100 pairs at 2040 x 1356, VGG and SqueezeNet on the first 10; PPL at"
                       " the JAX defaults; random convs (no pretrained file), the bundled trained heads")
    o = out
    print(
        f"perceptual phase: {label}: LPIPS values {o['values']}; ms a pair {o['ms_per_pair']}; card vs float64 CPU"
        f" {o['cpu_rel']} (tolerance {LPIPS_CPU_RTOL}; with the float32 guard out {o['cpu_rel_unguarded']}); host syncs"
        f" {o['host_syncs']}; profiled alex update {o['profile']}; bf16 gate {o['bf16_gate']}; PPL {o['ppl']} in"
        f" {o['ppl_compute_s']:.2f} s; PPL vs float64 on {PPL_ORACLE} {o['ppl_oracle']}; discarding vs numpy"
        f" {o['discard_err']:.2e}; waited {o['cpu_wait_s']:.1f} s on the CPU path after PPL; phase {o['phase_s']:.1f} s",
        flush=True,
    )
    return out


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


def profile_step(torch, col, batch, label: str) -> dict:
    """After every check: one steady (leaders-only) update and one compute,
    timed on the host clock, then each again under ``torch.profiler``. From
    that one profiled run: its wall time (host clock, from the call to the
    end of ``torch.cuda.synchronize()``), the union of its device activity
    intervals from the trace, their share of that wall time (the rest is the
    device idle, waiting on the host), the kernels that take most, and the
    convolutions' time; those numbers are returned by step."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    stats = {}

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
        conv_us, conv_n, conv_names = conv_kernels(prof)
        conv_part = (f" convolution kernels x{conv_n} {conv_us:.1f} us ({conv_us / 10 / busy_ms:.1f}% of the union:"
                     f" {conv_names});" if conv_us else "")
        stats[step] = {"wall_ms": wall_ms, "profiled_ms": profiled_ms, "busy_ms": busy_ms, "conv_us": conv_us,
                       "conv_launches": conv_n, "scratch_mb": scratch_mb}
        print(
            f"profile: {label}: steady {step} {wall_ms:.3f} ms wall unprofiled; profiled run {profiled_ms:.3f} ms wall,"
            f" device busy (union of {len(device)} device intervals) {busy_ms:.3f} ms"
            f" = {100 * busy_ms / profiled_ms:.1f}% of it, first-to-last device span {span_ms:.3f} ms;"
            f" peak device memory above resident {scratch_mb:.1f} MiB;"
            f" binned_confusion kernels (rank + count) {ours:.1f} us;{iir_part}{conv_part}"
            f" top: {parts or 'the profiler saw no device time'}",
            flush=True,
        )
    return stats



# ---------------------------------------------------------------- detection

COCO_IMAGES = 5_000  # val2017
COCO_W, COCO_H = 640, 480
COCO_CLASSES = 80
COCO_GT_MEAN = 36_781 / 5_000  # val2017's instances an image
COCO_GT_MAX = 60  # crowd scenes' tail
COCO_PERSON = 0.30  # class 0's share of the instances
COCO_AREA_SHARES = (0.41, 0.34, 0.25)  # small (< 32^2), medium (< 96^2), large instances
COCO_CROWD = 0.01
COCO_AREA_ZERO = 0.1  # instances whose `area` is 0, so the box's area stands in
COCO_DETS = 100  # a detector's top-100 an image
COCO_EXACT_IMAGES = 0.05  # images whose integer boxes put IoUs exactly on 0.5 and 0.75
COCO_BATCH = 32
COCO_DET_SLOTS, COCO_GT_SLOTS = 128, 64
COCO_DET_CAPACITY, COCO_GT_CAPACITY = 524_288, 65_536
COCO_UNFUSED_IMAGES = 500  # held against the per-cell reference too
COCO_IOU_IMAGES = 500  # the IoU family's images
PANOPTIC_IMAGES = 200  # of COCO panoptic val2017's 5,000
PANOPTIC_CPU_WORKERS = 3  # the CPU path's batches (its torch.unique passes take some 0.2 s an image a member)
PANOPTIC_THINGS, PANOPTIC_STUFFS = 80, 53
PANOPTIC_BATCH = 8


def coco_image(rng, index: int) -> tuple:
    """One image of the COCO val2017-size detection stream: ``(preds, target)``
    numpy dicts (see ``detection_phase``)."""
    n_gt = 0 if rng.random() < 0.01 else int(min(COCO_GT_MAX, 1 + rng.negative_binomial(1.2, 1.2 / COCO_GT_MEAN)))
    share = np.full(COCO_CLASSES, (1 - COCO_PERSON) / (COCO_CLASSES - 1)) * (1.0 / np.arange(1, COCO_CLASSES + 1))
    share[0] = 0.0
    share = share / share.sum() * (1 - COCO_PERSON)
    share[0] = COCO_PERSON
    labels = rng.choice(COCO_CLASSES, n_gt, p=share)
    kind = rng.choice(3, n_gt, p=COCO_AREA_SHARES)
    lo = np.array([4.0, 32.0**2, 96.0**2])[kind]
    hi = np.array([32.0**2, 96.0**2, 0.6 * COCO_W * COCO_H])[kind]
    fill = rng.uniform(0.5, 0.9, n_gt)  # an instance's area over its box's
    area = np.exp(rng.uniform(np.log(lo), np.log(hi))) / fill
    ratio = np.exp(rng.normal(0.0, 0.5, n_gt))
    w = np.minimum(np.sqrt(area * ratio), COCO_W - 1.0)
    h = np.minimum(area / w, COCO_H - 1.0)
    x, y = rng.uniform(0, COCO_W - w), rng.uniform(0, COCO_H - h)
    exact = rng.random() < COCO_EXACT_IMAGES
    if exact:  # integer boxes with even sides divisible by 4: halves and quarters stay integers
        w, h = np.maximum(4 * np.round(w / 4), 4), np.maximum(4 * np.round(h / 4), 4)
        x, y = np.round(np.minimum(x, COCO_W - w)), np.round(np.minimum(y, COCO_H - h))
    gt = np.stack([x, y, x + w, y + h], 1).astype(np.float32)
    crowd = (rng.random(n_gt) < COCO_CROWD).astype(np.int64)
    g_area = (w * h * fill).astype(np.float32)
    g_area[rng.random(n_gt) < COCO_AREA_ZERO] = 0.0

    # detections: jittered copies of the ground truths (IoU about 0.3-0.98), some of another class, and background
    n_copy = min(COCO_DETS, int(rng.integers(n_gt, 3 * n_gt + 1)) if n_gt else 0)
    src = rng.integers(0, max(n_gt, 1), n_copy)
    scale = rng.uniform(0.01, 0.35, n_copy)[:, None]
    wh = np.stack([w, h], 1)[src] if n_gt else np.zeros((0, 2))
    boxes = gt[src].astype(np.float64) + rng.normal(0.0, 1.0, (n_copy, 4)) * np.concatenate([wh, wh], 1) * scale
    d_labels = labels[src] if n_gt else np.zeros(0, np.int64)
    confused = rng.random(n_copy) < 0.1
    d_labels = np.where(confused, rng.integers(0, COCO_CLASSES, n_copy), d_labels)
    good = np.exp(-4.0 * scale[:, 0])
    if exact and n_copy:  # exactly 0.5 and 0.75 of the ground truth: the top half / three quarters of it
        pick = rng.random(n_copy) < 0.5
        frac = np.where(rng.random(n_copy) < 0.5, 0.5, 0.75)
        g = gt[src].astype(np.float64)
        cut = np.stack([g[:, 0], g[:, 1], g[:, 2], g[:, 1] + frac * (g[:, 3] - g[:, 1])], 1)
        boxes = np.where(pick[:, None], cut, boxes)
        d_labels = np.where(pick, labels[src], d_labels)
    n_bg = COCO_DETS - n_copy
    bw, bh = rng.uniform(8, 300, n_bg), rng.uniform(8, 300, n_bg)
    bx, by = rng.uniform(0, COCO_W - bw), rng.uniform(0, COCO_H - bh)
    boxes = np.concatenate([boxes, np.stack([bx, by, bx + bw, by + bh], 1)])
    d_labels = np.concatenate([d_labels, rng.choice(COCO_CLASSES, n_bg, p=share)]).astype(np.int64)
    score = 1.0 / (1.0 + np.exp(-(3.0 * np.concatenate([good, np.zeros(n_bg)]) - 1.5 + rng.normal(0, 1.0, COCO_DETS))))
    score = score.astype(np.float32)
    tie = rng.random(COCO_DETS) < 0.2
    score[tie] = np.round(score[tie] * 1024) / 1024  # scores that tie
    zero = rng.random(COCO_DETS) < 0.01
    score[zero] = np.where(rng.random(COCO_DETS) < 0.5, -0.0, 0.0).astype(np.float32)[zero]
    preds = {"boxes": boxes.astype(np.float32), "scores": score, "labels": d_labels}
    target = {"boxes": gt, "labels": labels.astype(np.int64), "iscrowd": crowd, "area": g_area}
    return preds, target


def coco_stream(n: int = None, seed: int = SEED) -> tuple:
    """The stream's first ``n`` images (all ``COCO_IMAGES``) from the seed: lists of per-image numpy dicts."""
    rng = np.random.default_rng([seed, 2017])
    pairs = [coco_image(rng, i) for i in range(COCO_IMAGES if n is None else n)]
    return [p for p, _ in pairs], [t for _, t in pairs]


def coco_flat(preds: list, target: list) -> dict:
    """The stream as flat numpy arrays with per-image counts (one transfer to the card)."""
    cat = np.concatenate
    return {
        "d_boxes": cat([p["boxes"] for p in preds]), "d_scores": cat([p["scores"] for p in preds]),
        "d_labels": cat([p["labels"] for p in preds]), "d_count": np.asarray([len(p["scores"]) for p in preds]),
        "g_boxes": cat([t["boxes"] for t in target]).reshape(-1, 4), "g_labels": cat([t["labels"] for t in target]),
        "g_crowd": cat([t["iscrowd"] for t in target]), "g_area": cat([t["area"] for t in target]),
        "g_count": np.asarray([len(t["labels"]) for t in target]),
    }


def coco_host_inputs(preds: list, target: list) -> tuple:
    """The numpy protocol's per-image tuples, boxes converted as the metric converts xyxy ones (float32 xywh, then
    float64 x + w)."""

    def xyxy(b):
        b = np.asarray(b, np.float32).reshape(-1, 4)
        x, y = b[:, 0].astype(np.float64), b[:, 1].astype(np.float64)
        w, h = (b[:, 2] - b[:, 0]).astype(np.float64), (b[:, 3] - b[:, 1]).astype(np.float64)
        return np.stack([x, y, x + w, y + h], 1)

    dets = [(xyxy(p["boxes"]), p["scores"], p["labels"]) for p in preds]
    gts = [(xyxy(t["boxes"]), t["labels"], t["iscrowd"], t["area"]) for t in target]
    return dets, gts


COCO_ORACLE_SPLIT = 4  # the macro oracle's classes but person, round-robin over this many workers


def coco_oracle(job: str, classes: tuple = None) -> dict:
    """The numpy protocol (the port's copy, pinned to the JAX package in the CPU tests) over the stream, in a worker
    process: ``macro`` over every image for the stream's classes among ``classes`` (every class when None), ``micro``
    over every image, ``unfused`` the per-cell reference over the first ``COCO_UNFUSED_IMAGES``. Returns the float64
    precision/recall arrays, their classes, the summary and the seconds taken. A class's entries of the arrays depend
    on that class's cells alone, so macro jobs over disjoint classes merge into the arrays of one call
    (``coco_oracle_merge``)."""
    from tpumetrics_torch.detection import _coco_eval
    from tpumetrics_torch.detection.mean_ap import _torch_f32_linspace

    t0 = time.perf_counter()
    n = COCO_UNFUSED_IMAGES if job == "unfused" else COCO_IMAGES
    dets, gts = coco_host_inputs(*coco_stream(n))
    class_ids = sorted(np.unique(np.concatenate([d[2] for d in dets] + [g[1] for g in gts])).tolist())
    if classes is not None:
        class_ids = [c for c in class_ids if c in classes]
    fn = _coco_eval.coco_evaluate_unfused if job == "unfused" else _coco_eval.coco_evaluate
    out = fn(dets, gts, _torch_f32_linspace(0.5, 0.95, 10), _torch_f32_linspace(0.0, 1.0, 101), [1, 10, 100],
             class_ids, average="micro" if job == "micro" else "macro", extended=True)
    out.pop("ious")
    out["class_ids"] = class_ids
    out["seconds"] = time.perf_counter() - t0
    return out


def coco_oracle_merge(parts: list) -> dict:
    """The macro jobs' arrays, class by class in the sorted order, and the numpy protocol's summary of them (its own
    ``_summarize``)."""
    from tpumetrics_torch.detection import _coco_eval
    from tpumetrics_torch.detection.mean_ap import _torch_f32_linspace

    slot = sorted((c, i, k) for i, part in enumerate(parts) for k, c in enumerate(part["class_ids"]))
    precision = np.stack([parts[i]["precision"][:, :, k] for _, i, k in slot], axis=2)
    recall = np.stack([parts[i]["recall"][:, k] for _, i, k in slot], axis=1)
    class_ids = [c for c, _, _ in slot]
    out = _coco_eval._summarize(precision, recall, np.asarray(_torch_f32_linspace(0.5, 0.95, 10)), class_ids,
                                class_ids, list(_coco_eval._AREA_RANGES), [1, 10, 100], {}, True)
    out.pop("ious")
    out["seconds"] = max(part["seconds"] for part in parts)
    return out


def coco_match_inputs(torch, n: int, dp: int, gp: int, seed: int, case: str = "mixed", device: str = "cuda",
                      areas: int = 4, thrs: int = 10) -> tuple:
    """``n`` cells of at most ``dp`` detections and ``gp`` ground truths (the first cell full) for
    ``coco_greedy_match``, flat and cell-sorted (the first ``areas`` of COCO's area ranges and ``thrs`` thresholds
    from 0.5 to 0.95, COCO's own at 4 and 10; at ``thrs`` 1 the threshold 0.5): integer boxes, so that
    IoUs tie and land exactly on 0.5 and 0.75 (detections cut to the top half or three quarters of a ground truth),
    exact copies, duplicated ground truths (IoU ties across g), crowds, areas in every range, a NaN box, garbage
    ground-truth rows between the cells that no cell reads, and the cell rows in a shuffled order. ``case``:
    ``mixed``, ``all_crowd``, ``all_ignored`` (every area past the ranges), ``ties`` (every ground truth of a cell
    one box), ``coco`` (COCO val2017's mix of cells: most without a ground truth, one detection most often; the
    second cell ``dp`` detections and no ground truth) or ``skewed`` (``n`` cells of one detection and at most one
    ground truth, and one of ``dp`` x ``gp``)."""
    from tpumetrics_torch.detection._coco_eval import _AREA_RANGES
    from tpumetrics_torch.detection.mean_ap import _torch_f32_linspace

    if case == "skewed":
        return coco_match_concat(torch, coco_match_inputs(torch, n, 1, 1, seed, "mixed", device, areas, thrs),
                                 coco_match_inputs(torch, 1, dp, gp, seed, "mixed", device, areas, thrs), seed)
    rng = np.random.default_rng([seed, dp, gp, n])
    det_count, gt_count = rng.integers(0, dp + 1, n), rng.integers(0, gp + 1, n)
    det_count[0], gt_count[0] = dp, gp
    if case == "coco":  # 86 % of the stream's cells hold no ground truth, 56 % one detection
        det_count = np.minimum(rng.geometric(0.56, n), dp)
        gt_count = np.where(rng.random(n) < 0.86, 0, np.minimum(rng.geometric(0.6, n), gp))
        det_count[:2], gt_count[:2] = dp, (gp, 0)
    gxy = rng.integers(0, 400, (n, gp, 2)).astype(np.float64)
    gwh = (4 * rng.integers(1, 40, (n, gp, 2))).astype(np.float64)
    gt = np.concatenate([gxy, gxy + gwh], -1)
    if case == "ties":
        gt[:] = gt[:, :1]
    dup = rng.random((n, gp)) < 0.2
    gt = np.where(dup[..., None], np.roll(gt, 1, axis=1), gt)
    base = np.take_along_axis(gt, rng.integers(0, gp, (n, dp))[..., None].repeat(4, -1), axis=1)
    det = base + rng.integers(-8, 9, (n, dp, 4))
    cut = base.copy()
    cut[..., 3] = base[..., 1] + np.where(rng.random((n, dp)) < 0.5, 0.5, 0.75) * (base[..., 3] - base[..., 1])
    det = np.where((rng.random((n, dp)) < 0.3)[..., None], cut, det)
    det = np.where((rng.random((n, dp)) < 0.1)[..., None], base, det)
    if n > 1 and dp > 1:
        det[1, 1, 0] = np.nan
    if n > 2 and gp > 1:
        gt[2, 1, 2] = np.nan
    crowd = rng.random((n, gp)) < 0.1
    area = np.where(rng.random((n, gp)) < 0.5, np.prod(gwh, -1) * rng.uniform(0.5, 0.9, (n, gp)),
                    rng.uniform(0, 20000, (n, gp)))
    if case == "all_crowd":
        crowd[:] = True
    if case == "all_ignored":
        area[:] = 2e10
    # flat: a cell's detections; its ground truths and one garbage ground-truth row after them
    junk = rng.uniform(-1e3, 1e3, (n, 1, 4))
    d_flat = np.concatenate([det[i, : det_count[i]] for i in range(n)]).reshape(-1, 4)
    g_flat = np.concatenate([x for i in range(n) for x in (gt[i, : gt_count[i]], junk[i])])
    crowd_flat = np.concatenate([x for i in range(n) for x in (crowd[i, : gt_count[i]], [True])])
    area_flat = np.concatenate([x for i in range(n) for x in (area[i, : gt_count[i]], [1.0])])
    d_start = np.concatenate([[0], np.cumsum(det_count)[:-1]])
    g_start = np.concatenate([[0], np.cumsum(gt_count + 1)[:-1]])
    cells = np.stack([d_start, det_count, g_start, gt_count], 1)[rng.permutation(n)]
    f64 = dict(dtype=torch.float64, device=device)
    thr = np.minimum(np.asarray(_torch_f32_linspace(0.5, 0.95, thrs) if thrs > 1 else [0.5]), 1 - 1e-10)
    return (
        torch.tensor(d_flat, **f64), torch.tensor(g_flat, **f64),
        torch.tensor(crowd_flat, dtype=torch.uint8, device=device), torch.tensor(area_flat, **f64),
        torch.tensor(cells, dtype=torch.int32, device=device), torch.tensor(thr, **f64),
        torch.tensor(list(_AREA_RANGES.values())[:areas], **f64),
    )


def coco_match_concat(torch, first: tuple, second: tuple, seed: int) -> tuple:
    """Two calls' inputs of ``coco_match_inputs`` as one: the second's rows after the first's, its cell rows
    shifted to them, all cell rows shuffled."""
    cells = torch.cat([first[4], second[4] + torch.tensor(
        [first[0].shape[0], 0, first[1].shape[0], 0], dtype=torch.int32, device=first[4].device)])
    order = torch.as_tensor(np.random.default_rng(seed).permutation(cells.shape[0]), device=cells.device)
    return (*(torch.cat([a, b]) for a, b in zip(first[:4], second[:4])), cells[order], first[5], first[6])


COCO_MATCH_CASES = [  # (label, cells, most detections, most ground truths in a cell, case, areas, thresholds)
    ("Gp=1", 257, 16, 1, "mixed", 4, 10), ("Gp=64", 300, 32, 64, "mixed", 4, 10),
    ("Gp=65", 200, 32, 65, "mixed", 4, 10), ("Gp=128", 100, 128, 128, "mixed", 4, 10),
    ("Dp=1", 513, 1, 8, "mixed", 4, 10), ("Dp=100", 150, 100, 16, "mixed", 4, 10),
    ("all-crowd", 100, 64, 16, "all_crowd", 4, 10), ("all-ignored", 100, 64, 16, "all_ignored", 4, 10),
    ("ties", 200, 64, 32, "ties", 4, 10), ("Gp=600", 8, 100, 600, "mixed", 4, 10),
    # the persistent design's limits: the COCO mix, the lanes' 32 and 64 ground truths, a 100 x 600 cell among
    # thousands of one-detection cells, more cells than the grid has warps, more detections than a warp stages,
    # and cells of at most 4 ground truths (walks below the heavy ones, taken last)
    ("coco-mix", 3000, 24, 12, "coco", 4, 10), ("Gp=32", 300, 32, 32, "mixed", 4, 10),
    ("Gp=33", 300, 32, 33, "mixed", 4, 10), ("skewed", 6000, 100, 600, "skewed", 4, 10),
    ("wrap", 20_000, 16, 8, "coco", 4, 10), ("Dp=200", 60, 200, 8, "coco", 4, 10),
    ("lane", 2000, 20, 4, "mixed", 4, 10), ("lane ties", 500, 16, 4, "ties", 4, 10),
    # other (area, threshold) pairs: one a lane and rows of 4, 1 and 2 bytes (4, 3 and 2 pairs), two a lane and
    # rows of 16-byte words (64 pairs), and past the warp path (80 and 160 pairs: the block path takes every cell)
    ("T=1", 2000, 20, 8, "coco", 4, 1), ("A=1 T=3", 2000, 20, 8, "mixed", 1, 3), ("A=2 T=1", 1000, 20, 8, "mixed", 2, 1),
    ("T=16", 1000, 32, 64, "mixed", 4, 16), ("T=20", 1000, 32, 64, "coco", 4, 20), ("T=40", 300, 32, 16, "mixed", 4, 40),
]


def coco_match_bound(args) -> dict:
    """Least time for one ``coco_greedy_match`` call on an H100 SXM: what this call's data needs read once (the
    boxes of the cells' detections, the boxes, crowds and effective areas of the cells' ground truths, the cell rows,
    the thresholds and ranges) and the two uint8 outputs written once, one (A, T) row for each detection, over the
    memory rate; against the float64 operations of the IoUs of the cells' (detection, ground truth) pairs (4
    max/min, 3 sub, 2 mul for the intersection, 2 add/sub for the union, a select, a division: 12) and the two
    boxes' areas (3 each), at the fp64 rate outside the tensor cores. The greedy walk's integer compares are not
    counted."""
    _, _, _, _, cells, thr, ranges = args
    nd, ng = cells[:, 1].long(), cells[:, 3].long()
    a, t = ranges.shape[0], thr.numel()
    dets, gts = int(nd.sum()), int(ng.sum())
    nbytes = dets * 32 + gts * (32 + 1 + 8) + 16 * cells.shape[0] + 8 * (t + 2 * a) + 2 * a * t * dets
    ops = 12 * int((nd * ng).sum()) + 3 * dets + 3 * gts
    bytes_ms, ops_ms = nbytes / H100_BYTES_PER_S * 1e3, ops / H100_FP64_OPS_PER_S * 1e3
    return {"cells": cells.shape[0], "detections": dets, "ground_truths": gts, "bytes": nbytes, "ops": ops,
            "bytes_ms": bytes_ms, "ops_ms": ops_ms, "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}


def coco_match_check(torch, cm, label: str, args, cpu: bool = True) -> int:
    """The kernel on the card, twice, against its plain version on the card and (``cpu``) on the CPU: bit for
    bit. Returns the largest absolute difference (0)."""
    m, ig = cm.coco_greedy_match(*args)
    m2, ig2 = cm.coco_greedy_match(*args)
    torch.cuda.synchronize()
    pm, pig = cm.coco_greedy_match_plain(*args)
    err = max(int((m.int() - pm.int()).abs().max()), int((ig.int() - pig.int()).abs().max())) if m.numel() else 0
    check(torch.equal(m, pm) and torch.equal(ig, pig), f"coco_greedy_match {label}: kernel != plain version (max {err})")
    check(torch.equal(m, m2) and torch.equal(ig, ig2), f"coco_greedy_match {label}: two calls differ")
    if cpu:
        cpu_m, cpu_ig = cm.coco_greedy_match(*(a.cpu() for a in args))
        check(torch.equal(m.cpu(), cpu_m) and torch.equal(ig.cpu(), cpu_ig), f"coco_greedy_match {label}: card != CPU")
    check(int(m.sum()) > 0 or label in ("all-ignored",), f"coco_greedy_match {label}: no match at all")
    return err


def iou_family_oracle(preds: list, target: list) -> dict:
    """Float64 numpy IoU, GIoU, DIoU and CIoU over per-image (detection, ground truth) pairs of the same label, the
    invalid entries left out, overall and per ground-truth class (the modular metrics' definition)."""

    def pair_values(d, g):
        d, g = d.astype(np.float64), g.astype(np.float64)
        area = lambda b: (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
        lt, rb = np.maximum(d[:, None, :2], g[None, :, :2]), np.minimum(d[:, None, 2:], g[None, :, 2:])
        wh = np.clip(rb - lt, 0, None)
        inter = wh[..., 0] * wh[..., 1]
        union = area(d)[:, None] + area(g)[None, :] - inter
        iou = inter / np.where(union > 0, union, 1.0)
        hlt, hrb = np.minimum(d[:, None, :2], g[None, :, :2]), np.maximum(d[:, None, 2:], g[None, :, 2:])
        hull = (hrb[..., 0] - hlt[..., 0]) * (hrb[..., 1] - hlt[..., 1])
        giou = iou - (hull - union) / np.where(hull > 0, hull, 1.0)
        c = ((d[:, None, :2] + d[:, None, 2:]) - (g[None, :, :2] + g[None, :, 2:])) / 2
        diag = (hrb[..., 0] - hlt[..., 0]) ** 2 + (hrb[..., 1] - hlt[..., 1]) ** 2
        diou = iou - (c[..., 0] ** 2 + c[..., 1] ** 2) / (diag + 1e-7)
        w1, h1 = (d[:, 2] - d[:, 0])[:, None], (d[:, 3] - d[:, 1])[:, None]
        w2, h2 = (g[:, 2] - g[:, 0])[None, :], (g[:, 3] - g[:, 1])[None, :]
        v = 4 / np.pi**2 * (np.arctan(w2 / (h2 + 1e-7)) - np.arctan(w1 / (h1 + 1e-7))) ** 2
        ciou = diou - v / (1 - iou + v + 1e-7) * v
        return {"iou": iou, "giou": giou, "diou": diou, "ciou": ciou}

    vals = {k: [] for k in ("iou", "giou", "diou", "ciou")}
    per_class = {k: {} for k in vals}
    for p, t in zip(preds, target):
        same = p["labels"][:, None] == t["labels"][None, :]
        for k, mat in pair_values(p["boxes"], t["boxes"]).items():
            vals[k].append(mat[same])
            for cl in np.unique(t["labels"]):
                per_class[k].setdefault(int(cl), []).append(mat[same & (t["labels"][None, :] == cl)])
    out = {}
    for k in vals:
        out[k] = float(np.concatenate(vals[k]).mean())
        for cl, parts in per_class[k].items():
            cat = np.concatenate(parts)
            out[f"{k}/cl_{cl}"] = float(cat.mean()) if cat.size else 0.0
    return out


def panoptic_batch(index: int) -> tuple:
    """A batch of COCO-panoptic-shaped maps (``PANOPTIC_BATCH`` x 480 x 640 x 2: category, instance) from the seed:
    a grid of stuff regions (53 categories) under 10-40 thing instances (80 categories) painted as rectangles, a
    share of the target's pixels void (category 255, unknown, so void); the prediction the target with its rectangles
    shifted, some things relabelled and some dropped."""
    rng = np.random.default_rng([SEED, 133, index])
    b, h, w = PANOPTIC_BATCH, COCO_H, COCO_W
    target = np.zeros((b, h, w, 2), np.int64)
    preds = np.zeros((b, h, w, 2), np.int64)
    stuffs = PANOPTIC_THINGS + np.arange(PANOPTIC_STUFFS)
    for i in range(b):
        gy, gx = int(rng.integers(2, 5)), int(rng.integers(2, 6))
        cells = rng.choice(stuffs, (gy, gx))
        stuff = np.repeat(np.repeat(cells, -(-h // gy), 0), -(-w // gx), 1)[:h, :w]
        pstuff = stuff.copy()
        pstuff[:, : int(rng.integers(0, 40))] = rng.choice(stuffs)
        target[i, ..., 0], preds[i, ..., 0] = stuff, pstuff
        for inst in range(1, int(rng.integers(10, 41)) + 1):
            cat = int(rng.integers(0, PANOPTIC_THINGS))
            bw, bh = int(rng.integers(8, 200)), int(rng.integers(8, 160))
            x, y = int(rng.integers(0, w - bw)), int(rng.integers(0, h - bh))
            target[i, y : y + bh, x : x + bw] = (cat, inst)
            if rng.random() < 0.1:
                continue  # missed
            dx, dy = rng.integers(-bw // 4 - 1, bw // 4 + 2), rng.integers(-bh // 4 - 1, bh // 4 + 2)
            px, py = int(np.clip(x + dx, 0, w - bw)), int(np.clip(y + dy, 0, h - bh))
            pcat = cat if rng.random() > 0.1 else int(rng.integers(0, PANOPTIC_THINGS))
            preds[i, py : py + bh, px : px + bw] = (pcat, inst)
        void = rng.random((h, w)) < 0.02
        target[i][void] = (255, 0)
    return preds, target


def panoptic_members(device) -> dict:
    from tpumetrics_torch.detection import ModifiedPanopticQuality, PanopticQuality

    things, stuffs = set(range(PANOPTIC_THINGS)), set(range(PANOPTIC_THINGS, PANOPTIC_THINGS + PANOPTIC_STUFFS))
    return {"pq": PanopticQuality(things, stuffs, device=device),
            "modified_pq": ModifiedPanopticQuality(things, stuffs, device=device)}


def panoptic_cpu_batch(index: int) -> dict:
    """Batch ``index`` of the panoptic stream on the port's CPU path, in a worker process: each member's states
    after that batch alone (its contribution: a state starts at zero, so the first add is exact)."""
    import torch

    torch.set_num_threads(1)
    members = panoptic_members("cpu")
    p, t = (torch.from_numpy(x) for x in panoptic_batch(index))
    for m in members.values():
        m.update(p, t)
    return {name: {k: getattr(m, k).numpy() for k in m._defaults} for name, m in members.items()}


def panoptic_cpu_start():
    """The panoptic stream's CPU path, a batch a job, in spawn workers at the lowest scheduling priority, started
    with the script beside the kernel phase (whose host work is one thread of launches), so that the detection
    phase finds it done. Beside the generative phase they slowed its host float64 KID and eigenvalues by some 6 s."""
    pool = multiprocessing.get_context("spawn").Pool(PANOPTIC_CPU_WORKERS, initializer=os.nice, initargs=(19,))
    return pool, [pool.apply_async(panoptic_cpu_batch, (i,)) for i in range(PANOPTIC_IMAGES // PANOPTIC_BATCH)]


def panoptic_cpu_states(cpu) -> tuple:
    """The CPU path's states over the whole panoptic stream: the batches' contributions added in the stream's
    order in float32, as ``update`` adds them; and the seconds waited for the workers."""
    pool, jobs = cpu
    t0 = time.perf_counter()
    parts = [job.get(timeout=600) for job in jobs]
    waited = time.perf_counter() - t0
    pool.close()
    pool.join()
    states = {}
    for name in parts[0]:
        states[name] = {}
        for key in parts[0][name]:
            total = np.zeros_like(parts[0][name][key])
            for part in parts:
                total = total + part[name][key]
            states[name][key] = total
    return states, waited


def detection_oracle_start():
    """The detection phase's host work in spawn workers, started just before the phase (the script starts them
    with the short perceptual phase) to run beside its main thread: the numpy protocol over the stream (macro
    split by class over 1 + ``COCO_ORACLE_SPLIT`` workers, person alone; micro; the per-cell reference over the
    first images), longest first."""
    pool = multiprocessing.get_context("spawn").Pool(6)
    jobs = {"micro": pool.apply_async(coco_oracle, ("micro",))}
    groups = [(0,)] + [tuple(range(1 + i, COCO_CLASSES, COCO_ORACLE_SPLIT)) for i in range(COCO_ORACLE_SPLIT)]
    for i, group in enumerate(groups):
        jobs[f"macro{i}"] = pool.apply_async(coco_oracle, ("macro", group))
    jobs["unfused"] = pool.apply_async(coco_oracle, ("unfused",))
    return pool, jobs


def coco_arrays_equal(got: dict, want: dict) -> bool:
    """Float64 precision and recall arrays bit for bit (the -1 of an empty cell included)."""
    return all(got[k].shape == want[k].shape and np.array_equal(got[k], want[k]) for k in ("precision", "recall"))


def coco_summary_mismatches(values: dict, want: dict, per_class: dict = None) -> list:
    """The summary keys whose float32 value differs in any bit from the oracle's (``per_class``: the oracle of the
    per-class entries, a macro one under micro averaging)."""
    bad = []
    for key in ("map", "map_50", "map_75", "map_small", "map_medium", "map_large", "mar_small", "mar_medium",
                "mar_large", "mar_1", "mar_10", "mar_100"):
        if np.float32(values[key].item()).tobytes() != np.float32(want[key]).tobytes():
            bad.append(key)
    if per_class is not None:
        for key, okey in (("map_per_class", "map_per_class"), ("mar_100_per_class", "mar_per_class")):
            if not np.array_equal(values[key].cpu().numpy().reshape(-1), np.asarray(per_class[okey]).reshape(-1)):
                bad.append(key)
    if not np.array_equal(values["classes"].cpu().numpy(), want["classes"]):
        bad.append("classes")
    return bad


def detection_kernel(torch, cm, label: str, stream_args: tuple, first_args: tuple) -> dict:
    """``coco_greedy_match`` on the card at the stream's one call (every cell of the macro evaluation), timed
    (events, L2 flushed) beside its plain version (one call, host clock) and its bound, and bit for bit against the
    plain version there; the cells of the first ``COCO_UNFUSED_IMAGES`` images and the edge shapes also against
    the plain version on the CPU."""
    flush = l2_flush(torch)
    bound = coco_match_bound(stream_args)
    ms, host_ms = cuda_ms(torch, lambda: cm.coco_greedy_match(*stream_args), 5, flush)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")  # the call reads nothing on the host below its ground-truth limit
    try:
        cm.coco_greedy_match(*stream_args)
        host_sync = False
    except RuntimeError:
        host_sync = True
    finally:
        torch.cuda.set_sync_debug_mode(0)
    check(not host_sync, f"{label}: coco_greedy_match synchronized with the host")
    # the cells in each of the sort's lists, as the kernel counted them in that call
    heavy, walks, ones, large = (int(v) for v in cm.last_cells_by_list.tolist())
    paths = {"none": bound["cells"] - heavy - walks - ones - large, "warp": heavy + walks + ones, "large": large,
             "warp_heavy": heavy, "warp_other": walks, "warp_one_gt": ones}
    grid = dict(cm.last_launch)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cm.coco_greedy_match_plain(*stream_args)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    max_err = coco_match_check(torch, cm, "the stream's cells", stream_args, cpu=False)
    max_err = max(max_err, coco_match_check(torch, cm, f"the first {COCO_UNFUSED_IMAGES} images' cells", first_args))
    for case_label, n, dp, gp, case, areas, thrs in COCO_MATCH_CASES:
        max_err = max(max_err, coco_match_check(
            torch, cm, case_label, coco_match_inputs(torch, n, dp, gp, SEED, case, areas=areas, thrs=thrs)))
    largest = cm_largest(stream_args)
    kernel = {"ms": ms, "host_ms": host_ms, "host_sync": host_sync, "plain_ms": plain_ms, **bound, "largest_cell": largest,
              "grid": grid, "paths": paths, "max_abs_err": max_err, "edge_cases": [c[0] for c in COCO_MATCH_CASES]}
    print(f"{label}: kernel over the stream's {bound['cells']} cells in one call {ms:.4f} ms ({ms / bound['bound_ms']:.2f}x"
          f" its bound {bound['bound_ms']:.4f} ms by {bound['bound_by']}: {bound['bytes']} bytes, {bound['ops']} fp64"
          f" operations), {host_ms:.4f} ms of host time to make the call ({'a' if host_sync else 'no'} host sync);"
          f" grids of {grid['sort_blocks']} (cell sort), {grid['row_blocks']} (default rows) and {grid['walk_blocks']}"
          f" (walks) blocks of {grid['threads']} threads, {grid['smem']} B of shared memory a walk block;"
          f" cells by path {paths}; plain version {plain_ms:.1f} ms; the largest cell {largest}", flush=True)
    return kernel


def cm_largest(args) -> list:
    """The most detections and the most ground truths of a ``coco_greedy_match`` call's cells."""
    return [int(v) for v in args[4][:, 1::2].amax(0).tolist()]


def detection_phase(torch, oracle, panoptic_cpu, device: str = "cuda") -> dict:
    """COCO val2017-size detection evaluation on the card (see the module note): list-of-dicts and packed (fused,
    replayed) streams, ``compute()`` times by stage, the card's float64 arrays and summaries bit for bit the numpy
    protocol's (worker processes beside the phase, ``detection_oracle_start``), the per-cell reference on the first
    images, a planted fault caught, the kernel at the stream's buckets and edge shapes against its plain version
    with its times and bound, and short IoU-family and panoptic streams (the panoptic stream's CPU path from
    ``panoptic_cpu_start``'s workers). ``device="cpu"`` rehearses it on the CPU
    (after patching the module's ``COCO_*`` and ``PANOPTIC_*`` sizes down), without the card-only parts: the
    guarded update, the kernel and its times."""
    from tpumetrics_torch import MetricCollection, interop
    from tpumetrics_torch.detection import (
        CompleteIntersectionOverUnion, DistanceIntersectionOverUnion, GeneralizedIntersectionOverUnion,
        IntersectionOverUnion, MeanAveragePrecision, pack_detection_batch,
    )
    from tpumetrics_torch.detection import _coco_eval_device as dev_eval
    from tpumetrics_torch.ops import coco_match as cm

    pool, jobs = oracle
    on_card = device == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize()
    label = f"detection COCO val2017 {COCO_IMAGES} images x {COCO_DETS} detections, {COCO_CLASSES} classes"
    t_phase = time.perf_counter()
    preds, target = coco_stream()
    flat = coco_flat(preds, target)
    n_gt = int(flat["g_count"].sum())
    print(f"{label}: {n_gt} ground truths ({n_gt / COCO_IMAGES:.2f} an image, at most {flat['g_count'].max()}),"
          f" {len(flat['d_scores'])} detections; made in {time.perf_counter() - t_phase:.1f} s", flush=True)
    on = {k: torch.as_tensor(v, device=device) for k, v in flat.items() if not k.endswith("count")}
    dc, gc = flat["d_count"].tolist(), flat["g_count"].tolist()
    d_views = {k: on[f"d_{k}"].split(dc) for k in ("boxes", "scores", "labels")}
    g_views = {k: on[f"g_{k}"].split(gc) for k in ("boxes", "labels", "crowd", "area")}
    preds_dev = [{k: d_views[k][i] for k in d_views} for i in range(COCO_IMAGES)]
    target_dev = [{"boxes": g_views["boxes"][i], "labels": g_views["labels"][i], "iscrowd": g_views["crowd"][i],
                   "area": g_views["area"][i]} for i in range(COCO_IMAGES)]
    sync()

    # ---- list-of-dicts, eager
    m_list = MeanAveragePrecision(device=device)
    update_ms = []
    for lo in range(0, COCO_IMAGES, COCO_BATCH):
        t0 = time.perf_counter()
        m_list.update(preds_dev[lo : lo + COCO_BATCH], target_dev[lo : lo + COCO_BATCH])
        sync()
        update_ms.append((time.perf_counter() - t0) * 1e3)
    launches, device_launches = {}, {}

    def timed_compute(metric, name):
        cm.launches = cm.device_launches = 0
        with dev_eval.record_stages() as stages:
            t0 = time.perf_counter()
            values = metric.compute()
            sync()
            total = time.perf_counter() - t0
        launches[name] = cm.launches
        device_launches[name] = cm.device_launches
        check(cm.launches >= 1 or not on_card, f"{label}: {name} compute() launched no coco_greedy_match")
        return values, {"total_ms": total * 1e3, **{k: v * 1e3 for k, v in stages.items()}}

    res_list, compute_list = timed_compute(m_list, "list compute")

    # ---- packed, into a fused collection with MaskedBuffer row states
    m_packed = MeanAveragePrecision(det_capacity=COCO_DET_CAPACITY, gt_capacity=COCO_GT_CAPACITY, device=device)
    interop.load_state(m_packed, m_packed.init_state())
    col = MetricCollection([m_packed], fused_update=True, device=device)
    t0 = time.perf_counter()
    packed = []
    for lo in range(0, COCO_IMAGES, COCO_BATCH):
        pd, gd = pack_detection_batch(preds[lo : lo + COCO_BATCH], target[lo : lo + COCO_BATCH],
                                      det_slots=COCO_DET_SLOTS, gt_slots=COCO_GT_SLOTS)
        packed.append(tuple({k: torch.as_tensor(v, device=device) for k, v in d.items()} for d in (pd, gd)))
    sync()
    pack_s = time.perf_counter() - t0
    packed_ms, guarded = [], None
    for i, (pd, gd) in enumerate(packed):
        step = col._fused_oo_step
        before = dict(step.counts) if step is not None else None
        t0 = time.perf_counter()
        if i == 10 and on_card:  # a steady update: its host syncs are errors
            torch.cuda.set_sync_debug_mode("error")
            try:
                col.update(pd, gd)
            finally:
                torch.cuda.set_sync_debug_mode(0)
            guarded = update_mode(col._fused_oo_step, before)
        else:
            col.update(pd, gd)
        sync()
        packed_ms.append((time.perf_counter() - t0) * 1e3)
    modes = dict(col._fused_oo_step.counts)
    check(guarded == "replayed" or not on_card, f"{label}: the guarded packed update was {guarded}, not a replay")
    check(modes["replayed"] >= len(packed) - 4 and modes["eager"] >= 2,
          f"{label}: packed updates ran {modes} (the last ragged batch eager, the rest replayed)")
    res_packed, compute_packed = timed_compute(m_packed, "packed compute")
    diff = [k for k in res_list if not torch.equal(res_list[k], res_packed[k])]
    check(not diff, f"{label}: list and packed results differ in {diff}")

    # ---- the card's float64 arrays, the kernel's call recorded for its timing
    det, gt, n_imgs, _, _ = m_list._gather_rows()
    rows = ((m_list._convert_boxes(det["boxes"]), det["scores"], det["labels"], det["img"]),
            (m_list._convert_boxes(gt["boxes"]), gt["labels"], gt["crowds"], gt["area"].double(), gt["img"]))
    classes = torch.unique(torch.cat([det["labels"], gt["labels"]])).tolist()
    match = dev_eval.coco_greedy_match
    calls = []

    def recording(*args):
        calls.append(args)
        return match(*args)

    def evaluate(rows, n_imgs, average="macro"):
        return dev_eval.coco_evaluate_rows(rows[0], rows[1], n_imgs, m_list.iou_thresholds, m_list.rec_thresholds,
                                           m_list.max_detection_thresholds, classes, average=average, arrays=True)

    dev_eval.coco_greedy_match = recording
    try:
        card = evaluate(rows, n_imgs)
    finally:
        dev_eval.coco_greedy_match = match

    def dropped(*args):  # the planted fault: the first match is lost
        m, ig = match(*args)
        if not dropped.done:
            first = torch.nonzero(m.reshape(-1))[0, 0]
            m.reshape(-1)[first] = 0
            dropped.done = True
        return m, ig

    dropped.done = False
    dev_eval.coco_greedy_match = dropped
    try:
        faulty = evaluate(rows, n_imgs)
    finally:
        dev_eval.coco_greedy_match = match
    first = ((rows[0][0][rows[0][3] < COCO_UNFUSED_IMAGES], rows[0][1][rows[0][3] < COCO_UNFUSED_IMAGES],
              rows[0][2][rows[0][3] < COCO_UNFUSED_IMAGES], rows[0][3][rows[0][3] < COCO_UNFUSED_IMAGES]),
             tuple(x[rows[1][4] < COCO_UNFUSED_IMAGES] for x in rows[1]))
    dev_eval.coco_greedy_match = recording
    try:
        card_first = evaluate(first, COCO_UNFUSED_IMAGES)
    finally:
        dev_eval.coco_greedy_match = match
    check(len(calls) == 2, f"{label}: {len(calls)} matcher calls in two evaluations")

    # ---- micro average with per-class values, once
    m_micro = MeanAveragePrecision(average="micro", class_metrics=True, device=device)
    m_micro.update(preds_dev, target_dev)
    res_micro, compute_micro = timed_compute(m_micro, "micro + class_metrics compute")

    kernel = detection_kernel(torch, cm, label, calls[0], calls[1]) if on_card else {}

    # ---- IoU family on the first images, against float64 oracles
    iou_members = {"iou": IntersectionOverUnion, "giou": GeneralizedIntersectionOverUnion,
                   "diou": DistanceIntersectionOverUnion, "ciou": CompleteIntersectionOverUnion}
    want_iou = iou_family_oracle(preds[:COCO_IOU_IMAGES], target[:COCO_IOU_IMAGES])
    iou_worst = 0.0
    t0 = time.perf_counter()
    for name, cls in iou_members.items():
        m = cls(class_metrics=True, respect_labels=True, device=device)
        m.update(preds_dev[:COCO_IOU_IMAGES], target_dev[:COCO_IOU_IMAGES])
        got = {k: float(v) for k, v in m.compute().items()}
        check(set(got) == {k for k in want_iou if k == name or k.startswith(f"{name}/")}, f"{label}: {name} keys")
        err = max(abs(got[k] - want_iou[k]) for k in got)
        check(err <= IOU_FAMILY_ATOL, f"{label}: {name} off its float64 oracle by {err:.3g} > {IOU_FAMILY_ATOL}")
        iou_worst = max(iou_worst, err)
    iou_s = time.perf_counter() - t0
    unlabelled = IntersectionOverUnion(respect_labels=False, device=device)
    unlabelled.update(preds_dev[:COCO_IOU_IMAGES], target_dev[:COCO_IOU_IMAGES])
    check(float(unlabelled.compute()["iou"]) < want_iou["iou"], f"{label}: respect_labels=False did not pool pairs")

    # ---- panoptic quality, card against the CPU path (``panoptic_cpu_start``'s workers)
    pq = panoptic_members(device)
    t0 = time.perf_counter()
    for index in range(PANOPTIC_IMAGES // PANOPTIC_BATCH):
        p, t = (torch.from_numpy(x).to(device) for x in panoptic_batch(index))
        for m in pq.values():
            m.update(p, t)
    sync()
    pq_s = time.perf_counter() - t0
    pq_values = {name: float(m.compute()) for name, m in pq.items()}
    main_s = time.perf_counter() - t_phase

    # ---- the host results
    t0 = time.perf_counter()
    want = {job: r.get(timeout=600) for job, r in jobs.items()}
    wait_s = time.perf_counter() - t0
    pool.close()
    pool.join()
    pq_cpu, pq_wait_s = panoptic_cpu_states(panoptic_cpu)
    want["macro"] = coco_oracle_merge([want.pop(job) for job in sorted(want) if job.startswith("macro")])
    check(coco_arrays_equal(card, want["macro"]), f"{label}: the card's precision/recall arrays != the numpy protocol's")
    check(not coco_arrays_equal(faulty, want["macro"]), f"{label}: a dropped match went unnoticed")
    check(coco_arrays_equal(card_first, want["unfused"]),
          f"{label}: the first {COCO_UNFUSED_IMAGES} images' arrays != coco_evaluate_unfused's")
    for name, values, oracle, per_class in (("list", res_list, want["macro"], None),
                                            ("packed", res_packed, want["macro"], None),
                                            ("micro", res_micro, want["micro"], want["macro"])):
        bad = coco_summary_mismatches(values, oracle, per_class)
        check(not bad, f"{label}: {name} summary differs from the numpy protocol in {bad}")
    for name, m in pq.items():
        card_states, cpu = {k: getattr(m, k).cpu().numpy() for k in m._defaults}, pq_cpu[name]
        for key in ("true_positives", "false_positives", "false_negatives"):
            check(np.array_equal(card_states[key], cpu[key]), f"{label}: {name} {key} card != CPU")
        got = card_states["iou_sum"]
        ulps = np.abs(got.view(np.int32).astype(np.int64) - cpu["iou_sum"].view(np.int32).astype(np.int64)).max()
        check(ulps <= 1, f"{label}: {name} iou_sum card != CPU by {ulps} float32 ulps")
    values = {k: float(res_list[k]) for k in ("map", "map_50", "map_75", "map_small", "map_medium", "map_large",
                                                "mar_1", "mar_10", "mar_100")}
    print(f"{label}: list updates median {np.median(update_ms):.2f} ms; packed updates median"
          f" {np.median(packed_ms[2:-1]):.2f} ms ({modes}); compute() list {compute_list}, packed {compute_packed},"
          f" micro {compute_micro}; numpy protocol {want['macro']['seconds']:.1f} s (macro), {want['micro']['seconds']:.1f}"
          f" s (micro), unfused {want['unfused']['seconds']:.1f} s over {COCO_UNFUSED_IMAGES} images; main thread"
          f" {main_s:.1f} s, waited {wait_s:.1f} s for the workers and {pq_wait_s:.1f} s more for the panoptic ones;"
          f" {values}; PQ {pq_values}", flush=True)
    return {
        "values": values, "pq": pq_values, "iou_worst": iou_worst, "iou_s": iou_s, "pq_s": pq_s,
        "update_ms_median": {"list": float(np.median(update_ms)), "packed": float(np.median(packed_ms[2:-1]))},
        "update_ms_all": {"list": update_ms, "packed": packed_ms}, "pack_s": pack_s, "modes": modes,
        "compute_ms": {"list": compute_list, "packed": compute_packed, "micro_class_metrics": compute_micro},
        "oracle_s": {job: want[job]["seconds"] for job in ("macro", "micro", "unfused")},
        "launches": launches, "device_launches": device_launches, "kernel": kernel, "main_s": main_s, "wait_s": wait_s, "pq_wait_s": pq_wait_s,
        "phase_s": time.perf_counter() - t_phase,
        "reduced": (f"none for mAP (the values are not COCO's, the times are); panoptic: {PANOPTIC_IMAGES} of"
                    f" val2017's 5,000 images, all held against the CPU path"),
    }


# ------------------------------------------------------------------ text (the perplexity stream and the string streams)

LLAMA3_VOCAB = 128_256  # vocab_size of Meta's published Llama-3-8B config.json
GPT2_VOCAB = 50_257
LLAMA2_VOCAB = 32_000
LM_BATCH, LM_SEQ = 8, 2048
WIKITEXT103_TEST_TOKENS = 245_569  # WikiText-103's test split (Merity et al. 2016)
LM_UPDATES = -(-WIKITEXT103_TEST_TOKENS // (LM_BATCH * LM_SEQ))  # 15, the last padded with -100
LM_SPREAD, LM_MARGIN = 2.0, (11.0, 2.0)  # logits N(0, 2); the target's logit N(11, 2): an NLL of about 3 nats
NLL_TOTAL_RTOL = 1e-6  # a kernel call's total and the stream's value against float64
GRAD_ATOL = 2e-6  # the backward's probabilities from the kernel's logsumexp against autograd's (both float32)
H100_SFU_EXP_PER_S = 132 * 16 * 1.98e9  # exponentials a second on the special-function units (16 an SM a clock)
TEXT_WORDS = 30_000  # the string streams' vocabulary, drawn Zipf-like
# each string stream at its dataset's size and the prefix run here (the rest cut: the streams are host Python, one
# thread in the main process and one in a worker; the prefixes keep the text phases' main thread near 15 s and the
# script near its 600 s). Host milliseconds an item on the host of an NVIDIA H100 80GB HBM3 (700 W) machine,
# from ``text_host_costs``:
TEXT_STREAMS = {
    "mt": (3_003, 120),  # WMT14 newstest2014 En-De: 21.7 ms a segment (TER 12.3, EED 6.7)
    "asr": (2_620, 150),  # LibriSpeech test-clean: 16.6 ms an utterance (CER 8.8, EditDistance 6.2)
    "squad": (10_570, 10_570),  # SQuAD v1.1 dev: 0.18 ms a question
    "cnndm": (11_490, 250),  # CNN/DailyMail test: 6.3 ms a summary (ROUGE-1/2/L/Lsum)
}
TEXT_BATCH = {"mt": 50, "asr": 100, "squad": 1_000, "cnndm": 100}


def lm_batch(torch, seed: int, b: int, s: int, v: int, dtype, device: str = "cuda", pad_from: int = None):
    """``(logits, target)``: ``(b, s, v)`` logits made on ``device`` from the seed, N(0, LM_SPREAD) with the
    target's logit set to a per-token margin N(LM_MARGIN), so that the NLL is a few nats and not log V;
    targets uniform over the vocabulary, and -100 (Hugging Face's label padding) from flat position
    ``pad_from`` on."""
    gen = torch.Generator(device=device).manual_seed(seed)
    target = torch.randint(0, v, (b, s), device=device, generator=gen)
    logits = torch.randn(b, s, v, device=device, generator=gen, dtype=dtype)
    logits.mul_(LM_SPREAD)
    margin = torch.randn(b, s, 1, device=device, generator=gen) * LM_MARGIN[1] + LM_MARGIN[0]
    logits.scatter_(2, target[..., None], margin.to(dtype))
    if pad_from is not None:
        flat = target.view(-1)
        flat[pad_from:] = -100
    return logits, target


class LMStream:
    """The WikiText-103 test split as ``LM_UPDATES`` batches of ``LM_BATCH`` x ``LM_SEQ`` bf16 logits at Llama 3's
    vocabulary, each made on the card from the seed when indexed (4.2 GB a batch: the stream is never held)."""

    def __init__(self, device: str = "cuda") -> None:
        self.device = device

    def __len__(self) -> int:
        return LM_UPDATES

    def __getitem__(self, i: int):
        if not 0 <= i < LM_UPDATES:
            raise IndexError(i)
        import torch

        last = WIKITEXT103_TEST_TOKENS - i * LM_BATCH * LM_SEQ
        pad = last if last < LM_BATCH * LM_SEQ else None
        return lm_batch(torch, SEED + 1000 + i, LM_BATCH, LM_SEQ, LLAMA3_VOCAB, torch.bfloat16, self.device, pad)


def nll_bound(b: int, s: int, v: int, dtype_bytes: int) -> dict:
    """Least time for ``token_nll_rows`` on an H100 SXM: the logits and int64 targets read once and the two
    float32 rows written (bytes), against the float32 operations (a max, a subtraction, an exponential and an
    addition an element) at 67 TFLOP/s; beside them the exponentials on the special-function units."""
    rows, elems = b * s, b * s * v
    nbytes = elems * dtype_bytes + rows * (8 + 4 + 4)
    ops = 4 * elems
    bytes_ms, ops_ms = nbytes / H100_BYTES_PER_S * 1e3, ops / H100_FP32_OPS_PER_S * 1e3
    return {"bound_ms": max(bytes_ms, ops_ms), "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "bytes": nbytes, "bytes_ms": bytes_ms, "ops_ms": ops_ms, "sfu_ms": elems / H100_SFU_EXP_PER_S * 1e3}


def peak_extra_bytes(torch, fn) -> int:
    """Device memory that ``fn()`` allocates above what is allocated before it (its inputs), at its peak."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    out = fn()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    del out
    return int(peak)


def nll_check(torch, tn, label: str, logits, target, ignore_index=None) -> dict:
    """The kernel's rows against the float64 reference beside the plain version's, row by row:
    ``row_error(kernel) <= 2 row_error(plain) + 1e-6`` and NaN where the plain version has NaN; the call's
    total within 1e-6 relative of float64 and its count the plain version's."""
    got, _ = tn.token_nll_rows(logits, target, ignore_index)
    torch.cuda.synchronize()
    plain, _ = tn.token_nll_rows_plain(logits, target, ignore_index)
    ref = tn.token_nll_reference(logits, target, ignore_index)
    err, err_plain = tn.row_error(got, ref), tn.row_error(plain, ref)
    check(torch.equal(got.isnan(), plain.isnan()), f"token_nll {label}: NaN rows differ from the plain version's")
    excess = (err - (tn.REL_SLACK * err_plain + tn.REL_FLOOR)).max()
    check(float(excess) <= 0.0, f"token_nll {label}: a row's error exceeds 2 x the plain version's + 1e-6 by {float(excess):.3e}")
    total, count = tn.token_nll(logits, target, ignore_index)
    _, plain_count = tn.token_nll_plain(logits, target, ignore_index)
    want = ref.sum()
    if bool(torch.isnan(want)):
        check(bool(torch.isnan(total)), f"token_nll {label}: total {float(total)} where float64 gives NaN")
        total_rel = 0.0
    else:
        total_rel = abs(float(total) - float(want)) / max(abs(float(want)), 1.0)
        check(total_rel <= NLL_TOTAL_RTOL, f"token_nll {label}: total {float(total)} vs float64 {float(want)} ({total_rel:.2e})")
    check(float(count) == float(plain_count), f"token_nll {label}: count {float(count)} vs {float(plain_count)}")
    fin = torch.isfinite(got) & torch.isfinite(plain)
    return {
        "rel": float(err.max()), "rel_plain": float(err_plain.max()), "total_rel": total_rel,
        "max_abs_err": float((got - plain).abs()[fin].max()) if bool(fin.any()) else 0.0,
        "nan_rows": int(got.isnan().sum()),
    }


def text_kernel_phase(torch, tn) -> dict:
    """``token_nll`` held to its contract beside its plain version on the same inputs, at the main path's shapes
    and the edge cases, with its time at the Llama 3 and GPT-2 shapes (events, L2 flushed) beside its bound, the
    plain version's and ``cross_entropy``'s, and each one's peak device memory above its inputs."""
    import torch.nn.functional as F

    t0 = time.perf_counter()
    ahead = l2_flush(torch)
    cases, timed = {}, {}
    shapes = [
        ("llama3 bf16", LM_BATCH, LM_SEQ, LLAMA3_VOCAB, torch.bfloat16, True),
        ("llama3 float32", LM_BATCH, LM_SEQ, LLAMA3_VOCAB, torch.float32, True),
        ("gpt2 bf16", LM_BATCH, 1024, GPT2_VOCAB, torch.bfloat16, True),
        ("llama2 bf16", LM_BATCH, LM_SEQ, LLAMA2_VOCAB, torch.bfloat16, False),
        ("V=1 fp16 ragged 3x5", 3, 5, 1, torch.float16, False),
        ("ragged fp16 7x13x4103", 7, 13, 4103, torch.float16, False),
    ]
    for label, b, s, v, dtype, time_it in shapes:
        logits, target = lm_batch(torch, SEED + v + b, b, s, v, dtype)
        cases[label] = nll_check(torch, tn, label, logits, target)
        if time_it:
            ms, host_ms = cuda_ms(torch, lambda: tn.token_nll_rows(logits, target), 10, ahead)
            call_ms, _ = cuda_ms(torch, lambda: tn.token_nll(logits, target, -100), 10, ahead)
            plain_ms, _ = cuda_ms(torch, lambda: tn.token_nll_plain(logits, target, -100), 5, ahead)
            flat, flat_t = logits.view(-1, v), target.view(-1)
            library_ms, _ = cuda_ms(
                torch, lambda: F.cross_entropy(flat, flat_t, reduction="sum", ignore_index=-100), 5, ahead)
            timed[label] = {
                "b": b, "s": s, "v": v, "dtype": str(dtype).replace("torch.", ""), "ms": ms, "host_ms": host_ms,
                "call_ms": call_ms, "plain_ms": plain_ms, "library_ms": library_ms,
                **nll_bound(b, s, v, logits.element_size()),
                "peak_extra_bytes": {
                    "kernel": peak_extra_bytes(torch, lambda: tn.token_nll(logits, target, -100)),
                    "plain": peak_extra_bytes(torch, lambda: tn.token_nll_plain(logits, target, -100)),
                    "library": peak_extra_bytes(
                        torch, lambda: F.cross_entropy(flat, flat_t, reduction="sum", ignore_index=-100)),
                },
                **{k: cases[label][k] for k in ("rel", "rel_plain")},
            }
            del flat, flat_t
        if label == "gpt2 bf16":
            shifted = logits[:, :-1]
            check(not shifted.is_contiguous(), "the shifted logits are a strided view")
            cases["gpt2 logits[:, :-1]"] = nll_check(torch, tn, "shifted", shifted, target[:, 1:])
            first = tn.token_nll(logits, target, -100)
            second = tn.token_nll(logits, target, -100)
            check(all(torch.equal(a, b_) for a, b_ in zip(first, second)), "token_nll: two calls differ")
            graph, stream = torch.cuda.CUDAGraph(), torch.cuda.Stream()
            stream.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(stream):
                tn.token_nll(logits, target, -100)
                torch.cuda.synchronize()
                with torch.cuda.graph(graph):
                    out = tn.token_nll(logits, target, -100)
            torch.cuda.current_stream().wait_stream(stream)
            for _ in range(3):
                graph.replay()
                torch.cuda.synchronize()
                check(all(torch.equal(a, b_) for a, b_ in zip(out, first)), "token_nll: a graph replay differs")
            del graph, out, shifted
        del logits, target
        torch.cuda.empty_cache()
    logits, target = lm_batch(torch, SEED + 7, 2, 64, LLAMA2_VOCAB, torch.bfloat16)
    cases["all ignored"] = nll_check(torch, tn, "all ignored", logits, torch.full_like(target, -100), -100)
    check(float(tn.token_nll(logits, torch.full_like(target, -100), -100)[1]) == 0.0, "all ignored: a count")
    small, _ = lm_batch(torch, SEED + 8, 1, 4, 5, torch.float32)
    for label, targets, ignore, nan in (("past V", [5, 0, 1, 2], None, True), ("wrapped", [-1, -5, 0, 4], None, False),
                                        ("-100 unignored", [-100, 1, 2, 3], None, True),
                                        ("-100 ignored", [-100, 1, 2, 3], -100, False)):
        t = torch.tensor([targets], device="cuda")
        cases[label] = nll_check(torch, tn, label, small, t, ignore)
        check(bool(torch.isnan(tn.token_nll(small, t, ignore)[0])) == nan, f"token_nll {label}: NaN as JAX gives")
    # the backward (plain torch ops from the saved logsumexp) against the plain version's autograd gradient
    x, y = logits.float().requires_grad_(True), logits.float().requires_grad_(True)
    masked = target.clone()
    masked[:, ::5] = -100
    tn.token_nll(x, masked, -100)[0].backward()
    tn.token_nll_plain(y, masked, -100)[0].backward()
    grad_err = float((x.grad - y.grad).abs().max())
    check(grad_err <= GRAD_ATOL, f"token_nll backward: {grad_err:.2e} from the plain version's autograd gradient")
    del x, y, logits, target
    torch.cuda.empty_cache()
    worst = max(c["rel"] - tn.REL_SLACK * c["rel_plain"] for c in cases.values())
    out = {"cases": cases, "timed": timed, "grad_err": grad_err, "worst_excess": worst,
           "max_abs_err": max(c["max_abs_err"] for c in cases.values()), "phase_s": time.perf_counter() - t0}
    for label, r in timed.items():
        print(f"token_nll {label} ({r['b']}x{r['s']}x{r['v']}): kernel {r['ms']:.4f} ms (host {r['host_ms']:.4f} ms; the"
              f" call with its sums {r['call_ms']:.4f} ms), bound {r['bound_ms']:.4f} ms ({r['bound_by']};"
              f" operations {r['ops_ms']:.4f} ms, exponentials on the SFUs {r['sfu_ms']:.4f} ms), {r['ms'] / r['bound_ms']:.2f}x;"
              f" plain {r['plain_ms']:.4f} ms, cross_entropy {r['library_ms']:.4f} ms; peak extra bytes {r['peak_extra_bytes']};"
              f" worst row error {r['rel']:.3e} (plain {r['rel_plain']:.3e})", flush=True)
    print(f"token_nll kernel phase: {len(cases)} cases held to row_error <= 2 x plain + 1e-6 and the totals within"
          f" 1e-6 of float64 (worst excess {worst:.3e}), two calls and three replays bit for bit, the backward within"
          f" {grad_err:.2e} of autograd's; {out['phase_s']:.1f} s", flush=True)
    return out


def lm_members(device) -> dict:
    from tpumetrics_torch.text import Perplexity

    return {"perplexity": Perplexity(ignore_index=-100, device=device)}


def perplexity_phase(torch, tn, device: str = "cuda") -> dict:
    """The WikiText-103 test split at Llama 3's vocabulary: 15 updates of 8 x 2,048 bf16 logits made on the card,
    the last padded with -100 so that exactly 245,569 tokens count; ``Perplexity(ignore_index=-100)`` unfused and
    in a fused collection in turns (states bit for bit, replays), its value against a float64 oracle built in
    chunks, the update time, the device union and the peak memory of an update against the plain path's. On the
    CPU (a rehearsal, with the ``LM_*`` sizes patched down) the card-only parts are left out."""
    from tpumetrics_torch import MetricCollection

    t0 = time.perf_counter()
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    stream = LMStream(device)
    tn.launches = 0  # the main path: the stream's updates
    metric = lm_members(device)["perplexity"]
    total64, count = 0.0, 0
    update_ms = []
    for i in range(LM_UPDATES):
        logits, target = stream[i]
        sync()
        t1 = time.perf_counter()
        metric.update(logits, target)
        sync()
        update_ms.append((time.perf_counter() - t1) * 1e3)
        ref = tn.token_nll_reference(logits, target, -100)
        total64 += float(ref.sum())
        count += int((target != -100).sum())
        del logits, target, ref
    stream_launches = tn.launches
    check(count == WIKITEXT103_TEST_TOKENS and float(metric.count) == count, f"perplexity: {float(metric.count)} tokens counted")
    value, oracle = float(metric.compute()), math.exp(total64 / count)
    rel = abs(value - oracle) / oracle
    check(rel <= NLL_TOTAL_RTOL, f"perplexity {value} vs float64 {oracle} ({rel:.2e})")
    check(2.0 < total64 / count < 5.0, f"perplexity: a mean NLL of {total64 / count:.3f} nats, not a few")
    check(stream_launches == (LM_UPDATES if device == "cuda" else 0),
          f"perplexity: {stream_launches} token_nll launches for {LM_UPDATES} updates")
    out = {"value": value, "oracle": oracle, "rel": rel, "mean_nll": total64 / count, "tokens": count,
           "update_ms": float(np.median(update_ms)), "update_ms_all": update_ms, "launches": stream_launches,
           "reduced": "none (the logits are made on the card from the seed: the times are a Llama 3 evaluation's, the"
                      " values not WikiText's)"}
    if device != "cuda":
        return out
    logits, target = stream[0]
    peak = {"kernel": peak_extra_bytes(torch, lambda: tn.token_nll(logits, target, -100)),
            "plain": peak_extra_bytes(torch, lambda: tn.token_nll_plain(logits, target, -100))}
    del logits, target
    torch.cuda.empty_cache()
    out["fused"] = fused_pair(torch, "WikiText-103 perplexity, Llama 3 vocabulary",
                              lambda f: MetricCollection(lm_members("cuda"), fused_update=f, device="cuda"), stream, rounds=5)
    out["peak_extra_bytes"], out["phase_s"] = peak, time.perf_counter() - t0
    print(f"perplexity phase: WikiText-103 test, {count} tokens in {LM_UPDATES} updates of {LM_BATCH}x{LM_SEQ}x{LLAMA3_VOCAB}"
          f" bf16: perplexity {value:.6f} vs float64 {oracle:.6f} ({rel:.2e}), mean NLL {total64 / count:.4f} nats;"
          f" unfused update median {out['update_ms']:.3f} ms; token_nll launches {stream_launches}; peak extra bytes of"
          f" an update {peak}; {out['phase_s']:.1f} s", flush=True)
    return out


def text_vocab(rng) -> tuple:
    """Up to ``TEXT_WORDS`` distinct lowercase words and the cumulative Zipf-like weights of a draw (exponent
    1.07); a word's length grows with the log of its rank (2 letters at the top, about 7 at rank 10,000), so that a
    drawn word has about 4.5 letters, as English and German running text do."""
    letters = np.array(list("abcdefghijklmnopqrstuvwxyzäöüß"))
    rank = np.arange(1, TEXT_WORDS + 1)
    lengths = np.clip(np.rint(1.9 + 1.35 * np.log10(rank) + rng.normal(0.0, 0.8, TEXT_WORDS)), 1, 14).astype(int)
    picks = letters[rng.integers(0, letters.size, (TEXT_WORDS, 14))]
    words = np.array(list(dict.fromkeys("".join(row[:n]) for row, n in zip(picks, lengths))))
    weights = 1.0 / np.arange(1, len(words) + 1) ** 1.07
    return words, np.cumsum(weights / weights.sum())


def draw_words(rng, vocab, n: int) -> list:
    words, cdf = vocab
    return [str(w) for w in words[np.minimum(np.searchsorted(cdf, rng.random(n)), len(words) - 1)]]


def noisy_copy(rng, vocab, words: list, keep: float, sub: float, ins: float, swap: float) -> list:
    """A system output from a reference: each word kept, substituted or dropped, words inserted, neighbours swapped."""
    out = []
    for w in words:
        r = rng.random()
        if r < keep:
            out.append(w)
        elif r < keep + sub:
            out.extend(draw_words(rng, vocab, 1))
        if rng.random() < ins:
            out.extend(draw_words(rng, vocab, 1))
    for i in range(len(out) - 1):
        if rng.random() < swap:
            out[i], out[i + 1] = out[i + 1], out[i]
    return out


def punctuate(rng, words: list) -> str:
    """Words into a sentence: a capital, commas after some words, a full stop."""
    if not words:
        return ""
    words = [w + "," if rng.random() < 0.06 else w for w in words]
    words[0] = words[0].capitalize()
    return " ".join(words) + "."


def text_stream(kind: str, n: int = None, seed: int = SEED) -> list:
    """The first ``n`` items of a string stream at its dataset's shape, made from the seed:

    - ``mt``: WMT14 newstest2014 En-De (3,003 segments, one reference; about 21 words a segment, gamma-spread),
      a system output of BLEU about 0.25: ``(hypothesis, [reference])``;
    - ``asr``: LibriSpeech test-clean (2,620 utterances, 52,576 words: about 20 a row, uppercase, no punctuation),
      hypotheses at a WER near 5 %: ``(hypothesis, reference)``;
    - ``squad``: SQuAD v1.1 dev (10,570 questions, up to 3 answers of about 3 words), a reader near 80 EM:
      ``(prediction dict, target dict)``;
    - ``cnndm``: CNN/DailyMail test (11,490 articles; highlights of 3-4 sentences, about 56 words, one a line),
      summaries near ROUGE-1 0.4: ``(summary, highlights)``."""
    total = TEXT_STREAMS[kind][0]
    n = total if n is None else min(n, total)
    rng = np.random.default_rng([seed, sum(map(ord, kind))])
    vocab = text_vocab(rng)
    items = []
    for i in range(n):
        if kind == "mt":
            ref = draw_words(rng, vocab, int(rng.gamma(3.0, 6.0)) + 3)
            hyp = noisy_copy(rng, vocab, ref, 0.62, 0.26, 0.06, 0.08)
            items.append((punctuate(rng, hyp), [punctuate(rng, ref)]))
        elif kind == "asr":
            ref = [w.upper() for w in draw_words(rng, vocab, int(rng.gamma(2.0, 10.0)) + 1)]
            hyp = [w.upper() for w in noisy_copy(rng, vocab, [w.lower() for w in ref], 0.96, 0.03, 0.01, 0.0)]
            items.append((" ".join(hyp), " ".join(ref)))
        elif kind == "squad":
            answers = [" ".join(draw_words(rng, vocab, int(rng.integers(1, 6)))) for _ in range(int(rng.integers(1, 4)))]
            r = rng.random()
            pred = answers[0] if r < 0.8 else (
                " ".join(answers[0].split()[:-1] + draw_words(rng, vocab, 1)) if r < 0.9 else " ".join(draw_words(rng, vocab, 3)))
            qid = f"{i:024x}"
            items.append(({"prediction_text": pred, "id": qid},
                          {"answers": {"answer_start": [0] * len(answers), "text": answers}, "id": qid}))
        else:
            sents = [draw_words(rng, vocab, int(rng.gamma(4.0, 3.5)) + 4) for _ in range(int(rng.integers(3, 5)))]
            summ = [noisy_copy(rng, vocab, s, 0.35, 0.4, 0.1, 0.05) for s in sents]
            items.append(("\n".join(punctuate(rng, s) for s in summ), "\n".join(punctuate(rng, s) for s in sents)))
    return items


def text_members(kind: str, device) -> dict:
    """Each string stream's collection: MT (BLEU, SacreBLEU 13a and intl where ``regex`` is installed, chrF, chrF++,
    TER, EED), ASR (WER, CER, MER, WIL, WIP, EditDistance), SQuAD, and ROUGE-1/2/L/Lsum."""
    from tpumetrics_torch import text
    from tpumetrics_torch.utils.imports import _REGEX_AVAILABLE

    if kind == "mt":
        members = {"bleu": text.BLEUScore(device=device), "sacrebleu": text.SacreBLEUScore(tokenize="13a", device=device),
                   "chrf": text.CHRFScore(n_word_order=0, device=device), "chrfpp": text.CHRFScore(device=device),
                   "ter": text.TranslationEditRate(device=device), "eed": text.ExtendedEditDistance(device=device)}
        if _REGEX_AVAILABLE:
            members["sacrebleu_intl"] = text.SacreBLEUScore(tokenize="intl", device=device)
        return members
    if kind == "asr":
        return {"wer": text.WordErrorRate(device=device), "cer": text.CharErrorRate(device=device),
                "mer": text.MatchErrorRate(device=device), "wil": text.WordInfoLost(device=device),
                "wip": text.WordInfoPreserved(device=device), "edit": text.EditDistance(device=device)}
    if kind == "squad":
        return {"squad": text.SQuAD(device=device)}
    return {"rouge": text.ROUGEScore(device=device)}


def text_batches(kind: str, items: list) -> list:
    size = TEXT_BATCH[kind]
    return [([p for p, _ in items[i : i + size]], [t for _, t in items[i : i + size]]) for i in range(0, len(items), size)]


def text_run(kind: str, device) -> tuple:
    """A string stream's collection on ``device`` over the stream's prefix: its states (numpy), its values
    (floats) and the seconds of its updates."""
    from tpumetrics_torch import MetricCollection
    from tpumetrics_torch.interop import export_state

    col = MetricCollection(text_members(kind, device), device=device)
    batches = text_batches(kind, text_stream(kind, TEXT_STREAMS[kind][1]))
    t0 = time.perf_counter()
    for preds, target in batches:
        col.update(preds, target)
    seconds = time.perf_counter() - t0
    values = {k: float(v) for k, v in flat_values(col.compute()).items()}
    groups = sorted(sorted(g) for g in col.compute_groups.values())
    return export_state(col), values, seconds, groups


def text_cpu_worker(kind: str) -> tuple:
    """The CPU path of one string stream, in a worker process."""
    import torch

    torch.set_num_threads(1)
    states, values, seconds, groups = text_run(kind, "cpu")
    return states, values, seconds


def text_cpu_start():
    """The string streams' CPU path in spawn workers at the lowest priority, started with the script beside the
    device-bound kernel phases, so that it is done long before the text phase: MT alone (TER's shift search is
    most of it), the other three in turn."""
    pool = multiprocessing.get_context("spawn").Pool(2, initializer=os.nice, initargs=(19,))
    return pool, {kind: pool.apply_async(text_cpu_worker, (kind,)) for kind in ("mt", "asr", "squad", "cnndm")}


def text_host_costs(kinds=("mt", "asr", "squad", "cnndm"), n: int = 40) -> dict:
    """Host milliseconds an item of each string stream's collection on the CPU (its first ``n`` items, after a
    warm batch): what sized the prefixes in ``TEXT_STREAMS``."""
    from tpumetrics_torch import MetricCollection

    costs = {}
    for kind in kinds:
        items = text_stream(kind, 2 * n)
        per_member = {}
        for name, metric in text_members(kind, "cpu").items():
            col = MetricCollection({name: metric}, device="cpu")
            col.update(*text_batches(kind, items[n:])[0])
            t0 = time.perf_counter()
            for preds, target in text_batches(kind, items[:n]):
                col.update(preds, target)
            per_member[name] = (time.perf_counter() - t0) * 1e3 / n
        costs[kind] = {"ms_per_item": sum(per_member.values()), "members": per_member}
    return costs


def text_phase(torch, cpu, device: str = "cuda") -> dict:
    """The string streams on the card, each held bit for bit against the port's CPU path (workers started earlier,
    ``text_cpu_start``); the values checked for their range (each stream's seeded quality)."""
    from tpumetrics_torch.functional.text.rouge import _punkt_available
    from tpumetrics_torch.utils.imports import _NLTK_AVAILABLE, _REGEX_AVAILABLE

    t0 = time.perf_counter()
    pool, jobs = cpu
    out = {}
    for kind in ("mt", "asr", "squad", "cnndm"):
        states, values, seconds, groups = text_run(kind, device)
        t1 = time.perf_counter()
        cpu_states, cpu_values, cpu_seconds = jobs[kind].get(timeout=600)
        waited = time.perf_counter() - t1
        check_identical_states(f"text {kind} card vs CPU", states, cpu_states)
        for key, value in cpu_values.items():  # the same states through float32 ops on each device
            check(abs(values[key] - value) <= 1e-6 * max(abs(value), 1.0), f"text {kind} {key}: card {values[key]} vs CPU {value}")
        full, ran = TEXT_STREAMS[kind]
        out[kind] = {"values": values, "update_s": seconds, "cpu_update_s": cpu_seconds, "wait_s": waited,
                     "items": ran, "groups": groups,
                     "reduced": "none" if ran >= full else f"the first {ran} of {full} (host time: one thread)"}
        print(f"text phase: {kind}: {ran} of {full} items in {-(-ran // TEXT_BATCH[kind])} updates on the {device} in"
              f" {seconds:.2f} s (the CPU path {cpu_seconds:.2f} s in a worker, waited {waited:.2f} s): states bit for bit"
              f" the CPU path's; groups {groups}; values {values}", flush=True)
    pool.close()
    pool.join()
    mt, asr, squad, cnndm = (out[k]["values"] for k in ("mt", "asr", "squad", "cnndm"))
    check(0.1 < mt["bleu"] < 0.5 and 0.1 < mt["ter"] < 0.8 and 0.2 < mt["chrf"] < 0.9, f"text mt values {mt}")
    check(0.01 < asr["wer"] < 0.15 and abs(asr["wil"] + asr["wip"] - 1.0) < 1e-6, f"text asr values {asr}")
    check(60.0 < squad["exact_match"] < 95.0 and squad["f1"] >= squad["exact_match"], f"text squad values {squad}")
    check(0.2 < cnndm["rouge1_fmeasure"] < 0.7, f"text cnndm values {cnndm}")
    out["intl"] = "run" if _REGEX_AVAILABLE else "skipped: the regex package is not installed"
    if not _REGEX_AVAILABLE:
        print("text phase: SacreBLEU's intl tokenizer skipped: the regex package is not installed", flush=True)
    out["host_packages"] = {"regex": _REGEX_AVAILABLE, "nltk": _NLTK_AVAILABLE, "punkt": _punkt_available()}
    print(f"text phase: host packages {out['host_packages']} (rougeLsum splits with punkt only where it is installed)",
          flush=True)
    out["phase_s"] = time.perf_counter() - t0
    return out


# ------------------------------------------------------------------ the encoder metrics: BERTScore, InfoLM, CLIP
# Random weights at the published widths, made on the card from the seed (no checkpoint is in the repository):
# RoBERTa-large (BERTScore's default), BERT-base-uncased with its MLM head (InfoLM's) and CLIP ViT-L/14.

BERT_BATCH = 64  # bert_score's default batch_size
BERT_ALL_LAYERS = (64, 25, 512, 512, 1024)  # all_layers: RoBERTa-large's 25 hidden states, 64 sentences of 512 tokens
BERT_F64_PAIRS = 64  # the MT pairs held against a float64 run of the encoder
BERT_F64_ATOL = 5e-6  # P, R, F1 against float64: 3.9e-7 measured, 2.2e-5 with the encoder in TF32 (tf32_encoders)
BERT_STREAM_ATOL = 1e-5  # stream-time against compute-time: the same encoder at other padded lengths
INFOLM_PAIRS = 96  # of newstest2014's 3,003: every token of a sentence masked in its own copy
INFOLM_F64_PAIRS = 8
INFOLM_F64_RTOL = 5e-5  # a sentence's KL / alpha-divergence against float64: 1.6e-6 / 5.0e-6 measured, 4.5e-4 / 4.2e-4 in TF32
CLIP_IMAGES = 1_000  # of COCO val2017's 5,000
CLIP_BATCH = 50
CLIP_CONTROL_IMAGES = 100  # the TF32 control's prefix (CLIPScore and CLIP-IQA), and CLIP-IQA's float64 prefix
CLIP_FAULT_IMAGES = 50  # the planted fault's prefix: its captions shifted by one image
CLIP_SHARED = 0.5  # the towers' shared direction, of a LayerNorm output's norm (clip_shared_direction)
CLIP_F64_ATOL = 3e-4  # CLIPScore (100 x a cosine) against float64, each image: 2.0e-5 measured, 6.9e-3 in TF32
IQA_F64_ATOL = 1e-5  # CLIP-IQA's probabilities against float64: 2.0e-6 measured, 1.5e-3 in TF32
CLIP_CAPTION_WORDS = (10.5, 2.4)  # COCO captions: about 10.5 words (mean, sd)
CLIP_MEAN, CLIP_STD = (0.48145466, 0.4578275, 0.40821073), (0.26862954, 0.26130258, 0.27577711)  # CLIPProcessor's


class HashTokenizer:
    """A tokenizer of the surface the metrics call (``tokenizer(sentences, padding=, truncation=, max_length=)`` to
    ``input_ids`` and ``attention_mask``): each lowercased word hashed (CRC-32) into ``[first, stop)`` of a model's
    vocabulary, between its begin and end tokens, the rows padded with ``pad``. It stands in for the models' BPE and
    WordPiece vocabularies, which are not in the repository: one id a word, at the vocabulary's width."""

    def __init__(self, first: int, stop: int, bos: int, eos: int, pad: int, mask: int = None, max_length: int = 512):
        self.first, self.stop, self.bos, self.eos, self.pad, self.max_length = first, stop, bos, eos, pad, max_length
        self.cls_token_id, self.sep_token_id, self.pad_token_id, self.mask_token_id = bos, eos, pad, mask

    def __call__(self, sentences, padding=True, truncation=True, max_length=None, **_):
        limit = min(max_length or self.max_length, self.max_length)
        rows = [[self.bos] + [self.first + zlib.crc32(w.lower().encode()) % (self.stop - self.first)
                              for w in s.split()][: limit - 2] + [self.eos] for s in sentences]
        width = max(len(r) for r in rows)
        ids = np.full((len(rows), width), self.pad, np.int64)
        mask = np.zeros((len(rows), width), np.int64)
        for i, r in enumerate(rows):
            ids[i, : len(r)] = r
            mask[i, : len(r)] = 1
        return {"input_ids": ids, "attention_mask": mask}


def roberta_tokenizer() -> HashTokenizer:
    """RoBERTa's specials: <s> 0, <pad> 1, </s> 2; words in 4..50,263 (50,264 is <mask>)."""
    return HashTokenizer(4, 50_264, 0, 2, 1, 50_264)


def bert_tokenizer() -> HashTokenizer:
    """BERT-base-uncased's specials: [PAD] 0, [CLS] 101, [SEP] 102, [MASK] 103; words in 1,000..30,521."""
    return HashTokenizer(1_000, 30_522, 101, 102, 0, 103)


class ClipHashProcessor(HashTokenizer):
    """CLIP's processor protocol (``processor(text=, images=, return_tensors="np", padding=True)``): captions hashed
    into 1..49,405 between <|startoftext|> 49,406 and <|endoftext|> 49,407 (also the pad, as CLIP's tokenizer pads),
    at most 77 positions; images (host copies, C x 224 x 224 in [0, 1]) normalized with CLIP's mean and std."""

    def __init__(self):
        super().__init__(1, 49_406, 49_406, 49_407, 49_407, max_length=77)

    def __call__(self, text=None, images=None, return_tensors="np", padding=True, **_):
        out = super().__call__(text) if text is not None else {}
        if images is not None:
            pix = np.stack([np.asarray(i, np.float32) for i in images])
            mean, std = np.asarray(CLIP_MEAN, np.float32)[:, None, None], np.asarray(CLIP_STD, np.float32)[:, None, None]
            out["pixel_values"] = (pix - mean) / std
        return out


def mt_pairs(n: int = None) -> tuple:
    """``(hypotheses, references)`` of the WMT14 newstest2014 En-De stream (``text_stream("mt")``)."""
    items = text_stream("mt", n)
    return [p for p, _ in items], [t[0] for _, t in items]


def tf32_encoders(torch):
    """The control of the encoder phases' float64 checks: a context inside which the port's BERT, RoBERTa and CLIP
    run their products in TF32, as an encoder would that lost its full-float32 guard (``_ieee_float32_matmul`` and
    ``_ieee_float32`` in ``text._bert_encoder`` and ``multimodal._clip``, swapped for guards that set TF32). Each
    phase holds a run under it to fail its float64 tolerance, so that the tolerance is shown to tell full float32
    from TF32."""
    import contextlib

    import tpumetrics_torch.multimodal._clip as clip_module
    import tpumetrics_torch.text._bert_encoder as bert_module

    @contextlib.contextmanager
    def tf32(*backends):
        saved = [b.fp32_precision for b in backends]
        for b in backends:
            b.fp32_precision = "tf32"
        try:
            yield
        finally:
            for b, value in zip(backends, saved):
                b.fp32_precision = value

    @contextlib.contextmanager
    def swapped():
        saved = (bert_module._ieee_float32_matmul, clip_module._ieee_float32_matmul, clip_module._ieee_float32)
        bert_module._ieee_float32_matmul = clip_module._ieee_float32_matmul = lambda: tf32(torch.backends.cuda.matmul)
        clip_module._ieee_float32 = lambda *backends: tf32(torch.backends.cudnn.conv)
        try:
            yield
        finally:
            bert_module._ieee_float32_matmul, clip_module._ieee_float32_matmul, clip_module._ieee_float32 = saved

    return swapped()


def bert_match_inputs(torch, n: int, layers: int, sp: int, st: int, dim: int, seed: int, case: str = "random",
                      device: str = "cuda") -> tuple:
    """``(pe, te, ps, ts)`` as ``bert_score`` gives them to the matcher: unit rows, zero at position 0 (the begin
    token, when a side has more than one position) and past each row's length (a quarter to all of its positions),
    positive scales on the real rows summing to 1. ``case``: ``"negative"`` makes every real pair's cosine negative
    (the maxima then come from the zero rows); ``"zero rows"`` zeroes the last third of the sentences, embeddings and
    scales (rows past a corpus's end)."""
    g = torch.Generator(device=device).manual_seed(seed)
    pe = torch.randn(n, layers, sp, dim, generator=g, device=device)
    te = torch.randn(n, layers, st, dim, generator=g, device=device)
    if case == "negative":
        base = torch.rand(n, layers, 1, dim, generator=g, device=device) + 0.5
        pe, te = base + 0.3 * pe.abs(), -(base + 0.3 * te.abs())
    pe, te = pe / pe.norm(dim=-1, keepdim=True), te / te.norm(dim=-1, keepdim=True)
    scales = []
    for emb, s in ((pe, sp), (te, st)):
        length = torch.randint(max(1, s // 4), s + 1, (n,), generator=g, device=device)
        real = torch.arange(s, device=device)[None] < length[:, None]
        if s > 1:
            real[:, 0] = False
        w = torch.rand(n, s, generator=g, device=device) * real
        emb.mul_(real[:, None, :, None])
        scales.append(w / w.sum(dim=1, keepdim=True).clamp(min=1e-30))
    ps, ts = scales
    if case == "zero rows":
        for t in (pe, te, ps, ts):
            t[2 * n // 3 :] = 0.0
    return pe, te, ps, ts


def bert_match_check(torch, bm, label: str, args) -> dict:
    """The kernel's contract at one case: two calls bit for bit, no NaN, and ``|kernel - ref| <= 2 |plain - ref| +
    1e-6`` for each cell and output against the float64 reference; the largest errors beside the plain version's."""
    got = bm.bert_greedy_match(*args)
    again = bm.bert_greedy_match(*args)
    torch.cuda.synchronize()
    check(all(same_bits(torch, a, b) for a, b in zip(got, again)), f"bert_greedy_match {label}: two calls differ")
    check(not any(bool(torch.isnan(x).any()) for x in got), f"bert_greedy_match {label}: NaN in the outputs")
    plain = bm.bert_greedy_match_plain(*args)
    ref = bm.bert_greedy_match_reference(*args)
    excess = float(bm.cell_excess(got, plain, ref))
    check(excess <= 0.0, f"bert_greedy_match {label}: a cell's error exceeds 2 x the plain version's + 1e-6 by {excess:.3e}")
    return {"excess": excess, "err": max(float((g.double() - r).abs().max()) for g, r in zip(got, ref)),
            "err_plain": max(float((p.double() - r).abs().max()) for p, r in zip(plain, ref)),
            "max_abs_err": max(float((g - p).abs().max()) for g, p in zip(got, plain))}


def bert_match_bound(n: int, layers: int, sp: int, st: int, dim: int) -> dict:
    """Least time for ``bert_greedy_match`` on an H100 SXM: ``pe`` and ``te`` read once, the scales read and the three
    outputs written (bytes), against the products' ``2 n L Sp St D`` float32 operations at 67 TFLOP/s on the CUDA
    cores (JAX's einsum is Precision.HIGHEST: no TF32 or bf16 tensor cores)."""
    nbytes = 4 * (n * layers * (sp + st) * dim + n * (sp + st) + 3 * n * layers)
    ops = 2 * n * layers * sp * st * dim
    bytes_ms, ops_ms = nbytes / H100_BYTES_PER_S * 1e3, ops / H100_FP32_OPS_PER_S * 1e3
    return {"bound_ms": max(bytes_ms, ops_ms), "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "bytes": nbytes, "bytes_ms": bytes_ms, "ops": ops, "ops_ms": ops_ms}


def bert_kernel_phase(torch, bm) -> dict:
    """``bert_greedy_match`` held to its contract beside its plain version on the same inputs, at the MT stream's
    call (3,003 pairs, RoBERTa-large's D = 1,024, L = 1, the stream's token counts), at ``all_layers`` (64 x 25 x
    512 x 512 x 1,024) and at edge cases (every real similarity negative in a 64 and a 128 tile, Sp != St past a
    tile, one token, rows of zero weight, D not a multiple of 4, two tiles' edges, token counts whose maxima spill
    past 48 KB of shared memory, a 128 tile over two layers: each of the kernel's three tiles); timed (events, L2 flushed) at the first two beside its bound, the plain version, the
    composite (the same torch ops in one pass: einsum, two amax, two weighted sums, TF32 off) and each one's peak
    memory."""
    t0 = time.perf_counter()
    preds, target = mt_pairs()
    tok = roberta_tokenizer()
    sp, st = tok(preds)["input_ids"].shape[1], tok(target)["input_ids"].shape[1]
    shapes = {"mt": (len(preds), 1, sp, st, 1024), "all_layers": BERT_ALL_LAYERS}
    edges = [("every real similarity negative", (8, 1, 9, 11, 1024), "negative"),
             ("Sp != St, 3 layers", (5, 3, 70, 130, 1024), "random"), ("one token", (4, 2, 1, 1, 64), "random"),
             ("rows of zero weight", (9, 1, 40, 33, 1024), "zero rows"), ("D = 100", (6, 2, 17, 29, 100), "random"),
             ("tile edges 64 / 65 / 128 tokens", (3, 1, 65, 128, 256), "random"),
             ("6,000 x 6,000 tokens (maxima past 48 KB)", (1, 1, 6000, 6000, 64), "random"),
             ("a 128 tile, every real similarity negative", (4, 1, 100, 96, 256), "negative"),
             ("a 128 tile, 256 x 250 tokens, 2 layers", (2, 2, 256, 250, 1024), "random"),
             ("D = 101 (4-byte loads)", (5, 1, 33, 47, 101), "random")]
    cases, timed = {}, {}
    for i, (label, shape, case) in enumerate([(k, v, "random") for k, v in shapes.items()] + edges):
        args = bert_match_inputs(torch, *shape, seed=SEED + 40 + i, case=case)
        cases[label] = {"shape": list(shape), **bert_match_check(torch, bm, label, args)}
        cases[label]["tile"] = bm.tile(shape[2], shape[3])
        if case == "negative":
            check(all(float(x.abs().max()) == 0.0 for x in bm.bert_greedy_match(*args)),
                  f"bert_greedy_match {label}: yet a maximum is not the zero rows' 0")
        if label in shapes:
            flush = l2_flush(torch)
            ms, host_ms = cuda_ms(torch, lambda: bm.bert_greedy_match(*args), 10, flush)
            plain_ms, _ = cuda_ms(torch, lambda: bm.bert_greedy_match_plain(*args), 3, flush)
            composite_ms, _ = cuda_ms(torch, lambda: bm._match(*args, shape[0]), 3, flush)
            timed[label] = {"shape": list(shape), "tile": cases[label]["tile"], "ms": ms, "host_ms": host_ms, "plain_ms": plain_ms,
                            "composite_ms": composite_ms, **bert_match_bound(*shape),
                            "peak_extra_bytes": {
                                "kernel": peak_extra_bytes(torch, lambda: bm.bert_greedy_match(*args)),
                                "plain": peak_extra_bytes(torch, lambda: bm.bert_greedy_match_plain(*args)),
                                "composite": peak_extra_bytes(torch, lambda: bm._match(*args, shape[0]))},
                            **{k: cases[label][k] for k in ("err", "err_plain")}}
            del flush
        del args
        torch.cuda.empty_cache()
    tiles = {c["tile"] for c in cases.values()}
    check(tiles == {64, 96, 128}, f"bert_greedy_match: the cases took the tiles {sorted(tiles)}, not all three")
    for label, r in timed.items():
        print(f"bert_greedy_match {label} {r['shape']} (tile {r['tile']}): kernel {r['ms']:.4f} ms (host {r['host_ms']:.4f} ms), bound"
              f" {r['bound_ms']:.4f} ms ({r['bound_by']}; bytes {r['bytes_ms']:.4f} ms, operations {r['ops_ms']:.4f} ms),"
              f" {r['ms'] / r['bound_ms']:.2f}x; plain {r['plain_ms']:.4f} ms, composite {r['composite_ms']:.4f} ms; peak"
              f" extra bytes {r['peak_extra_bytes']}; worst error {r['err']:.3e} (plain {r['err_plain']:.3e})", flush=True)
    out = {"cases": cases, "timed": timed, "max_abs_err": max(c["max_abs_err"] for c in cases.values()),
           "worst_excess": max(c["excess"] for c in cases.values()), "phase_s": time.perf_counter() - t0}
    print(f"bert kernel phase: {len(cases)} cases held to |kernel - ref| <= 2 |plain - ref| + 1e-6 (worst excess"
          f" {out['worst_excess']:.3e}), two calls bit for bit each; {out['phase_s']:.1f} s", flush=True)
    return out


def bertscore_float64(torch, bm, model64, tok, preds: list, target: list) -> tuple:
    """``(P, R, F1)`` of a float64 run of the encoder, idf off: its last hidden state normalized and masked in
    float64, scored by the float64 reference."""
    from tpumetrics_torch.functional.text.bert import _tokenize_padded, _weight_mask

    sides = []
    for sentences in (preds, target):
        batch = _tokenize_padded(tok, sentences, 512)
        ids, mask = (torch.as_tensor(batch[k], device="cuda") for k in ("input_ids", "attention_mask"))
        with torch.no_grad():
            h = model64(input_ids=ids, attention_mask=mask).last_hidden_state
        w = torch.as_tensor(_weight_mask(batch["attention_mask"]), device="cuda", dtype=torch.float64)
        h = h / h.norm(dim=-1, keepdim=True).clamp(min=1e-12) * w[..., None]
        sides.append((h[:, None], w / w.sum(dim=1, keepdim=True).clamp(min=1.0)))
    return bm.bert_greedy_match_reference(sides[0][0], sides[1][0], sides[0][1], sides[1][1])


def bertscore_phase(torch, bm) -> dict:
    """BERTScore over WMT14 newstest2014 En-De's 3,003 pairs on RoBERTa-large (random weights at its widths, from
    the seed), ``batch_size=64``: compute-time with idf off and on, and stream-time through a ``backbone=`` handle
    (the engine's bucket graphs), idf off; the matcher's launches counted on that main path. Held: the stream-time
    scores against the compute-time ones, the first 64 pairs against a float64 run of the encoder (and a planted
    fault, one target's words reversed, caught by the same check), and the stream-time call's scores against float64
    scoring of its own float32 embeddings (the kernel's contract over the whole stream)."""
    from tpumetrics_torch.backbones import get_backbone
    from tpumetrics_torch.functional.text import bert_score
    from tpumetrics_torch.text import BERTScore
    from tpumetrics_torch.text._bert_encoder import ROBERTA_LARGE, BertEncoder, build, random_bert_params

    t0 = time.perf_counter()
    preds, target = mt_pairs()
    tok = roberta_tokenizer()
    params = random_bert_params(ROBERTA_LARGE, SEED, device="cuda")
    encoder = build(ROBERTA_LARGE, params, device="cuda")
    batches = [(preds[i : i + BERT_BATCH], target[i : i + BERT_BATCH]) for i in range(0, len(preds), BERT_BATCH)]
    with torch.device("meta"):
        template = BertEncoder(ROBERTA_LARGE)

    def forward(p, ids, mask):
        return torch.func.functional_call(template, p, (ids, mask)).last_hidden_state

    handle = get_backbone("roberta-large", params, forward=forward, pad_axes=(0, 1), key=f"random-seed{SEED}", device="cuda")
    runs, seconds = {}, {}
    bm.launches = 0  # the main path: the three runs' compute()
    for name in ("compute-time", "compute-time idf", "stream-time"):
        if name == "stream-time":
            metric = BERTScore(backbone=handle, user_tokenizer=tok, batch_size=BERT_BATCH, device="cuda")
        else:
            metric = BERTScore(model=encoder, user_tokenizer=tok, idf=name.endswith("idf"), batch_size=BERT_BATCH,
                               device="cuda")
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        for p, t in batches:
            metric.update(p, t)
        t2 = time.perf_counter()
        runs[name] = metric.compute()
        torch.cuda.synchronize()
        seconds[name] = {"update_s": t2 - t1, "compute_s": time.perf_counter() - t2}
        if name == "stream-time":
            stream_emb = [metric._cat_streamed([p[i] for p in metric._streamed]) for i in (0, 1)]
            modes = {"graphs": handle.engine.compile_count, "dispatches": handle.engine.dispatch_count}
            metric.release_backbones()
    launches = bm.launches
    check(launches == 3, f"bertscore: {launches} bert_greedy_match launches on the main path, expected 3")
    values = {name: {k: v.cpu().numpy() for k, v in r.items()} for name, r in runs.items()}
    for name, v in values.items():
        for k, x in v.items():
            check(x.shape == (len(preds),) and bool(np.isfinite(x).all()) and 0.0 < x.min() and x.max() <= 1.0 + 1e-6,
                  f"bertscore {name} {k}: shape {x.shape}, range [{x.min()}, {x.max()}]")
    stream_diff = max(float(np.abs(values["stream-time"][k] - values["compute-time"][k]).max()) for k in ("precision", "recall", "f1"))
    check(stream_diff <= BERT_STREAM_ATOL, f"bertscore: stream-time differs from compute-time by {stream_diff:.3e}")
    idf_moved = float(np.abs(values["compute-time idf"]["f1"] - values["compute-time"]["f1"]).max())
    check(idf_moved > 1e-4, f"bertscore: idf moved no score ({idf_moved:.2e})")
    # the whole stream's scoring against float64 scoring of the same float32 embeddings
    (pe, ps), (te, ts) = stream_emb
    got = bm.bert_greedy_match(pe, te, ps, ts)
    check(all(np.array_equal(g[:, 0].cpu().numpy(), values["stream-time"][k]) for g, k in zip(got, ("precision", "recall", "f1"))),
          "bertscore: the stream-time scores are not the kernel's on its own embeddings")
    plain, ref = bm.bert_greedy_match_plain(pe, te, ps, ts), bm.bert_greedy_match_reference(pe, te, ps, ts)
    stream_excess = float(bm.cell_excess(got, plain, ref))
    check(stream_excess <= 0.0, f"bertscore: the stream's scoring exceeds its contract against float64 by {stream_excess:.3e}")
    del pe, te, ps, ts, got, plain, ref, stream_emb
    # the first pairs against a float64 run of the same encoder, and a planted fault the same check catches
    n64 = BERT_F64_PAIRS
    encoder64 = build(ROBERTA_LARGE, params, device="cuda", dtype=torch.float64)
    ref = [r[:, 0].cpu().numpy() for r in bertscore_float64(torch, bm, encoder64, tok, preds[:n64], target[:n64])]
    f64_err = max(float(np.abs(values["compute-time"][k][:n64] - r).max()) for k, r in zip(("precision", "recall", "f1"), ref))
    check(f64_err <= BERT_F64_ATOL, f"bertscore: the first {n64} pairs differ from float64 by {f64_err:.3e}")
    faulty = list(target[:n64])
    faulty[3] = " ".join(reversed(faulty[3].split()))
    fault = bert_score(preds[:n64], faulty, model=encoder, user_tokenizer=tok, device="cuda")
    fault_err = max(float(np.abs(fault[k].cpu().numpy() - r).max()) for k, r in zip(("precision", "recall", "f1"), ref))
    check(fault_err > BERT_F64_ATOL, f"bertscore: the planted fault (a reversed target) moved no score past the tolerance"
          f" ({fault_err:.3e})")
    with tf32_encoders(torch):
        control = bert_score(preds[:n64], target[:n64], model=encoder, user_tokenizer=tok, device="cuda")
    control_err = max(float(np.abs(control[k].cpu().numpy() - r).max()) for k, r in zip(("precision", "recall", "f1"), ref))
    check(control_err > BERT_F64_ATOL, f"bertscore: the encoder in TF32 ({control_err:.3e} from float64) passes the"
          f" float64 tolerance {BERT_F64_ATOL:g}")
    del encoder64, encoder, template
    handle.close()
    torch.cuda.empty_cache()
    out = {"pairs": len(preds), "launches": {"bertscore": launches}, "seconds": seconds, "stream_diff": stream_diff,
           "idf_moved": idf_moved, "stream_excess": stream_excess, "f64_err": f64_err, "f64_pairs": n64,
           "fault_err": fault_err, "tf32_control_err": control_err, "f64_atol": BERT_F64_ATOL, "engine": modes,
           "means": {name: {k: float(x.mean()) for k, x in v.items()} for name, v in values.items()},
           "reduced": "none (3,003 pairs; random RoBERTa-large weights at its widths, hashed word ids: the times are"
                      " RoBERTa-large's, the values not BERTScore's)", "phase_s": time.perf_counter() - t0}
    print(f"bertscore phase: {len(preds)} WMT14 newstest2014 pairs on RoBERTa-large (random weights), batch 64: seconds"
          f" {seconds}; F1 means {({n: round(m['f1'], 4) for n, m in out['means'].items()})}; stream-time vs compute-time"
          f" {stream_diff:.2e}; idf moved F1 by up to {idf_moved:.3f}; the stream's scoring against float64 of its"
          f" embeddings: worst excess {stream_excess:.3e}; first {n64} pairs against a float64 encoder {f64_err:.2e}"
          f" (tolerance {BERT_F64_ATOL:g}; the planted fault {fault_err:.3f}; the encoder in TF32 {control_err:.3e});"
          f" engine {modes}; bert_greedy_match"
          f" launches {launches}; {out['phase_s']:.1f} s", flush=True)
    return out


def infolm_phase(torch) -> dict:
    """InfoLM on BERT-base-uncased's masked LM (random weights at its widths, from the seed) over the first
    ``INFOLM_PAIRS`` newstest2014 pairs: KL with idf at temperature 0.25, run twice with the same bits, and the
    alpha-divergence (alpha 0.5); the first ``INFOLM_F64_PAIRS`` held against a float64 run of the same model."""
    from tpumetrics_torch.functional.text import infolm
    from tpumetrics_torch.text import InfoLM
    from tpumetrics_torch.text._bert_encoder import BERT_BASE_UNCASED, build, random_bert_params

    t0 = time.perf_counter()
    preds, target = mt_pairs(INFOLM_PAIRS)
    tok = bert_tokenizer()
    params = random_bert_params(BERT_BASE_UNCASED, SEED + 1, mlm=True, device="cuda")
    mlm = build(BERT_BASE_UNCASED, params, mlm=True, device="cuda")
    runs, seconds = {}, {}
    for name, kw in (("kl", {}), ("kl again", {}), ("alpha", {"information_measure": "alpha_divergence", "alpha": 0.5})):
        metric = InfoLM(model=mlm, user_tokenizer=tok, idf=True, temperature=0.25, return_sentence_level_score=True,
                        device="cuda", **kw)
        for i in range(0, len(preds), 32):
            metric.update(preds[i : i + 32], target[i : i + 32])
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        runs[name] = metric.compute()
        torch.cuda.synchronize()
        seconds[name] = time.perf_counter() - t1
    check(all(same_bits(torch, a, b) for a, b in zip(runs["kl"], runs["kl again"])), "infolm: two runs differ")
    for name, (mean, scores) in runs.items():
        check(scores.shape == (len(preds),) and bool(torch.isfinite(scores).all()), f"infolm {name}: {scores}")
    n64 = INFOLM_F64_PAIRS
    mlm64 = build(BERT_BASE_UNCASED, params, mlm=True, device="cuda", dtype=torch.float64)
    worst, controls = {}, {}
    for name, kw in (("kl", {}), ("alpha", {"information_measure": "alpha_divergence", "alpha": 0.5})):
        args = dict(user_tokenizer=tok, idf=True, temperature=0.25, return_sentence_level_score=True, device="cuda", **kw)
        got = infolm(preds[:n64], target[:n64], model=mlm, **args)[1].double()
        want = infolm(preds[:n64], target[:n64], model=mlm64, **args)[1]
        check(want.dtype == torch.float64, "infolm: the float64 run is not float64")
        worst[name] = float(((got - want).abs() / want.abs().clamp(min=1e-3)).max())
        check(worst[name] <= INFOLM_F64_RTOL, f"infolm {name}: {worst[name]:.3e} from float64")
        with tf32_encoders(torch):
            control = infolm(preds[:n64], target[:n64], model=mlm, **args)[1].double()
        controls[name] = float(((control - want).abs() / want.abs().clamp(min=1e-3)).max())
        check(controls[name] > INFOLM_F64_RTOL, f"infolm {name}: the MLM in TF32 ({controls[name]:.3e} from float64)"
              f" passes the float64 tolerance {INFOLM_F64_RTOL:g}")
    del mlm, mlm64
    torch.cuda.empty_cache()
    out = {"pairs": len(preds), "means": {name: float(r[0]) for name, r in runs.items()}, "seconds": seconds,
           "f64_rel": worst, "tf32_control_rel": controls, "f64_rtol": INFOLM_F64_RTOL, "f64_pairs": n64,
           "phase_s": time.perf_counter() - t0,
           "reduced": f"the first {len(preds)} of newstest2014's 3,003 pairs (each sentence's tokens masked one a copy:"
                      f" some 21 BERT-base forwards a sentence); random weights, hashed word ids"}
    print(f"infolm phase: {len(preds)} newstest2014 pairs on BERT-base-uncased's MLM (random weights): KL {out['means']['kl']:.4f}"
          f" (twice, bit for bit), alpha-divergence {out['means']['alpha']:.4f}; compute seconds {seconds}; the first {n64}"
          f" pairs against float64: {worst} (tolerance {INFOLM_F64_RTOL:g}; the MLM in TF32 {controls}); {out['phase_s']:.1f} s",
          flush=True)
    return out


def coco_caption_stream(torch, n: int, seed: int = SEED) -> tuple:
    """``(images, captions)``: ``n`` 224 x 224 RGB images in [0, 1] made on the card from the seed (smooth fields:
    16 x 16 noise upsampled bicubically, plus fine noise) and one caption each of about 10.5 words (COCO's), drawn
    from the string streams' Zipf vocabulary."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    coarse = torch.rand(n, 3, 16, 16, generator=g, device="cuda")
    images = torch.nn.functional.interpolate(coarse, size=(224, 224), mode="bicubic", align_corners=False)
    images = (images + 0.05 * torch.randn(images.shape, generator=g, device="cuda")).clamp(0.0, 1.0)
    rng = np.random.default_rng([seed, 2017])
    vocab = text_vocab(rng)
    lengths = np.clip(np.rint(rng.normal(*CLIP_CAPTION_WORDS, n)), 5, 25).astype(int)
    return images, [punctuate(rng, draw_words(rng, vocab, int(k))) for k in lengths]


def clip_shared_direction(torch, params: dict, seed: int) -> dict:
    """Random CLIP weights whose towers share a direction: the last LayerNorms' biases (the vision tower's
    ``post_norm``, the text tower's ``final_norm``) set so that both projections map them onto one random unit
    vector of the joint space, with a norm of ``CLIP_SHARED`` x a LayerNorm output's (the square root of the width).
    With N(0, 0.02) weights alone an image's and a caption's features are near orthogonal (CLIPScore's mean over this
    stream is then -2.5, which its floor at 0 reads as 0 whatever the scores); with the shared part each pair's
    cosine is positive, and the towers' own parts still set each pair's score apart."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    joint = params["text_projection.weight"].shape[0]
    u = torch.randn(joint, generator=g, device="cuda")
    u = u / u.norm()
    out = dict(params)
    for norm, proj in (("vision.post_norm.bias", "visual_projection.weight"), ("text.final_norm.bias", "text_projection.weight")):
        bias = params[proj].T @ u
        out[norm] = bias * (CLIP_SHARED * math.sqrt(bias.numel()) / bias.norm())
    return out


def clip_phase(torch) -> dict:
    """CLIPScore over an MS-COCO val2017-shaped caption stream (``CLIP_IMAGES`` images with a caption each, in
    batches of 50) on CLIP ViT-L/14 (random weights at its widths, from the seed, the towers sharing a direction:
    ``clip_shared_direction``), then CLIP-IQA on the same images with ("quality", "sharpness") and one custom pair.
    Held against a float64 run of the same model: every image's score of the stream (recorded from the metric's
    own updates; their float32 sum is the metric's state bit for bit) and the first ``CLIP_CONTROL_IMAGES`` images'
    probabilities. A planted fault (the first ``CLIP_FAULT_IMAGES`` captions shifted by one image) and the TF32
    control (``tf32_encoders``) on the first ``CLIP_CONTROL_IMAGES`` must fail the same checks."""
    import tpumetrics_torch.multimodal.clip_score as clip_score_module
    from tpumetrics_torch.functional.multimodal.clip_iqa import clip_image_quality_assessment
    from tpumetrics_torch.functional.multimodal.clip_score import _clip_score_update
    from tpumetrics_torch.multimodal import CLIPImageQualityAssessment, CLIPScore
    from tpumetrics_torch.multimodal._clip import CLIP_VIT_L_14, build_clip, random_clip_params

    t0 = time.perf_counter()
    images, captions = coco_caption_stream(torch, CLIP_IMAGES)
    proc = ClipHashProcessor()
    params = clip_shared_direction(torch, random_clip_params(CLIP_VIT_L_14, SEED + 2, device="cuda"), SEED + 3)
    model = build_clip(CLIP_VIT_L_14, params, device="cuda")
    prompts = ("quality", "sharpness", ("Crisp photo.", "Smudged photo."))
    score = CLIPScore((model, proc), device="cuda")
    iqa = CLIPImageQualityAssessment((model, proc), prompts=prompts, device="cuda")
    recorded = []  # each update's per-image scores, as the metric made them

    def recording(*args):
        out = _clip_score_update(*args)
        recorded.append(out[0])
        return out

    seconds = {}
    clip_score_module._clip_score_update = recording
    try:
        for name, metric, update in (("clip_score", score, lambda m, i: m.update(images[i : i + CLIP_BATCH], captions[i : i + CLIP_BATCH])),
                                     ("clip_iqa", iqa, lambda m, i: m.update(images[i : i + CLIP_BATCH]))):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            for i in range(0, CLIP_IMAGES, CLIP_BATCH):
                update(metric, i)
            torch.cuda.synchronize()
            seconds[name] = time.perf_counter() - t1
    finally:
        clip_score_module._clip_score_update = _clip_score_update
    value, probs = float(score.compute()), {k: float(v) for k, v in iqa.compute().items()}
    per_image = torch.cat(recorded)
    state = torch.zeros((), device="cuda")
    for batch in recorded:
        state = state + batch.sum()
    check(same_bits(torch, state, score.score), "clip_score: the recorded scores do not sum to the metric's state")
    raw_mean = float(score.score / score.n_samples)
    check(math.isfinite(value) and raw_mean > 0.0 and value == raw_mean and float(score.n_samples) == CLIP_IMAGES,
          f"clip_score {value} (mean before the floor at 0: {raw_mean})")
    check(all(0.0 <= p <= 1.0 for p in probs.values()) and len(probs) == 3, f"clip_iqa {probs}")
    model64 = build_clip(CLIP_VIT_L_14, params, device="cuda", dtype=torch.float64)
    t1 = time.perf_counter()
    s64 = torch.cat([_clip_score_update(images[i : i + CLIP_BATCH], captions[i : i + CLIP_BATCH], model64, proc)[0]
                     for i in range(0, CLIP_IMAGES, CLIP_BATCH)])
    seconds["clip_score float64"] = time.perf_counter() - t1
    check(s64.dtype == torch.float64 and per_image.shape == s64.shape, "clip: the float64 run is not float64, or short")
    score_err = float((per_image.double() - s64).abs().max())
    check(score_err <= CLIP_F64_ATOL, f"clip_score: {score_err:.3e} from float64 over the stream's {CLIP_IMAGES} images")
    nf = CLIP_FAULT_IMAGES
    shifted = captions[1:nf] + captions[:1]
    fault = _clip_score_update(images[:nf], shifted, model, proc)[0]
    fault_err = float((fault.double() - s64[:nf]).abs().max())
    check(fault_err > CLIP_F64_ATOL, f"clip_score: the planted fault (captions shifted by one image) moved no score past"
          f" the tolerance ({fault_err:.3e})")
    nc = CLIP_CONTROL_IMAGES
    with tf32_encoders(torch):
        control = torch.cat([_clip_score_update(images[i : i + CLIP_BATCH], captions[i : i + CLIP_BATCH], model, proc)[0]
                             for i in range(0, nc, CLIP_BATCH)])
        p_control = clip_image_quality_assessment(images[:nc], (model, proc), prompts=prompts)
    control_err = float((control.double() - s64[:nc]).abs().max())
    check(control_err > CLIP_F64_ATOL, f"clip_score: the model in TF32 ({control_err:.3e} from float64) passes the float64"
          f" tolerance {CLIP_F64_ATOL:g}")
    p32 = clip_image_quality_assessment(images[:nc], (model, proc), prompts=prompts)
    p64 = clip_image_quality_assessment(images[:nc], (model64, proc), prompts=prompts)
    iqa_err = max(float((p32[k].double() - p64[k]).abs().max()) for k in p32)
    check(iqa_err <= IQA_F64_ATOL, f"clip_iqa: {iqa_err:.3e} from float64 over the first {nc} images")
    iqa_control_err = max(float((p_control[k].double() - p64[k]).abs().max()) for k in p32)
    check(iqa_control_err > IQA_F64_ATOL, f"clip_iqa: the model in TF32 ({iqa_control_err:.3e} from float64) passes the"
          f" float64 tolerance {IQA_F64_ATOL:g}")
    spread = {"min": float(per_image.min()), "max": float(per_image.max()), "std": float(per_image.std())}
    del model, model64, images
    torch.cuda.empty_cache()
    out = {"images": CLIP_IMAGES, "clip_score": value, "clip_score_spread": spread, "clip_iqa": probs, "seconds": seconds,
           "score_f64_err": score_err, "score_f64_atol": CLIP_F64_ATOL, "fault_err": fault_err,
           "tf32_control_err": control_err, "iqa_f64_err": iqa_err, "iqa_f64_atol": IQA_F64_ATOL,
           "iqa_tf32_control_err": iqa_control_err, "iqa_f64_images": nc, "phase_s": time.perf_counter() - t0,
           "reduced": f"{CLIP_IMAGES} of COCO val2017's 5,000 images (the processor's host round trip sets the time);"
                      " random CLIP ViT-L/14 weights sharing a direction between the towers, hashed caption ids,"
                      " images made from the seed"}
    print(f"clip phase: {CLIP_IMAGES} COCO-shaped images and captions on CLIP ViT-L/14 (random weights, a shared"
          f" direction): CLIPScore {value:.4f} (per image {spread}), CLIP-IQA {probs}; seconds {seconds}; every image's"
          f" score against float64 {score_err:.2e} (tolerance {CLIP_F64_ATOL:g}; the planted fault {fault_err:.3f}; the model"
          f" in TF32 {control_err:.2e}), the first {nc} images' probabilities {iqa_err:.2e} ({IQA_F64_ATOL:g}; in TF32"
          f" {iqa_control_err:.2e}); {out['phase_s']:.1f} s", flush=True)
    return out


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
        from tpumetrics_torch.ops import bert_match as bm
        from tpumetrics_torch.ops import token_nll as tn
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

    phase_s = {}  # each phase's seconds on the host clock, in the order the script runs them

    def timed(name, phase, *args, **kwargs):
        t = time.perf_counter()
        out = phase(*args, **kwargs)
        phase_s[name] = time.perf_counter() - t
        return out

    panoptic_cpu = panoptic_cpu_start()  # the detection phase's panoptic CPU path, beside the kernel phase
    text_cpu = text_cpu_start()  # the string streams' CPU path, beside the kernel phases too
    biquad_plain = biquad_plain_start()  # the IIR plain loop on a few lanes at the full T, done by the biquad phase
    kern = timed("kernel", kernel_phase, torch, bc)
    paths = {
        "imagenet": timed(
            "imagenet", slice_phase, torch, bc, "ImageNet-1k val 50000x1000 T=200, classification report", 50000, 1000, 200, 8192, extra=True
        ),
        "headline": timed("headline", slice_phase, torch, bc, "bench headline 40960x128 T=64", 5 * 8192, 128, 64, 8192),
        "binary": timed("binary", task_phase, torch, bc, "binary"),
        "fairness": timed("fairness", fairness_phase, torch, bc),
        "multilabel": timed("multilabel", task_phase, torch, bc, "multilabel"),
        "segmentation": timed("segmentation", segmentation_phase, torch, bc),
        "ratings": timed("ratings", ratings_phase, torch, bc),
        "multioutput": timed("multioutput", multioutput_phase, torch, bc),
        "clustering": timed("clustering", clustering_phase, torch, bc),
        "nominal": timed("nominal", nominal_phase, torch, bc),
        "retrieval": timed("retrieval", retrieval_phase, torch, bc),
        "separation": timed("separation", separation_phase, torch, bc),
    }
    iir = timed("biquad kernel", biquad_kernel_phase, torch, bq, biquad_plain)
    biquad_plain[0].close()
    biquad_plain[0].join()
    paths |= {
        "srmr": timed("srmr", srmr_phase, torch, bc),
        "restoration": timed("restoration", restoration_phase, torch, bc),
        "pansharpening": timed("pansharpening", pansharpening_phase, torch, bc),
        "criteo": timed("criteo", criteo_phase, torch, bc),
    }
    paths["sync"] = timed("sync", sync_phase, torch, bc, smi)
    div2k = paths["restoration"].pop("div2k_u8")
    lpips_cpu = lpips_cpu_start(torch, div2k)  # the perceptual phase's CPU path, beside the next two phases
    pairwise = timed("pairwise", pairwise_phase, torch, bc)
    backbone_image = {"generative": timed("generative", generative_phase, torch, bc)}
    # the detection phase's host workers start beside the short perceptual phase (its CPU path is done by then),
    # so that they have started up when the detection phase begins
    detection_oracle = detection_oracle_start()
    backbone_image["perceptual"] = timed("perceptual", perceptual_phase, torch, bc, div2k, lpips_cpu)
    del div2k
    detection = timed("detection", detection_phase, torch, detection_oracle, panoptic_cpu)
    torch.cuda.empty_cache()
    nll_kern = timed("token_nll kernel", text_kernel_phase, torch, tn)
    lm = timed("perplexity", perplexity_phase, torch, tn)
    strings = timed("text strings", text_phase, torch, text_cpu)
    text_s = sum(phase_s[k] for k in ("token_nll kernel", "perplexity", "text strings"))
    print(f"text phases (kernel checks, perplexity stream, string streams): {text_s:.1f} s", flush=True)
    check(lm["fused"]["modes"]["replayed"] >= 1 and lm["fused"]["guarded_replay"], "perplexity: no checked graph replay")
    torch.cuda.empty_cache()
    bert_kern = timed("bert_greedy_match kernel", bert_kernel_phase, torch, bm)
    bertscore = timed("bertscore", bertscore_phase, torch, bm)
    infolm_out = timed("infolm", infolm_phase, torch)
    clip = timed("clip", clip_phase, torch)
    encoder_s = sum(phase_s[k] for k in ("bert_greedy_match kernel", "bertscore", "infolm", "clip"))
    print(f"encoder phases (kernel checks, BERTScore, InfoLM, CLIP): {encoder_s:.1f} s", flush=True)
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
    nll_by_path = {"perplexity": lm["launches"],
                   "perplexity fused phase, unfused": lm["fused"]["kernel_launches"]["token_nll"]["plain"],
                   "perplexity fused phase, fused (eager + replayed)": lm["fused"]["kernel_launches"]["token_nll"]["fused"]}
    check(all(nll_by_path.values()), f"token_nll: a path of the perplexity stream launched it no time: {nll_by_path}")
    nll_shape = nll_kern["timed"]["llama3 bf16"]
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
                "plain_ms": iir_shape["plain_ms_t2048"],  # the plain loop on the card at T = 2,048 (a launch per op and step;
                # at the full T it runs on a few lanes on the host: plain_cpu_s)
                "plain_shape": [iir_shape["lanes"], 2048, iir_shape["stages"]],
                "plain_cpu_s": iir_shape["plain_cpu_s"],
                "bound_ms": iir_shape["bound_ms"],
                "bound_by": iir_shape["bound_by"],
                "one_lane_ms": iir_shape["one_lane_ms"],  # one lane at the full T: the carry chain's latency
                "library_ms": None,  # no PyTorch call runs an IIR recurrence (torchaudio's lfilter is not installed)
                "shape": [iir_shape["lanes"], iir_shape["t"], iir_shape["stages"]],
                "timed_shapes": iir["timed"],
                "card": smi,
            },
            {
                "name": "coco_greedy_match",
                "route": "cuda",
                "source": "tpumetrics_torch/csrc/coco_greedy_match.cu",
                "replaces": "tpumetrics/detection/_coco_eval_jax.py:217",  # a lax.fori_loop, and the numpy loop at _coco_eval.py:357
                "launches": sum(detection["launches"].values()),  # calls: one an evaluation
                "launches_by_path": detection["launches"],
                "device_launches": sum(detection["device_launches"].values()),  # the calls' kernel launches
                "max_abs_err": detection["kernel"]["max_abs_err"],  # against the plain version: bit for bit
                "ms": detection["kernel"]["ms"],  # the stream's one call: every cell of the macro evaluation
                "plain_ms": detection["kernel"]["plain_ms"],
                "bound_ms": detection["kernel"]["bound_ms"],
                "bound_by": detection["kernel"]["bound_by"],
                "library_ms": None,  # no PyTorch call performs a greedy match
                "host_ms": detection["kernel"]["host_ms"],  # to make the call
                "host_sync": detection["kernel"]["host_sync"],
                "grid": detection["kernel"]["grid"],
                "cells_by_path": detection["kernel"]["paths"],
                "shape": {k: detection["kernel"][k] for k in ("cells", "detections", "ground_truths", "largest_cell")},
                "edge_cases": detection["kernel"]["edge_cases"],
                "card": smi,
            },
            {
                "name": "token_nll",
                "route": "cuda",
                "source": "tpumetrics_torch/csrc/token_nll.cu",
                "replaces": "tpumetrics/functional/text/perplexity.py:40",  # XLA's fusion of _perplexity_update; not Pallas
                "launches": sum(nll_by_path.values()),
                "launches_by_path": nll_by_path,
                "max_abs_err": nll_kern["max_abs_err"],  # against the plain version, over every case
                "rel": nll_shape["rel"],  # the worst row's error against float64: at most 2 x rel_plain + 1e-6
                "rel_plain": nll_shape["rel_plain"],
                "ms": nll_shape["ms"],  # the kernel (token_nll_rows) at the Llama 3 shape, bf16
                "call_ms": nll_shape["call_ms"],  # token_nll: the kernel, the float64 sum of the rows and the count
                "plain_ms": nll_shape["plain_ms"],
                "bound_ms": nll_shape["bound_ms"],
                "bound_by": nll_shape["bound_by"],
                "sfu_ms": nll_shape["sfu_ms"],  # the exponentials on the special-function units, beside the bound
                "library_ms": nll_shape["library_ms"],  # F.cross_entropy(reduction="sum", ignore_index=-100)
                "peak_extra_bytes": nll_shape["peak_extra_bytes"],
                "shape": [nll_shape["b"], nll_shape["s"], nll_shape["v"]],
                "timed_shapes": nll_kern["timed"],
                "cases": nll_kern["cases"],
                "grad_err": nll_kern["grad_err"],
                "card": smi,
            },
            {
                "name": "bert_greedy_match",
                "route": "cuda",
                "source": "tpumetrics_torch/csrc/bert_greedy_match.cu",
                "replaces": "tpumetrics/functional/text/bert.py:98",  # XLA's fusion of _get_precision_recall_f1; not Pallas
                "launches": sum(bertscore["launches"].values()),
                "launches_by_path": bertscore["launches"],
                "max_abs_err": bert_kern["max_abs_err"],  # against the plain version, over every case
                "worst_excess": bert_kern["worst_excess"],  # over |kernel - ref| <= 2 |plain - ref| + 1e-6, float64 ref
                "ms": bert_kern["timed"]["mt"]["ms"],  # the MT stream's call: 3,003 pairs, L = 1, D = 1,024
                "plain_ms": bert_kern["timed"]["mt"]["plain_ms"],
                "composite_ms": bert_kern["timed"]["mt"]["composite_ms"],  # the torch ops in one pass, no port
                "bound_ms": bert_kern["timed"]["mt"]["bound_ms"],
                "bound_by": bert_kern["timed"]["mt"]["bound_by"],
                "library_ms": None,  # no single PyTorch call computes greedy matching
                "peak_extra_bytes": bert_kern["timed"]["mt"]["peak_extra_bytes"],
                "shape": bert_kern["timed"]["mt"]["shape"],
                "timed_shapes": bert_kern["timed"],
                "cases": bert_kern["cases"],
                "card": smi,
            },
        ],
        "fused_update": fused_report,
        "phase_s": phase_s,
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
        "image": {
            path: {
                **{k: paths[path][k] for k in (
                    "update_ms", "compute_ms", "values", "oracle", "oracle_tol", "oracle_worst", "state_worst",
                    "host_syncs", "profile", "reduced") if k in paths[path]},
                **({"unguarded_ssim_err": paths[path]["unguarded_ssim_err"]} if path == "restoration" else {}),
                "fused": {kind: {k: f[k] for k in ("modes", "plain_ms", "fused_ms", "profile", "capture_s", "eager_leaders")}
                          for kind, f in paths[path]["fused_all"].items()},
            }
            for path in ("restoration", "pansharpening")
        } | backbone_image,
        "monitoring": {
            **{k: paths["criteo"][k] for k in (
                "stream_s", "compute_ms", "alerts", "worst", "state_worst", "cpu_updates", "cpu_s", "reduced", "host_syncs",
                "profile", "phase_s")},
            "fused": {kind: {k: f[k] for k in ("modes", "plain_ms", "fused_ms", "profile", "capture_s", "eager_leaders")}
                      for kind, f in paths["criteo"]["fused_all"].items()},
            "sync_ledger": paths["sync"]["ledger"],
        },
        "detection": {k: detection[k] for k in (
            "values", "pq", "iou_worst", "iou_s", "pq_s", "update_ms_median", "pack_s", "modes", "compute_ms",
            "oracle_s", "launches", "main_s", "wait_s", "pq_wait_s", "phase_s", "reduced")},
        "text": {
            "perplexity": {
                **{k: lm[k] for k in ("value", "oracle", "rel", "mean_nll", "tokens", "update_ms", "launches",
                                      "peak_extra_bytes", "phase_s", "reduced")},
                "fused": {k: lm["fused"][k] for k in ("modes", "plain_ms", "fused_ms", "profile", "capture_s",
                                                      "kernel_launches", "eager_leaders")},
            },
            "strings": strings,
            "kernel_phase_s": nll_kern["phase_s"],
            "phase_s": text_s,
        },
        "encoders": {"bertscore": bertscore, "infolm": infolm_out, "clip": clip, "kernel_phase_s": bert_kern["phase_s"],
                     "phase_s": encoder_s},
    }
    print(f"phase times (s, host clock): {({k: round(v, 1) for k, v in phase_s.items()})}", flush=True)
    print(f"script wall time: {time.perf_counter() - t_start:.1f} s", flush=True)
    print(json.dumps(report), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
