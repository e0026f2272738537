"""COCO bbox evaluation on the metric's device, in float64 (the port's
counterpart of ``tpumetrics/detection/_coco_eval_jax.py``).

:func:`coco_evaluate_rows` takes packed flat rows with image ids (the
``coco_evaluate_rows`` contract of the JAX module) and returns the same
summary dict, bit for bit the numpy protocol of
:mod:`~tpumetrics_torch.detection._coco_eval` (``coco_evaluate`` and the
per-cell ``coco_evaluate_unfused``). Every step but the last runs on the
rows' device:

1. **cells**: one stable sort orders the detections by (class, image,
   score), ranks them within their (image, class) cell and caps each cell
   at the largest max-det; the kept detections and the ground truths, each
   in cell order, and one ``(det_start, det_count, gt_start, gt_count)``
   row for each cell that holds a detection, are the matcher's inputs (a
   cell of ground truths alone matches nothing);
2. **match**: one call of
   :func:`~tpumetrics_torch.ops.coco_match.coco_greedy_match` (the CUDA
   kernel on a card, one launch for every cell; its plain torch version on
   the CPU) gives one ``(A, T)`` row for each kept detection;
3. **accumulate**: a class's columns are its kept detections in a stable
   score order over (image, rank), the numpy path's order; TP/FP are int32
   cumulative sums, cast to float64, divided by the class's runtime count
   of countable ground truths (a true division, never a multiply by a
   reciprocal), made monotone from the right within the class, and sampled
   at the recall thresholds with a float64 ``searchsorted``. One class at a
   time, so the largest tensor is the densest class's columns times
   A x T x M.

Then the ``(T, R, K, A, M)`` precision and ``(T, K, A, M)`` recall arrays
are fetched once and reduced on the host by the numpy module's
``_summarize``, whose ``np.mean`` (a pairwise sum) a device mean would not
match bit for bit.

Where bit-exactness could break, and what keeps it:

- score order: ``torch.sort`` orders float keys by their bits (``-0.0``
  before ``0.0``, NaN where its bits fall), numpy's stable ``argsort`` of
  ``-scores`` ties the zeros and puts NaN last; the key here is ``-score``
  with one zero and one NaN, mapped to an order-preserving int32;
- the IoU: the kernel rounds every operation on its own in numpy's order
  (its source says how);
- accumulation: the TP/FP sums are integers; the divisions are elementwise
  IEEE divisions by tensors; the envelope is a cummax within a class.

No budget declines: a corpus of any size is evaluated here (the JAX
program's ``MATCH_BUDGET`` fallback to the host has no counterpart). The
JAX module's ``telemetry.device.register_program`` call waits for the
port's device-profile telemetry.
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from tpumetrics_torch.detection._coco_eval import _AREA_RANGES, _summarize
from tpumetrics_torch.ops.coco_match import coco_greedy_match

Tensor = torch.Tensor

#: stage name -> seconds of the last evaluation, while :func:`record_stages` is active
_STAGES: Optional[Dict[str, float]] = None


@contextlib.contextmanager
def record_stages() -> Iterator[Dict[str, float]]:
    """Record the host-clock seconds of each stage of the evaluations run
    inside (``conversion``, ``cells``, ``kernel``, ``accumulation``,
    ``fetch_summary``; summed over evaluations). The card is synchronized at
    every stage boundary, which the untimed path does not do."""
    global _STAGES
    prev, _STAGES = _STAGES, {}
    try:
        yield _STAGES
    finally:
        _STAGES = prev


def stage_mark(device: torch.device, name: str, since: float) -> float:
    """Add the seconds since ``since`` to stage ``name`` and return now (a
    no-op returning ``since`` unless :func:`record_stages` is active)."""
    if _STAGES is None:
        return since
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    now = time.perf_counter()
    _STAGES[name] = _STAGES.get(name, 0.0) + now - since
    return now


def score_sort_key(scores: Tensor) -> Tensor:
    """int64 keys whose ascending order is numpy's stable order of
    ``-scores`` (float32): ``-0.0`` and ``0.0`` tie, NaN comes last (after
    ``+inf``), every other value by its float order."""
    key = -scores.to(torch.float32)
    key = torch.where(key == 0, torch.zeros_like(key), key)
    key = torch.where(torch.isnan(key), torch.full_like(key, float("nan")), key)
    bits = key.view(torch.int32).to(torch.int64)
    return torch.where(bits >= 0, bits, bits ^ 0x7FFFFFFF)


def _cell_starts(cell: Tensor, n_cells: int) -> Tuple[Tensor, Tensor]:
    """Per cell id: ``(count, start)`` in an array sorted by cell."""
    counts = torch.bincount(cell, minlength=n_cells)
    return counts, torch.cumsum(counts, 0) - counts


def coco_evaluate_rows(
    det: Tuple[Tensor, Tensor, Tensor, Tensor],
    gt: Tuple[Tensor, Tensor, Tensor, Tensor, Tensor],
    num_imgs: int,
    iou_thresholds: Sequence[float],
    rec_thresholds: Sequence[float],
    max_detection_thresholds: Sequence[int],
    class_ids: Sequence[int],
    average: str = "macro",
    arrays: bool = False,
) -> Dict[str, np.ndarray]:
    """COCO bbox evaluation of packed rows on their device.

    Args:
        det: ``(boxes xyxy float64 (N, 4), scores float32 (N,), labels int64,
            image ids int64)``, rows of one image in their stored order.
        gt: ``(boxes xyxy float64 (G, 4), labels int64, iscrowd int64, area
            float64 (0 falls back to the box's area), image ids int64)``.
        num_imgs: images the ids index (ids in ``[0, num_imgs)``).
        class_ids: the sorted class label space (every label among them).
        average: ``macro`` (per class) or ``micro`` (all classes pooled).
        arrays: also return the float64 ``precision`` (T, R, K, A, M) and
            ``recall`` (T, K, A, M) arrays.

    Returns:
        the :func:`~tpumetrics_torch.detection._coco_eval._summarize` dict.
    """
    d_box, d_score, d_label, d_img = det
    g_box, g_label, g_crowd, g_area, g_img = gt
    dev = d_box.device
    t = time.perf_counter()
    iou_thrs = np.asarray(iou_thresholds, np.float64)
    rec_thrs = np.asarray(rec_thresholds, np.float64)
    max_dets = sorted(int(m) for m in max_detection_thresholds)
    class_list = sorted(int(c) for c in class_ids)
    eval_class_ids: List[int] = [0] if average == "micro" else class_list
    area_names = list(_AREA_RANGES)
    num_k, num_a, num_t, num_r, num_m = len(eval_class_ids), len(area_names), len(iou_thrs), len(rec_thrs), len(max_dets)
    f64 = dict(dtype=torch.float64, device=dev)
    precision = torch.full((num_t, num_r, num_k, num_a, num_m), -1.0, **f64)
    recall = torch.full((num_t, num_k, num_a, num_m), -1.0, **f64)

    if num_imgs and num_k:
        if num_k * num_imgs >= 1 << 31:
            raise ValueError(f"{num_k} classes x {num_imgs} images exceed the 2^31 cells one sort key holds")
        n_cells = num_k * num_imgs
        if average == "micro":
            d_slot, g_slot = torch.zeros_like(d_label), torch.zeros_like(g_label)
        else:
            classes = torch.tensor(class_list, dtype=torch.int64, device=dev)
            d_slot, g_slot = torch.searchsorted(classes, d_label), torch.searchsorted(classes, g_label)
        d_cell, g_cell = d_slot * num_imgs + d_img, g_slot * num_imgs + g_img
        score_key = score_sort_key(d_score) + (1 << 31)  # in [0, 2^32)

        # ---- cells: detections by (class, image, score) stable in stored order, capped per cell
        order = torch.sort(d_cell * (1 << 32) + score_key, stable=True).indices
        _, d_start_all = _cell_starts(d_cell, n_cells)
        cell_sorted = d_cell[order]
        rank = torch.arange(order.numel(), device=dev) - d_start_all[cell_sorted]
        keep = rank < max_dets[-1]
        kept = order[keep]
        k_cell, k_rank = cell_sorted[keep], rank[keep]
        g_order = torch.sort(g_cell, stable=True).indices
        g_cell_s = g_cell[g_order]
        ga_geom = (g_box[:, 2] - g_box[:, 0]) * (g_box[:, 3] - g_box[:, 1])
        area_eff = torch.where(g_area > 0, g_area, ga_geom)
        nd_all, d_start = _cell_starts(k_cell, n_cells)
        ng_all, g_start = _cell_starts(g_cell_s, n_cells)
        cells = torch.nonzero(nd_all > 0).reshape(-1)
        cell_rows = torch.stack([d_start[cells], nd_all[cells], g_start[cells], ng_all[cells]], 1).to(torch.int32)

        ranges = torch.tensor([_AREA_RANGES[a] for a in area_names], **f64)
        thr = torch.as_tensor(np.minimum(iou_thrs, 1 - 1e-10), **f64)
        # countable ground truths per (class, area), an exact integer sum
        lo, hi = ranges[:, 0], ranges[:, 1]
        countable = ~((g_crowd != 0)[:, None] | (area_eff[:, None] < lo) | (area_eff[:, None] > hi))
        npig = torch.zeros((num_k, num_a), dtype=torch.int64, device=dev).index_add_(0, g_slot, countable.long())
        t = stage_mark(dev, "cells", t)

        # ---- match: one (A, T) row for each kept detection
        n_kept = kept.numel()
        flat_m, flat_i = coco_greedy_match(
            d_box[kept], g_box[g_order], (g_crowd[g_order] != 0).to(torch.uint8), area_eff[g_order], cell_rows, thr,
            ranges,
        )
        flat_m, flat_i = flat_m.reshape(n_kept, num_a * num_t).bool(), flat_i.reshape(n_kept, num_a * num_t).bool()
        t = stage_mark(dev, "kernel", t)

        # ---- accumulate: per class, columns in stable score order over (image, rank)
        k_slot = k_cell // num_imgs
        col_order = torch.sort(k_slot * (1 << 32) + score_key[kept], stable=True).indices
        col_count = torch.bincount(k_slot, minlength=num_k).cpu().tolist()
        live = (npig > 0).cpu().numpy()
        caps = torch.tensor(max_dets, dtype=torch.int64, device=dev)
        rec = torch.as_tensor(rec_thrs, **f64)
        eps = float(np.finfo(np.float64).eps)
        begin = 0
        for k_idx in range(num_k):
            n_cols = col_count[k_idx]
            cols = col_order[begin : begin + n_cols]
            begin += n_cols
            if not live[k_idx].any():
                continue
            a_live = torch.as_tensor(live[k_idx], device=dev)
            if n_cols == 0:
                precision[:, :, k_idx] = torch.where(a_live[:, None], 0.0, precision[:, :, k_idx])
                recall[:, k_idx] = torch.where(a_live[:, None], 0.0, recall[:, k_idx])
                continue
            m, ig = flat_m[cols].T.contiguous(), flat_i[cols].T.contiguous()  # (A*T, c): scans along the innermost dim
            capped = (k_rank[cols][None, :] < caps[:, None])[:, None, :]  # (M, 1, c)
            tp = (m & ~ig)[None] & capped
            fp = (~m & ~ig)[None] & capped
            tp_sum = torch.cumsum(tp.to(torch.int32), dim=-1).to(torch.float64)  # (M, A*T, c)
            fp_sum = torch.cumsum(fp.to(torch.int32), dim=-1).to(torch.float64)
            npig_k = npig[k_idx].clamp(min=1).to(torch.float64).repeat_interleave(num_t)[None, :, None]
            rc = tp_sum / npig_k
            pr = tp_sum / torch.clamp(fp_sum + tp_sum, min=eps)
            env = torch.flip(torch.cummax(torch.flip(pr, (-1,)), dim=-1).values, (-1,))
            rc_rows, env_rows = rc.reshape(-1, n_cols), env.reshape(-1, n_cols)
            inds = torch.searchsorted(rc_rows, rec[None, :].expand(rc_rows.shape[0], num_r).contiguous(), side="left")
            sampled = torch.gather(env_rows, 1, inds.clamp(max=n_cols - 1))
            q = torch.where(inds < n_cols, sampled, torch.zeros((), **f64))  # (M*A*T, R)
            q = q.reshape(num_m, num_a, num_t, num_r).permute(2, 3, 1, 0)  # (T, R, A, M)
            last = rc[..., -1].reshape(num_m, num_a, num_t).permute(2, 1, 0)  # (T, A, M)
            precision[:, :, k_idx] = torch.where(a_live[None, None, :, None], q, precision[:, :, k_idx])
            recall[:, k_idx] = torch.where(a_live[None, :, None], last, recall[:, k_idx])
        t = stage_mark(dev, "accumulation", t)

    flat = torch.cat([precision.reshape(-1), recall.reshape(-1)]).cpu().numpy()  # the one fetch
    precision_h = flat[: precision.numel()].reshape(tuple(precision.shape))
    recall_h = flat[precision.numel():].reshape(tuple(recall.shape))
    out = _summarize(precision_h, recall_h, iou_thrs, class_list, eval_class_ids, area_names, max_dets, {}, False)
    if arrays:
        out["precision"], out["recall"] = precision_h, recall_h
    stage_mark(dev, "fetch_summary", t)
    return out
