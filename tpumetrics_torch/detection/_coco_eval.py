"""COCO-faithful detection evaluation in vectorized numpy (a copy of
``tpumetrics/detection/_coco_eval.py``, the JAX package's host protocol).

A from-scratch reimplementation of the COCO mAP protocol (the semantics of
pycocotools' ``COCOeval``):

- IoU thresholds 0.50:0.05:0.95, recall thresholds 0:0.01:1 (101 points),
  max-detection caps (1, 10, 100), area ranges all/small/medium/large;
- per (class, image): detections sorted by score, greedily matched to the
  not-yet-matched ground truth with the highest IoU above the threshold;
  crowd ground truths may match many detections and use a detection-area
  union (``iscrowd`` semantics); ignored ground truths (crowd or
  out-of-area-range) absorb matches without counting;
- accumulation: detections merged across images per class, re-sorted by
  score, TP/FP cumsums over non-ignored entries, precision made monotone
  from the right, sampled at the recall thresholds.

**Batched matching**: the greedy loop is sequential only over the
detections *within* one (image, class) cell, and cells are independent.
:func:`coco_evaluate` therefore pads every cell of a class to a shared
(D, G) bucket (pow-2 edges) and runs ONE loop over the padded detection
axis, vectorized across all images x area ranges x IoU thresholds at once.
Accumulation is likewise batched: per (class, max_det cap) the detections
of all images flatten into one score-sorted matrix shared by every area
range. The per-cell reference implementation is kept verbatim
(:func:`_match_image_areas`, :func:`_accumulate_class_area`,
:func:`coco_evaluate_unfused`), and the batched path is bit-identical to it.

In the port this module serves three purposes: the ``segm`` and
``extended_summary`` routes of ``MeanAveragePrecision`` (as the JAX package
routes them); the host oracle that the device path
(:mod:`tpumetrics_torch.detection._coco_eval_device`, bbox matching and
accumulation on the metric's device, bit for bit these numbers) is held to;
and :func:`_summarize`, which the device path also uses.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from tpumetrics_torch.detection._bucketing import ShapeBucketer, pow2_bucket_edges

_AREA_RANGES = {
    "all": (0.0, 1e10),
    "small": (0.0, 32.0**2),
    "medium": (32.0**2, 96.0**2),
    "large": (96.0**2, 1e10),
}


def rle_decode_flat(runs: np.ndarray, num_pixels: int) -> np.ndarray:
    """Decode column-major RLE runs (alternating 0s/1s, leading 0-run) to a
    flat (num_pixels,) uint8 vector."""
    runs = np.asarray(runs, dtype=np.int64)
    vals = np.zeros(runs.shape[0], dtype=np.uint8)
    vals[1::2] = 1
    flat = np.repeat(vals, runs)
    if flat.shape[0] != num_pixels:
        raise ValueError(f"RLE decodes to {flat.shape[0]} pixels, expected {num_pixels}")
    return flat


def _pairwise_geometry(
    det_geom, gt_geom, iou_type: str
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Precompute class-independent pairwise pieces for one image: the
    intersection matrix (D, G) and the per-item geometry areas.

    For ``bbox`` the geometry is an xyxy (N, 4) array; for ``segm`` it is
    ``((h, w), [runs, ...])`` — column-major RLE runs per mask.  Masks are
    decoded once per image and intersected with ONE (D, HW) x (HW, G)
    matmul, so the per-class loop below only slices — the pycocotools
    equivalent recomputes ``maskUtils.iou`` per (image, category).
    """
    if iou_type == "bbox":
        det, gt = det_geom, gt_geom
        det_area = (det[:, 2] - det[:, 0]) * (det[:, 3] - det[:, 1]) if det.size else np.zeros(det.shape[0])
        gt_area = (gt[:, 2] - gt[:, 0]) * (gt[:, 3] - gt[:, 1]) if gt.size else np.zeros(gt.shape[0])
        if det.shape[0] == 0 or gt.shape[0] == 0:
            inter = np.zeros((det.shape[0], gt.shape[0]))
        else:
            lt = np.maximum(det[:, None, :2], gt[None, :, :2])
            rb = np.minimum(det[:, None, 2:], gt[None, :, 2:])
            wh = np.clip(rb - lt, 0, None)
            inter = (wh[..., 0] * wh[..., 1]).astype(np.float64)
        return inter, np.asarray(det_area, np.float64), np.asarray(gt_area, np.float64)

    (h, w), det_runs = det_geom
    _, gt_runs = gt_geom
    num_px = h * w
    det_area = np.array([float(np.asarray(r, np.int64)[1::2].sum()) for r in det_runs])
    gt_area = np.array([float(np.asarray(r, np.int64)[1::2].sum()) for r in gt_runs])
    if len(det_runs) == 0 or len(gt_runs) == 0:
        return np.zeros((len(det_runs), len(gt_runs))), det_area, gt_area
    # decode to uint8 and matmul in float32, chunked over detections: f32 is
    # exact for pixel counts < 2^24 (any mask below 16.7 Mpx) at half the
    # float64 footprint, and chunking bounds the peak to the gt matrix plus
    # one chunk rather than the full (D, HW) dense float block
    dmat = np.stack([rle_decode_flat(r, num_px) for r in det_runs])
    gmat32 = np.stack([rle_decode_flat(r, num_px) for r in gt_runs]).astype(np.float32).T
    inter = np.empty((dmat.shape[0], gmat32.shape[1]), dtype=np.float64)
    chunk = max(1, min(dmat.shape[0], (1 << 25) // max(num_px, 1)))  # ~128 MB f32 per chunk
    for i in range(0, dmat.shape[0], chunk):
        inter[i : i + chunk] = dmat[i : i + chunk].astype(np.float32) @ gmat32
    return inter, det_area, gt_area


def _match_image_areas(
    ious: np.ndarray,
    det_areas: np.ndarray,
    det_scores: np.ndarray,
    gt_crowd: np.ndarray,
    gt_area: np.ndarray,
    iou_thresholds: np.ndarray,
    area_ranges: Sequence[Tuple[float, float]],
    max_det: int,
) -> Optional[List[dict]]:
    """Match one (image, class) pair at every (area range, IoU threshold)
    simultaneously (pycocotools ``evaluateImg`` semantics; reference
    _mean_ap.py:521-649).

    ``ious``/``det_areas``/``det_scores`` are already score-sorted
    (descending, stable) — computed once per (image, class) by the caller.
    Only the detection loop is sequential (each det claims a gt); the per-det
    candidate search is vectorized over all (area, threshold, gt) triples —
    area ranges only change which gts are ignored, so evaluating all four in
    one pass quarters the Python-loop overhead of the hot host path.  The
    greedy rules are replicated exactly: non-ignored gts take precedence over
    ignored ones (the reference's sorted-ignored-last + break), ties replace
    (last-wins argmax), crowd gts can absorb any number of detections.
    """
    n_gt = gt_crowd.shape[0]
    n_det = min(det_scores.shape[0], max_det)
    if n_gt == 0 and n_det == 0:
        return None

    lo = np.asarray([r[0] for r in area_ranges])  # (A,)
    hi = np.asarray([r[1] for r in area_ranges])
    crowd = gt_crowd.astype(bool)
    gt_ignore = crowd[None, :] | (gt_area[None, :] < lo[:, None]) | (gt_area[None, :] > hi[:, None])  # (A, G)
    num_areas = len(area_ranges)
    num_thrs = len(iou_thresholds)
    thr = np.minimum(np.asarray(iou_thresholds)[None, :, None], 1 - 1e-10)  # (1, T, 1)
    det_matches = np.zeros((num_areas, num_thrs, n_det), dtype=np.int64)  # 1 if matched
    det_ignore = np.zeros((num_areas, num_thrs, n_det), dtype=bool)
    avail = np.ones((num_areas, num_thrs, n_gt), dtype=bool)  # gt not yet claimed
    ious = ious[:n_det]
    real = ~gt_ignore

    for d_idx in range(n_det):
        iou_row = ious[d_idx][None, None, :]  # (1, 1, G)
        cand = avail & (iou_row >= thr)  # (A, T, G)
        cand_real = cand & real[:, None, :]
        use_real = cand_real.any(axis=2)
        pick_from = np.where(use_real[..., None], cand_real, cand & gt_ignore[:, None, :])
        has = pick_from.any(axis=2)
        if not has.any():
            continue
        vals = np.where(pick_from, iou_row, -1.0)
        best_g = n_gt - 1 - np.argmax(vals[..., ::-1], axis=2)  # last-wins argmax
        rows_a, rows_t = np.nonzero(has)
        bg = best_g[rows_a, rows_t]
        det_matches[rows_a, rows_t, d_idx] = 1
        det_ignore[rows_a, rows_t, d_idx] = gt_ignore[rows_a, bg]
        noncrowd = ~crowd[bg]
        avail[rows_a[noncrowd], rows_t[noncrowd], bg[noncrowd]] = False

    # unmatched detections outside the area range are ignored
    da = det_areas[:n_det]
    det_out_of_range = (da[None, :] < lo[:, None]) | (da[None, :] > hi[:, None])  # (A, D)
    det_ignore = det_ignore | ((det_matches == 0) & det_out_of_range[:, None, :])

    scores = det_scores[:n_det]
    return [
        {
            "det_scores": scores,
            "det_matches": det_matches[a],
            "det_ignore": det_ignore[a],
            "num_gt": int((~gt_ignore[a]).sum()),
        }
        for a in range(num_areas)
    ]




def _accumulate_class_area(
    results: List[Optional[dict]], num_thrs: int, rec_thresholds: np.ndarray, max_det: Optional[int] = None
) -> Tuple[np.ndarray, np.ndarray]:
    """Merge per-image matchings of one (class, area, maxdet) cell into
    precision-at-recall-thresholds and best recall (pycocotools
    ``accumulate``; reference _mean_ap.py:696-782).

    ``max_det`` slices each image's (already score-sorted) detections, so the
    greedy matching runs once per (class, area) at the largest cap and is
    reused for the smaller ones — pycocotools does the same."""
    results = [r for r in results if r is not None]
    num_rec = len(rec_thresholds)
    precision = -np.ones((num_thrs, num_rec))
    recall = -np.ones(num_thrs)
    if not results:
        return precision, recall

    m = max_det if max_det is not None else max(r["det_scores"].shape[0] for r in results)
    scores = np.concatenate([r["det_scores"][:m] for r in results])
    matches = np.concatenate([r["det_matches"][:, :m] for r in results], axis=1)
    ignore = np.concatenate([r["det_ignore"][:, :m] for r in results], axis=1)
    npig = sum(r["num_gt"] for r in results)
    if npig == 0:
        return precision, recall

    order = np.argsort(-scores, kind="mergesort")
    matches = matches[:, order]
    ignore = ignore[:, order]

    tps = np.logical_and(matches, ~ignore)
    fps = np.logical_and(~matches.astype(bool), ~ignore)
    tp_sum = np.cumsum(tps, axis=1).astype(np.float64)
    fp_sum = np.cumsum(fps, axis=1).astype(np.float64)

    for t_idx in range(num_thrs):
        tp = tp_sum[t_idx]
        fp = fp_sum[t_idx]
        nd = len(tp)
        rc = tp / npig
        pr = tp / np.maximum(fp + tp, np.finfo(np.float64).eps)
        recall[t_idx] = rc[-1] if nd else 0.0

        # monotone precision envelope from the right (pycocotools loop)
        pr = np.maximum.accumulate(pr[::-1])[::-1]
        inds = np.searchsorted(rc, rec_thresholds, side="left")
        q = np.zeros(num_rec)
        valid = inds < nd
        q[valid] = pr[inds[valid]]
        precision[t_idx] = q
    return precision, recall


# ---------------------------------------------------------- batched matching


# batched-match work budget: N_cells * areas * thresholds * G_pad * D_pad
# elements touched by one bucket's greedy pass.  Under it, ONE bucket per
# class maximizes batching (every Python-level matcher dispatch covers all
# cells); above it, pow-2 sub-buckets bound the padding blow-up a single
# huge image would force on every small cell.
_MATCH_BUDGET = 1 << 24


def _cell_buckets(
    cells: List[Tuple], max_det: int, num_areas: int, num_thrs: int
) -> Dict[Tuple[int, int], List[int]]:
    """Group cell indices by their padded (detection, groundtruth) bucket.

    Fewest-buckets-first: if padding every cell straight to the class max
    stays under ``_MATCH_BUDGET`` (the common case — evaluation corpora are
    ragged but not wild), everything lands in one bucket and the greedy pass
    is a single vectorized loop.  Otherwise cells split along pow-2 edges
    (:func:`~tpumetrics_torch.detection._bucketing.pow2_bucket_edges`,
    floored at 8 so near-sized cells still share a shape)."""

    d_sizes = [max(min(c[2].shape[0], max_det), 1) for c in cells]
    g_sizes = [max(c[3].shape[0], 1) for c in cells]
    d_max, g_max = max(d_sizes, default=1), max(g_sizes, default=1)
    if len(cells) * num_areas * num_thrs * d_max * g_max <= _MATCH_BUDGET:
        return {(d_max, g_max): list(range(len(cells)))}
    floor = 8
    d_bucketer = ShapeBucketer(
        [e for e in pow2_bucket_edges(d_max) if e >= min(floor, d_max)]
    )
    g_bucketer = ShapeBucketer(
        [e for e in pow2_bucket_edges(g_max) if e >= min(floor, g_max)]
    )
    groups: Dict[Tuple[int, int], List[int]] = {}
    for i, (d, g) in enumerate(zip(d_sizes, g_sizes)):
        groups.setdefault((d_bucketer.bucket_for(d), g_bucketer.bucket_for(g)), []).append(i)
    return groups


def _match_cells_batched(
    cells: List[Tuple],
    iou_thresholds: np.ndarray,
    area_ranges: Sequence[Tuple[float, float]],
    max_det: int,
    d_pad: int,
    g_pad: int,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Greedy-match a batch of same-bucket (image, class) cells at once.

    Semantically identical to running :func:`_match_image_areas` per cell —
    the greedy detection loop is sequential only *within* a cell, so the
    loop below runs over the padded detection axis once, vectorized over
    (cell, area range, IoU threshold, gt) for every cell simultaneously.

    ``cells`` entries are ``(ious, det_areas, det_scores, gt_crowd,
    gt_area)`` with detections already score-sorted and capped to
    ``max_det``.  Padding convention: pad IoUs are ``-1`` (below every
    threshold), pad gts are unavailable and ignored, pad detections are
    marked invalid and excluded by the caller's validity mask.

    Returns ``(det_matches (N, A, T, Dp) bool, det_ignore (N, A, T, Dp)
    bool, scores (N, Dp) f32, det_valid (N, Dp) bool, num_gt (N, A))``.
    """
    n_cells = len(cells)
    num_areas = len(area_ranges)
    num_thrs = len(iou_thresholds)

    ious_p = np.full((n_cells, d_pad, g_pad), -1.0)
    da_p = np.zeros((n_cells, d_pad))
    sc_p = np.zeros((n_cells, d_pad), np.float32)
    crowd_p = np.zeros((n_cells, g_pad), bool)
    ga_p = np.zeros((n_cells, g_pad))
    det_valid = np.zeros((n_cells, d_pad), bool)
    gt_valid = np.zeros((n_cells, g_pad), bool)
    for i, (ious, da, ds, gc, ga) in enumerate(cells):
        d = min(ds.shape[0], max_det)
        g = gc.shape[0]
        ious_p[i, :d, :g] = ious[:d]
        da_p[i, :d] = da[:d]
        sc_p[i, :d] = ds[:d]
        crowd_p[i, :g] = gc.astype(bool)
        ga_p[i, :g] = ga
        det_valid[i, :d] = True
        gt_valid[i, :g] = True

    lo = np.asarray([r[0] for r in area_ranges])
    hi = np.asarray([r[1] for r in area_ranges])
    # (N, A, G): crowd / out-of-range gts absorb matches without counting;
    # pad gts are forced ignored AND unavailable so they can never match
    gt_ignore = (
        crowd_p[:, None, :]
        | (ga_p[:, None, :] < lo[None, :, None])
        | (ga_p[:, None, :] > hi[None, :, None])
        | ~gt_valid[:, None, :]
    )
    real = ~gt_ignore  # pads are never "real": forced ignored above
    thr = np.minimum(np.asarray(iou_thresholds, np.float64), 1 - 1e-10)  # (T,)

    det_matches = np.zeros((n_cells, num_areas, num_thrs, d_pad), bool)
    det_ignore = np.zeros((n_cells, num_areas, num_thrs, d_pad), bool)
    avail = np.broadcast_to(
        gt_valid[:, None, None, :], (n_cells, num_areas, num_thrs, g_pad)
    ).copy()
    g_idx = np.arange(g_pad)
    n_idx = np.arange(n_cells)[:, None, None]
    a_idx = np.arange(num_areas)[None, :, None]
    for d_i in range(d_pad):
        # pad detections (d_i >= a cell's true count) carry IoU -1 for every
        # gt, below any threshold — no per-iteration validity masking needed
        iou_row = ious_p[:, d_i, :]  # (N, G)
        cand = avail & (iou_row[:, None, None, :] >= thr[None, None, :, None])
        cand_real = cand & real[:, :, None, :]
        use_real = cand_real.any(axis=3)  # non-ignored gts take precedence
        pick_from = np.where(use_real[..., None], cand_real, cand & gt_ignore[:, :, None, :])
        has = pick_from.any(axis=3)  # (N, A, T)
        if not has.any():
            continue
        vals = np.where(pick_from, iou_row[:, None, None, :], -1.0)
        best_g = g_pad - 1 - np.argmax(vals[..., ::-1], axis=3)  # last-wins argmax
        det_matches[:, :, :, d_i] = has
        det_ignore[:, :, :, d_i] = has & gt_ignore[n_idx, a_idx, best_g]
        # crowd gts can absorb any number of detections: only non-crowd
        # picks claim their gt
        claimed = has & ~crowd_p[n_idx, best_g]
        avail &= ~(claimed[..., None] & (g_idx[None, None, None, :] == best_g[..., None]))

    # unmatched detections outside the area range are ignored
    det_out = (da_p[:, None, :] < lo[None, :, None]) | (da_p[:, None, :] > hi[None, :, None])
    det_ignore |= (~det_matches) & det_out[:, :, None, :] & det_valid[:, None, None, :]

    num_gt = (~gt_ignore).sum(axis=2)  # (N, A)
    return det_matches, det_ignore, sc_p, det_valid, num_gt


def _accumulate_cells(
    groups: List[Tuple[np.ndarray, Tuple]],
    num_thrs: int,
    rec_thresholds: np.ndarray,
    max_dets: Sequence[int],
    num_areas: int,
) -> Tuple[np.ndarray, np.ndarray]:
    """Batched :func:`_accumulate_class_area` over every (area, maxdet) cell
    of one class at once.

    ``groups`` pairs each bucket's original cell indices with its
    :func:`_match_cells_batched` output.  Per max-det cap the detections of
    ALL cells flatten into one score-sorted column set, shared across area
    ranges (scores do not depend on the area range); the flatten order is
    restored to global cell order first so stable-sort tie-breaking is
    bit-identical to concatenating per-cell arrays.

    Returns ``(precision (T, R, A, M), recall (T, A, M))``.
    """
    num_rec = len(rec_thresholds)
    n_m = len(max_dets)
    precision = -np.ones((num_thrs, num_rec, num_areas, n_m))
    recall = -np.ones((num_thrs, num_areas, n_m))
    if not groups:
        return precision, recall
    npig = np.zeros(num_areas, dtype=np.int64)
    for _cells_idx, (_dm, _dig, _sc, _dv, num_gt) in groups:
        npig += num_gt.sum(axis=0)

    eps = np.finfo(np.float64).eps
    single = len(groups) == 1  # one bucket: cell order is already global order
    for m_idx, m in enumerate(max_dets):
        if single:
            _ci, (dm_s, dig_s, sc_s, dv_s, _ng) = groups[0]
            valid_s = dv_s & (np.arange(dv_s.shape[1])[None, :] < m)
            # flat (cell * Dp) positions in cell-major order == the per-cell
            # concatenation order; one stable score sort gives the columns
            flat = np.flatnonzero(valid_s.ravel())
            scores = sc_s.ravel()[flat]
            cols = flat[np.argsort(-scores, kind="mergesort")]
        else:
            valids = []
            counts = []
            for cells_idx, (_dm, _dig, sc, dv, _ng) in groups:
                valid = dv & (np.arange(dv.shape[1])[None, :] < m)
                valids.append(valid)
                counts.append((cells_idx, valid.sum(axis=1)))
            # global column order = per-cell blocks in original cell order
            # (the per-cell concatenation order), then one stable score sort
            rows_cell = np.concatenate([np.repeat(ci, cnt) for ci, cnt in counts])
            perm = np.argsort(rows_cell, kind="stable")
            scores = np.concatenate(
                [sc[valid] for valid, (_ci, (_dm, _dig, sc, _dv, _ng)) in zip(valids, groups)]
            )[perm]
            cols = perm[np.argsort(-scores, kind="mergesort")]
        nd = cols.shape[0]
        for a_idx in range(num_areas):
            if npig[a_idx] == 0:
                continue
            if nd == 0:
                precision[:, :, a_idx, m_idx] = 0.0
                recall[:, a_idx, m_idx] = 0.0
                continue
            if single:
                matches = np.transpose(dm_s[:, a_idx], (1, 0, 2)).reshape(num_thrs, -1)[:, cols]
                ignore = np.transpose(dig_s[:, a_idx], (1, 0, 2)).reshape(num_thrs, -1)[:, cols]
            else:
                matches = np.concatenate(
                    [
                        np.transpose(dm[:, a_idx], (1, 0, 2))[:, valid]
                        for valid, (_ci, (dm, _dig, _sc, _dv, _ng)) in zip(valids, groups)
                    ],
                    axis=1,
                )[:, cols]
                ignore = np.concatenate(
                    [
                        np.transpose(dig[:, a_idx], (1, 0, 2))[:, valid]
                        for valid, (_ci, (_dm, dig, _sc, _dv, _ng)) in zip(valids, groups)
                    ],
                    axis=1,
                )[:, cols]
            tp_sum = np.cumsum(matches & ~ignore, axis=1).astype(np.float64)
            fp_sum = np.cumsum(~matches & ~ignore, axis=1).astype(np.float64)
            rc = tp_sum / npig[a_idx]
            pr = tp_sum / np.maximum(fp_sum + tp_sum, eps)
            recall[:, a_idx, m_idx] = rc[:, -1]
            # monotone precision envelope from the right (pycocotools loop)
            pr = np.maximum.accumulate(pr[:, ::-1], axis=1)[:, ::-1]
            for t_idx in range(num_thrs):
                inds = np.searchsorted(rc[t_idx], rec_thresholds, side="left")
                q = np.zeros(num_rec)
                valid_i = inds < nd
                q[valid_i] = pr[t_idx][inds[valid_i]]
                precision[t_idx, :, a_idx, m_idx] = q
    return precision, recall


def precompute_geometries(
    detections: Sequence[Tuple],
    groundtruths: Sequence[Tuple],
    iou_type: str,
) -> List[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
    """Class-independent pairwise geometry, ONCE per image (intersections +
    areas); the per-class loop in :func:`coco_evaluate` only slices these.
    pycocotools recomputes IoU per (image, category) — for masks that means
    re-decoding RLEs K times; here each mask is decoded once and intersected
    by one matmul."""
    return [
        _pairwise_geometry(detections[img][0], groundtruths[img][0], iou_type)
        for img in range(len(detections))
    ]


def coco_evaluate(
    detections: Sequence[Tuple[np.ndarray, np.ndarray, np.ndarray]],
    groundtruths: Sequence[Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]],
    iou_thresholds: Sequence[float],
    rec_thresholds: Sequence[float],
    max_detection_thresholds: Sequence[int],
    class_ids: Sequence[int],
    average: str = "macro",
    iou_type: str = "bbox",
    geom_cache: Optional[List[Tuple[np.ndarray, np.ndarray, np.ndarray]]] = None,
    extended: bool = False,
) -> Dict[str, np.ndarray]:
    """Full COCO evaluation over per-image detections/groundtruths.

    The hot path: per class, every image's cell is padded to a shared
    pow-2 (D, G) bucket, matched by ONE vectorized greedy pass
    (:func:`_match_cells_batched`) and accumulated by ONE batched
    precision/recall pass (:func:`_accumulate_cells`).  Bit-identical to
    the per-cell reference path (:func:`coco_evaluate_unfused`).

    Args:
        detections: per image (geometry, scores (D,), labels (D,)).
        groundtruths: per image (geometry, labels (G,), iscrowd (G,),
            area (G,) — zero entries fall back to the geometry area).
        iou_type: geometry kind — ``bbox`` (geometry = xyxy (N, 4) array) or
            ``segm`` (geometry = ``((h, w), [RLE runs per mask])``).
        class_ids: the class label space to evaluate.
        average: ``macro`` (per-class then averaged, COCO standard) or
            ``micro`` (all classes pooled into one).
        geom_cache: output of a prior :func:`precompute_geometries` call on
            the same inputs — lets a caller that evaluates twice (e.g. micro
            scores + macro per-class values) pay the mask-decode/intersection
            cost once.
    """
    iou_thrs = np.asarray(iou_thresholds, dtype=np.float64)
    rec_thrs = np.asarray(rec_thresholds, dtype=np.float64)
    max_dets = sorted(max_detection_thresholds)
    num_imgs = len(detections)

    # micro pools all classes into one evaluation bucket, but the reported
    # `classes` stay the observed ids
    eval_class_ids: Sequence[int] = [0] if average == "micro" else class_ids

    area_names = list(_AREA_RANGES)
    all_ranges = [_AREA_RANGES[a] for a in area_names]
    # precision[T, R, K, A, M], recall[T, K, A, M]
    precision = -np.ones((len(iou_thrs), len(rec_thrs), len(eval_class_ids), len(area_names), len(max_dets)))
    recall = -np.ones((len(iou_thrs), len(eval_class_ids), len(area_names), len(max_dets)))

    per_image_geom = (
        geom_cache if geom_cache is not None else precompute_geometries(detections, groundtruths, iou_type)
    )

    # class-independent work, ONCE per image (shared by every class and by
    # a micro+macro double evaluation): the full crowd-aware IoU matrix and
    # one stable score sort — a per-class stable subset selection of a
    # sorted order equals sorting the subset
    per_image_full = []
    for img in range(num_imgs):
        _, det_scores, _ = detections[img]
        _, _, gt_crowd, gt_area = groundtruths[img]
        inter_full, det_area_full, gt_area_geom_full = per_image_geom[img]
        union = det_area_full[:, None] + gt_area_geom_full[None, :] - inter_full
        union = np.where(gt_crowd[None, :].astype(bool), det_area_full[:, None], union)
        ious_full = inter_full / np.where(union > 0, union, 1.0)
        area_eff = np.where(gt_area > 0, gt_area, gt_area_geom_full)
        per_image_full.append((ious_full, np.argsort(-det_scores, kind="stable"), area_eff))

    iou_map: Dict[Tuple[int, int], np.ndarray] = {}
    for k_idx, class_id in enumerate(eval_class_ids):
        # per (image, class) cell: slice the presorted full-image pieces
        cells = []
        for img in range(num_imgs):
            _, det_scores, det_labels = detections[img]
            _, gt_labels, gt_crowd, _ = groundtruths[img]
            _, det_area_full, _ = per_image_geom[img]
            ious_full, order_full, area_eff = per_image_full[img]
            if average == "micro":
                idx = order_full[: max_dets[-1]]
                gt_sel = slice(None)
            else:
                idx = order_full[det_labels[order_full] == class_id][: max_dets[-1]]
                gt_sel = gt_labels == class_id
            ious = ious_full[idx][:, gt_sel]
            cells.append(
                (ious, det_area_full[idx], det_scores[idx], gt_crowd[gt_sel], area_eff[gt_sel])
            )
            if extended:
                iou_map[(img, int(class_id))] = ious

        groups = [
            (
                np.asarray(cell_idx, np.int64),
                _match_cells_batched(
                    [cells[i] for i in cell_idx], iou_thrs, all_ranges, max_dets[-1], d_pad, g_pad
                ),
            )
            for (d_pad, g_pad), cell_idx in _cell_buckets(
                cells, max_dets[-1], len(area_names), len(iou_thrs)
            ).items()
        ]
        prec_k, rec_k = _accumulate_cells(groups, len(iou_thrs), rec_thrs, max_dets, len(area_names))
        precision[:, :, k_idx] = prec_k
        recall[:, k_idx] = rec_k

    return _summarize(
        precision, recall, iou_thrs, class_ids, eval_class_ids, area_names, max_dets, iou_map, extended
    )


def coco_evaluate_unfused(
    detections: Sequence[Tuple[np.ndarray, np.ndarray, np.ndarray]],
    groundtruths: Sequence[Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]],
    iou_thresholds: Sequence[float],
    rec_thresholds: Sequence[float],
    max_detection_thresholds: Sequence[int],
    class_ids: Sequence[int],
    average: str = "macro",
    iou_type: str = "bbox",
    geom_cache: Optional[List[Tuple[np.ndarray, np.ndarray, np.ndarray]]] = None,
    extended: bool = False,
) -> Dict[str, np.ndarray]:
    """The per-(image, class)-cell reference evaluation (pre-batching
    implementation, kept verbatim): the parity anchor the batched
    :func:`coco_evaluate` is asserted bit-identical against."""
    iou_thrs = np.asarray(iou_thresholds, dtype=np.float64)
    rec_thrs = np.asarray(rec_thresholds, dtype=np.float64)
    max_dets = sorted(max_detection_thresholds)
    num_imgs = len(detections)

    eval_class_ids: Sequence[int] = [0] if average == "micro" else class_ids

    area_names = list(_AREA_RANGES)
    precision = -np.ones((len(iou_thrs), len(rec_thrs), len(eval_class_ids), len(area_names), len(max_dets)))
    recall = -np.ones((len(iou_thrs), len(eval_class_ids), len(area_names), len(max_dets)))

    per_image_geom = (
        geom_cache if geom_cache is not None else precompute_geometries(detections, groundtruths, iou_type)
    )

    iou_map: Dict[Tuple[int, int], np.ndarray] = {}
    for k_idx, class_id in enumerate(eval_class_ids):
        # per (image, class): sort detections by score and compute IoUs ONCE,
        # shared across all four area ranges (pycocotools computes computeIoU
        # once per (img, cat) the same way)
        per_image_cls = []
        for img in range(num_imgs):
            _, det_scores, det_labels = detections[img]
            _, gt_labels, gt_crowd, gt_area = groundtruths[img]
            inter_full, det_area_full, gt_area_geom_full = per_image_geom[img]
            if average == "micro":
                det_sel = np.ones(det_labels.shape[0], dtype=bool)
                gt_sel = np.ones(gt_labels.shape[0], dtype=bool)
            else:
                det_sel = det_labels == class_id
                gt_sel = gt_labels == class_id
            area = gt_area[gt_sel]
            geom_area = gt_area_geom_full[gt_sel]
            area = np.where(area > 0, area, geom_area)
            ds, gc = det_scores[det_sel], gt_crowd[gt_sel]
            det_order = np.argsort(-ds, kind="stable")[: max_dets[-1]]
            ds = ds[det_order]
            da = det_area_full[det_sel][det_order]
            inter = inter_full[det_sel][:, gt_sel][det_order]
            union = da[:, None] + geom_area[None, :] - inter
            union = np.where(gc[None, :].astype(bool), da[:, None], union)
            ious = inter / np.where(union > 0, union, 1.0)
            per_image_cls.append((ious, da, ds, gc, area))
            if extended:
                iou_map[(img, int(class_id))] = ious

        # match once per image across ALL area ranges at the largest cap;
        # smaller caps reuse by slicing
        all_ranges = [_AREA_RANGES[a] for a in area_names]
        per_image_areas = [
            _match_image_areas(ious, da, ds, gc, ga, iou_thrs, all_ranges, max_dets[-1])
            for (ious, da, ds, gc, ga) in per_image_cls
        ]
        for a_idx in range(len(area_names)):
            results = [r if r is None else r[a_idx] for r in per_image_areas]
            for m_idx, max_det in enumerate(max_dets):
                prec, rec = _accumulate_class_area(results, len(iou_thrs), rec_thrs, max_det)
                precision[:, :, k_idx, a_idx, m_idx] = prec
                recall[:, k_idx, a_idx, m_idx] = rec

    return _summarize(
        precision, recall, iou_thrs, class_ids, eval_class_ids, area_names, max_dets, iou_map, extended
    )


def _summarize(
    precision: np.ndarray,
    recall: np.ndarray,
    iou_thrs: np.ndarray,
    class_ids: Sequence[int],
    eval_class_ids: Sequence[int],
    area_names: List[str],
    max_dets: List[int],
    iou_map: Dict[Tuple[int, int], np.ndarray],
    extended: bool,
) -> Dict[str, np.ndarray]:
    """Reduce the (T, R, K, A, M) precision / (T, K, A, M) recall tensors to
    the COCO summary scalars (shared by the batched and reference paths)."""

    def _map(thr_sel=slice(None), area="all", max_det_idx=-1, class_idx=None):
        a_idx = area_names.index(area)
        p = precision[thr_sel, :, :, a_idx, max_det_idx]
        if class_idx is not None:
            p = p[..., class_idx]
        p = p[p > -1]
        return np.float32(p.mean()) if p.size else np.float32(-1.0)

    def _mar(area="all", max_det_idx=-1, class_idx=None):
        a_idx = area_names.index(area)
        r = recall[:, :, a_idx, max_det_idx]
        if class_idx is not None:
            r = r[..., class_idx]
        r = r[r > -1]
        return np.float32(r.mean()) if r.size else np.float32(-1.0)

    thr50 = [i for i, t in enumerate(iou_thrs) if abs(t - 0.5) < 1e-9]
    thr75 = [i for i, t in enumerate(iou_thrs) if abs(t - 0.75) < 1e-9]

    out: Dict[str, np.ndarray] = {
        "map": _map(),
        "map_50": _map(thr_sel=thr50) if thr50 else np.float32(-1.0),
        "map_75": _map(thr_sel=thr75) if thr75 else np.float32(-1.0),
        "map_small": _map(area="small"),
        "map_medium": _map(area="medium"),
        "map_large": _map(area="large"),
        "mar_small": _mar(area="small"),
        "mar_medium": _mar(area="medium"),
        "mar_large": _mar(area="large"),
        "classes": np.asarray(class_ids, dtype=np.int32),
    }
    for m_idx, max_det in enumerate(max_dets):
        out[f"mar_{max_det}"] = _mar(max_det_idx=m_idx)
    out["map_per_class"] = np.asarray([_map(class_idx=k) for k in range(len(eval_class_ids))], np.float32)
    out["mar_per_class"] = np.asarray(
        [_mar(class_idx=k, max_det_idx=len(max_dets) - 1) for k in range(len(eval_class_ids))], np.float32
    )
    if extended:
        # the reference's extended_summary payload (reference mean_ap.py:525-536):
        # score-sorted per-(image, class) IoU matrices plus the raw
        # precision/recall tensors over (T, R, K, A, M) / (T, K, A, M)
        out["ious"] = iou_map
        out["precision"] = precision
        out["recall"] = recall
    return out
