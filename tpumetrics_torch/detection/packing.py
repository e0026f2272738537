"""Host-side packing of ragged detection batches into dense dict layout
(port of ``tpumetrics/detection/packing.py``, unchanged: plain numpy).

The packed update path of
:class:`~tpumetrics_torch.detection.MeanAveragePrecision` takes each side of a
batch as ONE dict of ``(B, slots, ...)`` arrays plus a per-image ``count``
— the trace-safe fixed-shape form that streams through the bucketed
runtime.  This module is the boundary where ragged per-image inputs become
that form: plain numpy, pow-2 slot padding (so the set of batch
signatures, and of CUDA graphs a fused update captures, stays bounded),
zero device work: the caller moves the arrays to the metric's device
(``torch.as_tensor(v, device=...)``) and hands them to ``update()``.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from tpumetrics_torch.detection._bucketing import pow2_at_least as pow2_slots  # the slot-count bucketing


def pack_detection_batch(
    preds: Sequence[Dict],
    target: Sequence[Dict],
    det_slots: Optional[int] = None,
    gt_slots: Optional[int] = None,
) -> Tuple[Dict[str, np.ndarray], Dict[str, np.ndarray]]:
    """Pack list-of-dicts (bbox) inputs into the dense packed-dict pair.

    Args:
        preds: per image ``{"boxes" (D, 4), "scores" (D,), "labels" (D,)}``.
        target: per image ``{"boxes" (G, 4), "labels" (G,)}`` with optional
            ``iscrowd``/``area``.
        det_slots / gt_slots: fixed inner slot counts.  Default: the pow-2
            bucket of this batch's largest per-image count.  Streaming
            callers should pass a corpus-wide constant so every batch has
            the same inner shape (a fused update then replays one graph per
            batch size).

    Returns:
        ``(preds_dense, target_dense)`` numpy dicts: ``boxes (B, slots, 4)
        f32``, ``scores``/``labels`` ``(B, slots)``, optional
        ``iscrowd``/``area`` (emitted only when any input image carries
        them), and ``count (B,) i32``.
    """
    b = len(preds)
    if b != len(target):
        raise ValueError(f"preds describe {b} images but target {len(target)}")
    for side, items, required in (("preds", preds, ("boxes", "scores", "labels")),
                                  ("target", target, ("boxes", "labels"))):
        for i, item in enumerate(items):
            missing = [k for k in required if item.get(k) is None]
            if missing:
                raise ValueError(f"{side}[{i}] is missing required key(s) {missing}")
    nd = [int(np.shape(p["boxes"])[0]) if np.size(p["boxes"]) else 0 for p in preds]
    ng = [int(np.shape(t["boxes"])[0]) if np.size(t["boxes"]) else 0 for t in target]
    d_slots = pow2_slots(max(nd, default=0)) if det_slots is None else int(det_slots)
    g_slots = pow2_slots(max(ng, default=0)) if gt_slots is None else int(gt_slots)
    if max(nd, default=0) > d_slots or max(ng, default=0) > g_slots:
        raise ValueError(
            f"An image exceeds the slot budget: {max(nd, default=0)} dets / "
            f"{max(ng, default=0)} gts vs slots {d_slots}/{g_slots}"
        )
    for side, items in (("preds", preds), ("target", target)):
        for i, item in enumerate(items):
            labels = np.asarray(item["labels"])
            if labels.size and float(np.abs(labels).max()) > 2.0**24:
                raise ValueError(
                    f"{side}[{i}] labels exceed float32's exact-integer range "
                    "(2^24): distinct class ids would alias in the packed f32 "
                    "row layout.  Remap class ids below 2^24."
                )

    def fill(rows: List[int], items: Sequence[Dict], key: str, slots: int, dtype) -> np.ndarray:
        shape = (b, slots, 4) if key == "boxes" else (b, slots)
        out = np.zeros(shape, dtype)
        for i, item in enumerate(items):
            if rows[i] and item.get(key) is not None:
                val = np.asarray(item[key], dtype)
                out[i, : rows[i]] = val.reshape((rows[i], 4) if key == "boxes" else (rows[i],))
        return out

    preds_dense = {
        "boxes": fill(nd, preds, "boxes", d_slots, np.float32),
        "scores": fill(nd, preds, "scores", d_slots, np.float32),
        "labels": fill(nd, preds, "labels", d_slots, np.float32),
        "count": np.asarray(nd, np.int32),
    }
    target_dense = {
        "boxes": fill(ng, target, "boxes", g_slots, np.float32),
        "labels": fill(ng, target, "labels", g_slots, np.float32),
        "count": np.asarray(ng, np.int32),
    }
    if any(t.get("iscrowd") is not None for t in target):
        target_dense["iscrowd"] = fill(ng, target, "iscrowd", g_slots, np.float32)
    if any(t.get("area") is not None for t in target):
        target_dense["area"] = fill(ng, target, "area", g_slots, np.float32)
    return preds_dense, target_dense
