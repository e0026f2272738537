"""MeanAveragePrecision (port of ``tpumetrics/detection/mean_ap.py``).

States are per-image ragged lists (reduce ``None``, merged across ranks
with their image boundaries), or, for packed updates, flat row states with
the image id in the last column. ``compute`` routes as the JAX package
does: ``bbox`` without ``extended_summary`` runs the COCO protocol on the
states' device, in float64, bit for bit the numpy protocol
(:mod:`~tpumetrics_torch.detection._coco_eval_device`, whose greedy match is
the CUDA kernel ``ops.coco_match`` on a card); ``segm`` and
``extended_summary`` run the numpy protocol on the host
(:mod:`~tpumetrics_torch.detection._coco_eval`).
"""

from __future__ import annotations

import time
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from tpumetrics_torch.buffers import MaskedBuffer, _BufferList, buffer_overflowed, materialize
from tpumetrics_torch.detection import _coco_eval_device
from tpumetrics_torch.detection._coco_eval import coco_evaluate, precompute_geometries
from tpumetrics_torch.detection.helpers import _as_tensor, _input_validator
from tpumetrics_torch.metric import Metric
from tpumetrics_torch.utils.exceptions import TPUMetricsUserError

Tensor = torch.Tensor

#: packed-row layouts: one float32 row per detection / ground truth, the
#: image id last (-1 marks a pad row). float32 carries class ids, crowd
#: flags and image ids exactly below 2^24.
_DET_COLS = 7  # x1, y1, x2, y2, score, label, image id
_GT_COLS = 8  # x1, y1, x2, y2, label, iscrowd, area, image id

_RESULT_KEYS = (
    "map", "map_50", "map_75", "map_small", "map_medium", "map_large", "mar_small", "mar_medium", "mar_large",
)


def _torch_f32_linspace(start: float, end: float, steps: int) -> List[float]:
    """The reference's default thresholds, bit-for-bit.

    ``torch.linspace`` in float32 (reference mean_ap.py:396,402) anchors the
    first half at ``start`` and the second half at ``end`` and evaluates
    ``base ± i*step`` with a fused multiply-add (one rounding). The exact
    doubles matter: a recall of exactly 3/5 samples on the opposite side of
    recThr[60] depending on whether it is float32-0.6 (0.6000000238…) or a
    float64 0.6 — a whole precision column flips with it. Emulated here with
    exact f64 intermediates (i ≤ 2²⁴, step a f32 value → products and sums
    are exact in f64) and a single final cast.
    """
    if steps == 1:
        return [float(np.float32(start))]
    step = np.float64(np.float32((np.float32(end) - np.float32(start)) / np.float32(steps - 1)))
    i = np.arange(steps, dtype=np.float64)
    lo = np.float64(np.float32(start)) + i * step
    hi = np.float64(np.float32(end)) - (steps - 1 - i) * step
    vals = np.where(np.arange(steps) < steps // 2, lo, hi).astype(np.float32).astype(np.float64)
    return vals.tolist()


_PACKED_MERGE_ERROR = (
    "Packed detection rows from distinct id spaces were merged: per-rank "
    "packed states collide. Packed (dense) updates support a single logical "
    "stream (one process); use the list-of-dicts layout for per-rank DDP."
)


def _check_packed_chunk_order(chunk_ids: Sequence[np.ndarray]) -> None:
    """Across the per-update chunks of ONE logical stream, image ids must
    STRICTLY increase at every chunk boundary (each update's ids start past
    everything before it). A cat-merge of per-rank states restarts the id
    sequence — caught here even when a rank contributed a single image."""
    last = -1
    for ids in chunk_ids:
        ids = ids[ids >= 0]
        if not ids.size:
            continue
        if int(ids[0]) <= last:
            raise TPUMetricsUserError(_PACKED_MERGE_ERROR)
        last = int(ids[-1])


def _filter_packed_ids(ids: np.ndarray, n_imgs: int) -> np.ndarray:
    """Validate the image ids of fetched packed rows and return the mask of
    real rows (the list path's ``-1`` pad-sentinel rows dropped): ids are
    nondecreasing (rows of one logical stream always are) and in range."""
    keep = ids >= 0
    kept = ids[keep]
    if kept.size and np.any(np.diff(kept) < 0):
        raise TPUMetricsUserError(_PACKED_MERGE_ERROR)
    if kept.size and kept[-1] >= n_imgs:
        raise TPUMetricsUserError(
            f"Packed detection state is inconsistent: row image id {int(kept[-1])} >= recorded image count {n_imgs}."
        )
    return keep


def _check_label_range(labels: Tensor) -> None:
    """Class labels of the float32 row columns must lie inside its exact
    integer range (a larger label would have aliased: fail loudly)."""
    if labels.numel() and float(labels.abs().max()) > 2.0**24:
        raise TPUMetricsUserError(
            "Packed detection state holds class labels beyond the 2^24 exact-integer range of the float32 row"
            " columns — distinct classes may already have aliased. Use smaller class ids (or the list-of-dicts"
            " layout)."
        )


def _rle_encode_batch(masks: np.ndarray) -> tuple:
    """Column-major RLE encode an (N, H, W) boolean stack.

    Returns ``(flat_runs int32, nruns int32 (N,))`` — all masks' runs
    concatenated, plus the per-mask run count to split them back."""
    n = masks.shape[0]
    if n == 0:
        return np.zeros(0, np.int32), np.zeros(0, np.int32)
    flat_all = masks.transpose(0, 2, 1).reshape(n, -1)
    runs_list = []
    nruns = np.empty(n, np.int32)
    for i in range(n):
        f = flat_all[i]
        change = np.flatnonzero(f[1:] != f[:-1]) + 1
        starts = np.concatenate(([0], change, [f.size]))
        runs = np.diff(starts)
        if f.size and f[0]:
            runs = np.concatenate(([0], runs))
        runs_list.append(runs)
        nruns[i] = runs.shape[0]
    return np.concatenate(runs_list).astype(np.int32), nruns


def _host(x: Any) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, Tensor) else np.asarray(x)


class MeanAveragePrecision(Metric):
    """Mean Average Precision / Recall for object detection (COCO protocol).

    Inputs follow the reference's list-of-dicts format: per image,
    ``preds`` = {"boxes" (D, 4), "scores" (D,), "labels" (D,)} and
    ``target`` = {"boxes" (G, 4), "labels" (G,)} with optional ``iscrowd``
    and ``area`` keys, tensors on the metric's device (numpy arrays are
    copied there). With ``iou_type="segm"``, ``masks`` (N, H, W) boolean
    stacks replace ``boxes``; masks are RLE-encoded on the host at update and
    matched by mask IoU at compute.

    **Packed dense layout** (bbox only): each side of a batch may instead be
    ONE dict of ``(B, slots, ...)`` tensors plus a per-image ``count``, built
    by :func:`tpumetrics_torch.detection.packing.pack_detection_batch` and
    moved to the device, with an optional ``valid`` image mask. That update
    is a fixed-shape append into the packed row states (``det_rows``,
    ``gt_rows``, ``packed_imgs``) that reads nothing on the host, so a fused
    collection captures it as a CUDA graph (the row states as MaskedBuffers:
    ``interop.load_state(m, m.init_state())``), and lands on bit-identical
    results.

    Args:
        box_format: ``xyxy``/``xywh``/``cxcywh`` input box format.
        iou_type: ``bbox`` (box IoU), ``segm`` (instance-mask IoU), or a
            list/tuple of both — inputs then carry ``boxes`` AND ``masks``
            and every output key is prefixed ``bbox_``/``segm_``.
        iou_thresholds: IoU thresholds; defaults to COCO's 0.50:0.05:0.95.
        rec_thresholds: recall thresholds; defaults to COCO's 0:0.01:1.
        max_detection_thresholds: per-image detection caps (default 1/10/100).
        class_metrics: include per-class map/mar in the output.
        extended_summary: additionally return the per-(image, class) IoU
            matrices and the ``precision``/``recall`` tensors over
            (T, R, K, A, M) / (T, K, A, M).
        average: ``macro`` (COCO standard) or ``micro`` (classes pooled).
        backend: accepted for drop-in compatibility; both values select the
            built-in engine.
        det_capacity / gt_capacity: row capacities of the packed
            ``det_rows``/``gt_rows`` states as MaskedBuffers (``init_state``);
            overflow raises at ``compute`` rather than truncating. The eager
            path keeps unbounded lists and ignores these.

    Example:
        >>> import torch
        >>> from tpumetrics_torch.detection import MeanAveragePrecision
        >>> preds = [dict(boxes=torch.tensor([[258.0, 41.0, 606.0, 285.0]]),
        ...               scores=torch.tensor([0.536]), labels=torch.tensor([0]))]
        >>> target = [dict(boxes=torch.tensor([[214.0, 41.0, 562.0, 285.0]]),
        ...                labels=torch.tensor([0]))]
        >>> metric = MeanAveragePrecision(device="cpu")
        >>> metric.update(preds, target)
        >>> result = metric.compute()
        >>> round(float(result["map"]), 4)
        0.6
        >>> round(float(result["map_50"]), 4)
        1.0
    """

    is_differentiable: bool = False
    higher_is_better: bool = True
    full_state_update: bool = True
    plot_lower_bound: float = 0.0
    plot_upper_bound: float = 1.0

    detection_boxes: List[Tensor]
    detection_scores: List[Tensor]
    detection_labels: List[Tensor]
    detection_counts: List[Tensor]
    groundtruth_boxes: List[Tensor]
    groundtruth_labels: List[Tensor]
    groundtruth_crowds: List[Tensor]
    groundtruth_area: List[Tensor]
    groundtruth_counts: List[Tensor]
    # segm-only ragged mask state: column-major RLE runs, flattened with
    # per-mask run counts, so the generic ragged-list merge syncs masks too
    detection_mask_runs: List[Tensor]
    detection_mask_nruns: List[Tensor]
    groundtruth_mask_runs: List[Tensor]
    groundtruth_mask_nruns: List[Tensor]
    mask_sizes: List[Tensor]
    # packed state (bbox only): ``det_rows`` (N, 7) float32 (box in the input
    # format, score, label, image id), ``gt_rows`` (N, 8) (box, label,
    # crowd, area, image id), ``packed_imgs`` the images they describe. The
    # image id rides as the LAST COLUMN of the same buffer, so a merge or an
    # overflow can never de-align rows from their ids. On the eager path the
    # states are lists and pad rows carry image id -1 (dropped at compute),
    # so eager dense updates are as free of host reads as buffered ones.
    det_rows: List[Tensor]
    gt_rows: List[Tensor]
    packed_imgs: Tensor

    # the per-image list states only the list-of-dicts layout fills, and a
    # fused step never runs that layout (its arguments are lists): a fused
    # update carries them while they are empty
    _idle_list_states = frozenset((
        "detection_boxes", "detection_scores", "detection_labels", "detection_counts", "groundtruth_boxes",
        "groundtruth_labels", "groundtruth_crowds", "groundtruth_area", "groundtruth_counts",
    ))

    def __init__(
        self,
        box_format: str = "xyxy",
        iou_type: Union[str, Sequence[str]] = "bbox",
        iou_thresholds: Optional[List[float]] = None,
        rec_thresholds: Optional[List[float]] = None,
        max_detection_thresholds: Optional[List[int]] = None,
        class_metrics: bool = False,
        extended_summary: bool = False,
        average: str = "macro",
        backend: str = "pycocotools",
        det_capacity: int = 8192,
        gt_capacity: int = 8192,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)

        allowed_box_formats = ("xyxy", "xywh", "cxcywh")
        if box_format not in allowed_box_formats:
            raise ValueError(f"Expected argument `box_format` to be one of {allowed_box_formats} but got {box_format}")
        self.box_format = box_format
        iou_types = (iou_type,) if isinstance(iou_type, str) else tuple(iou_type)
        if (
            not iou_types
            or any(t not in ("bbox", "segm") for t in iou_types)
            or len(set(iou_types)) != len(iou_types)
        ):
            raise ValueError(
                f"Expected argument `iou_type` to be one of ('bbox', 'segm') or a list of distinct"
                f" entries, but got {iou_type}"
            )
        self.iou_type = iou_types[0] if len(iou_types) == 1 else iou_types
        self._iou_types = iou_types

        if iou_thresholds is not None and not isinstance(iou_thresholds, list):
            raise ValueError(
                f"Expected argument `iou_thresholds` to either be `None` or a list of floats but got {iou_thresholds}"
            )
        self.iou_thresholds = iou_thresholds or _torch_f32_linspace(0.5, 0.95, 10)

        if rec_thresholds is not None and not isinstance(rec_thresholds, list):
            raise ValueError(
                f"Expected argument `rec_thresholds` to either be `None` or a list of floats but got {rec_thresholds}"
            )
        self.rec_thresholds = rec_thresholds or _torch_f32_linspace(0.0, 1.0, 101)

        if max_detection_thresholds is not None and not isinstance(max_detection_thresholds, list):
            raise ValueError(
                f"Expected argument `max_detection_thresholds` to either be `None` or a list of ints"
                f" but got {max_detection_thresholds}"
            )
        self.max_detection_thresholds = sorted(max_detection_thresholds or [1, 10, 100])

        if not isinstance(class_metrics, bool):
            raise ValueError("Expected argument `class_metrics` to be a boolean")
        self.class_metrics = class_metrics
        if not isinstance(extended_summary, bool):
            raise ValueError("Expected argument `extended_summary` to be a boolean")
        self.extended_summary = extended_summary
        if average not in ("macro", "micro"):
            raise ValueError(f"Expected argument `average` to be one of ('macro', 'micro') but got {average}")
        self.average = average
        if backend not in ("pycocotools", "faster_coco_eval"):
            raise ValueError(
                f"Expected argument `backend` to be one of ('pycocotools', 'faster_coco_eval') but got {backend}"
            )
        self.backend = backend

        if not (isinstance(det_capacity, int) and isinstance(gt_capacity, int)) or min(det_capacity, gt_capacity) < 1:
            raise ValueError(
                f"Expected `det_capacity`/`gt_capacity` to be positive ints, got {det_capacity}/{gt_capacity}"
            )

        self.add_state("detection_scores", default=[], dist_reduce_fx=None)
        self.add_state("detection_labels", default=[], dist_reduce_fx=None)
        self.add_state("detection_counts", default=[], dist_reduce_fx=None)
        self.add_state("groundtruth_labels", default=[], dist_reduce_fx=None)
        self.add_state("groundtruth_crowds", default=[], dist_reduce_fx=None)
        self.add_state("groundtruth_area", default=[], dist_reduce_fx=None)
        self.add_state("groundtruth_counts", default=[], dist_reduce_fx=None)
        if "bbox" in iou_types:
            self.add_state("detection_boxes", default=[], dist_reduce_fx=None)
            self.add_state("groundtruth_boxes", default=[], dist_reduce_fx=None)
            self.add_state(
                "det_rows", default=[], dist_reduce_fx="cat",
                capacity=det_capacity, feature_shape=(_DET_COLS,), feature_dtype=torch.float32,
            )
            self.add_state(
                "gt_rows", default=[], dist_reduce_fx="cat",
                capacity=gt_capacity, feature_shape=(_GT_COLS,), feature_dtype=torch.float32,
            )
            self.add_state("packed_imgs", default=torch.zeros((), dtype=torch.int32), dist_reduce_fx="sum")
        if "segm" in iou_types:
            self.add_state("detection_mask_runs", default=[], dist_reduce_fx=None)
            self.add_state("detection_mask_nruns", default=[], dist_reduce_fx=None)
            self.add_state("groundtruth_mask_runs", default=[], dist_reduce_fx=None)
            self.add_state("groundtruth_mask_nruns", default=[], dist_reduce_fx=None)
            self.add_state("mask_sizes", default=[], dist_reduce_fx=None)

    def update(
        self,
        preds: Union[Sequence[Dict[str, Tensor]], Dict[str, Tensor]],
        target: Union[Sequence[Dict[str, Tensor]], Dict[str, Tensor]],
        valid: Optional[Tensor] = None,
    ) -> None:
        """Append one batch of detections and ground truths.

        Two input layouts:

        - **list-of-dicts**: one dict per image with ragged tensors, stored
          per image as given (numpy arrays copied to the device), with
          per-image counts and, for missing ``iscrowd``/``area``, zero
          placeholders (views of one zero tensor per update).
        - **packed dense dicts** (``preds``/``target`` each ONE dict of
          ``(B, slots, ...)`` tensors, see :func:`~tpumetrics_torch.detection.
          packing.pack_detection_batch`): a fixed-shape append into the packed
          row states with no host read. ``valid`` masks padded images.

        Matching waits for ``compute``."""
        if isinstance(preds, dict) or isinstance(target, dict):
            self._update_packed(preds, target, valid)
            return
        if valid is not None:
            raise TPUMetricsUserError(
                "`valid` only applies to packed (dict) detection batches; the list-of-dicts layout is always fully"
                " valid."
            )
        _input_validator(preds, target, iou_type=self.iou_type)
        if not preds:
            return

        dev = self.device
        # ALL validation happens before the first state append: a raising
        # update must leave no half-appended state behind
        if "bbox" in self._iou_types:
            dboxes = [self._boxes(p["boxes"]) for p in preds]
            dcounts = [int(b.shape[0]) for b in dboxes]
            gboxes = [self._boxes(t["boxes"]) for t in target]
            gcounts = [int(b.shape[0]) for b in gboxes]
        else:
            dcounts = [int(p["masks"].shape[0]) for p in preds]
            gcounts = [int(t["masks"].shape[0]) for t in target]
        if "segm" in self._iou_types:
            if "bbox" in self._iou_types:
                for i, (p, t, nd, ng) in enumerate(zip(preds, target, dcounts, gcounts)):
                    if int(p["masks"].shape[0]) != nd:
                        raise ValueError(
                            f"Sample {i}: prediction `boxes` and `masks` must describe the same"
                            f" detections, got {nd} boxes vs {int(p['masks'].shape[0])} masks"
                        )
                    if int(t["masks"].shape[0]) != ng:
                        raise ValueError(
                            f"Sample {i}: target `boxes` and `masks` must describe the same"
                            f" ground truths, got {ng} boxes vs {int(t['masks'].shape[0])} masks"
                        )
            self._append_masks(preds, target)

        if "bbox" in self._iou_types:
            self.detection_boxes.extend(dboxes)
            self.groundtruth_boxes.extend(gboxes)
        self.detection_scores.extend(_as_tensor(p["scores"], dev) for p in preds)
        self.detection_labels.extend(_as_tensor(p["labels"], dev) for p in preds)
        self.detection_counts.append(torch.tensor(dcounts, dtype=torch.int64, device=dev))
        self.groundtruth_labels.extend(_as_tensor(t["labels"], dev) for t in target)
        n_gt = sum(gcounts)
        no_crowd = torch.zeros(n_gt, dtype=torch.int64, device=dev).split(gcounts)
        no_area = torch.zeros(n_gt, dtype=torch.float32, device=dev).split(gcounts)
        self.groundtruth_crowds.extend(
            _as_tensor(t["iscrowd"], dev) if t.get("iscrowd") is not None else z for t, z in zip(target, no_crowd)
        )
        self.groundtruth_area.extend(
            _as_tensor(t["area"], dev) if t.get("area") is not None else z for t, z in zip(target, no_area)
        )
        self.groundtruth_counts.append(torch.tensor(gcounts, dtype=torch.int64, device=dev))

    def _boxes(self, boxes: Any) -> Tensor:
        """One image's boxes on the device; an empty input becomes (0, 4)."""
        boxes = _as_tensor(boxes, self.device)
        if boxes.numel() == 0 and boxes.ndim != 2:
            return torch.zeros((0, 4), dtype=torch.float32, device=self.device)
        return boxes

    # ------------------------------------------------- packed (device) path

    @staticmethod
    def _check_packed_shapes(side: str, d: Dict[str, Tensor], keys: tuple) -> tuple:
        """Shape-only validation of one dense dict; returns ``(B, slots)``."""
        for key in keys:
            if key not in d:
                raise ValueError(f"Packed {side} dict is missing the `{key}` key")
        boxes = d["boxes"]
        if getattr(boxes, "ndim", 0) != 3 or boxes.shape[-1] != 4:
            raise ValueError(f"Packed {side} `boxes` must have shape (B, slots, 4), got {tuple(np.shape(boxes))}")
        b, slots = boxes.shape[0], boxes.shape[1]
        for key in d:
            if key == "boxes":
                continue
            shape = tuple(np.shape(d[key]))
            want = (b,) if key == "count" else (b, slots)
            if shape != want:
                raise ValueError(f"Packed {side} `{key}` must have shape {want}, got {shape}")
        return b, slots

    def _update_packed(self, preds: Dict[str, Tensor], target: Dict[str, Tensor], valid: Optional[Tensor]) -> None:
        """One fixed-shape append of a packed dense batch: shape checks and
        device tensor math, no host read of the data (a host ``count`` is
        checked against the slots while it is host-readable)."""
        if not (isinstance(preds, dict) and isinstance(target, dict)):
            raise ValueError("Packed detection updates need BOTH `preds` and `target` as dense dicts")
        if self._iou_types != ("bbox",):
            raise TPUMetricsUserError(
                "Packed detection updates support iou_type='bbox' only; the RLE segm path needs host mask encode —"
                " use the list-of-dicts layout."
            )
        b, d_slots = self._check_packed_shapes("preds", preds, ("boxes", "scores", "labels"))
        bt, g_slots = self._check_packed_shapes("target", target, ("boxes", "labels"))
        if bt != b:
            raise ValueError(f"Packed preds describe {b} images but target {bt}")

        dev = self.device
        if valid is None:
            valid_b = torch.ones((b,), dtype=torch.bool, device=dev)
        else:
            valid_b = _as_tensor(valid, dev).to(torch.bool).reshape((b,))
        vi = valid_b.to(torch.int32)
        base = self.packed_imgs
        # compacted image ids: the j-th VALID image of this batch gets base + j
        ids = base + torch.cumsum(vi, 0, dtype=torch.int32) - 1

        def col(x: Any, slots: int, width: int = 1) -> Tensor:
            return _as_tensor(x, dev, torch.float32).reshape(b * slots, width)

        def rows_for(d: Dict[str, Any], slots: int, is_det: bool) -> Tuple[Tensor, Tensor]:
            count = d.get("count")
            if count is None:
                count = torch.full((b,), slots, dtype=torch.int32, device=dev)
            elif not isinstance(count, Tensor):
                # host counts (the pack_detection_batch output): a count past
                # the slot budget would mark zero-filled pad slots as real
                host_max = int(np.max(count)) if np.size(count) else 0
                if host_max > slots:
                    raise ValueError(f"Packed `count` claims {host_max} rows but the dict has only {slots} slots per image")
            # device counts are not value-checked (that would read the host); clamping keeps the rows in the slots
            count = torch.clamp(_as_tensor(count, dev), max=slots)
            rvalid = (torch.arange(slots, device=dev)[None, :] < count[:, None]) & valid_b[:, None]
            img_col = torch.where(rvalid, ids[:, None].to(torch.float32), torch.full((), -1.0, device=dev))
            cols = [col(d["boxes"], slots, 4), col(d["scores"] if is_det else d["labels"], slots)]
            if is_det:
                cols.append(col(d["labels"], slots))
            else:
                zeros = torch.zeros((b * slots, 1), dtype=torch.float32, device=dev)
                cols.append(zeros if d.get("iscrowd") is None else col(d["iscrowd"], slots))
                cols.append(zeros if d.get("area") is None else col(d["area"], slots))
            cols.append(img_col.reshape(b * slots, 1))
            return torch.cat(cols, dim=1), rvalid.reshape(b * slots)

        det_rows, det_valid = rows_for(preds, d_slots, is_det=True)
        gt_rows, gt_valid = rows_for(target, g_slots, is_det=False)
        self._append_packed("det_rows", det_rows, det_valid)
        self._append_packed("gt_rows", gt_rows, gt_valid)
        self.packed_imgs = base + vi.sum(dtype=torch.int32)

    def _append_packed(self, name: str, rows: Tensor, mask: Tensor) -> None:
        """Masked-compacted into a MaskedBuffer state; appended whole to a list
        state, where the ``-1`` image id already marks pad rows (a boolean
        compaction would read the host)."""
        val = getattr(self, name)
        if isinstance(val, _BufferList):
            val.append(rows, valid=mask)
        else:
            val.append(rows)

    @staticmethod
    def coco_to_tm(
        coco_preds: str,
        coco_target: str,
        iou_type: str = "bbox",
        backend: str = "pycocotools",
    ):
        """Convert COCO-format json files into this metric's input format
        (reference mean_ap.py:612-719, without pycocotools: the files are plain
        json). Boxes come back in COCO's xywh layout — construct the metric with
        ``box_format="xywh"`` — and segm masks must be uncompressed-RLE dicts.
        ``backend`` is accepted and ignored, like the constructor's.

        Returns:
            ``(preds, target)`` lists of per-image dicts of CPU tensors.
        """
        import json

        if iou_type not in ("bbox", "segm"):
            raise ValueError(f"Expected argument `iou_type` to be bbox or segm, got {iou_type}")
        if backend not in ("pycocotools", "faster_coco_eval"):
            raise ValueError(f"Expected argument `backend` to be `pycocotools` or `faster_coco_eval`, got {backend}")
        with open(coco_target) as fh:
            gt_data = json.load(fh)
        with open(coco_preds) as fh:
            dt_anns = json.load(fh)
        if isinstance(dt_anns, dict):
            dt_anns = dt_anns.get("annotations", [])
        gt_anns = gt_data.get("annotations") if isinstance(gt_data, dict) else gt_data
        if not isinstance(gt_anns, list):
            raise ValueError(
                "coco_target must be a COCO dataset dict with an `annotations` list or a bare annotation list"
            )
        # one entry per image for BOTH sides, in one shared order: gt images
        # without detections (and vice versa) get empty entries
        image_ids = sorted(
            {img["id"] for img in (gt_data.get("images", []) if isinstance(gt_data, dict) else [])}
            | {a["image_id"] for a in gt_anns}
            | {a["image_id"] for a in dt_anns}
        )

        def decode_mask(ann):
            seg = ann.get("segmentation")
            if not (isinstance(seg, dict) and isinstance(seg.get("counts"), (list, tuple))):
                raise NotImplementedError(
                    "coco_to_tm supports uncompressed-RLE segmentations only (dict with a list `counts`); compressed"
                    " strings and polygons need pycocotools."
                )
            h, w = seg["size"]
            flat = np.repeat(np.arange(len(seg["counts"])) % 2, np.asarray(seg["counts"], np.int64)).astype(bool)
            return flat.reshape(w, h).T  # column-major, like COCO

        def group(anns, with_scores):
            by_img: Dict[int, Dict[str, list]] = {
                i: {"labels": [], "scores": [], "iscrowd": [], "area": [], "boxes": [], "masks": []}
                for i in image_ids
            }
            for a in anns:
                entry = by_img[a["image_id"]]
                entry["labels"].append(a["category_id"])
                if with_scores:
                    entry["scores"].append(a["score"])
                else:
                    entry["iscrowd"].append(a.get("iscrowd", 0))
                    entry["area"].append(a.get("area", 0))
                if iou_type == "bbox":
                    entry["boxes"].append(a["bbox"])
                else:
                    entry["masks"].append(decode_mask(a))
            out = []
            for img_id in image_ids:
                e = by_img[img_id]
                d = {"labels": torch.as_tensor(np.asarray(e["labels"], np.int64))}
                if iou_type == "bbox":
                    d["boxes"] = torch.as_tensor(np.asarray(e["boxes"], np.float32).reshape(-1, 4))
                else:
                    d["masks"] = torch.as_tensor(np.stack(e["masks"]) if e["masks"] else np.zeros((0, 0, 0), bool))
                if with_scores:
                    d["scores"] = torch.as_tensor(np.asarray(e["scores"], np.float32))
                else:
                    d["iscrowd"] = torch.as_tensor(np.asarray(e["iscrowd"], np.int64))
                    d["area"] = torch.as_tensor(np.asarray(e["area"], np.float32))
                out.append(d)
            return out

        return group(dt_anns, True), group(gt_anns, False)

    def tm_to_coco(self, name: str = "tm_map_input") -> None:
        """Dump the accumulated state as COCO-format json
        (``{name}_preds.json`` / ``{name}_target.json``; reference
        mean_ap.py:721-792)."""
        import json

        if "bbox" not in self._iou_types:
            raise NotImplementedError(
                "tm_to_coco currently exports bbox states (segm export needs a compressed-RLE writer to be readable"
                " by pycocotools)."
            )
        if len(self.det_rows) or len(self.gt_rows):
            raise NotImplementedError(
                "tm_to_coco exports the per-image list states; this metric holds packed (dense-update) rows. Use the"
                " list-of-dicts update layout for COCO export."
            )
        gcounts = torch.cat(self.groundtruth_counts).cpu().numpy() if self.groundtruth_counts else np.zeros(0, int)

        def xywh(b):
            b = np.asarray(b, np.float64).reshape(-1, 4)
            return np.stack([b[:, 0], b[:, 1], b[:, 2] - b[:, 0], b[:, 3] - b[:, 1]], 1)

        def converted(boxes):
            return self._convert_boxes(_as_tensor(boxes, self.device).reshape(-1, 4)).cpu().numpy()

        images = [{"id": i} for i in range(len(gcounts))]
        ann_id = 1
        target_anns = []
        for img, (boxes, labels, crowds, areas) in enumerate(
            zip(self.groundtruth_boxes, self.groundtruth_labels, self.groundtruth_crowds, self.groundtruth_area)
        ):
            for b, lab, c, a in zip(xywh(converted(boxes)), _host(labels).reshape(-1), _host(crowds).reshape(-1),
                                    _host(areas).reshape(-1)):
                target_anns.append({
                    "id": ann_id, "image_id": img, "bbox": [float(v) for v in b],
                    "area": float(a) if a > 0 else float(b[2] * b[3]),
                    "category_id": int(lab), "iscrowd": int(c),
                })
                ann_id += 1
        pred_anns = []
        ann_id = 1
        for img, (boxes, labels, scores) in enumerate(
            zip(self.detection_boxes, self.detection_labels, self.detection_scores)
        ):
            for b, lab, s in zip(xywh(converted(boxes)), _host(labels).reshape(-1), _host(scores).reshape(-1)):
                pred_anns.append({
                    "id": ann_id, "image_id": img, "bbox": [float(v) for v in b],
                    "area": float(b[2] * b[3]), "category_id": int(lab), "score": float(s),
                })
                ann_id += 1
        classes = sorted({a["category_id"] for a in target_anns + pred_anns})
        target_dataset = {"images": images, "annotations": target_anns,
                          "categories": [{"id": c, "name": str(c)} for c in classes]}
        with open(f"{name}_preds.json", "w") as fh:
            json.dump(pred_anns, fh, indent=4)
        with open(f"{name}_target.json", "w") as fh:
            json.dump(target_dataset, fh, indent=4)

    def _convert_boxes(self, boxes: Tensor) -> Tensor:
        """Convert ``(N, 4)`` boxes to float64 xyxy on their device.

        Bit-faithful to the reference's primary path: boxes pass through
        float32 xywh (reference mean_ap.py:803-812 ``box_convert(...,
        out_fmt='xywh')`` on f32 tensors) and the xyxy extents are rebuilt in
        float64 as ``x + w`` — exactly what pycocotools' double-precision IoU
        sees. Skipping the f32 xywh rounding shifts IoUs by ~1e-8, enough to
        flip matches that land on an IoU threshold. Each step is an IEEE
        elementwise op, so the card gives the host's bits."""
        b = boxes.to(torch.float32).reshape(-1, 4)
        if self.box_format == "xyxy":
            xywh = torch.stack([b[:, 0], b[:, 1], b[:, 2] - b[:, 0], b[:, 3] - b[:, 1]], dim=1)
        elif self.box_format == "xywh":
            xywh = b
        else:  # cxcywh
            xywh = torch.stack([b[:, 0] - b[:, 2] / 2, b[:, 1] - b[:, 3] / 2, b[:, 2], b[:, 3]], dim=1)
        x, y, w, h = xywh.to(torch.float64).unbind(1)
        return torch.stack([x, y, x + w, y + h], dim=1)

    def _unpack_mask_geoms(self, dcounts, gcounts):
        """Rebuild per-image ``((h, w), [runs per mask])`` geometries from the
        run states (the inverse of :meth:`_append_masks`)."""

        def flat(states) -> np.ndarray:
            return torch.cat(list(states)).cpu().numpy() if states else np.zeros(0, np.int32)

        d_runs_flat, d_nruns = flat(self.detection_mask_runs), flat(self.detection_mask_nruns)
        g_runs_flat, g_nruns = flat(self.groundtruth_mask_runs), flat(self.groundtruth_mask_nruns)
        sizes = flat(self.mask_sizes).reshape(-1, 2)
        d_masks = np.split(d_runs_flat, np.cumsum(d_nruns)[:-1]) if d_nruns.size else []
        g_masks = np.split(g_runs_flat, np.cumsum(g_nruns)[:-1]) if g_nruns.size else []
        det_geoms, gt_geoms = [], []
        d_pos = g_pos = 0
        for i in range(len(dcounts)):
            h, w = int(sizes[i, 0]), int(sizes[i, 1])
            dc, gc = int(dcounts[i]), int(gcounts[i])
            det_geoms.append(((h, w), d_masks[d_pos : d_pos + dc]))
            gt_geoms.append(((h, w), g_masks[g_pos : g_pos + gc]))
            d_pos += dc
            g_pos += gc
        return det_geoms, gt_geoms

    def _append_masks(self, preds, target) -> None:
        """RLE-encode one batch of instance masks on the host and append flat
        run states (int32 on the metric's device, so the generic ragged-list
        merge syncs them). Everything is validated and encoded BEFORE the
        first state append, so a bad input leaves no half-appended state."""
        pred_masks = [_host(p["masks"]).astype(bool) for p in preds]
        target_masks = [_host(t["masks"]).astype(bool) for t in target]
        sizes = []
        for i, (pm, tm) in enumerate(zip(pred_masks, target_masks)):
            for side, m in (("preds", pm), ("target", tm)):
                # non-3D is only acceptable as a fully-empty stack with a zero leading dim
                if m.ndim != 3 and (m.ndim == 0 or m.shape[0] != 0):
                    raise ValueError(
                        f"Expected `masks` of sample {i} in {side} to have shape (num_masks, H, W), but got {m.shape}"
                    )
            ph, pw = (pm.shape[-2], pm.shape[-1]) if pm.ndim == 3 and pm.shape[0] else (0, 0)
            th, tw = (tm.shape[-2], tm.shape[-1]) if tm.ndim == 3 and tm.shape[0] else (0, 0)
            if ph and th and (ph, pw) != (th, tw):
                raise ValueError(
                    f"Prediction and target masks of one image have different sizes: {(ph, pw)} vs {(th, tw)}"
                )
            sizes.append((max(ph, th), max(pw, tw)))

        staged = []
        for stacks in (pred_masks, target_masks):
            flats, nruns = [], []
            for masks in stacks:
                if masks.ndim != 3:
                    masks = masks.reshape((0, 0, 0))
                f, n = _rle_encode_batch(masks)
                flats.append(f)
                nruns.append(n)
            staged.append((np.concatenate(flats) if flats else np.zeros(0, np.int32),
                           np.concatenate(nruns) if nruns else np.zeros(0, np.int32)))

        def dev(x: np.ndarray) -> Tensor:
            return torch.as_tensor(x, dtype=torch.int32, device=self.device)

        self.mask_sizes.append(dev(np.asarray(sizes, np.int32).reshape(-1, 2)))
        self.detection_mask_runs.append(dev(staged[0][0]))
        self.detection_mask_nruns.append(dev(staged[0][1]))
        self.groundtruth_mask_runs.append(dev(staged[1][0]))
        self.groundtruth_mask_nruns.append(dev(staged[1][1]))

    # ---------------------------------------------------------------- compute

    def _packed_rows(self, name: str, cols: int) -> Tuple[Tensor, List[int]]:
        """A packed row state as one ``(rows, cols)`` tensor and its chunk
        sizes (one chunk per eager update; a MaskedBuffer is one chunk)."""
        val = getattr(self, name)
        if isinstance(val, _BufferList):
            val = val.buffer
        if isinstance(val, MaskedBuffer):
            chunks = [materialize(val)]
        else:
            chunks = [c.reshape(-1, cols) for c in val]
        if not chunks:
            return torch.zeros((0, cols), dtype=torch.float32, device=self.device), []
        return torch.cat(chunks).to(torch.float32), [c.shape[0] for c in chunks]

    def _gather_rows(self) -> Tuple[dict, dict, int, np.ndarray, np.ndarray]:
        """Every image's detections and ground truths as flat rows on the
        device, list images first, then the packed ones: ``(det, gt,
        num_imgs, dcounts, gcounts)`` with ``det`` = {boxes (raw, float32),
        scores, labels, img} and ``gt`` = {boxes, labels, crowds, area, img}
        (per-image counts on the host; boxes absent for segm-only)."""
        dev = self.device
        bbox = "bbox" in self._iou_types
        counts = [*self.detection_counts, *self.groundtruth_counts]
        if counts:
            host = torch.cat(counts).cpu().numpy()
            n_det_updates = sum(c.numel() for c in self.detection_counts)
            dcounts, gcounts = host[:n_det_updates].astype(np.int64), host[n_det_updates:].astype(np.int64)
        else:
            dcounts = gcounts = np.zeros(0, np.int64)
        num_list = len(dcounts)

        def cat(states, dtype, width=None) -> Tensor:
            shape = (-1,) if width is None else (-1, width)
            if not states:
                return torch.zeros((0,) if width is None else (0, width), dtype=dtype, device=dev)
            return torch.cat([s.reshape(shape) for s in states]).to(dtype)

        def img_ids(c: np.ndarray) -> Tensor:
            return torch.repeat_interleave(
                torch.arange(len(c), device=dev), torch.as_tensor(c, device=dev), output_size=int(c.sum())
            )

        det = {
            "scores": cat(self.detection_scores, torch.float32),
            "labels": cat(self.detection_labels, torch.int64),
            "img": img_ids(dcounts),
        }
        gt = {
            "labels": cat(self.groundtruth_labels, torch.int64),
            "crowds": cat(self.groundtruth_crowds, torch.int64),
            "area": cat(self.groundtruth_area, torch.float32),
            "img": img_ids(gcounts),
        }
        n_packed = 0
        if bbox:
            det["boxes"] = cat(self.detection_boxes, torch.float32, 4)
            gt["boxes"] = cat(self.groundtruth_boxes, torch.float32, 4)
            d_rows, d_chunks = self._packed_rows("det_rows", _DET_COLS)
            g_rows, g_chunks = self._packed_rows("gt_rows", _GT_COLS)
            n_packed = int(self.packed_imgs)
            if n_packed > 2**24:
                raise TPUMetricsUserError(
                    f"Packed detection state describes {n_packed} images, past the 2^24 exact-integer range of the"
                    " float32 image-id column — ids would alias and mAP would be silently wrong. Compute/reset in"
                    " smaller windows, or use the list-of-dicts layout."
                )
            if n_packed or d_rows.shape[0] or g_rows.shape[0]:
                ids_h = torch.cat([d_rows[:, -1], g_rows[:, -1]]).cpu().numpy()
                ids_h = np.rint(ids_h).astype(np.int64)
                d_ids, g_ids = ids_h[: d_rows.shape[0]], ids_h[d_rows.shape[0]:]
                for ids, chunks in ((d_ids, d_chunks), (g_ids, g_chunks)):
                    # one update = one chunk: ids must strictly increase across chunk boundaries
                    _check_packed_chunk_order(np.split(ids, np.cumsum(chunks)[:-1]) if chunks else [])
                d_keep, g_keep = _filter_packed_ids(d_ids, n_packed), _filter_packed_ids(g_ids, n_packed)
                d_rows = d_rows[torch.as_tensor(d_keep, device=dev)]
                g_rows = g_rows[torch.as_tensor(g_keep, device=dev)]
                _check_label_range(torch.cat([d_rows[:, 5], g_rows[:, 4]]))
                dcounts = np.concatenate([dcounts, np.bincount(d_ids[d_keep], minlength=n_packed)])
                gcounts = np.concatenate([gcounts, np.bincount(g_ids[g_keep], minlength=n_packed)])
                offset = torch.as_tensor(num_list, device=dev)
                det = {
                    "boxes": torch.cat([det["boxes"], d_rows[:, :4]]),
                    "scores": torch.cat([det["scores"], d_rows[:, 4]]),
                    "labels": torch.cat([det["labels"], torch.round(d_rows[:, 5]).to(torch.int64)]),
                    "img": torch.cat([det["img"], torch.round(d_rows[:, 6]).to(torch.int64) + offset]),
                }
                gt = {
                    "boxes": torch.cat([gt["boxes"], g_rows[:, :4]]),
                    "labels": torch.cat([gt["labels"], torch.round(g_rows[:, 4]).to(torch.int64)]),
                    "crowds": torch.cat([gt["crowds"], torch.round(g_rows[:, 5]).to(torch.int64)]),
                    "area": torch.cat([gt["area"], g_rows[:, 6]]),
                    "img": torch.cat([gt["img"], torch.round(g_rows[:, 7]).to(torch.int64) + offset]),
                }
        return det, gt, num_list + n_packed, dcounts, gcounts

    def compute(self) -> Dict[str, Any]:
        """Run the COCO protocol over the accumulated images (see the module
        note for the routes). Outputs are float32 tensors on the metric's
        device (``classes`` int32); with ``extended_summary`` the ``ious``
        dict stays host numpy."""
        types = self._iou_types
        self._check_packed_overflow()
        t0 = time.perf_counter()
        det, gt, num_imgs, dcounts, gcounts = self._gather_rows()
        labels = torch.cat([det["labels"], gt["labels"]])
        class_ids = torch.unique(labels).tolist() if labels.numel() else []
        if "bbox" in types:
            det["xyxy"], gt["xyxy"] = self._convert_boxes(det["boxes"]), self._convert_boxes(gt["boxes"])
        t0 = _coco_eval_device.stage_mark(self.device, "conversion", t0)

        max_det = self.max_detection_thresholds[-1]
        staged: Dict[str, Any] = {}
        np_only: Dict[str, Any] = {}
        host = None  # the per-image host tuples, built once if a host route needs them
        for i_type in types:
            # prefix outputs only when evaluating both geometries at once, like the reference
            prefix = "" if len(types) == 1 else f"{i_type}_"
            if i_type == "bbox" and not self.extended_summary:
                rows = (
                    (det["xyxy"], det["scores"], det["labels"], det["img"]),
                    (gt["xyxy"], gt["labels"], gt["crowds"], gt["area"].to(torch.float64), gt["img"]),
                )
                result = self._evaluate_device(rows, num_imgs, class_ids, self.average)
                per_class = (self._evaluate_device(rows, num_imgs, class_ids, "macro")
                             if self.class_metrics and self.average == "micro" else result)
            else:
                if host is None:
                    host = self._host_images(det, gt, dcounts, gcounts, num_imgs)
                detections, groundtruths = self._host_tuples(host, i_type, dcounts, gcounts)
                geom_cache = precompute_geometries(detections, groundtruths, i_type)
                result = self._evaluate_host(detections, groundtruths, class_ids, i_type, self.average, geom_cache,
                                             extended=self.extended_summary)
                per_class = (self._evaluate_host(detections, groundtruths, class_ids, i_type, "macro", geom_cache)
                             if self.class_metrics and self.average == "micro" else result)
            if self.extended_summary:
                np_only[f"{prefix}ious"] = {k: np.asarray(v, np.float32) for k, v in result["ious"].items()}
                staged[f"{prefix}precision"] = np.asarray(result["precision"], np.float32)
                staged[f"{prefix}recall"] = np.asarray(result["recall"], np.float32)
            for key in (*_RESULT_KEYS, *(f"mar_{m}" for m in self.max_detection_thresholds)):
                staged[f"{prefix}{key}"] = np.asarray(result[key], np.float32)
            if self.class_metrics:
                staged[f"{prefix}map_per_class"] = np.asarray(per_class["map_per_class"], np.float32)
                staged[f"{prefix}mar_{max_det}_per_class"] = np.asarray(per_class["mar_per_class"], np.float32)
            else:
                staged[f"{prefix}map_per_class"] = np.asarray(-1.0, np.float32)
                staged[f"{prefix}mar_{max_det}_per_class"] = np.asarray(-1.0, np.float32)
        staged["classes"] = np.asarray(class_ids, np.int32)
        out: Dict[str, Any] = {k: torch.as_tensor(v, device=self.device) for k, v in staged.items()}
        out.update(np_only)
        return out

    def _evaluate_device(self, rows, num_imgs: int, class_ids: List[int], average: str) -> Dict[str, Any]:
        return _coco_eval_device.coco_evaluate_rows(
            rows[0], rows[1], num_imgs, self.iou_thresholds, self.rec_thresholds, self.max_detection_thresholds,
            class_ids, average=average,
        )

    def _evaluate_host(self, detections, groundtruths, class_ids, i_type, average, geom_cache, extended=False):
        return coco_evaluate(
            detections, groundtruths, self.iou_thresholds, self.rec_thresholds, self.max_detection_thresholds,
            class_ids, average=average, iou_type=i_type, geom_cache=geom_cache, extended=extended,
        )

    @staticmethod
    def _host_images(det: dict, gt: dict, dcounts: np.ndarray, gcounts: np.ndarray, num_imgs: int) -> dict:
        """The flat rows fetched to the host and split per image (rows of one
        image are contiguous and in image order)."""

        def split(x: Tensor, counts: np.ndarray) -> List[np.ndarray]:
            x = x.cpu().numpy()
            return np.split(x, np.cumsum(counts)[:-1]) if num_imgs else []

        out = {f"det_{k}": split(det[k], dcounts) for k in ("scores", "labels") if k in det}
        out.update({f"gt_{k}": split(gt[k], gcounts) for k in ("labels", "crowds", "area")})
        if "xyxy" in det:
            out["det_xyxy"], out["gt_xyxy"] = split(det["xyxy"], dcounts), split(gt["xyxy"], gcounts)
        return out

    def _host_tuples(self, host: dict, i_type: str, dcounts, gcounts) -> Tuple[list, list]:
        """Per-image ``(geometry, scores, labels)`` / ``(geometry, labels,
        iscrowd, area)`` tuples of the numpy protocol."""
        if i_type == "bbox":
            det_geoms, gt_geoms = host["det_xyxy"], host["gt_xyxy"]
        else:
            det_geoms, gt_geoms = self._unpack_mask_geoms(dcounts, gcounts) if len(dcounts) else ([], [])
        detections = [(g, s, lab) for g, s, lab in zip(det_geoms, host["det_scores"], host["det_labels"])]
        groundtruths = [
            (g, lab, c, a) for g, lab, c, a in zip(gt_geoms, host["gt_labels"], host["gt_crowds"], host["gt_area"])
        ]
        return detections, groundtruths

    def _sync_state_collect_inner(self, state, backend, reducer, group, out, pending):
        """Refuse a cross-rank sync while packed rows exist: a cat-merge would
        concatenate independent per-rank image-id spaces, which is wrong (and
        a compacted buffer could hide the collision). Per-rank DDP uses the
        list-of-dicts layout."""
        try:
            world = int(backend.world_size())
        except Exception:
            world = 1
        if world > 1 and "bbox" in self._iou_types and self._packed_rows_present(state):
            raise TPUMetricsUserError(
                "Packed detection state cannot sync across eager ranks: per-rank image-id spaces would collide in"
                " the cat-merge. Use the list-of-dicts update layout for DDP."
            )
        return super()._sync_state_collect_inner(state, backend, reducer, group, out, pending)

    @staticmethod
    def _packed_rows_present(state) -> bool:
        for name in ("det_rows", "gt_rows"):
            val = state.get(name)
            if isinstance(val, _BufferList):
                val = val.buffer
            if isinstance(val, MaskedBuffer):
                if int(val.count) > 0:  # a sync reads the host anyway
                    return True
            elif isinstance(val, list) and val:
                return True
        return False

    def _check_packed_overflow(self) -> None:
        """A packed MaskedBuffer that dropped rows must fail loudly: mAP over
        silently truncated detections is a wrong number, not an estimate."""
        if "bbox" not in self._iou_types:
            return
        for name in ("det_rows", "gt_rows"):
            val = getattr(self, name)
            if isinstance(val, _BufferList):
                val = val.buffer
            if isinstance(val, MaskedBuffer) and bool(buffer_overflowed(val)):
                raise TPUMetricsUserError(
                    f"Packed detection state {name!r} overflowed its declared capacity {val.capacity}"
                    f" ({int(val.requested)} rows requested) — rows were dropped and mAP would be silently wrong."
                    " Raise `det_capacity`/`gt_capacity`."
                )
