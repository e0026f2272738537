"""IntersectionOverUnion (port of ``tpumetrics/detection/iou.py``)."""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence

import torch

from tpumetrics_torch.detection.helpers import _as_tensor, _fix_empty_tensors, _input_validator
from tpumetrics_torch.functional.detection._box_ops import box_convert
from tpumetrics_torch.functional.detection.iou import _iou_compute, _iou_update
from tpumetrics_torch.metric import Metric

Tensor = torch.Tensor


class IntersectionOverUnion(Metric):
    """IoU between per-image detection and ground-truth boxes, accumulated
    over batches (reference detection/iou.py:30-291). ``update`` appends one
    IoU matrix per image on the device; ``compute`` averages the valid
    entries.

    Args:
        box_format: input box format.
        iou_threshold: entries below the threshold count as the invalid value.
        class_metrics: include per-class scores in the output.
        respect_labels: only compare boxes of matching labels.

    Example:
        >>> import torch
        >>> from tpumetrics_torch.detection import IntersectionOverUnion
        >>> preds = [dict(boxes=torch.tensor([[296.55, 93.96, 314.97, 152.79]]), labels=torch.tensor([4]))]
        >>> target = [dict(boxes=torch.tensor([[300.00, 100.00, 315.00, 150.00]]), labels=torch.tensor([4]))]
        >>> metric = IntersectionOverUnion(device="cpu")
        >>> metric.update(preds, target)
        >>> round(float(metric.compute()["iou"]), 4)
        0.6898
    """

    is_differentiable: bool = False
    higher_is_better: bool = True
    full_state_update: bool = True

    _iou_type: str = "iou"
    _invalid_val: float = -1.0

    groundtruth_labels: List[Tensor]
    iou_matrix: List[Tensor]

    def __init__(
        self,
        box_format: str = "xyxy",
        iou_threshold: Optional[float] = None,
        class_metrics: bool = False,
        respect_labels: bool = True,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        allowed_box_formats = ("xyxy", "xywh", "cxcywh")
        if box_format not in allowed_box_formats:
            raise ValueError(f"Expected argument `box_format` to be one of {allowed_box_formats} but got {box_format}")
        self.box_format = box_format
        self.iou_threshold = iou_threshold
        if not isinstance(class_metrics, bool):
            raise ValueError("Expected argument `class_metrics` to be a boolean")
        self.class_metrics = class_metrics
        if not isinstance(respect_labels, bool):
            raise ValueError("Expected argument `respect_labels` to be a boolean")
        self.respect_labels = respect_labels

        self.add_state("groundtruth_labels", default=[], dist_reduce_fx=None)
        self.add_state("iou_matrix", default=[], dist_reduce_fx=None)

    _iou_update_fn: Callable = staticmethod(_iou_update)
    _iou_compute_fn: Callable = staticmethod(_iou_compute)

    def update(self, preds: Sequence[Dict[str, Tensor]], target: Sequence[Dict[str, Tensor]]) -> None:
        """Accumulate per-image IoU matrices (reference detection/iou.py:142-160)."""
        _input_validator(preds, target, ignore_score=True)
        for p, t in zip(preds, target):
            det_boxes = self._get_safe_item_values(p["boxes"])
            gt_boxes = self._get_safe_item_values(t["boxes"])
            gt_labels = _as_tensor(t["labels"], self.device)
            self.groundtruth_labels.append(gt_labels.to(torch.int32).reshape(-1))

            iou_matrix = type(self)._iou_update_fn(det_boxes, gt_boxes, self.iou_threshold, self._invalid_val)
            if self.respect_labels:
                label_eq = _as_tensor(p["labels"], self.device).reshape(-1, 1) == gt_labels.reshape(1, -1)
                iou_matrix = torch.where(label_eq, iou_matrix, torch.full_like(iou_matrix, self._invalid_val))
            self.iou_matrix.append(iou_matrix)

    def _get_safe_item_values(self, boxes: Any) -> Tensor:
        boxes = _fix_empty_tensors(_as_tensor(boxes, self.device, torch.float32))
        if boxes.numel() > 0:
            boxes = box_convert(boxes, in_fmt=self.box_format, out_fmt="xyxy")
        return boxes

    def compute(self) -> Dict[str, Tensor]:
        """Mean over valid matrix entries, plus optional per-class means (the
        entries of each class's ground-truth columns). Every image's entries
        are flattened into one tensor with their column's label first, so a
        class takes one selection, not one per image; the selected entries
        keep the per-image order, and so the per-image result."""
        zero = torch.zeros((), device=self.device)
        if self.iou_matrix:
            values = torch.cat([mat.reshape(-1) for mat in self.iou_matrix])
            labels = torch.cat([
                labels.reshape(1, -1).expand(mat.shape[0], -1).reshape(-1)
                for mat, labels in zip(self.iou_matrix, self.groundtruth_labels)
            ])
        else:
            values, labels = zero.new_zeros((0,)), zero.new_zeros((0,), dtype=torch.int32)
        valid = values != self._invalid_val
        all_entries = values[valid]
        score = all_entries.mean() if all_entries.numel() else zero
        results: Dict[str, Tensor] = {f"{self._iou_type}": score}

        if self.class_metrics:
            gt_labels = torch.cat(self.groundtruth_labels) if self.groundtruth_labels else zero.new_zeros((0,))
            classes = torch.unique(gt_labels).tolist() if gt_labels.numel() else []
            for cl in classes:
                vals = values[valid & (labels == cl)]
                results[f"{self._iou_type}/cl_{int(cl)}"] = vals.mean() if vals.numel() else zero
        return results
