"""CIoU (port of ``tpumetrics/functional/detection/ciou.py``)."""

from __future__ import annotations

from typing import Optional

import torch

from tpumetrics_torch.functional.detection._box_ops import complete_box_iou

Tensor = torch.Tensor


def _ciou_update(
    preds: Tensor, target: Tensor, iou_threshold: Optional[float], replacement_val: float = 0
) -> Tensor:
    iou = complete_box_iou(preds, target)
    if iou_threshold is not None:
        iou = torch.where(iou < iou_threshold, torch.full_like(iou, replacement_val), iou)
    return iou


def _ciou_compute(iou: Tensor, aggregate: bool = True) -> Tensor:
    if not aggregate:
        return iou
    return torch.diagonal(iou).mean() if iou.numel() > 0 else torch.zeros((), device=iou.device)


def complete_intersection_over_union(
    preds: Tensor,
    target: Tensor,
    iou_threshold: Optional[float] = None,
    replacement_val: float = 0,
    aggregate: bool = True,
) -> Tensor:
    """Complete IoU between two xyxy box sets (reference ciou.py:41-118).

    Example:
        >>> import torch
        >>> from tpumetrics_torch.functional.detection import complete_intersection_over_union
        >>> preds = torch.tensor([[296.55, 93.96, 314.97, 152.79]])
        >>> target = torch.tensor([[300.00, 100.00, 315.00, 150.00]])
        >>> round(float(complete_intersection_over_union(preds, target)), 4)
        0.6883
    """
    iou = _ciou_update(preds, target, iou_threshold, replacement_val)
    return _ciou_compute(iou, aggregate)
