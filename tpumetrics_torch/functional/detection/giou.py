"""GIoU (port of ``tpumetrics/functional/detection/giou.py``)."""

from __future__ import annotations

from typing import Optional

import torch

from tpumetrics_torch.functional.detection._box_ops import generalized_box_iou

Tensor = torch.Tensor


def _giou_update(
    preds: Tensor, target: Tensor, iou_threshold: Optional[float], replacement_val: float = 0
) -> Tensor:
    iou = generalized_box_iou(preds, target)
    if iou_threshold is not None:
        iou = torch.where(iou < iou_threshold, torch.full_like(iou, replacement_val), iou)
    return iou


def _giou_compute(iou: Tensor, aggregate: bool = True) -> Tensor:
    if not aggregate:
        return iou
    return torch.diagonal(iou).mean() if iou.numel() > 0 else torch.zeros((), device=iou.device)


def generalized_intersection_over_union(
    preds: Tensor,
    target: Tensor,
    iou_threshold: Optional[float] = None,
    replacement_val: float = 0,
    aggregate: bool = True,
) -> Tensor:
    """Generalized IoU between two xyxy box sets (reference giou.py:41-118).

    Example:
        >>> import torch
        >>> from tpumetrics_torch.functional.detection import generalized_intersection_over_union
        >>> preds = torch.tensor([[296.55, 93.96, 314.97, 152.79]])
        >>> target = torch.tensor([[300.00, 100.00, 315.00, 150.00]])
        >>> round(float(generalized_intersection_over_union(preds, target)), 4)
        0.6895
    """
    iou = _giou_update(preds, target, iou_threshold, replacement_val)
    return _giou_compute(iou, aggregate)
