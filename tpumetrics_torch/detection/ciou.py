"""CompleteIntersectionOverUnion (port of ``tpumetrics/detection/ciou.py``)."""

from __future__ import annotations

from typing import Callable

from tpumetrics_torch.detection.iou import IntersectionOverUnion
from tpumetrics_torch.functional.detection.ciou import _ciou_compute, _ciou_update


class CompleteIntersectionOverUnion(IntersectionOverUnion):
    """CIoU accumulated over batches (reference detection/ciou.py).

    Example:
        >>> import torch
        >>> from tpumetrics_torch.detection import CompleteIntersectionOverUnion
        >>> preds = [dict(boxes=torch.tensor([[296.55, 93.96, 314.97, 152.79]]), labels=torch.tensor([4]))]
        >>> target = [dict(boxes=torch.tensor([[300.00, 100.00, 315.00, 150.00]]), labels=torch.tensor([4]))]
        >>> metric = CompleteIntersectionOverUnion(device="cpu")
        >>> metric.update(preds, target)
        >>> round(float(metric.compute()["ciou"]), 4)
        0.6883
    """

    _iou_type: str = "ciou"
    _invalid_val: float = -2.0  # CIoU is bounded in [-2, 1] (reference ciou.py)

    _iou_update_fn: Callable = staticmethod(_ciou_update)
    _iou_compute_fn: Callable = staticmethod(_ciou_compute)
