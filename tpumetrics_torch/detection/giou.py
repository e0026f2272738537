"""GeneralizedIntersectionOverUnion (port of ``tpumetrics/detection/giou.py``)."""

from __future__ import annotations

from typing import Callable

from tpumetrics_torch.detection.iou import IntersectionOverUnion
from tpumetrics_torch.functional.detection.giou import _giou_compute, _giou_update


class GeneralizedIntersectionOverUnion(IntersectionOverUnion):
    """GIoU accumulated over batches (reference detection/giou.py).

    Example:
        >>> import torch
        >>> from tpumetrics_torch.detection import GeneralizedIntersectionOverUnion
        >>> preds = [dict(boxes=torch.tensor([[296.55, 93.96, 314.97, 152.79]]), labels=torch.tensor([4]))]
        >>> target = [dict(boxes=torch.tensor([[300.00, 100.00, 315.00, 150.00]]), labels=torch.tensor([4]))]
        >>> metric = GeneralizedIntersectionOverUnion(device="cpu")
        >>> metric.update(preds, target)
        >>> round(float(metric.compute()["giou"]), 4)
        0.6895
    """

    _iou_type: str = "giou"

    _iou_update_fn: Callable = staticmethod(_giou_update)
    _iou_compute_fn: Callable = staticmethod(_giou_compute)
