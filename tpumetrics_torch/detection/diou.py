"""DistanceIntersectionOverUnion (port of ``tpumetrics/detection/diou.py``)."""

from __future__ import annotations

from typing import Callable

from tpumetrics_torch.detection.iou import IntersectionOverUnion
from tpumetrics_torch.functional.detection.diou import _diou_compute, _diou_update


class DistanceIntersectionOverUnion(IntersectionOverUnion):
    """DIoU accumulated over batches (reference detection/diou.py).

    Example:
        >>> import torch
        >>> from tpumetrics_torch.detection import DistanceIntersectionOverUnion
        >>> preds = [dict(boxes=torch.tensor([[296.55, 93.96, 314.97, 152.79]]), labels=torch.tensor([4]))]
        >>> target = [dict(boxes=torch.tensor([[300.00, 100.00, 315.00, 150.00]]), labels=torch.tensor([4]))]
        >>> metric = DistanceIntersectionOverUnion(device="cpu")
        >>> metric.update(preds, target)
        >>> round(float(metric.compute()["diou"]), 4)
        0.6883
    """

    _iou_type: str = "diou"

    _iou_update_fn: Callable = staticmethod(_diou_update)
    _iou_compute_fn: Callable = staticmethod(_diou_compute)
