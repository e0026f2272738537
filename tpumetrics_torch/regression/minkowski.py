"""MinkowskiDistance (port of ``tpumetrics/regression/minkowski.py``)."""

from __future__ import annotations

from typing import Any

import torch

from tpumetrics_torch.functional.regression.minkowski import (
    _check_p,
    _minkowski_distance_compute,
    _minkowski_distance_update,
)
from tpumetrics_torch.metric import Metric

Tensor = torch.Tensor


class MinkowskiDistance(Metric):
    """Minkowski distance of order ``p``: a float32 sum of ``|p - t|^p``.

    Example:
        >>> import torch
        >>> from tpumetrics_torch.regression import MinkowskiDistance
        >>> metric = MinkowskiDistance(p=3, device="cpu")
        >>> metric.update(torch.tensor([0., 1, 2, 3]), torch.tensor([0., 2, 3, 1]))
        >>> round(float(metric.compute()), 4)
        2.1544
    """

    is_differentiable = True
    higher_is_better = False
    full_state_update = False

    minkowski_dist_sum: Tensor

    def __init__(self, p: float, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        _check_p(p)
        self.p = p
        self.add_state("minkowski_dist_sum", torch.zeros(()), dist_reduce_fx="sum")

    def update(self, preds: Tensor, targets: Tensor) -> None:
        self.minkowski_dist_sum = self.minkowski_dist_sum + _minkowski_distance_update(preds, targets, self.p)

    def compute(self) -> Tensor:
        return _minkowski_distance_compute(self.minkowski_dist_sum, self.p)
