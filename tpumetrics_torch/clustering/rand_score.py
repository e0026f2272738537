"""RandScore (port of ``tpumetrics/clustering/rand_score.py``)."""

from __future__ import annotations

import torch

from tpumetrics_torch.clustering.base import _LabelPairClusterMetric
from tpumetrics_torch.functional.clustering.rand_score import rand_score

Tensor = torch.Tensor


class RandScore(_LabelPairClusterMetric):
    """Rand score between cluster assignments.

    Example:
        >>> import torch
        >>> from tpumetrics_torch.clustering import RandScore
        >>> metric = RandScore(device="cpu")
        >>> round(float(metric(torch.tensor([2, 1, 0, 1, 0]), torch.tensor([0, 2, 1, 1, 0]))), 4)
        0.6
    """

    plot_lower_bound: float = 0.0

    def compute(self) -> Tensor:
        preds, target, mask = self._catted()
        return rand_score(preds, target, mask=mask, **self._class_spaces())
