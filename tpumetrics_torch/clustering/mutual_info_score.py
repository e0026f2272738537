"""MutualInfoScore (port of ``tpumetrics/clustering/mutual_info_score.py``)."""

from __future__ import annotations

import torch

from tpumetrics_torch.clustering.base import _LabelPairClusterMetric
from tpumetrics_torch.functional.clustering.mutual_info_score import mutual_info_score

Tensor = torch.Tensor


class MutualInfoScore(_LabelPairClusterMetric):
    """Mutual information between cluster assignments.

    Example:
        >>> import torch
        >>> from tpumetrics_torch.clustering import MutualInfoScore
        >>> preds = torch.tensor([2, 1, 0, 1, 0])
        >>> target = torch.tensor([0, 2, 1, 1, 0])
        >>> metric = MutualInfoScore(device="cpu")
        >>> round(float(metric(preds, target)), 4)
        0.5004
    """

    plot_lower_bound: float = 0.0

    def compute(self) -> Tensor:
        preds, target, mask = self._catted()
        return mutual_info_score(preds, target, mask=mask, **self._class_spaces())
