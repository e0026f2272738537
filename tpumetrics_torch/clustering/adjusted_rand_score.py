"""AdjustedRandScore (port of ``tpumetrics/clustering/adjusted_rand_score.py``)."""

from __future__ import annotations

import torch

from tpumetrics_torch.clustering.base import _LabelPairClusterMetric
from tpumetrics_torch.functional.clustering.adjusted_rand_score import adjusted_rand_score

Tensor = torch.Tensor


class AdjustedRandScore(_LabelPairClusterMetric):
    """Chance-adjusted Rand score between cluster assignments.

    Example:
        >>> import torch
        >>> from tpumetrics_torch.clustering import AdjustedRandScore
        >>> metric = AdjustedRandScore(device="cpu")
        >>> round(float(metric(torch.tensor([0, 0, 1, 2]), torch.tensor([0, 0, 1, 1]))), 4)
        0.5714
    """

    plot_lower_bound: float = -0.5
    plot_upper_bound: float = 1.0

    def compute(self) -> Tensor:
        preds, target, mask = self._catted()
        return adjusted_rand_score(preds, target, mask=mask, **self._class_spaces())
