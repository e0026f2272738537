"""HomogeneityScore, CompletenessScore and VMeasureScore (port of
``tpumetrics/clustering/homogeneity_completeness_v_measure.py``)."""

from __future__ import annotations

from typing import Any

import torch

from tpumetrics_torch.clustering.base import _LabelPairClusterMetric
from tpumetrics_torch.functional.clustering.homogeneity_completeness_v_measure import (
    completeness_score,
    homogeneity_score,
    v_measure_score,
)

Tensor = torch.Tensor


class HomogeneityScore(_LabelPairClusterMetric):
    """Homogeneity: each predicted cluster holds members of one class only.

    Example:
        >>> import torch
        >>> from tpumetrics_torch.clustering import HomogeneityScore
        >>> metric = HomogeneityScore(device="cpu")
        >>> round(float(metric(torch.tensor([0, 0, 1, 2]), torch.tensor([0, 0, 1, 1]))), 4)
        1.0
    """

    plot_lower_bound: float = 0.0
    plot_upper_bound: float = 1.0

    def compute(self) -> Tensor:
        preds, target, mask = self._catted()
        return homogeneity_score(preds, target, mask=mask, **self._class_spaces())


class CompletenessScore(_LabelPairClusterMetric):
    """Completeness: all members of a class land in one predicted cluster.

    Example:
        >>> import torch
        >>> from tpumetrics_torch.clustering import CompletenessScore
        >>> metric = CompletenessScore(device="cpu")
        >>> round(float(metric(torch.tensor([0, 0, 1, 2]), torch.tensor([0, 0, 1, 1]))), 4)
        0.6667
    """

    plot_lower_bound: float = 0.0
    plot_upper_bound: float = 1.0

    def compute(self) -> Tensor:
        preds, target, mask = self._catted()
        return completeness_score(preds, target, mask=mask, **self._class_spaces())


class VMeasureScore(_LabelPairClusterMetric):
    """V-measure: the harmonic mean of homogeneity and completeness.

    Args:
        beta: the weight of homogeneity in the harmonic mean.

    Example:
        >>> import torch
        >>> from tpumetrics_torch.clustering import VMeasureScore
        >>> metric = VMeasureScore(beta=1.0, device="cpu")
        >>> round(float(metric(torch.tensor([0, 0, 1, 2]), torch.tensor([0, 0, 1, 1]))), 4)
        0.8
    """

    plot_lower_bound: float = 0.0
    plot_upper_bound: float = 1.0

    def __init__(self, beta: float = 1.0, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        if not (isinstance(beta, (int, float)) and beta > 0):
            raise ValueError(f"Argument `beta` should be a positive float. Got {beta}.")
        self.beta = float(beta)

    def compute(self) -> Tensor:
        preds, target, mask = self._catted()
        return v_measure_score(preds, target, beta=self.beta, mask=mask, **self._class_spaces())
