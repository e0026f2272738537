"""CalinskiHarabaszScore (port of ``tpumetrics/clustering/calinski_harabasz_score.py``)."""

from __future__ import annotations

import torch

from tpumetrics_torch.clustering.base import _IntrinsicClusterMetric
from tpumetrics_torch.functional.clustering.calinski_harabasz_score import calinski_harabasz_score

Tensor = torch.Tensor


class CalinskiHarabaszScore(_IntrinsicClusterMetric):
    """Calinski-Harabasz (variance-ratio) score of a clustering.

    Example:
        >>> import torch
        >>> from tpumetrics_torch.clustering import CalinskiHarabaszScore
        >>> data = torch.tensor([[0., 0], [1.1, 0], [0, 1], [2, 2], [2.2, 2.1], [2, 2.2]])
        >>> labels = torch.tensor([0, 0, 0, 1, 1, 1])
        >>> metric = CalinskiHarabaszScore(device="cpu")
        >>> round(float(metric(data, labels)), 2)
        23.73
    """

    plot_lower_bound: float = 0.0

    def compute(self) -> Tensor:
        data, labels, mask = self._catted()
        return calinski_harabasz_score(data, labels, num_labels=self.num_labels, mask=mask)
