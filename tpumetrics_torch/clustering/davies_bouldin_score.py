"""DaviesBouldinScore (port of ``tpumetrics/clustering/davies_bouldin_score.py``)."""

from __future__ import annotations

import torch

from tpumetrics_torch.clustering.base import _IntrinsicClusterMetric
from tpumetrics_torch.functional.clustering.davies_bouldin_score import davies_bouldin_score

Tensor = torch.Tensor


class DaviesBouldinScore(_IntrinsicClusterMetric):
    """Davies-Bouldin score of a clustering (lower is better).

    Example:
        >>> import torch
        >>> from tpumetrics_torch.clustering import DaviesBouldinScore
        >>> data = torch.tensor([[0., 0], [1.1, 0], [0, 1], [2, 2], [2.2, 2.1], [2, 2.2]])
        >>> labels = torch.tensor([0, 0, 0, 1, 1, 1])
        >>> metric = DaviesBouldinScore(device="cpu")
        >>> round(float(metric(data, labels)), 4)
        0.3311
    """

    higher_is_better: bool = False
    plot_lower_bound: float = 0.0

    def compute(self) -> Tensor:
        data, labels, mask = self._catted()
        return davies_bouldin_score(data, labels, num_labels=self.num_labels, mask=mask)
