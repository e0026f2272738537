"""DunnIndex (port of ``tpumetrics/clustering/dunn_index.py``)."""

from __future__ import annotations

from typing import Any

import torch

from tpumetrics_torch.clustering.base import _IntrinsicClusterMetric
from tpumetrics_torch.functional.clustering.dunn_index import dunn_index

Tensor = torch.Tensor


class DunnIndex(_IntrinsicClusterMetric):
    """Dunn index of a clustering (higher is better).

    Args:
        p: the p-norm of the distances.

    Example:
        >>> import torch
        >>> from tpumetrics_torch.clustering import DunnIndex
        >>> data = torch.tensor([[0., 0], [0.5, 0], [1, 0], [0.5, 1]])
        >>> labels = torch.tensor([0, 0, 0, 1])
        >>> metric = DunnIndex(p=2, device="cpu")
        >>> float(metric(data, labels))
        2.0
    """

    plot_lower_bound: float = 0.0

    def __init__(self, p: float = 2, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.p = p

    def compute(self) -> Tensor:
        data, labels, mask = self._catted()
        return dunn_index(data, labels, p=self.p, num_labels=self.num_labels, mask=mask)
