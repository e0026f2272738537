"""FowlkesMallowsIndex (port of ``tpumetrics/clustering/fowlkes_mallows_index.py``)."""

from __future__ import annotations

import torch

from tpumetrics_torch.clustering.base import _LabelPairClusterMetric
from tpumetrics_torch.functional.clustering.fowlkes_mallows_index import fowlkes_mallows_index

Tensor = torch.Tensor


class FowlkesMallowsIndex(_LabelPairClusterMetric):
    """Fowlkes-Mallows index between cluster assignments.

    Example:
        >>> import torch
        >>> from tpumetrics_torch.clustering import FowlkesMallowsIndex
        >>> metric = FowlkesMallowsIndex(device="cpu")
        >>> round(float(metric(torch.tensor([2, 2, 0, 1, 0]), torch.tensor([2, 2, 1, 1, 0]))), 4)
        0.5
    """

    plot_lower_bound: float = 0.0
    plot_upper_bound: float = 1.0

    def compute(self) -> Tensor:
        preds, target, mask = self._catted()
        return fowlkes_mallows_index(preds, target, mask=mask, **self._class_spaces())
