"""Modular accuracy, multiclass part (port of ``tpumetrics/classification/accuracy.py``)."""

from __future__ import annotations

import torch

from tpumetrics_torch.classification.stat_scores import MulticlassStatScores
from tpumetrics_torch.functional.classification.accuracy import _accuracy_reduce


class MulticlassAccuracy(MulticlassStatScores):
    """Multiclass accuracy.

    Example:
        >>> import torch
        >>> from tpumetrics_torch.classification import MulticlassAccuracy
        >>> target = torch.tensor([2, 1, 0, 0])
        >>> preds = torch.tensor([2, 1, 0, 1])
        >>> metric = MulticlassAccuracy(num_classes=3, device='cpu')
        >>> metric.update(preds, target)
        >>> round(float(metric.compute()), 4)
        0.8333
    """

    is_differentiable = False
    higher_is_better = True
    full_state_update: bool = False

    def compute(self) -> torch.Tensor:
        tp, fp, tn, fn = self._final_state()
        return _accuracy_reduce(tp, fp, tn, fn, average=self.average, multidim_average=self.multidim_average)
