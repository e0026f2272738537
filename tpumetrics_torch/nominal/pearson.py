"""PearsonsContingencyCoefficient (port of ``tpumetrics/nominal/pearson.py``)."""

from __future__ import annotations

import torch

from tpumetrics_torch.functional.nominal.pearson import _pearsons_contingency_coefficient_compute
from tpumetrics_torch.nominal.base import _NominalAssociationMetric

Tensor = torch.Tensor


class PearsonsContingencyCoefficient(_NominalAssociationMetric):
    """Pearson's contingency coefficient between two categorical series.

    Example:
        >>> import torch
        >>> from tpumetrics_torch.nominal import PearsonsContingencyCoefficient
        >>> metric = PearsonsContingencyCoefficient(num_classes=5, device="cpu")
        >>> preds = torch.tensor([0, 1, 2, 2, 1, 0, 1, 3, 4])
        >>> target = torch.tensor([0, 1, 2, 1, 1, 0, 0, 3, 4])
        >>> round(float(metric(preds, target)), 4)
        0.8619
    """

    def compute(self) -> Tensor:
        return _pearsons_contingency_coefficient_compute(self.confmat)
