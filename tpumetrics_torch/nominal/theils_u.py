"""TheilsU (port of ``tpumetrics/nominal/theils_u.py``)."""

from __future__ import annotations

import torch

from tpumetrics_torch.functional.nominal.theils_u import _theils_u_compute
from tpumetrics_torch.nominal.base import _NominalAssociationMetric

Tensor = torch.Tensor


class TheilsU(_NominalAssociationMetric):
    """Theil's uncertainty coefficient U(X|Y) between two categorical series.

    Example:
        >>> import torch
        >>> from tpumetrics_torch.nominal import TheilsU
        >>> metric = TheilsU(num_classes=5, device="cpu")
        >>> preds = torch.tensor([0, 1, 2, 2, 1, 0, 1, 3, 4])
        >>> target = torch.tensor([0, 1, 2, 1, 1, 0, 0, 3, 4])
        >>> round(float(metric(preds, target)), 4)
        0.7214
    """

    def compute(self) -> Tensor:
        return _theils_u_compute(self.confmat)
