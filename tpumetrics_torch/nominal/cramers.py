"""CramersV (port of ``tpumetrics/nominal/cramers.py``)."""

from __future__ import annotations

from typing import Any, Optional

import torch

from tpumetrics_torch.functional.nominal.cramers import _cramers_v_compute
from tpumetrics_torch.nominal.base import _NominalAssociationMetric

Tensor = torch.Tensor


class CramersV(_NominalAssociationMetric):
    """Cramer's V association between two categorical series, from one
    float32 ``(C, C)`` contingency-table sum state.

    Args:
        num_classes: the size of the class space.
        bias_correction: apply Bergsma's bias correction.
        nan_strategy: ``replace`` (no host read) or ``drop`` (eager).
        nan_replace_value: the replacement value for ``replace``.

    Example:
        >>> import torch
        >>> from tpumetrics_torch.nominal import CramersV
        >>> metric = CramersV(num_classes=5, bias_correction=False, device="cpu")
        >>> preds = torch.tensor([0, 1, 2, 2, 1, 0, 1, 3, 4])
        >>> target = torch.tensor([0, 1, 2, 1, 1, 0, 0, 3, 4])
        >>> round(float(metric(preds, target)), 4)
        0.8498
    """

    def __init__(
        self,
        num_classes: int,
        bias_correction: bool = True,
        nan_strategy: str = "replace",
        nan_replace_value: Optional[float] = 0.0,
        **kwargs: Any,
    ) -> None:
        super().__init__(num_classes, nan_strategy, nan_replace_value, **kwargs)
        self.bias_correction = bias_correction

    def compute(self) -> Tensor:
        return _cramers_v_compute(self.confmat, self.bias_correction)
