"""UniversalImageQualityIndex (port of ``tpumetrics/image/uqi.py``)."""

from __future__ import annotations

from typing import Any, Optional, Sequence

import torch

from tpumetrics_torch.functional.image.uqi import _uqi_compute, _uqi_update
from tpumetrics_torch.metric import Metric
from tpumetrics_torch.utils.data import dim_zero_cat

Tensor = torch.Tensor


class UniversalImageQualityIndex(Metric):
    """UQI over batches: the sum of the UQI map and its element count, or
    the images themselves in list states under ``reduction`` ``"none"``/None.

    Example:
        >>> import torch
        >>> from tpumetrics_torch.image import UniversalImageQualityIndex
        >>> preds = torch.rand(16, 1, 16, 16, generator=torch.Generator().manual_seed(0))
        >>> target = preds * 0.75
        >>> uqi = UniversalImageQualityIndex(device="cpu")
        >>> round(float(uqi(preds, target)), 2)
        0.92
    """

    is_differentiable: bool = True
    higher_is_better: bool = True
    full_state_update: bool = False
    plot_lower_bound: float = 0.0
    plot_upper_bound: float = 1.0

    def __init__(
        self,
        kernel_size: Sequence[int] = (11, 11),
        sigma: Sequence[float] = (1.5, 1.5),
        reduction: Optional[str] = "elementwise_mean",
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        if reduction in ("elementwise_mean", "sum"):
            self.add_state("sum_uqi", torch.zeros(()), dist_reduce_fx="sum")
            self.add_state("numel", torch.zeros(()), dist_reduce_fx="sum")
        else:
            self.add_state("preds", default=[], dist_reduce_fx="cat")
            self.add_state("target", default=[], dist_reduce_fx="cat")
        self.kernel_size = kernel_size
        self.sigma = sigma
        self.reduction = reduction

    def update(self, preds: Tensor, target: Tensor) -> None:
        preds, target = _uqi_update(preds, target)
        if self.reduction in ("elementwise_mean", "sum"):
            uqi_map = _uqi_compute(preds, target, self.kernel_size, self.sigma, reduction="none")
            self.sum_uqi = self.sum_uqi + uqi_map.sum()
            self.numel = self.numel + uqi_map.numel()
        else:
            self.preds.append(preds)
            self.target.append(target)

    def compute(self) -> Tensor:
        if self.reduction == "elementwise_mean":
            return self.sum_uqi / self.numel
        if self.reduction == "sum":
            return self.sum_uqi
        return _uqi_compute(
            dim_zero_cat(self.preds), dim_zero_cat(self.target), self.kernel_size, self.sigma, self.reduction
        )
