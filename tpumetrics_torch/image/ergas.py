"""ErrorRelativeGlobalDimensionlessSynthesis (port of ``tpumetrics/image/ergas.py``)."""

from __future__ import annotations

from typing import Any, List, Optional

import torch

from tpumetrics_torch.functional.image.ergas import _ergas_compute, _ergas_update
from tpumetrics_torch.metric import Metric
from tpumetrics_torch.utils.data import dim_zero_cat

Tensor = torch.Tensor


class ErrorRelativeGlobalDimensionlessSynthesis(Metric):
    """ERGAS over batches: the images in list states, scored at ``compute``.

    Example:
        >>> import torch
        >>> from tpumetrics_torch.image import ErrorRelativeGlobalDimensionlessSynthesis
        >>> preds = torch.rand(16, 1, 16, 16, generator=torch.Generator().manual_seed(42))
        >>> target = preds * 0.75
        >>> ergas = ErrorRelativeGlobalDimensionlessSynthesis(device="cpu")
        >>> bool(150.0 < float(ergas(preds, target)) < 160.0)
        True
    """

    higher_is_better: bool = False
    is_differentiable: bool = True
    full_state_update: bool = False
    plot_lower_bound: float = 0.0

    preds: List[Tensor]
    target: List[Tensor]

    def __init__(self, ratio: float = 4, reduction: Optional[str] = "elementwise_mean", **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.add_state("preds", default=[], dist_reduce_fx="cat")
        self.add_state("target", default=[], dist_reduce_fx="cat")
        self.ratio = ratio
        self.reduction = reduction

    def update(self, preds: Tensor, target: Tensor) -> None:
        preds, target = _ergas_update(preds, target)
        self.preds.append(preds)
        self.target.append(target)

    def compute(self) -> Tensor:
        return _ergas_compute(dim_zero_cat(self.preds), dim_zero_cat(self.target), self.ratio, self.reduction)
