"""SpectralAngleMapper (port of ``tpumetrics/image/sam.py``)."""

from __future__ import annotations

from typing import Any, Optional

import torch

from tpumetrics_torch.functional.image.sam import _sam_compute, _sam_update
from tpumetrics_torch.metric import Metric
from tpumetrics_torch.utils.data import dim_zero_cat

Tensor = torch.Tensor


class SpectralAngleMapper(Metric):
    """Spectral angle over batches: the sum of per-pixel angles and their
    count, or the images in list states under ``reduction`` ``"none"``/None
    (give those a capacity, ``set_state_capacity``, to hold them in
    MaskedBuffers that a fused collection captures).

    Example:
        >>> import torch
        >>> from tpumetrics_torch.image import SpectralAngleMapper
        >>> g = torch.Generator().manual_seed(42)
        >>> preds, target = torch.rand(16, 3, 16, 16, generator=g), torch.rand(16, 3, 16, 16, generator=g)
        >>> sam = SpectralAngleMapper(device="cpu")
        >>> 0.0 < float(sam(preds, target)) < 1.6
        True
    """

    higher_is_better: bool = False
    is_differentiable: bool = True
    full_state_update: bool = False
    plot_lower_bound: float = 0.0

    def __init__(self, reduction: Optional[str] = "elementwise_mean", **kwargs: Any) -> None:
        super().__init__(**kwargs)
        if reduction == "none" or reduction is None:
            self.add_state("preds", default=[], dist_reduce_fx="cat")
            self.add_state("target", default=[], dist_reduce_fx="cat")
        else:
            self.add_state("sum_sam", torch.zeros(()), dist_reduce_fx="sum")
            self.add_state("numel", torch.zeros(()), dist_reduce_fx="sum")
        self.reduction = reduction

    def update(self, preds: Tensor, target: Tensor) -> None:
        preds, target = _sam_update(preds, target)
        if self.reduction == "none" or self.reduction is None:
            self.preds.append(preds)
            self.target.append(target)
        else:
            sam_map = _sam_compute(preds, target, reduction="none")
            self.sum_sam = self.sum_sam + sam_map.sum()
            self.numel = self.numel + sam_map.numel()

    def compute(self) -> Tensor:
        if self.reduction == "none" or self.reduction is None:
            return _sam_compute(dim_zero_cat(self.preds), dim_zero_cat(self.target), self.reduction)
        if self.reduction == "sum":
            return self.sum_sam
        return self.sum_sam / self.numel
