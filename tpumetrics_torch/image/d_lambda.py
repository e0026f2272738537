"""SpectralDistortionIndex (port of ``tpumetrics/image/d_lambda.py``)."""

from __future__ import annotations

from typing import Any, List, Optional

import torch

from tpumetrics_torch.functional.image.d_lambda import (
    _spectral_distortion_index_compute,
    _spectral_distortion_index_update,
)
from tpumetrics_torch.metric import Metric
from tpumetrics_torch.utils.data import dim_zero_cat

Tensor = torch.Tensor


class SpectralDistortionIndex(Metric):
    """D_lambda over batches: the images in list states (``preds`` and
    ``target`` may differ in resolution), scored at ``compute``.

    Example:
        >>> import torch
        >>> from tpumetrics_torch.image import SpectralDistortionIndex
        >>> preds = torch.rand(16, 3, 16, 16, generator=torch.Generator().manual_seed(42))
        >>> target = preds * 0.75
        >>> sdi = SpectralDistortionIndex(device="cpu")
        >>> float(sdi(preds, target)) < 0.2
        True
    """

    higher_is_better: bool = True
    is_differentiable: bool = True
    full_state_update: bool = False
    plot_lower_bound: float = 0.0
    plot_upper_bound: float = 1.0

    preds: List[Tensor]
    target: List[Tensor]

    def __init__(self, p: int = 1, reduction: Optional[str] = "elementwise_mean", **kwargs: Any) -> None:
        super().__init__(**kwargs)
        if not isinstance(p, int) or p <= 0:
            raise ValueError(f"Expected `p` to be a positive integer. Got p: {p}.")
        self.p = p
        allowed_reductions = ("elementwise_mean", "sum", "none")
        if reduction not in allowed_reductions:
            raise ValueError(f"Expected argument `reduction` be one of {allowed_reductions} but got {reduction}")
        self.reduction = reduction
        self.add_state("preds", default=[], dist_reduce_fx="cat")
        self.add_state("target", default=[], dist_reduce_fx="cat")

    def update(self, preds: Tensor, target: Tensor) -> None:
        preds, target = _spectral_distortion_index_update(preds, target)
        self.preds.append(preds)
        self.target.append(target)

    def compute(self) -> Tensor:
        return _spectral_distortion_index_compute(
            dim_zero_cat(self.preds), dim_zero_cat(self.target), self.p, self.reduction
        )
