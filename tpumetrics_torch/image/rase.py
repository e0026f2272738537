"""RelativeAverageSpectralError (port of ``tpumetrics/image/rase.py``)."""

from __future__ import annotations

from typing import Any, List

import torch

from tpumetrics_torch.functional.image.rase import relative_average_spectral_error
from tpumetrics_torch.metric import Metric
from tpumetrics_torch.utils.data import dim_zero_cat

Tensor = torch.Tensor


class RelativeAverageSpectralError(Metric):
    """RASE over batches: the images in list states, scored at ``compute``.

    Example:
        >>> import torch
        >>> from tpumetrics_torch.image import RelativeAverageSpectralError
        >>> preds = torch.rand(4, 3, 16, 16, generator=torch.Generator().manual_seed(42))
        >>> target = preds * 0.75
        >>> rase = RelativeAverageSpectralError(device="cpu")
        >>> float(rase(preds, target)) > 0
        True
    """

    higher_is_better: bool = False
    is_differentiable: bool = True
    full_state_update: bool = False
    plot_lower_bound: float = 0.0

    preds: List[Tensor]
    target: List[Tensor]

    def __init__(self, window_size: int = 8, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        if not isinstance(window_size, int) or window_size < 1:
            raise ValueError(f"Argument `window_size` is expected to be a positive integer, but got {window_size}")
        self.window_size = window_size
        self.add_state("preds", default=[], dist_reduce_fx="cat")
        self.add_state("target", default=[], dist_reduce_fx="cat")

    def update(self, preds: Tensor, target: Tensor) -> None:
        self.preds.append(preds)
        self.target.append(target)

    def compute(self) -> Tensor:
        return relative_average_spectral_error(dim_zero_cat(self.preds), dim_zero_cat(self.target), self.window_size)
