"""RootMeanSquaredErrorUsingSlidingWindow (port of ``tpumetrics/image/rmse_sw.py``)."""

from __future__ import annotations

from typing import Any, Optional

import torch

from tpumetrics_torch.functional.image.rmse_sw import _rmse_sw_compute, _rmse_sw_update
from tpumetrics_torch.metric import Metric

Tensor = torch.Tensor


class RootMeanSquaredErrorUsingSlidingWindow(Metric):
    """Windowed RMSE over batches: the sum of per-image scores and the image
    count (the RMSE map is not needed for the score, so it is not kept).

    Example:
        >>> import torch
        >>> from tpumetrics_torch.image import RootMeanSquaredErrorUsingSlidingWindow
        >>> preds = torch.rand(4, 3, 16, 16, generator=torch.Generator().manual_seed(42))
        >>> target = preds * 0.75
        >>> rmse_sw = RootMeanSquaredErrorUsingSlidingWindow(device="cpu")
        >>> float(rmse_sw(preds, target)) > 0
        True
    """

    higher_is_better: bool = False
    is_differentiable: bool = True
    full_state_update: bool = False
    plot_lower_bound: float = 0.0

    def __init__(self, window_size: int = 8, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        if not (isinstance(window_size, int) and window_size > 0):
            raise ValueError("Argument `window_size` is expected to be a positive integer.")
        self.window_size = window_size
        self.add_state("rmse_val_sum", default=torch.zeros(()), dist_reduce_fx="sum")
        self.add_state("total_images", default=torch.zeros(()), dist_reduce_fx="sum")

    def update(self, preds: Tensor, target: Tensor) -> None:
        rmse_val_sum, _, total = _rmse_sw_update(
            preds, target, self.window_size, rmse_val_sum=None, rmse_map=None, total_images=None
        )
        self.rmse_val_sum = self.rmse_val_sum + rmse_val_sum
        self.total_images = self.total_images + total

    def compute(self) -> Optional[Tensor]:
        rmse, _ = _rmse_sw_compute(self.rmse_val_sum, torch.zeros((), device=self.device), self.total_images)
        return rmse
