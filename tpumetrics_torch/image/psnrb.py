"""PeakSignalNoiseRatioWithBlockedEffect (port of ``tpumetrics/image/psnrb.py``)."""

from __future__ import annotations

from typing import Any

import torch

from tpumetrics_torch.functional.image.psnrb import _psnrb_compute, _psnrb_update
from tpumetrics_torch.metric import Metric

Tensor = torch.Tensor


class PeakSignalNoiseRatioWithBlockedEffect(Metric):
    """PSNR-B over batches of grayscale images: the squared-error sum, the
    blocked-effect sum, the count and the largest target range seen.

    Example:
        >>> import torch
        >>> from tpumetrics_torch.image import PeakSignalNoiseRatioWithBlockedEffect
        >>> metric = PeakSignalNoiseRatioWithBlockedEffect(device="cpu")
        >>> g = torch.Generator().manual_seed(0)
        >>> preds, target = torch.rand(2, 1, 16, 16, generator=g), torch.rand(2, 1, 16, 16, generator=g)
        >>> float(metric(preds, target)) > 0
        True
    """

    is_differentiable: bool = True
    higher_is_better: bool = True
    full_state_update: bool = False
    plot_lower_bound: float = 0.0

    def __init__(self, block_size: int = 8, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        if not isinstance(block_size, int) or block_size < 1:
            raise ValueError("Argument `block_size` should be a positive integer")
        self.block_size = block_size
        self.add_state("sum_squared_error", default=torch.zeros(()), dist_reduce_fx="sum")
        self.add_state("total", default=torch.zeros(()), dist_reduce_fx="sum")
        self.add_state("bef", default=torch.zeros(()), dist_reduce_fx="sum")
        # the identity of max; the first update replaces it
        self.add_state("data_range", default=torch.tensor(float("-inf")), dist_reduce_fx="max")

    def update(self, preds: Tensor, target: Tensor) -> None:
        preds = torch.as_tensor(preds).to(torch.float32)
        target = torch.as_tensor(target).to(torch.float32)
        sum_squared_error, bef, num_obs = _psnrb_update(preds, target, block_size=self.block_size)
        self.sum_squared_error = self.sum_squared_error + sum_squared_error
        self.bef = self.bef + bef
        self.total = self.total + num_obs
        self.data_range = torch.maximum(self.data_range, target.max() - target.min())

    def compute(self) -> Tensor:
        return _psnrb_compute(self.sum_squared_error, self.bef, self.total, self.data_range)
