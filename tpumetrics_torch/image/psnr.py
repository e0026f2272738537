"""PeakSignalNoiseRatio (port of ``tpumetrics/image/psnr.py``)."""

from __future__ import annotations

import functools
from typing import Any, Optional, Sequence, Tuple, Union

import torch

from tpumetrics_torch.functional.image.psnr import _psnr_compute, _psnr_update
from tpumetrics_torch.metric import Metric
from tpumetrics_torch.utils.data import dim_zero_cat

Tensor = torch.Tensor


class PeakSignalNoiseRatio(Metric):
    """PSNR over batches.

    Args:
        data_range: the inputs' value range; None tracks the target's min and
            max in two states on the device (only with ``dim=None``), a tuple
            clamps both inputs into the range.
        base: the logarithm's base.
        reduction: the reduction over per-``dim`` scores.
        dim: the dimensions each score covers; None is one global score.

    Example:
        >>> import torch
        >>> from tpumetrics_torch.image import PeakSignalNoiseRatio
        >>> psnr = PeakSignalNoiseRatio(data_range=3.0, device="cpu")
        >>> preds = torch.tensor([[0.0, 1.0], [2.0, 3.0]])
        >>> target = torch.tensor([[3.0, 2.0], [1.0, 0.0]])
        >>> round(float(psnr(preds, target)), 3)
        2.553
    """

    is_differentiable: bool = True
    higher_is_better: bool = True
    full_state_update: bool = False
    plot_lower_bound: float = 0.0

    def __init__(
        self,
        data_range: Optional[Union[float, Tuple[float, float]]] = None,
        base: float = 10.0,
        reduction: Optional[str] = "elementwise_mean",
        dim: Optional[Union[int, Tuple[int, ...]]] = None,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        if dim is None and reduction != "elementwise_mean":
            from tpumetrics_torch.utils.prints import rank_zero_warn

            rank_zero_warn(f"The `reduction={reduction}` will not have any effect when `dim` is None.")

        if dim is None:
            self.add_state("sum_squared_error", default=torch.zeros(()), dist_reduce_fx="sum")
            self.add_state("total", default=torch.zeros(()), dist_reduce_fx="sum")
        else:
            self.add_state("sum_squared_error", default=[], dist_reduce_fx="cat")
            self.add_state("total", default=[], dist_reduce_fx="cat")

        self.clamping_fn = None
        if data_range is None:
            if dim is not None:
                raise ValueError("The `data_range` must be given when `dim` is not None.")
            self.data_range = None
            # the identities of min and max, so a rank that never updated leaves the tracked range alone
            self.add_state("min_target", default=torch.tensor(float("inf")), dist_reduce_fx="min")
            self.add_state("max_target", default=torch.tensor(float("-inf")), dist_reduce_fx="max")
        elif isinstance(data_range, tuple):
            range_ = torch.tensor(float(data_range[1] - data_range[0]))
            self.add_state("data_range", default=range_, dist_reduce_fx="mean")
            self.clamping_fn = functools.partial(torch.clamp, min=data_range[0], max=data_range[1])
        else:
            self.add_state("data_range", default=torch.tensor(float(data_range)), dist_reduce_fx="mean")
        self.base = base
        self.reduction = reduction
        self.dim = tuple(dim) if isinstance(dim, Sequence) else dim

    def update(self, preds: Tensor, target: Tensor) -> None:
        preds = torch.as_tensor(preds).to(torch.float32)
        target = torch.as_tensor(target).to(torch.float32)
        if self.clamping_fn is not None:
            preds = self.clamping_fn(preds)
            target = self.clamping_fn(target)

        sum_squared_error, num_obs = _psnr_update(preds, target, dim=self.dim)
        if self.dim is None:
            if self.data_range is None:
                self.min_target = torch.minimum(target.min(), self.min_target)
                self.max_target = torch.maximum(target.max(), self.max_target)
            self.sum_squared_error = self.sum_squared_error + sum_squared_error
            self.total = self.total + num_obs
        else:
            self.sum_squared_error.append(sum_squared_error)
            self.total.append(num_obs)

    def compute(self) -> Tensor:
        data_range = self.data_range if self.data_range is not None else (self.max_target - self.min_target)
        if self.dim is None:
            sum_squared_error = self.sum_squared_error
            total = self.total
        else:
            sum_squared_error = dim_zero_cat(self.sum_squared_error)
            total = dim_zero_cat(self.total)
        return _psnr_compute(sum_squared_error, total, data_range, base=self.base, reduction=self.reduction)
