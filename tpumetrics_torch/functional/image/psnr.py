"""PSNR (port of ``tpumetrics/functional/image/psnr.py``)."""

from __future__ import annotations

from typing import Optional, Tuple, Union

import torch

from tpumetrics_torch.functional.image.helper import _reduce
from tpumetrics_torch.utils.checks import _check_same_shape

Tensor = torch.Tensor


def _psnr_update(
    preds: Tensor,
    target: Tensor,
    dim: Optional[Union[int, Tuple[int, ...]]] = None,
) -> Tuple[Tensor, Tensor]:
    """Sum of squared errors and the observation count, over everything or per ``dim``."""
    diff = preds - target
    if dim is None:
        sum_squared_error = torch.sum(diff * diff)
        num_obs = torch.full((), float(target.numel()), dtype=torch.float32, device=target.device)
        return sum_squared_error, num_obs

    sum_squared_error = torch.sum(diff * diff, dim=dim)
    dim_list = [dim] if isinstance(dim, int) else list(dim)
    num = 1
    for d in dim_list:
        num *= target.shape[d]
    num_obs = torch.full(sum_squared_error.shape, float(num), dtype=torch.float32, device=target.device)
    return sum_squared_error, num_obs


def _psnr_compute(
    sum_squared_error: Tensor,
    num_obs: Tensor,
    data_range: Tensor,
    base: float = 10.0,
    reduction: Optional[str] = "elementwise_mean",
) -> Tensor:
    """PSNR from the accumulated sums, in dB for ``base`` 10."""
    psnr_base_e = 2 * torch.log(data_range) - torch.log(sum_squared_error / num_obs)
    log_base = torch.log(torch.full((), base, dtype=torch.float32, device=psnr_base_e.device))
    psnr_vals = psnr_base_e * (10 / log_base)
    return _reduce(psnr_vals, reduction)


def peak_signal_noise_ratio(
    preds: Tensor,
    target: Tensor,
    data_range: Optional[Union[float, Tuple[float, float]]] = None,
    base: float = 10.0,
    reduction: Optional[str] = "elementwise_mean",
    dim: Optional[Union[int, Tuple[int, ...]]] = None,
) -> Tensor:
    """Peak signal-to-noise ratio; ``data_range`` None takes the target's
    range, a tuple clamps both inputs into it.

    Example:
        >>> import torch
        >>> from tpumetrics_torch.functional.image import peak_signal_noise_ratio
        >>> pred = torch.tensor([[0.0, 1.0], [2.0, 3.0]])
        >>> target = torch.tensor([[3.0, 2.0], [1.0, 0.0]])
        >>> round(float(peak_signal_noise_ratio(pred, target)), 3)
        2.553
    """
    if dim is None and reduction != "elementwise_mean":
        from tpumetrics_torch.utils.prints import rank_zero_warn

        rank_zero_warn(f"The `reduction={reduction}` will not have any effect when `dim` is None.")

    preds = torch.as_tensor(preds).to(torch.float32)
    target = torch.as_tensor(target).to(torch.float32)
    _check_same_shape(preds, target)

    if data_range is None:
        if dim is not None:
            raise ValueError("The `data_range` must be given when `dim` is not None.")
        data_range_t = target.max() - target.min()
    elif isinstance(data_range, tuple):
        preds = torch.clamp(preds, data_range[0], data_range[1])
        target = torch.clamp(target, data_range[0], data_range[1])
        data_range_t = torch.full((), data_range[1] - data_range[0], dtype=torch.float32, device=preds.device)
    else:
        data_range_t = torch.full((), float(data_range), dtype=torch.float32, device=preds.device)
    sum_squared_error, num_obs = _psnr_update(preds, target, dim=dim)
    return _psnr_compute(sum_squared_error, num_obs, data_range_t, base=base, reduction=reduction)
