"""SNR metrics (port of ``tpumetrics/audio/snr.py``)."""

from __future__ import annotations

from typing import Any

import torch

from tpumetrics_torch.functional.audio.snr import (
    complex_scale_invariant_signal_noise_ratio,
    scale_invariant_signal_noise_ratio,
    signal_noise_ratio,
)
from tpumetrics_torch.metric import Metric

Tensor = torch.Tensor


class SignalNoiseRatio(Metric):
    """Mean SNR over samples: a float32 sum and a float32 count.

    Example:
        >>> import torch
        >>> from tpumetrics_torch.audio import SignalNoiseRatio
        >>> snr = SignalNoiseRatio(device="cpu")
        >>> target = torch.tensor([3.0, -0.5, 2.0, 7.0])
        >>> preds = torch.tensor([2.5, 0.0, 2.0, 8.0])
        >>> round(float(snr(preds, target)), 3)
        16.18
    """

    is_differentiable = True
    higher_is_better = True
    full_state_update = False

    sum_snr: Tensor
    total: Tensor

    def __init__(self, zero_mean: bool = False, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.zero_mean = zero_mean
        self.add_state("sum_snr", torch.zeros(()), dist_reduce_fx="sum")
        self.add_state("total", torch.zeros(()), dist_reduce_fx="sum")

    def update(self, preds: Tensor, target: Tensor) -> None:
        snr_batch = signal_noise_ratio(preds=preds, target=target, zero_mean=self.zero_mean)
        self.sum_snr = self.sum_snr + snr_batch.sum()
        self.total = self.total + snr_batch.numel()

    def compute(self) -> Tensor:
        return self.sum_snr / self.total


class ScaleInvariantSignalNoiseRatio(Metric):
    """Mean SI-SNR over samples.

    Example:
        >>> import torch
        >>> from tpumetrics_torch.audio import ScaleInvariantSignalNoiseRatio
        >>> si_snr = ScaleInvariantSignalNoiseRatio(device="cpu")
        >>> target = torch.tensor([3.0, -0.5, 2.0, 7.0])
        >>> preds = torch.tensor([2.5, 0.0, 2.0, 8.0])
        >>> round(float(si_snr(preds, target)), 4)
        15.0918
    """

    is_differentiable = True
    higher_is_better = True
    full_state_update = False

    sum_si_snr: Tensor
    total: Tensor

    def __init__(self, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.add_state("sum_si_snr", torch.zeros(()), dist_reduce_fx="sum")
        self.add_state("total", torch.zeros(()), dist_reduce_fx="sum")

    def update(self, preds: Tensor, target: Tensor) -> None:
        si_snr_batch = scale_invariant_signal_noise_ratio(preds=preds, target=target)
        self.sum_si_snr = self.sum_si_snr + si_snr_batch.sum()
        self.total = self.total + si_snr_batch.numel()

    def compute(self) -> Tensor:
        return self.sum_si_snr / self.total


class ComplexScaleInvariantSignalNoiseRatio(Metric):
    """Mean C-SI-SNR over complex spectrogram samples (complex
    ``(..., freq, time)`` or real ``(..., freq, time, 2)``).

    Example:
        >>> import torch
        >>> from tpumetrics_torch.audio import ComplexScaleInvariantSignalNoiseRatio
        >>> g = torch.randn(2, 4, 10, 2, generator=torch.Generator().manual_seed(0))
        >>> metric = ComplexScaleInvariantSignalNoiseRatio(device="cpu")
        >>> metric.update(g * 0.9 + 0.1, g)
        >>> bool(float(metric.compute()) > 10.0)
        True
    """

    is_differentiable = True
    higher_is_better = True
    full_state_update = False

    ci_snr_sum: Tensor
    num: Tensor

    def __init__(self, zero_mean: bool = False, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        if not isinstance(zero_mean, bool):
            raise ValueError(f"Expected argument `zero_mean` to be a bool, but got {zero_mean}")
        self.zero_mean = zero_mean
        self.add_state("ci_snr_sum", torch.zeros(()), dist_reduce_fx="sum")
        self.add_state("num", torch.zeros(()), dist_reduce_fx="sum")

    def update(self, preds: Tensor, target: Tensor) -> None:
        value = complex_scale_invariant_signal_noise_ratio(preds=preds, target=target, zero_mean=self.zero_mean)
        self.ci_snr_sum = self.ci_snr_sum + value.sum()
        self.num = self.num + value.numel()

    def compute(self) -> Tensor:
        return self.ci_snr_sum / self.num
