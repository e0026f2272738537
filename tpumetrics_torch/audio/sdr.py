"""SDR metrics (port of ``tpumetrics/audio/sdr.py``)."""

from __future__ import annotations

from typing import Any, Optional

import torch

from tpumetrics_torch.functional.audio.sdr import (
    scale_invariant_signal_distortion_ratio,
    signal_distortion_ratio,
    source_aggregated_signal_distortion_ratio,
)
from tpumetrics_torch.metric import Metric

Tensor = torch.Tensor


class SignalDistortionRatio(Metric):
    """Mean SDR over samples (the Toeplitz solve in float32, see
    :func:`~tpumetrics_torch.functional.audio.signal_distortion_ratio`).

    Example:
        >>> import torch
        >>> from tpumetrics_torch.audio import SignalDistortionRatio
        >>> g = torch.randn(2, 8000, generator=torch.Generator().manual_seed(1))
        >>> preds = g + 0.1 * torch.randn(2, 8000, generator=torch.Generator().manual_seed(2))
        >>> sdr = SignalDistortionRatio(device="cpu")
        >>> float(sdr(preds, g)) > 15
        True
    """

    is_differentiable = True
    higher_is_better = True
    full_state_update = False

    sum_sdr: Tensor
    total: Tensor

    def __init__(
        self,
        use_cg_iter: Optional[int] = None,
        filter_length: int = 512,
        zero_mean: bool = False,
        load_diag: Optional[float] = None,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        self.use_cg_iter = use_cg_iter
        self.filter_length = filter_length
        self.zero_mean = zero_mean
        self.load_diag = load_diag
        self.add_state("sum_sdr", torch.zeros(()), dist_reduce_fx="sum")
        self.add_state("total", torch.zeros(()), dist_reduce_fx="sum")

    @property
    def _update_reads_host(self) -> bool:  # type: ignore[override]
        """On a card, torch solves a batch of systems of more than 128
        unknowns with MAGMA's batched LU, which cannot be captured in a CUDA
        graph (cuSOLVER's, which can, loops over the systems and took about
        ten times as long for 100 systems of 512 on an H100); so a fused
        collection keeps this metric eager. Its update reads nothing on the
        host."""
        return self.device.type == "cuda"

    def update(self, preds: Tensor, target: Tensor) -> None:
        sdr_batch = signal_distortion_ratio(
            preds, target, self.use_cg_iter, self.filter_length, self.zero_mean, self.load_diag
        )
        self.sum_sdr = self.sum_sdr + sdr_batch.sum()
        self.total = self.total + sdr_batch.numel()

    def compute(self) -> Tensor:
        return self.sum_sdr / self.total


class ScaleInvariantSignalDistortionRatio(Metric):
    """Mean SI-SDR over samples.

    Example:
        >>> import torch
        >>> from tpumetrics_torch.audio import ScaleInvariantSignalDistortionRatio
        >>> target = torch.tensor([3.0, -0.5, 2.0, 7.0])
        >>> preds = torch.tensor([2.5, 0.0, 2.0, 8.0])
        >>> si_sdr = ScaleInvariantSignalDistortionRatio(device="cpu")
        >>> round(float(si_sdr(preds, target)), 4)
        18.403
    """

    is_differentiable = True
    higher_is_better = True
    full_state_update = False

    sum_si_sdr: Tensor
    total: Tensor

    def __init__(self, zero_mean: bool = False, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        if not isinstance(zero_mean, bool):
            raise ValueError(f"Expected argument `zero_mean` to be a bool, but got {zero_mean}")
        self.zero_mean = zero_mean
        self.add_state("sum_si_sdr", torch.zeros(()), dist_reduce_fx="sum")
        self.add_state("total", torch.zeros(()), dist_reduce_fx="sum")

    def update(self, preds: Tensor, target: Tensor) -> None:
        si_sdr_batch = scale_invariant_signal_distortion_ratio(preds=preds, target=target, zero_mean=self.zero_mean)
        self.sum_si_sdr = self.sum_si_sdr + si_sdr_batch.sum()
        self.total = self.total + si_sdr_batch.numel()

    def compute(self) -> Tensor:
        return self.sum_si_sdr / self.total


class SourceAggregatedSignalDistortionRatio(Metric):
    """Mean SA-SDR over samples, inputs ``(..., spk, time)``.

    Example:
        >>> import torch
        >>> from tpumetrics_torch.audio import SourceAggregatedSignalDistortionRatio
        >>> g = torch.randn(2, 2, 8000, generator=torch.Generator().manual_seed(1))
        >>> preds = g + 0.1 * torch.randn(2, 2, 8000, generator=torch.Generator().manual_seed(2))
        >>> sa_sdr = SourceAggregatedSignalDistortionRatio(device="cpu")
        >>> float(sa_sdr(preds, g)) > 15
        True
    """

    is_differentiable = True
    higher_is_better = True
    full_state_update = False

    msdr_sum: Tensor
    num: Tensor

    def __init__(self, scale_invariant: bool = True, zero_mean: bool = False, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        if not isinstance(scale_invariant, bool):
            raise ValueError(f"Expected argument `scale_invariant` to be a bool, but got {scale_invariant}")
        self.scale_invariant = scale_invariant
        if not isinstance(zero_mean, bool):
            raise ValueError(f"Expected argument `zero_mean` to be a bool, but got {zero_mean}")
        self.zero_mean = zero_mean
        self.add_state("msdr_sum", torch.zeros(()), dist_reduce_fx="sum")
        self.add_state("num", torch.zeros(()), dist_reduce_fx="sum")

    def update(self, preds: Tensor, target: Tensor) -> None:
        msdr = source_aggregated_signal_distortion_ratio(preds, target, self.scale_invariant, self.zero_mean)
        self.msdr_sum = self.msdr_sum + msdr.sum()
        self.num = self.num + msdr.numel()

    def compute(self) -> Tensor:
        return self.msdr_sum / self.num
