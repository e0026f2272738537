"""ShortTimeObjectiveIntelligibility (port of ``tpumetrics/audio/stoi.py``)."""

from __future__ import annotations

from typing import Any

import torch

from tpumetrics_torch.functional.audio.stoi import short_time_objective_intelligibility
from tpumetrics_torch.metric import Metric
from tpumetrics_torch.utils.imports import _PYSTOI_AVAILABLE

Tensor = torch.Tensor


class ShortTimeObjectiveIntelligibility(Metric):
    """Mean STOI over samples, computed on the host by the ``pystoi``
    package; without it the constructor raises ``ModuleNotFoundError``. Its
    update reads the host, so a fused collection keeps it eager.

    Example:
        >>> import torch
        >>> from tpumetrics_torch.audio import ShortTimeObjectiveIntelligibility
        >>> wave = torch.randn(8000)
        >>> metric = ShortTimeObjectiveIntelligibility(fs=8000, device="cpu")  # doctest: +SKIP
        >>> metric.update(wave, wave)  # doctest: +SKIP
        >>> round(float(metric.compute()), 2)  # doctest: +SKIP
        1.0
    """

    is_differentiable = False
    higher_is_better = True
    full_state_update = False
    _update_reads_host = True

    sum_stoi: Tensor
    total: Tensor

    def __init__(self, fs: int, extended: bool = False, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        if not _PYSTOI_AVAILABLE:
            raise ModuleNotFoundError(
                "STOI metric requires that `pystoi` is installed."
                " Either install as `pip install torchmetrics[audio]` or `pip install pystoi`."
            )
        self.fs = fs
        self.extended = extended
        self.add_state("sum_stoi", torch.zeros(()), dist_reduce_fx="sum")
        self.add_state("total", torch.zeros(()), dist_reduce_fx="sum")

    def update(self, preds: Tensor, target: Tensor) -> None:
        stoi_batch = short_time_objective_intelligibility(preds, target, self.fs, self.extended)
        self.sum_stoi = self.sum_stoi + stoi_batch.sum()
        self.total = self.total + stoi_batch.numel()

    def compute(self) -> Tensor:
        return self.sum_stoi / self.total
