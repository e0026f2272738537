"""SpeechReverberationModulationEnergyRatio (port of ``tpumetrics/audio/srmr.py``)."""

from __future__ import annotations

from typing import Any, Optional

import torch

from tpumetrics_torch.functional.audio.srmr import _srmr_arg_validate, speech_reverberation_modulation_energy_ratio
from tpumetrics_torch.metric import Metric

Tensor = torch.Tensor


class SpeechReverberationModulationEnergyRatio(Metric):
    """Mean SRMR over samples: the gammatone and modulation filterbanks run
    through the hand-written biquad kernel on a card (see
    :func:`~tpumetrics_torch.functional.audio.speech_reverberation_modulation_energy_ratio`).

    Example:
        >>> import torch
        >>> from tpumetrics_torch.audio import SpeechReverberationModulationEnergyRatio
        >>> wave = torch.randn(2048, generator=torch.Generator().manual_seed(1))
        >>> metric = SpeechReverberationModulationEnergyRatio(fs=8000, device="cpu")
        >>> metric.update(wave)
        >>> bool(0.2 < float(metric.compute()) < 0.6)
        True
    """

    is_differentiable = False
    higher_is_better = True
    full_state_update = False

    sum_srmr: Tensor
    total: Tensor

    def __init__(
        self,
        fs: int,
        n_cochlear_filters: int = 23,
        low_freq: float = 125,
        min_cf: float = 4,
        max_cf: Optional[float] = None,
        norm: bool = False,
        fast: bool = False,
        **kwargs: Any,
    ) -> None:
        self._srmr_kwargs = {
            "n_cochlear_filters": n_cochlear_filters, "low_freq": low_freq, "min_cf": min_cf,
            "norm": norm, "fast": fast,
        }
        if max_cf is not None:
            self._srmr_kwargs["max_cf"] = max_cf
        super().__init__(**kwargs)
        _srmr_arg_validate(fs, **self._srmr_kwargs)
        self.fs = fs
        self.add_state("sum_srmr", torch.zeros(()), dist_reduce_fx="sum")
        self.add_state("total", torch.zeros(()), dist_reduce_fx="sum")

    def update(self, preds: Tensor) -> None:
        srmr_batch = speech_reverberation_modulation_energy_ratio(preds, self.fs, **self._srmr_kwargs)
        self.sum_srmr = self.sum_srmr + srmr_batch.sum()
        self.total = self.total + srmr_batch.numel()

    def compute(self) -> Tensor:
        return self.sum_srmr / self.total
