"""PerceptualEvaluationSpeechQuality (port of ``tpumetrics/audio/pesq.py``)."""

from __future__ import annotations

from typing import Any

import torch

from tpumetrics_torch.functional.audio.pesq import perceptual_evaluation_speech_quality
from tpumetrics_torch.metric import Metric
from tpumetrics_torch.utils.imports import _PESQ_AVAILABLE

Tensor = torch.Tensor


class PerceptualEvaluationSpeechQuality(Metric):
    """Mean PESQ over samples, computed on the host by the ``pesq`` package;
    without it the constructor raises ``ModuleNotFoundError``. Its update
    reads the host, so a fused collection keeps it eager.

    Example:
        >>> import torch
        >>> from tpumetrics_torch.audio import PerceptualEvaluationSpeechQuality
        >>> wave = torch.randn(8000)
        >>> metric = PerceptualEvaluationSpeechQuality(8000, 'nb', device="cpu")  # doctest: +SKIP
        >>> metric.update(wave, wave)  # doctest: +SKIP
        >>> round(float(metric.compute()), 2)  # doctest: +SKIP
        4.64
    """

    is_differentiable = False
    higher_is_better = True
    full_state_update = False
    _update_reads_host = True

    sum_pesq: Tensor
    total: Tensor

    def __init__(self, fs: int, mode: str, n_processes: int = 1, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        if not _PESQ_AVAILABLE:
            raise ModuleNotFoundError(
                "PerceptualEvaluationSpeechQuality metric requires that `pesq` is installed."
                " Either install as `pip install torchmetrics[audio]` or `pip install pesq`."
            )
        if fs not in (8000, 16000):
            raise ValueError(f"Expected argument `fs` to either be 8000 or 16000 but got {fs}")
        self.fs = fs
        if mode not in ("wb", "nb"):
            raise ValueError(f"Expected argument `mode` to either be 'wb' or 'nb' but got {mode}")
        self.mode = mode
        self.n_processes = n_processes
        self.add_state("sum_pesq", torch.zeros(()), dist_reduce_fx="sum")
        self.add_state("total", torch.zeros(()), dist_reduce_fx="sum")

    def update(self, preds: Tensor, target: Tensor) -> None:
        pesq_batch = perceptual_evaluation_speech_quality(
            preds, target, self.fs, self.mode, n_processes=self.n_processes
        )
        self.sum_pesq = self.sum_pesq + pesq_batch.sum()
        self.total = self.total + pesq_batch.numel()

    def compute(self) -> Tensor:
        return self.sum_pesq / self.total
