"""PermutationInvariantTraining (port of ``tpumetrics/audio/pit.py``)."""

from __future__ import annotations

from typing import Any, Callable

import torch

from tpumetrics_torch.functional.audio.pit import permutation_invariant_training
from tpumetrics_torch.metric import Metric

Tensor = torch.Tensor


class PermutationInvariantTraining(Metric):
    """Mean best-permutation metric over samples.

    The constructor's keyword arguments that ``Metric`` takes
    (``Metric._BASE_KWARGS``, ``device`` among them) go to the metric; the
    others go to ``metric_func``. In ``"speaker-wise"`` mode an update with
    3 speakers or more reads the metric matrix on the host for the Hungarian
    assignment, so the metric marks ``_update_reads_host`` and a fused
    collection keeps it eager.

    Example:
        >>> import torch
        >>> from tpumetrics_torch.audio import PermutationInvariantTraining
        >>> from tpumetrics_torch.functional.audio import scale_invariant_signal_distortion_ratio
        >>> target = torch.randn(3, 2, 100, generator=torch.Generator().manual_seed(1))
        >>> preds = target.flip(1) + 0.1 * torch.randn(3, 2, 100, generator=torch.Generator().manual_seed(2))
        >>> pit = PermutationInvariantTraining(scale_invariant_signal_distortion_ratio, eval_func="max",
        ...                                    device="cpu")
        >>> float(pit(preds, target)) > 15
        True
    """

    is_differentiable = True
    higher_is_better = True
    full_state_update = False

    sum_pit_metric: Tensor
    total: Tensor

    def __init__(
        self,
        metric_func: Callable,
        mode: str = "speaker-wise",
        eval_func: str = "max",
        **kwargs: Any,
    ) -> None:
        base_kwargs = {k: kwargs.pop(k) for k in list(kwargs) if k in Metric._BASE_KWARGS}
        super().__init__(**base_kwargs)
        if eval_func not in ("max", "min"):
            raise ValueError(f'eval_func can only be "max" or "min" but got {eval_func}')
        if mode not in ("speaker-wise", "permutation-wise"):
            raise ValueError(f'mode can only be "speaker-wise" or "permutation-wise" but got {mode}')
        self.metric_func = metric_func
        self.mode = mode
        self.eval_func = eval_func
        self.kwargs = kwargs
        self._update_reads_host = mode == "speaker-wise"
        self.add_state("sum_pit_metric", torch.zeros(()), dist_reduce_fx="sum")
        self.add_state("total", torch.zeros(()), dist_reduce_fx="sum")

    def update(self, preds: Tensor, target: Tensor) -> None:
        pit_metric = permutation_invariant_training(
            preds, target, self.metric_func, self.mode, self.eval_func, **self.kwargs
        )[0]
        self.sum_pit_metric = self.sum_pit_metric + pit_metric.sum()
        self.total = self.total + pit_metric.numel()

    def compute(self) -> Tensor:
        return self.sum_pit_metric / self.total
