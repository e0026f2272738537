"""Modular group fairness: ``BinaryGroupStatRates`` and ``BinaryFairness``
(port of ``tpumetrics/classification/group_fairness.py``).

Both hold int32 ``(num_groups,)`` tp/fp/tn/fn states counted by one
``index_add_`` histogram per update (see the functional module), so they
share one compute group in a ``MetricCollection``. The group check reads the
largest id on the host in an eager update with ``validate_args`` and is
skipped inside a CUDA graph capture, so the fused collection update captures
and replays them.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from tpumetrics_torch.functional.classification.group_fairness import (
    _binary_groups_stat_scores,
    _fairness_compute,
    _fairness_task_validation,
    _groups_reduce,
)
from tpumetrics_torch.metric import Metric
from tpumetrics_torch.utils.data import _count_dtype

Tensor = torch.Tensor


class _AbstractGroupStatScores(Metric):
    """Per-group tp/fp/tn/fn accumulators, each ``(num_groups,)`` int32."""

    tp: Tensor
    fp: Tensor
    tn: Tensor
    fn: Tensor

    def _init_groups(self, num_groups: int, threshold: float, ignore_index: Optional[int], validate_args: bool) -> None:
        if validate_args and (not isinstance(num_groups, int) or num_groups < 2):
            raise ValueError(f"Expected argument `num_groups` to be an int larger than 1, but got {num_groups}")
        self.num_groups = num_groups
        self.threshold = threshold
        self.ignore_index = ignore_index
        self.validate_args = validate_args
        for name in ("tp", "fp", "tn", "fn"):
            self.add_state(name, torch.zeros(num_groups, dtype=_count_dtype()), dist_reduce_fx="sum")

    def _update_groups(self, preds: Tensor, target: Tensor, groups: Tensor) -> None:
        stats = _binary_groups_stat_scores(
            preds, target, groups, self.num_groups, self.threshold, self.ignore_index, self.validate_args
        )
        self.tp = self.tp + stats[:, 0]
        self.fp = self.fp + stats[:, 1]
        self.tn = self.tn + stats[:, 2]
        self.fn = self.fn + stats[:, 3]

    def _stats(self) -> Tensor:
        return torch.stack([self.tp, self.fp, self.tn, self.fn], dim=1)


class BinaryGroupStatRates(_AbstractGroupStatScores):
    """tp/fp/tn/fn rates by group.

    Example:
        >>> import torch
        >>> from tpumetrics_torch.classification import BinaryGroupStatRates
        >>> metric = BinaryGroupStatRates(num_groups=2, device='cpu')
        >>> metric.update(torch.tensor([0, 1, 0, 1]), torch.tensor([0, 1, 0, 1]), torch.tensor([0, 1, 0, 1]))
        >>> {k: v.tolist() for k, v in metric.compute().items()}
        {'group_0': [0.0, 0.0, 1.0, 0.0], 'group_1': [1.0, 0.0, 0.0, 0.0]}
    """

    is_differentiable: bool = False
    higher_is_better: Optional[bool] = None
    full_state_update: bool = False

    def __init__(
        self,
        num_groups: int,
        threshold: float = 0.5,
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        self._init_groups(num_groups, threshold, ignore_index, validate_args)

    def update(self, preds: Tensor, target: Tensor, groups: Tensor) -> None:
        self._update_groups(preds, target, groups)

    def compute(self) -> Dict[str, Tensor]:
        return _groups_reduce(self._stats())


class BinaryFairness(_AbstractGroupStatScores):
    """Demographic parity and/or equal opportunity between groups.

    Example:
        >>> import torch
        >>> from tpumetrics_torch.classification import BinaryFairness
        >>> metric = BinaryFairness(num_groups=2, device='cpu')
        >>> metric.update(torch.tensor([0.11, 0.84, 0.22, 0.73]), torch.tensor([0, 1, 0, 1]),
        ...               torch.tensor([0, 1, 0, 1]))
        >>> sorted(metric.compute().keys())
        ['DP_0_1', 'EO_0_1']
    """

    is_differentiable: bool = False
    higher_is_better: Optional[bool] = None
    full_state_update: bool = False

    def __init__(
        self,
        num_groups: int,
        task: str = "all",
        threshold: float = 0.5,
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        _fairness_task_validation(task)
        self.task = task
        self._init_groups(num_groups, threshold, ignore_index, validate_args)

    def update(self, preds: Tensor, target: Optional[Tensor], groups: Tensor) -> None:
        if self.task == "demographic_parity":
            target = torch.zeros_like(preds, dtype=torch.int32)
        self._update_groups(preds, target, groups)

    def compute(self) -> Dict[str, Tensor]:
        return _fairness_compute(self._stats(), self.task)
