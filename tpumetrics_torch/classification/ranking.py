"""Modular multilabel ranking metrics: coverage error, label ranking average
precision and label ranking loss (port of
``tpumetrics/classification/ranking.py``).

Each holds a float32 sum of per-sample scores and an int32 sample count; no
update reads anything on the host, so the fused collection update captures
and replays them.
"""

from __future__ import annotations

from typing import Any, Callable, Optional, Tuple

import torch

from tpumetrics_torch.functional.classification.precision_recall_curve import (
    _multilabel_precision_recall_curve_tensor_validation,
)
from tpumetrics_torch.functional.classification.ranking import (
    _multilabel_coverage_error_update,
    _multilabel_ranking_average_precision_update,
    _multilabel_ranking_format,
    _multilabel_ranking_loss_update,
    _ranking_reduce,
)
from tpumetrics_torch.metric import Metric
from tpumetrics_torch.utils.data import _count_dtype

Tensor = torch.Tensor


class _MultilabelRankingMetric(Metric):
    """The score/total sum states of the ranking family; a subclass names its update."""

    is_differentiable: bool = False
    full_state_update: bool = False

    score: Tensor
    total: Tensor

    _update_fn: Callable[[Tensor, Tensor], Tuple[Tensor, Tensor]]

    def __init__(
        self,
        num_labels: int,
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        if validate_args:
            if not isinstance(num_labels, int) or num_labels < 2:
                raise ValueError(f"Expected argument `num_labels` to be an integer larger than 1, but got {num_labels}")
            if ignore_index is not None and not isinstance(ignore_index, int):
                raise ValueError(
                    f"Expected argument `ignore_index` to either be `None` or an int, but got {ignore_index}"
                )
        self.num_labels = num_labels
        self.ignore_index = ignore_index
        self.validate_args = validate_args
        self.add_state("score", torch.zeros(()), dist_reduce_fx="sum")
        self.add_state("total", torch.zeros((), dtype=_count_dtype()), dist_reduce_fx="sum")

    def update(self, preds: Tensor, target: Tensor) -> None:
        if self.validate_args:
            _multilabel_precision_recall_curve_tensor_validation(preds, target, self.num_labels, self.ignore_index)
        preds, target = _multilabel_ranking_format(preds, target, self.num_labels, self.ignore_index)
        score, total = type(self)._update_fn(preds, target)
        self.score = self.score + score
        self.total = self.total + total

    def compute(self) -> Tensor:
        return _ranking_reduce(self.score, self.total)


class MultilabelCoverageError(_MultilabelRankingMetric):
    """Coverage error: how far down the ranking every relevant label is covered.

    Example:
        >>> import torch
        >>> from tpumetrics_torch.classification import MultilabelCoverageError
        >>> metric = MultilabelCoverageError(num_labels=3, device='cpu')
        >>> metric.update(torch.tensor([[0.75, 0.05, 0.35], [0.45, 0.75, 0.05], [0.05, 0.65, 0.35]]),
        ...               torch.tensor([[1, 0, 1], [0, 0, 1], [0, 1, 1]]))
        >>> round(float(metric.compute()), 4)
        2.3333
    """

    higher_is_better: bool = False
    _update_fn = staticmethod(_multilabel_coverage_error_update)


class MultilabelRankingAveragePrecision(_MultilabelRankingMetric):
    """Label ranking average precision.

    Example:
        >>> import torch
        >>> from tpumetrics_torch.classification import MultilabelRankingAveragePrecision
        >>> metric = MultilabelRankingAveragePrecision(num_labels=3, device='cpu')
        >>> metric.update(torch.tensor([[0.75, 0.05, 0.35], [0.45, 0.75, 0.05], [0.05, 0.65, 0.35]]),
        ...               torch.tensor([[1, 0, 1], [0, 0, 1], [0, 1, 1]]))
        >>> round(float(metric.compute()), 4)
        0.7778
    """

    higher_is_better: bool = True
    _update_fn = staticmethod(_multilabel_ranking_average_precision_update)


class MultilabelRankingLoss(_MultilabelRankingMetric):
    """Label ranking loss (lower is better).

    Example:
        >>> import torch
        >>> from tpumetrics_torch.classification import MultilabelRankingLoss
        >>> metric = MultilabelRankingLoss(num_labels=3, device='cpu')
        >>> metric.update(torch.tensor([[0.75, 0.05, 0.35], [0.45, 0.75, 0.05], [0.05, 0.65, 0.35]]),
        ...               torch.tensor([[1, 0, 1], [0, 0, 1], [0, 1, 1]]))
        >>> round(float(metric.compute()), 4)
        0.3333
    """

    higher_is_better: bool = False
    _update_fn = staticmethod(_multilabel_ranking_loss_update)
