"""Modular exact match, multiclass and multilabel, and the ``ExactMatch``
task wrapper (port of ``tpumetrics/classification/exact_match.py``).

The states are int32 ``correct`` and ``total`` summed over batches; with
``multidim_average="samplewise"`` ``correct`` is a list state of per-sample
0/1 values ("cat"). No update reads the device on the host, so a global
exact match is captured and replayed by the fused collection update.
"""

from __future__ import annotations

from typing import Any, Optional

import torch

from tpumetrics_torch.classification.base import _ClassificationTaskWrapper
from tpumetrics_torch.functional.classification.exact_match import _exact_match_update, _exact_match_value
from tpumetrics_torch.functional.classification.stat_scores import (
    _multiclass_stat_scores_arg_validation,
    _multiclass_stat_scores_format,
    _multiclass_stat_scores_tensor_validation,
    _multilabel_stat_scores_arg_validation,
    _multilabel_stat_scores_format,
    _multilabel_stat_scores_tensor_validation,
)
from tpumetrics_torch.metric import Metric
from tpumetrics_torch.utils.checks import _check_task_size
from tpumetrics_torch.utils.data import _count_dtype, dim_zero_cat
from tpumetrics_torch.utils.enums import ClassificationTaskNoBinary

Tensor = torch.Tensor


class _AbstractExactMatch(Metric):
    """The correct/total state machine of both exact-match metrics."""

    correct: Any
    total: Tensor

    def _create_state(self, multidim_average: str) -> None:
        if multidim_average == "samplewise":
            self.add_state("correct", [], dist_reduce_fx="cat")
        else:
            self.add_state("correct", torch.zeros((), dtype=_count_dtype()), dist_reduce_fx="sum")
        self.add_state("total", torch.zeros((), dtype=_count_dtype()), dist_reduce_fx="sum")

    def _update_state(self, correct: Tensor, total: Tensor) -> None:
        if isinstance(self.correct, list):
            self.correct.append(correct)
        else:
            self.correct = self.correct + correct
        self.total = self.total + torch.sum(total, dtype=self.total.dtype)

    def compute(self) -> Tensor:
        return _exact_match_value(dim_zero_cat(self.correct), self.total, self.multidim_average)


class MulticlassExactMatch(_AbstractExactMatch):
    """Exact match of multiclass inputs with extra dimensions.

    Example:
        >>> import torch
        >>> from tpumetrics_torch.classification import MulticlassExactMatch
        >>> metric = MulticlassExactMatch(num_classes=3, device='cpu')
        >>> metric.update(torch.tensor([[0, 1], [2, 1]]), torch.tensor([[0, 1], [2, 2]]))
        >>> float(metric.compute())
        0.5
    """

    is_differentiable = False
    higher_is_better = True
    full_state_update: bool = False

    def __init__(
        self,
        num_classes: int,
        multidim_average: str = "global",
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        if validate_args:
            _multiclass_stat_scores_arg_validation(num_classes, 1, None, multidim_average, ignore_index)
        self.num_classes = num_classes
        self.multidim_average = multidim_average
        self.ignore_index = ignore_index
        self.validate_args = validate_args
        self._create_state(multidim_average)

    def update(self, preds: Tensor, target: Tensor) -> None:
        if self.validate_args:
            _multiclass_stat_scores_tensor_validation(
                preds, target, self.num_classes, self.multidim_average, self.ignore_index
            )
        preds, target, mask = _multiclass_stat_scores_format(preds, target, self.num_classes, self.ignore_index, 1)
        self._update_state(*_exact_match_update(preds, target, mask, self.multidim_average))


class MultilabelExactMatch(_AbstractExactMatch):
    """Exact match of multilabel inputs.

    Example:
        >>> import torch
        >>> from tpumetrics_torch.classification import MultilabelExactMatch
        >>> metric = MultilabelExactMatch(num_labels=3, device='cpu')
        >>> metric.update(torch.tensor([[0, 1, 0], [1, 0, 0]]), torch.tensor([[0, 1, 0], [1, 0, 1]]))
        >>> float(metric.compute())
        0.5
    """

    is_differentiable = False
    higher_is_better = True
    full_state_update: bool = False

    def __init__(
        self,
        num_labels: int,
        threshold: float = 0.5,
        multidim_average: str = "global",
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        if validate_args:
            _multilabel_stat_scores_arg_validation(num_labels, threshold, None, multidim_average, ignore_index)
        self.num_labels = num_labels
        self.threshold = threshold
        self.multidim_average = multidim_average
        self.ignore_index = ignore_index
        self.validate_args = validate_args
        self._create_state(multidim_average)

    def update(self, preds: Tensor, target: Tensor) -> None:
        if self.validate_args:
            _multilabel_stat_scores_tensor_validation(
                preds, target, self.num_labels, self.multidim_average, self.ignore_index
            )
        preds, target, mask = _multilabel_stat_scores_format(
            preds, target, self.num_labels, self.threshold, self.ignore_index
        )
        self._update_state(*_exact_match_update(preds, target, mask, self.multidim_average))


class ExactMatch(_ClassificationTaskWrapper):
    """Task-string wrapper for exact match (multiclass or multilabel); other
    keyword arguments (``device=`` among them) go to the metric it returns.

    Example:
        >>> import torch
        >>> from tpumetrics_torch import ExactMatch
        >>> preds = torch.tensor([[0, 1], [2, 2], [1, 1]])
        >>> target = torch.tensor([[0, 1], [2, 0], [1, 1]])
        >>> metric = ExactMatch(task="multiclass", num_classes=3, device='cpu')
        >>> metric.update(preds, target)
        >>> round(float(metric.compute()), 4)
        0.6667
    """

    def __new__(  # type: ignore[misc]
        cls,
        task: str,
        threshold: float = 0.5,
        num_classes: Optional[int] = None,
        num_labels: Optional[int] = None,
        multidim_average: str = "global",
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ) -> Metric:
        task = ClassificationTaskNoBinary.from_str(task)
        kwargs.update(
            {"multidim_average": multidim_average, "ignore_index": ignore_index, "validate_args": validate_args}
        )
        if task == ClassificationTaskNoBinary.MULTICLASS:
            return MulticlassExactMatch(_check_task_size("num_classes", num_classes), **kwargs)
        return MultilabelExactMatch(_check_task_size("num_labels", num_labels), threshold, **kwargs)
