"""Modular precision and recall, binary, multiclass and multilabel, and the
``Precision`` / ``Recall`` task wrappers (port of
``tpumetrics/classification/precision_recall.py``): the stat-score classes
with another ``compute``, so beside an F1 score of the same ``average``
they share its compute group and its update."""

from __future__ import annotations

from typing import Any, Optional

import torch

from tpumetrics_torch.classification.base import _ClassificationTaskWrapper
from tpumetrics_torch.classification.stat_scores import (
    BinaryStatScores,
    MulticlassStatScores,
    MultilabelStatScores,
    _stat_scores_task_metric,
)
from tpumetrics_torch.functional.classification.precision_recall import _precision_recall_reduce
from tpumetrics_torch.metric import Metric


class BinaryPrecision(BinaryStatScores):
    """Binary precision: tp / (tp + fp).

    Example:
        >>> import torch
        >>> from tpumetrics_torch.classification import BinaryPrecision
        >>> metric = BinaryPrecision(device='cpu')
        >>> metric.update(torch.tensor([0, 0, 1, 1, 0, 1]), torch.tensor([0, 1, 0, 1, 0, 1]))
        >>> round(float(metric.compute()), 4)
        0.6667
    """

    is_differentiable = False
    higher_is_better = True
    full_state_update: bool = False

    def compute(self) -> torch.Tensor:
        tp, fp, tn, fn = self._final_state()
        return _precision_recall_reduce("precision", tp, fp, tn, fn, "binary", self.multidim_average)


class MulticlassPrecision(MulticlassStatScores):
    """Multiclass precision.

    Example:
        >>> import torch
        >>> from tpumetrics_torch.classification import MulticlassPrecision
        >>> metric = MulticlassPrecision(num_classes=3, device='cpu')
        >>> metric.update(torch.tensor([2, 1, 0, 1]), torch.tensor([2, 1, 0, 0]))
        >>> round(float(metric.compute()), 4)
        0.8333
    """

    is_differentiable = False
    higher_is_better = True
    full_state_update: bool = False

    def compute(self) -> torch.Tensor:
        tp, fp, tn, fn = self._final_state()
        return _precision_recall_reduce("precision", tp, fp, tn, fn, self.average, self.multidim_average)


class MultilabelPrecision(MultilabelStatScores):
    """Multilabel precision.

    Example:
        >>> import torch
        >>> from tpumetrics_torch.classification import MultilabelPrecision
        >>> metric = MultilabelPrecision(num_labels=3, device='cpu')
        >>> metric.update(torch.tensor([[0, 0, 1], [1, 0, 1]]), torch.tensor([[0, 1, 0], [1, 0, 1]]))
        >>> round(float(metric.compute()), 4)
        0.5
    """

    is_differentiable = False
    higher_is_better = True
    full_state_update: bool = False

    def compute(self) -> torch.Tensor:
        tp, fp, tn, fn = self._final_state()
        return _precision_recall_reduce(
            "precision", tp, fp, tn, fn, self.average, self.multidim_average, multilabel=True
        )


class BinaryRecall(BinaryStatScores):
    """Binary recall: tp / (tp + fn).

    Example:
        >>> import torch
        >>> from tpumetrics_torch.classification import BinaryRecall
        >>> metric = BinaryRecall(device='cpu')
        >>> metric.update(torch.tensor([0, 0, 1, 1, 0, 1]), torch.tensor([0, 1, 0, 1, 0, 1]))
        >>> round(float(metric.compute()), 4)
        0.6667
    """

    is_differentiable = False
    higher_is_better = True
    full_state_update: bool = False

    def compute(self) -> torch.Tensor:
        tp, fp, tn, fn = self._final_state()
        return _precision_recall_reduce("recall", tp, fp, tn, fn, "binary", self.multidim_average)


class MulticlassRecall(MulticlassStatScores):
    """Multiclass recall.

    Example:
        >>> import torch
        >>> from tpumetrics_torch.classification import MulticlassRecall
        >>> metric = MulticlassRecall(num_classes=3, device='cpu')
        >>> metric.update(torch.tensor([2, 1, 0, 1]), torch.tensor([2, 1, 0, 0]))
        >>> round(float(metric.compute()), 4)
        0.8333
    """

    is_differentiable = False
    higher_is_better = True
    full_state_update: bool = False

    def compute(self) -> torch.Tensor:
        tp, fp, tn, fn = self._final_state()
        return _precision_recall_reduce("recall", tp, fp, tn, fn, self.average, self.multidim_average)


class MultilabelRecall(MultilabelStatScores):
    """Multilabel recall.

    Example:
        >>> import torch
        >>> from tpumetrics_torch.classification import MultilabelRecall
        >>> metric = MultilabelRecall(num_labels=3, device='cpu')
        >>> metric.update(torch.tensor([[0, 0, 1], [1, 0, 1]]), torch.tensor([[0, 1, 0], [1, 0, 1]]))
        >>> round(float(metric.compute()), 4)
        0.6667
    """

    is_differentiable = False
    higher_is_better = True
    full_state_update: bool = False

    def compute(self) -> torch.Tensor:
        tp, fp, tn, fn = self._final_state()
        return _precision_recall_reduce("recall", tp, fp, tn, fn, self.average, self.multidim_average, multilabel=True)


class Precision(_ClassificationTaskWrapper):
    """Task-string wrapper for precision; other keyword arguments (``device=``
    among them) go to the metric it returns.

    Example:
        >>> import torch
        >>> from tpumetrics_torch import Precision
        >>> logits = torch.tensor([[2.0, 0.5, 0.1], [0.3, 2.1, 0.2], [0.2, 0.3, 2.2], [2.0, 0.1, 0.4]])
        >>> target = torch.tensor([0, 1, 2, 1])
        >>> metric = Precision(task="multiclass", num_classes=3, average="macro", device='cpu')
        >>> metric.update(logits, target)
        >>> round(float(metric.compute()), 4)
        0.8333
    """

    def __new__(  # type: ignore[misc]
        cls,
        task: str,
        threshold: float = 0.5,
        num_classes: Optional[int] = None,
        num_labels: Optional[int] = None,
        average: Optional[str] = "micro",
        multidim_average: str = "global",
        top_k: Optional[int] = 1,
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ) -> Metric:
        kwargs.update(
            {"multidim_average": multidim_average, "ignore_index": ignore_index, "validate_args": validate_args}
        )
        return _stat_scores_task_metric(
            BinaryPrecision, MulticlassPrecision, MultilabelPrecision, task, threshold, num_classes, num_labels,
            average, top_k, kwargs,
        )


class Recall(_ClassificationTaskWrapper):
    """Task-string wrapper for recall; other keyword arguments (``device=``
    among them) go to the metric it returns.

    Example:
        >>> import torch
        >>> from tpumetrics_torch import Recall
        >>> logits = torch.tensor([[2.0, 0.5, 0.1], [0.3, 2.1, 0.2], [0.2, 0.3, 2.2], [2.0, 0.1, 0.4]])
        >>> target = torch.tensor([0, 1, 2, 1])
        >>> metric = Recall(task="multiclass", num_classes=3, average="macro", device='cpu')
        >>> metric.update(logits, target)
        >>> round(float(metric.compute()), 4)
        0.8333
    """

    def __new__(  # type: ignore[misc]
        cls,
        task: str,
        threshold: float = 0.5,
        num_classes: Optional[int] = None,
        num_labels: Optional[int] = None,
        average: Optional[str] = "micro",
        multidim_average: str = "global",
        top_k: Optional[int] = 1,
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ) -> Metric:
        kwargs.update(
            {"multidim_average": multidim_average, "ignore_index": ignore_index, "validate_args": validate_args}
        )
        return _stat_scores_task_metric(
            BinaryRecall, MulticlassRecall, MultilabelRecall, task, threshold, num_classes, num_labels, average,
            top_k, kwargs,
        )
