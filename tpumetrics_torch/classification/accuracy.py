"""Modular accuracy, binary, multiclass and multilabel, and the ``Accuracy``
task wrapper (port of ``tpumetrics/classification/accuracy.py``)."""

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
from tpumetrics_torch.functional.classification.accuracy import _accuracy_reduce
from tpumetrics_torch.metric import Metric


class BinaryAccuracy(BinaryStatScores):
    """Binary accuracy: the fraction of correct predictions.

    Example:
        >>> import torch
        >>> from tpumetrics_torch.classification import BinaryAccuracy
        >>> target = torch.tensor([0, 1, 0, 1, 0, 1])
        >>> preds = torch.tensor([0, 0, 1, 1, 0, 1])
        >>> metric = BinaryAccuracy(device='cpu')
        >>> metric.update(preds, target)
        >>> round(float(metric.compute()), 4)
        0.6667
    """

    is_differentiable = False
    higher_is_better = True
    full_state_update: bool = False

    def compute(self) -> torch.Tensor:
        tp, fp, tn, fn = self._final_state()
        return _accuracy_reduce(tp, fp, tn, fn, average="binary", multidim_average=self.multidim_average)


class MulticlassAccuracy(MulticlassStatScores):
    """Multiclass accuracy.

    Example:
        >>> import torch
        >>> from tpumetrics_torch.classification import MulticlassAccuracy
        >>> target = torch.tensor([2, 1, 0, 0])
        >>> preds = torch.tensor([2, 1, 0, 1])
        >>> metric = MulticlassAccuracy(num_classes=3, device='cpu')
        >>> metric.update(preds, target)
        >>> round(float(metric.compute()), 4)
        0.8333
    """

    is_differentiable = False
    higher_is_better = True
    full_state_update: bool = False

    def compute(self) -> torch.Tensor:
        tp, fp, tn, fn = self._final_state()
        return _accuracy_reduce(tp, fp, tn, fn, average=self.average, multidim_average=self.multidim_average)


class MultilabelAccuracy(MultilabelStatScores):
    """Multilabel accuracy.

    Example:
        >>> import torch
        >>> from tpumetrics_torch.classification import MultilabelAccuracy
        >>> target = torch.tensor([[0, 1, 0], [1, 0, 1]])
        >>> preds = torch.tensor([[0, 0, 1], [1, 0, 1]])
        >>> metric = MultilabelAccuracy(num_labels=3, device='cpu')
        >>> metric.update(preds, target)
        >>> round(float(metric.compute()), 4)
        0.6667
    """

    is_differentiable = False
    higher_is_better = True
    full_state_update: bool = False

    def compute(self) -> torch.Tensor:
        tp, fp, tn, fn = self._final_state()
        return _accuracy_reduce(
            tp, fp, tn, fn, average=self.average, multidim_average=self.multidim_average, multilabel=True
        )


class Accuracy(_ClassificationTaskWrapper):
    """Task-string wrapper: ``Accuracy(task="multiclass", num_classes=5)``
    returns a ``MulticlassAccuracy``; other keyword arguments (``device=``
    among them) go to that metric.

    Example:
        >>> import torch
        >>> from tpumetrics_torch.classification import Accuracy
        >>> target = torch.tensor([0, 1, 2, 3])
        >>> preds = torch.tensor([0, 2, 1, 3])
        >>> metric = Accuracy(task="multiclass", num_classes=4, device='cpu')
        >>> metric.update(preds, target)
        >>> float(metric.compute())
        0.5
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
            BinaryAccuracy, MulticlassAccuracy, MultilabelAccuracy, task, threshold, num_classes, num_labels,
            average, top_k, kwargs,
        )
