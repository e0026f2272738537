"""Modular specificity, binary, multiclass and multilabel, and the
``Specificity`` task wrapper (port of ``tpumetrics/classification/specificity.py``):
the stat-score classes with another ``compute``, so beside an F1 score of
the same ``average`` they share its compute group and its update."""

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
from tpumetrics_torch.functional.classification.specificity import _specificity_reduce
from tpumetrics_torch.metric import Metric


class BinarySpecificity(BinaryStatScores):
    """Binary specificity.

    Example:
        >>> import torch
        >>> from tpumetrics_torch.classification import BinarySpecificity
        >>> metric = BinarySpecificity(device='cpu')
        >>> metric.update(torch.tensor([0, 0, 1, 1, 0, 1]), torch.tensor([0, 1, 0, 1, 0, 1]))
        >>> round(float(metric.compute()), 4)
        0.6667
    """

    is_differentiable = False
    higher_is_better = True
    full_state_update: bool = False

    def compute(self) -> torch.Tensor:
        tp, fp, tn, fn = self._final_state()
        return _specificity_reduce(tp, fp, tn, fn, "binary", self.multidim_average)


class MulticlassSpecificity(MulticlassStatScores):
    """Multiclass specificity.

    Example:
        >>> import torch
        >>> from tpumetrics_torch.classification import MulticlassSpecificity
        >>> metric = MulticlassSpecificity(num_classes=3, device='cpu')
        >>> metric.update(torch.tensor([2, 1, 0, 1]), torch.tensor([2, 1, 0, 0]))
        >>> round(float(metric.compute()), 4)
        0.8889
    """

    is_differentiable = False
    higher_is_better = True
    full_state_update: bool = False

    def compute(self) -> torch.Tensor:
        tp, fp, tn, fn = self._final_state()
        return _specificity_reduce(tp, fp, tn, fn, self.average, self.multidim_average)


class MultilabelSpecificity(MultilabelStatScores):
    """Multilabel specificity.

    Example:
        >>> import torch
        >>> from tpumetrics_torch.classification import MultilabelSpecificity
        >>> metric = MultilabelSpecificity(num_labels=3, device='cpu')
        >>> metric.update(torch.tensor([[0, 0, 1], [1, 0, 1]]), torch.tensor([[0, 1, 0], [1, 0, 1]]))
        >>> round(float(metric.compute()), 4)
        0.6667
    """

    is_differentiable = False
    higher_is_better = True
    full_state_update: bool = False

    def compute(self) -> torch.Tensor:
        tp, fp, tn, fn = self._final_state()
        return _specificity_reduce(tp, fp, tn, fn, self.average, self.multidim_average, multilabel=True)


class Specificity(_ClassificationTaskWrapper):
    """Task-string wrapper for specificity; other keyword arguments (``device=``
    among them) go to the metric it returns.

    Example:
        >>> import torch
        >>> from tpumetrics_torch import Specificity
        >>> logits = torch.tensor([[2.0, 0.5, 0.1], [0.3, 2.1, 0.2], [0.2, 0.3, 2.2], [2.0, 0.1, 0.4]])
        >>> target = torch.tensor([0, 1, 2, 1])
        >>> metric = Specificity(task="multiclass", num_classes=3, average="macro", device='cpu')
        >>> metric.update(logits, target)
        >>> round(float(metric.compute()), 4)
        0.8889
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
            BinarySpecificity, MulticlassSpecificity, MultilabelSpecificity, task, threshold, num_classes, num_labels,
            average, top_k, kwargs,
        )
