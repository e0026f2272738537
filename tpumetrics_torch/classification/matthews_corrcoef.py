"""Modular Matthews correlation coefficient, binary, multiclass and
multilabel, and the ``MatthewsCorrCoef`` task wrapper (port of
``tpumetrics/classification/matthews_corrcoef.py``): the confusion-matrix
classes with another ``compute``, so beside a confusion matrix of the same
task they share its compute group and its update."""

from __future__ import annotations

from typing import Any, Optional

import torch

from tpumetrics_torch.classification.base import _ClassificationTaskWrapper
from tpumetrics_torch.classification.confusion_matrix import (
    BinaryConfusionMatrix,
    MulticlassConfusionMatrix,
    MultilabelConfusionMatrix,
)
from tpumetrics_torch.functional.classification.matthews_corrcoef import _matthews_corrcoef_reduce
from tpumetrics_torch.metric import Metric
from tpumetrics_torch.utils.checks import _check_task_size
from tpumetrics_torch.utils.enums import ClassificationTask


class BinaryMatthewsCorrCoef(BinaryConfusionMatrix):
    """MCC for binary tasks.

    Example:
        >>> import torch
        >>> from tpumetrics_torch.classification import BinaryMatthewsCorrCoef
        >>> metric = BinaryMatthewsCorrCoef(device='cpu')
        >>> metric.update(torch.tensor([0.35, 0.85, 0.48, 0.01]), torch.tensor([1, 1, 0, 0]))
        >>> round(float(metric.compute()), 4)
        0.5774
    """

    is_differentiable: bool = False
    higher_is_better: bool = True
    full_state_update: bool = False

    def __init__(
        self,
        threshold: float = 0.5,
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ) -> None:
        super().__init__(
            threshold=threshold, normalize=None, ignore_index=ignore_index, validate_args=validate_args, **kwargs
        )

    def compute(self) -> torch.Tensor:
        return _matthews_corrcoef_reduce(self.confmat)


class MulticlassMatthewsCorrCoef(MulticlassConfusionMatrix):
    """MCC for multiclass tasks.

    Example:
        >>> import torch
        >>> from tpumetrics_torch.classification import MulticlassMatthewsCorrCoef
        >>> metric = MulticlassMatthewsCorrCoef(num_classes=3, device='cpu')
        >>> metric.update(torch.tensor([2, 1, 0, 1]), torch.tensor([2, 1, 0, 0]))
        >>> round(float(metric.compute()), 4)
        0.7
    """

    is_differentiable: bool = False
    higher_is_better: bool = True
    full_state_update: bool = False

    def __init__(
        self,
        num_classes: int,
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ) -> None:
        super().__init__(
            num_classes=num_classes, normalize=None, ignore_index=ignore_index, validate_args=validate_args, **kwargs
        )

    def compute(self) -> torch.Tensor:
        return _matthews_corrcoef_reduce(self.confmat)


class MultilabelMatthewsCorrCoef(MultilabelConfusionMatrix):
    """MCC for multilabel tasks.

    Example:
        >>> import torch
        >>> from tpumetrics_torch.classification import MultilabelMatthewsCorrCoef
        >>> metric = MultilabelMatthewsCorrCoef(num_labels=3, device='cpu')
        >>> metric.update(torch.tensor([[0, 0, 1], [1, 0, 1]]), torch.tensor([[0, 1, 0], [1, 0, 1]]))
        >>> round(float(metric.compute()), 4)
        0.3333
    """

    is_differentiable: bool = False
    higher_is_better: bool = True
    full_state_update: bool = False

    def __init__(
        self,
        num_labels: int,
        threshold: float = 0.5,
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ) -> None:
        super().__init__(
            num_labels=num_labels, threshold=threshold, normalize=None, ignore_index=ignore_index,
            validate_args=validate_args, **kwargs,
        )

    def compute(self) -> torch.Tensor:
        return _matthews_corrcoef_reduce(self.confmat)


class MatthewsCorrCoef(_ClassificationTaskWrapper):
    """Task-string wrapper for MCC; other keyword arguments (``device=``
    among them) go to the metric it returns.

    Example:
        >>> import torch
        >>> from tpumetrics_torch import MatthewsCorrCoef
        >>> logits = torch.tensor([[2.0, 0.5, 0.1], [0.3, 2.1, 0.2], [0.2, 0.3, 2.2], [2.0, 0.1, 0.4]])
        >>> target = torch.tensor([0, 1, 2, 1])
        >>> metric = MatthewsCorrCoef(task="multiclass", num_classes=3, device='cpu')
        >>> metric.update(logits, target)
        >>> round(float(metric.compute()), 4)
        0.7
    """

    def __new__(  # type: ignore[misc]
        cls,
        task: str,
        threshold: float = 0.5,
        num_classes: Optional[int] = None,
        num_labels: Optional[int] = None,
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ) -> Metric:
        task = ClassificationTask.from_str(task)
        kwargs.update({"ignore_index": ignore_index, "validate_args": validate_args})
        if task == ClassificationTask.BINARY:
            return BinaryMatthewsCorrCoef(threshold, **kwargs)
        if task == ClassificationTask.MULTICLASS:
            return MulticlassMatthewsCorrCoef(_check_task_size("num_classes", num_classes), **kwargs)
        return MultilabelMatthewsCorrCoef(_check_task_size("num_labels", num_labels), threshold, **kwargs)
