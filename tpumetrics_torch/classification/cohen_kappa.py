"""Modular Cohen's kappa, binary and multiclass, and the ``CohenKappa`` task
wrapper (port of ``tpumetrics/classification/cohen_kappa.py``): the
confusion-matrix classes with another ``compute``, so beside a confusion
matrix of the same task they share its compute group and its update."""

from __future__ import annotations

from typing import Any, Optional

import torch

from tpumetrics_torch.classification.base import _ClassificationTaskWrapper
from tpumetrics_torch.classification.confusion_matrix import BinaryConfusionMatrix, MulticlassConfusionMatrix
from tpumetrics_torch.functional.classification.cohen_kappa import (
    _cohen_kappa_reduce,
    _cohen_kappa_weights_validation,
)
from tpumetrics_torch.metric import Metric
from tpumetrics_torch.utils.checks import _check_task_size
from tpumetrics_torch.utils.enums import ClassificationTaskNoMultilabel


class BinaryCohenKappa(BinaryConfusionMatrix):
    """Cohen's kappa for binary tasks.

    Example:
        >>> import torch
        >>> from tpumetrics_torch.classification import BinaryCohenKappa
        >>> metric = BinaryCohenKappa(device='cpu')
        >>> metric.update(torch.tensor([0.35, 0.85, 0.48, 0.01]), torch.tensor([1, 1, 0, 0]))
        >>> round(float(metric.compute()), 4)
        0.5
    """

    is_differentiable: bool = False
    higher_is_better: bool = True
    full_state_update: bool = False

    def __init__(
        self,
        threshold: float = 0.5,
        ignore_index: Optional[int] = None,
        weights: Optional[str] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ) -> None:
        super().__init__(
            threshold=threshold, normalize=None, ignore_index=ignore_index, validate_args=validate_args, **kwargs
        )
        if validate_args:
            _cohen_kappa_weights_validation(weights)
        self.weights = weights

    def compute(self) -> torch.Tensor:
        return _cohen_kappa_reduce(self.confmat, self.weights)


class MulticlassCohenKappa(MulticlassConfusionMatrix):
    """Cohen's kappa for multiclass tasks.

    Example:
        >>> import torch
        >>> from tpumetrics_torch.classification import MulticlassCohenKappa
        >>> metric = MulticlassCohenKappa(num_classes=3, device='cpu')
        >>> metric.update(torch.tensor([2, 1, 0, 1]), torch.tensor([2, 1, 0, 0]))
        >>> round(float(metric.compute()), 4)
        0.6364
    """

    is_differentiable: bool = False
    higher_is_better: bool = True
    full_state_update: bool = False

    def __init__(
        self,
        num_classes: int,
        ignore_index: Optional[int] = None,
        weights: Optional[str] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ) -> None:
        super().__init__(
            num_classes=num_classes, normalize=None, ignore_index=ignore_index, validate_args=validate_args, **kwargs
        )
        if validate_args:
            _cohen_kappa_weights_validation(weights)
        self.weights = weights

    def compute(self) -> torch.Tensor:
        return _cohen_kappa_reduce(self.confmat, self.weights)


class CohenKappa(_ClassificationTaskWrapper):
    """Task-string wrapper for Cohen's kappa (binary or multiclass); other
    keyword arguments (``device=`` among them) go to the metric it returns.

    Example:
        >>> import torch
        >>> from tpumetrics_torch import CohenKappa
        >>> logits = torch.tensor([[2.0, 0.5, 0.1], [0.3, 2.1, 0.2], [0.2, 0.3, 2.2], [2.0, 0.1, 0.4]])
        >>> target = torch.tensor([0, 1, 2, 1])
        >>> metric = CohenKappa(task="multiclass", num_classes=3, device='cpu')
        >>> metric.update(logits, target)
        >>> round(float(metric.compute()), 4)
        0.6364
    """

    def __new__(  # type: ignore[misc]
        cls,
        task: str,
        threshold: float = 0.5,
        num_classes: Optional[int] = None,
        weights: Optional[str] = None,
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ) -> Metric:
        task = ClassificationTaskNoMultilabel.from_str(task)
        kwargs.update({"weights": weights, "ignore_index": ignore_index, "validate_args": validate_args})
        if task == ClassificationTaskNoMultilabel.BINARY:
            return BinaryCohenKappa(threshold, **kwargs)
        return MulticlassCohenKappa(_check_task_size("num_classes", num_classes), **kwargs)
