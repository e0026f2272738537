"""Modular average precision, binary, multiclass and multilabel, and the
``AveragePrecision`` task wrapper (port of
``tpumetrics/classification/average_precision.py``): the precision-recall
curve classes with another ``compute``. A binned AP and a binned AUROC of
the same thresholds hold the same state, so in a ``MetricCollection`` they
share one compute group and one update."""

from __future__ import annotations

from typing import Any, Optional

import torch

from tpumetrics_torch.classification.base import _ClassificationTaskWrapper
from tpumetrics_torch.classification.precision_recall_curve import (
    BinaryPrecisionRecallCurve,
    MulticlassPrecisionRecallCurve,
    MultilabelPrecisionRecallCurve,
)
from tpumetrics_torch.functional.classification.average_precision import (
    _binary_average_precision_compute,
    _multiclass_average_precision_arg_validation,
    _multiclass_average_precision_compute,
    _multilabel_average_precision_arg_validation,
    _multilabel_average_precision_compute,
)
from tpumetrics_torch.functional.classification.precision_recall_curve import Thresholds
from tpumetrics_torch.metric import Metric
from tpumetrics_torch.utils.checks import _check_task_size
from tpumetrics_torch.utils.enums import ClassificationTask


class BinaryAveragePrecision(BinaryPrecisionRecallCurve):
    """Average precision for binary tasks.

    Example:
        >>> import torch
        >>> from tpumetrics_torch.classification import BinaryAveragePrecision
        >>> metric = BinaryAveragePrecision(device='cpu')
        >>> metric.update(torch.tensor([0.1, 0.4, 0.35, 0.8]), torch.tensor([0, 0, 1, 1]))
        >>> round(float(metric.compute()), 4)
        0.8333
    """

    is_differentiable: bool = False
    higher_is_better: bool = True
    full_state_update: bool = False

    def compute(self) -> torch.Tensor:
        return _binary_average_precision_compute(self._final_state(), self.thresholds)


class MulticlassAveragePrecision(MulticlassPrecisionRecallCurve):
    """Average precision over one-vs-rest curves for multiclass tasks.

    Example:
        >>> import torch
        >>> from tpumetrics_torch.classification import MulticlassAveragePrecision
        >>> metric = MulticlassAveragePrecision(num_classes=3, device='cpu')
        >>> metric.update(torch.tensor([[0.8, 0.1, 0.1], [0.1, 0.8, 0.1], [0.1, 0.1, 0.8]]),
        ...               torch.tensor([0, 1, 2]))
        >>> round(float(metric.compute()), 4)
        1.0
    """

    is_differentiable: bool = False
    higher_is_better: bool = True
    full_state_update: bool = False

    def __init__(
        self,
        num_classes: int,
        average: Optional[str] = "macro",
        thresholds: Thresholds = None,
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ) -> None:
        if validate_args:
            _multiclass_average_precision_arg_validation(num_classes, average, thresholds, ignore_index)
        # the curve state is per class (average=None); `average` here is the AP reduction
        super().__init__(
            num_classes=num_classes, thresholds=thresholds, average=None,
            ignore_index=ignore_index, validate_args=False, **kwargs,
        )
        self.average_ap = average
        self.validate_args = validate_args

    def compute(self) -> torch.Tensor:
        return _multiclass_average_precision_compute(
            self._final_state(), self.num_classes, self.average_ap, self.thresholds
        )


class MultilabelAveragePrecision(MultilabelPrecisionRecallCurve):
    """Average precision over per-label curves for multilabel tasks.

    Example:
        >>> import torch
        >>> from tpumetrics_torch.classification import MultilabelAveragePrecision
        >>> metric = MultilabelAveragePrecision(num_labels=2, device='cpu')
        >>> metric.update(torch.tensor([[0.8, 0.1], [0.1, 0.8]]), torch.tensor([[1, 0], [0, 1]]))
        >>> round(float(metric.compute()), 4)
        1.0
    """

    is_differentiable: bool = False
    higher_is_better: bool = True
    full_state_update: bool = False

    def __init__(
        self,
        num_labels: int,
        average: Optional[str] = "macro",
        thresholds: Thresholds = None,
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ) -> None:
        if validate_args:
            _multilabel_average_precision_arg_validation(num_labels, average, thresholds, ignore_index)
        super().__init__(
            num_labels=num_labels, thresholds=thresholds, ignore_index=ignore_index, validate_args=False, **kwargs
        )
        self.average_ap = average
        self.validate_args = validate_args

    def compute(self) -> torch.Tensor:
        return _multilabel_average_precision_compute(
            self._final_state(), self.num_labels, self.average_ap, self.thresholds, self.ignore_index
        )


class AveragePrecision(_ClassificationTaskWrapper):
    """Task-string wrapper for average precision; other keyword arguments
    (``device=`` among them) go to the metric it returns.

    Example:
        >>> import torch
        >>> from tpumetrics_torch import AveragePrecision
        >>> probs = torch.tensor([0.11, 0.84, 0.22, 0.73, 0.33, 0.92])
        >>> target = torch.tensor([0, 1, 0, 1, 0, 1])
        >>> metric = AveragePrecision(task="binary", thresholds=8, device='cpu')
        >>> metric.update(probs, target)
        >>> round(float(metric.compute()), 4)
        1.0
    """

    def __new__(  # type: ignore[misc]
        cls,
        task: str,
        thresholds: Thresholds = None,
        num_classes: Optional[int] = None,
        num_labels: Optional[int] = None,
        average: Optional[str] = "macro",
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ) -> Metric:
        task = ClassificationTask.from_str(task)
        kwargs.update({"thresholds": thresholds, "ignore_index": ignore_index, "validate_args": validate_args})
        if task == ClassificationTask.BINARY:
            return BinaryAveragePrecision(**kwargs)
        if task == ClassificationTask.MULTICLASS:
            return MulticlassAveragePrecision(_check_task_size("num_classes", num_classes), average, **kwargs)
        return MultilabelAveragePrecision(_check_task_size("num_labels", num_labels), average, **kwargs)
