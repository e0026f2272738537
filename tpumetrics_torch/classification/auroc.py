"""Modular AUROC, binary, multiclass and multilabel, and the ``AUROC`` task
wrapper (port of ``tpumetrics/classification/auroc.py``): the
precision-recall curve classes with another ``compute``."""

from __future__ import annotations

from typing import Any, Optional

import torch

from tpumetrics_torch.classification.base import _ClassificationTaskWrapper
from tpumetrics_torch.classification.precision_recall_curve import (
    BinaryPrecisionRecallCurve,
    MulticlassPrecisionRecallCurve,
    MultilabelPrecisionRecallCurve,
)
from tpumetrics_torch.functional.classification.auroc import (
    _binary_auroc_arg_validation,
    _binary_auroc_compute,
    _multiclass_auroc_arg_validation,
    _multiclass_auroc_compute,
    _multilabel_auroc_arg_validation,
    _multilabel_auroc_compute,
)
from tpumetrics_torch.functional.classification.precision_recall_curve import Thresholds
from tpumetrics_torch.metric import Metric
from tpumetrics_torch.utils.checks import _check_task_size
from tpumetrics_torch.utils.enums import ClassificationTask


class BinaryAUROC(BinaryPrecisionRecallCurve):
    """Area under the ROC curve for binary tasks; ``max_fpr`` gives the
    McClish-corrected partial AUC.

    Example:
        >>> import torch
        >>> from tpumetrics_torch.classification import BinaryAUROC
        >>> metric = BinaryAUROC(device='cpu')
        >>> metric.update(torch.tensor([0.1, 0.4, 0.35, 0.8]), torch.tensor([0, 0, 1, 1]))
        >>> round(float(metric.compute()), 4)
        0.75
    """

    is_differentiable: bool = False
    higher_is_better: bool = True
    full_state_update: bool = False

    def __init__(
        self,
        max_fpr: Optional[float] = None,
        thresholds: Thresholds = None,
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ) -> None:
        if validate_args:
            _binary_auroc_arg_validation(max_fpr, thresholds, ignore_index)
        super().__init__(thresholds=thresholds, ignore_index=ignore_index, validate_args=False, **kwargs)
        self.max_fpr = max_fpr
        self.validate_args = validate_args

    def compute(self) -> torch.Tensor:
        return _binary_auroc_compute(self._final_state(), self.thresholds, self.max_fpr)


class MulticlassAUROC(MulticlassPrecisionRecallCurve):
    """AUROC over one-vs-rest curves for multiclass tasks.

    Example:
        >>> import torch
        >>> from tpumetrics_torch.classification import MulticlassAUROC
        >>> metric = MulticlassAUROC(num_classes=3, device='cpu')
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
            _multiclass_auroc_arg_validation(num_classes, average, thresholds, ignore_index)
        # the curve state is per class (average=None); `average` here is the AUC reduction
        super().__init__(
            num_classes=num_classes, thresholds=thresholds, average=None,
            ignore_index=ignore_index, validate_args=False, **kwargs,
        )
        self.average_auroc = average
        self.validate_args = validate_args

    def compute(self) -> torch.Tensor:
        return _multiclass_auroc_compute(self._final_state(), self.num_classes, self.average_auroc, self.thresholds)


class MultilabelAUROC(MultilabelPrecisionRecallCurve):
    """AUROC over per-label curves for multilabel tasks.

    Example:
        >>> import torch
        >>> from tpumetrics_torch.classification import MultilabelAUROC
        >>> metric = MultilabelAUROC(num_labels=2, device='cpu')
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
            _multilabel_auroc_arg_validation(num_labels, average, thresholds, ignore_index)
        super().__init__(
            num_labels=num_labels, thresholds=thresholds, ignore_index=ignore_index, validate_args=False, **kwargs
        )
        self.average_auroc = average
        self.validate_args = validate_args

    def compute(self) -> torch.Tensor:
        return _multilabel_auroc_compute(
            self._final_state(), self.num_labels, self.average_auroc, self.thresholds, self.ignore_index
        )


class AUROC(_ClassificationTaskWrapper):
    """Task-string wrapper for AUROC; other keyword arguments (``device=``
    among them) go to the metric it returns.

    Example:
        >>> import torch
        >>> from tpumetrics_torch import AUROC
        >>> probs = torch.tensor([0.11, 0.84, 0.22, 0.73, 0.33, 0.92])
        >>> target = torch.tensor([0, 1, 0, 1, 0, 1])
        >>> metric = AUROC(task="binary", device='cpu')
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
        max_fpr: Optional[float] = None,
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ) -> Metric:
        task = ClassificationTask.from_str(task)
        kwargs.update({"thresholds": thresholds, "ignore_index": ignore_index, "validate_args": validate_args})
        if task == ClassificationTask.BINARY:
            return BinaryAUROC(max_fpr, **kwargs)
        if task == ClassificationTask.MULTICLASS:
            return MulticlassAUROC(_check_task_size("num_classes", num_classes), average, **kwargs)
        return MultilabelAUROC(_check_task_size("num_labels", num_labels), average, **kwargs)
