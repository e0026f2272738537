"""Modular ROC curves, binary, multiclass and multilabel, and the ``ROC``
task wrapper (port of ``tpumetrics/classification/roc.py``): the
precision-recall curve classes with another ``compute``."""

from __future__ import annotations

from typing import Any, Optional, Tuple

import torch

from tpumetrics_torch.classification.base import _ClassificationTaskWrapper
from tpumetrics_torch.classification.precision_recall_curve import (
    BinaryPrecisionRecallCurve,
    MulticlassPrecisionRecallCurve,
    MultilabelPrecisionRecallCurve,
)
from tpumetrics_torch.functional.classification.precision_recall_curve import Curves, Thresholds
from tpumetrics_torch.functional.classification.roc import (
    _binary_roc_compute,
    _multiclass_roc_compute,
    _multilabel_roc_compute,
)
from tpumetrics_torch.metric import Metric
from tpumetrics_torch.utils.checks import _check_task_size
from tpumetrics_torch.utils.enums import ClassificationTask

Tensor = torch.Tensor


class BinaryROC(BinaryPrecisionRecallCurve):
    """ROC curve for binary tasks.

    Example:
        >>> import torch
        >>> from tpumetrics_torch.classification import BinaryROC
        >>> metric = BinaryROC(thresholds=5, device='cpu')
        >>> metric.update(torch.tensor([0.1, 0.4, 0.35, 0.8]), torch.tensor([0, 0, 1, 1]))
        >>> fpr, tpr, thresholds = metric.compute()
        >>> tpr.tolist()
        [0.0, 0.5, 0.5, 1.0, 1.0]
    """

    def compute(self) -> Tuple[Tensor, Tensor, Tensor]:
        return _binary_roc_compute(self._final_state(), self.thresholds)


class MulticlassROC(MulticlassPrecisionRecallCurve):
    """Per-class one-vs-rest ROC curves.

    Example:
        >>> import torch
        >>> from tpumetrics_torch.classification import MulticlassROC
        >>> metric = MulticlassROC(num_classes=3, thresholds=5, device='cpu')
        >>> metric.update(torch.tensor([[0.8, 0.1, 0.1], [0.1, 0.8, 0.1]]), torch.tensor([0, 1]))
        >>> fpr, tpr, thresholds = metric.compute()
        >>> tuple(fpr.shape)
        (3, 5)
    """

    def compute(self) -> Curves:
        return _multiclass_roc_compute(self._final_state(), self.num_classes, self.thresholds, self.average)


class MultilabelROC(MultilabelPrecisionRecallCurve):
    """Per-label ROC curves.

    Example:
        >>> import torch
        >>> from tpumetrics_torch.classification import MultilabelROC
        >>> metric = MultilabelROC(num_labels=2, device='cpu')
        >>> metric.update(torch.tensor([[0.8, 0.1], [0.1, 0.8], [0.3, 0.6]]), torch.tensor([[1, 0], [0, 1], [0, 0]]))
        >>> fpr, tpr, thresholds = metric.compute()
        >>> [x.tolist() for x in fpr]
        [[0.0, 0.0, 0.5, 1.0], [0.0, 0.0, 0.5, 1.0]]
    """

    def compute(self) -> Curves:
        return _multilabel_roc_compute(self._final_state(), self.num_labels, self.thresholds, self.ignore_index)


class ROC(_ClassificationTaskWrapper):
    """Task-string wrapper for ROC; other keyword arguments (``device=``
    among them) go to the metric it returns.

    Example:
        >>> import torch
        >>> from tpumetrics_torch import ROC
        >>> probs = torch.tensor([0.11, 0.84, 0.22, 0.73, 0.33, 0.92])
        >>> target = torch.tensor([0, 1, 0, 1, 0, 1])
        >>> metric = ROC(task="binary", thresholds=4, device='cpu')
        >>> metric.update(probs, target)
        >>> fpr, tpr, thresholds = metric.compute()
        >>> tuple(fpr.shape), tuple(tpr.shape), tuple(thresholds.shape)
        ((4,), (4,), (4,))
    """

    def __new__(  # type: ignore[misc]
        cls,
        task: str,
        thresholds: Thresholds = None,
        num_classes: Optional[int] = None,
        num_labels: Optional[int] = None,
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ) -> Metric:
        task = ClassificationTask.from_str(task)
        kwargs.update({"thresholds": thresholds, "ignore_index": ignore_index, "validate_args": validate_args})
        if task == ClassificationTask.BINARY:
            return BinaryROC(**kwargs)
        if task == ClassificationTask.MULTICLASS:
            return MulticlassROC(_check_task_size("num_classes", num_classes), **kwargs)
        return MultilabelROC(_check_task_size("num_labels", num_labels), **kwargs)
