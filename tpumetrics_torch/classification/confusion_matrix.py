"""Modular confusion matrices, binary, multiclass and multilabel, and the
``ConfusionMatrix`` task wrapper (port of
``tpumetrics/classification/confusion_matrix.py``). The state is one int32
``confmat`` summed over batches; ``normalize`` applies at ``compute``."""

from __future__ import annotations

from typing import Any, Optional

import torch

from tpumetrics_torch.classification.base import _ClassificationTaskWrapper
from tpumetrics_torch.functional.classification.confusion_matrix import (
    _binary_confusion_matrix_arg_validation,
    _confusion_matrix_reduce,
    _multiclass_confusion_matrix_arg_validation,
    _multilabel_confmat,
    _multilabel_confusion_matrix_arg_validation,
)
from tpumetrics_torch.functional.classification.stat_scores import (
    _binary_stat_scores_format,
    _binary_stat_scores_tensor_validation,
    _masked_confmat,
    _multiclass_stat_scores_format,
    _multiclass_stat_scores_tensor_validation,
    _multilabel_stat_scores_format,
    _multilabel_stat_scores_tensor_validation,
)
from tpumetrics_torch.metric import Metric
from tpumetrics_torch.utils.checks import _check_task_size
from tpumetrics_torch.utils.data import _count_dtype
from tpumetrics_torch.utils.enums import ClassificationTask

Tensor = torch.Tensor


class BinaryConfusionMatrix(Metric):
    """2x2 confusion matrix for binary tasks.

    Example:
        >>> import torch
        >>> from tpumetrics_torch.classification import BinaryConfusionMatrix
        >>> metric = BinaryConfusionMatrix(device='cpu')
        >>> metric.update(torch.tensor([0, 1, 0, 0]), torch.tensor([1, 1, 0, 0]))
        >>> metric.compute().tolist()
        [[2, 0], [1, 1]]
    """

    is_differentiable = False
    higher_is_better = None
    full_state_update: bool = False

    confmat: Tensor

    def __init__(
        self,
        threshold: float = 0.5,
        normalize: Optional[str] = None,
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        if validate_args:
            _binary_confusion_matrix_arg_validation(threshold, ignore_index, normalize)
        self.threshold = threshold
        self.normalize = normalize
        self.ignore_index = ignore_index
        self.validate_args = validate_args
        self.add_state("confmat", torch.zeros((2, 2), dtype=_count_dtype()), dist_reduce_fx="sum")

    def update(self, preds: Tensor, target: Tensor) -> None:
        if self.validate_args:
            _binary_stat_scores_tensor_validation(preds, target, "global", self.ignore_index)
        preds, target, mask = _binary_stat_scores_format(preds, target, self.threshold, self.ignore_index)
        self.confmat = self.confmat + _masked_confmat(preds, target, mask, 2)

    def compute(self) -> Tensor:
        return _confusion_matrix_reduce(self.confmat, self.normalize)


class MulticlassConfusionMatrix(Metric):
    """(C, C) confusion matrix for multiclass tasks, true labels in the rows.

    Example:
        >>> import torch
        >>> from tpumetrics_torch.classification import MulticlassConfusionMatrix
        >>> metric = MulticlassConfusionMatrix(num_classes=3, device='cpu')
        >>> metric.update(torch.tensor([2, 1, 0, 1]), torch.tensor([2, 1, 0, 0]))
        >>> metric.compute().tolist()
        [[1, 1, 0], [0, 1, 0], [0, 0, 1]]
    """

    is_differentiable = False
    higher_is_better = None
    full_state_update: bool = False

    confmat: Tensor

    def __init__(
        self,
        num_classes: int,
        normalize: Optional[str] = None,
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        if validate_args:
            _multiclass_confusion_matrix_arg_validation(num_classes, ignore_index, normalize)
        self.num_classes = num_classes
        self.normalize = normalize
        self.ignore_index = ignore_index
        self.validate_args = validate_args
        self.add_state(
            "confmat", torch.zeros((num_classes, num_classes), dtype=_count_dtype()), dist_reduce_fx="sum"
        )

    def update(self, preds: Tensor, target: Tensor) -> None:
        if self.validate_args:
            _multiclass_stat_scores_tensor_validation(preds, target, self.num_classes, "global", self.ignore_index)
        preds, target, mask = _multiclass_stat_scores_format(preds, target, self.num_classes, self.ignore_index, 1)
        self.confmat = self.confmat + _masked_confmat(preds, target, mask, self.num_classes)

    def compute(self) -> Tensor:
        return _confusion_matrix_reduce(self.confmat, self.normalize)


class MultilabelConfusionMatrix(Metric):
    """(num_labels, 2, 2) per-label confusion matrices.

    Example:
        >>> import torch
        >>> from tpumetrics_torch.classification import MultilabelConfusionMatrix
        >>> metric = MultilabelConfusionMatrix(num_labels=3, device='cpu')
        >>> metric.update(torch.tensor([[0, 0, 1], [1, 0, 1]]), torch.tensor([[0, 1, 0], [1, 0, 1]]))
        >>> metric.compute().tolist()
        [[[1, 0], [0, 1]], [[1, 0], [1, 0]], [[0, 1], [0, 1]]]
    """

    is_differentiable = False
    higher_is_better = None
    full_state_update: bool = False

    confmat: Tensor

    def __init__(
        self,
        num_labels: int,
        threshold: float = 0.5,
        normalize: Optional[str] = None,
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        if validate_args:
            _multilabel_confusion_matrix_arg_validation(num_labels, threshold, ignore_index, normalize)
        self.num_labels = num_labels
        self.threshold = threshold
        self.normalize = normalize
        self.ignore_index = ignore_index
        self.validate_args = validate_args
        self.add_state("confmat", torch.zeros((num_labels, 2, 2), dtype=_count_dtype()), dist_reduce_fx="sum")

    def update(self, preds: Tensor, target: Tensor) -> None:
        if self.validate_args:
            _multilabel_stat_scores_tensor_validation(preds, target, self.num_labels, "global", self.ignore_index)
        preds, target, mask = _multilabel_stat_scores_format(
            preds, target, self.num_labels, self.threshold, self.ignore_index
        )
        self.confmat = self.confmat + _multilabel_confmat(preds, target, mask)

    def compute(self) -> Tensor:
        return _confusion_matrix_reduce(self.confmat, self.normalize)


class ConfusionMatrix(_ClassificationTaskWrapper):
    """Task-string wrapper for the confusion matrix; other keyword arguments
    (``device=`` among them) go to the metric it returns.

    Example:
        >>> import torch
        >>> from tpumetrics_torch import ConfusionMatrix
        >>> logits = torch.tensor([[2.0, 0.5, 0.1], [0.3, 2.1, 0.2], [0.2, 0.3, 2.2], [2.0, 0.1, 0.4]])
        >>> metric = ConfusionMatrix(task="multiclass", num_classes=3, device='cpu')
        >>> metric.update(logits, torch.tensor([0, 1, 2, 1]))
        >>> metric.compute().tolist()
        [[1, 0, 0], [1, 1, 0], [0, 0, 1]]
    """

    def __new__(  # type: ignore[misc]
        cls,
        task: str,
        threshold: float = 0.5,
        num_classes: Optional[int] = None,
        num_labels: Optional[int] = None,
        normalize: Optional[str] = None,
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ) -> Metric:
        task = ClassificationTask.from_str(task)
        kwargs.update({"normalize": normalize, "ignore_index": ignore_index, "validate_args": validate_args})
        if task == ClassificationTask.BINARY:
            return BinaryConfusionMatrix(threshold, **kwargs)
        if task == ClassificationTask.MULTICLASS:
            return MulticlassConfusionMatrix(_check_task_size("num_classes", num_classes), **kwargs)
        return MultilabelConfusionMatrix(_check_task_size("num_labels", num_labels), threshold, **kwargs)
