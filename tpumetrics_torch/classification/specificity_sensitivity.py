"""Modular specificity at a fixed sensitivity, binary, multiclass and
multilabel, and the ``SpecificityAtSensitivity`` task wrapper (port of
``tpumetrics/classification/specificity_sensitivity.py``, without its plot
mixin): the precision-recall curve classes with another ``compute``. A
binned one holds the state of a binned AUROC of the same thresholds, so in a
``MetricCollection`` it joins that compute group and adds no update."""

from __future__ import annotations

from typing import Any, Optional, Tuple

import torch

from tpumetrics_torch.classification.base import _ClassificationTaskWrapper
from tpumetrics_torch.classification.precision_recall_curve import (
    BinaryPrecisionRecallCurve,
    MulticlassPrecisionRecallCurve,
    MultilabelPrecisionRecallCurve,
)
from tpumetrics_torch.functional.classification.precision_recall_curve import Thresholds
from tpumetrics_torch.functional.classification.specificity_sensitivity import (
    _binary_specificity_at_sensitivity_arg_validation,
    _binary_specificity_at_sensitivity_compute,
    _multiclass_specificity_at_sensitivity_arg_validation,
    _multiclass_specificity_at_sensitivity_compute,
    _multilabel_specificity_at_sensitivity_arg_validation,
    _multilabel_specificity_at_sensitivity_compute,
)
from tpumetrics_torch.metric import Metric
from tpumetrics_torch.utils.checks import _check_task_size
from tpumetrics_torch.utils.enums import ClassificationTask

Tensor = torch.Tensor


class BinarySpecificityAtSensitivity(BinaryPrecisionRecallCurve):
    """The largest specificity with sensitivity >= ``min_sensitivity``, and its threshold.

    Example:
        >>> import torch
        >>> from tpumetrics_torch.classification import BinarySpecificityAtSensitivity
        >>> metric = BinarySpecificityAtSensitivity(min_sensitivity=0.5, device='cpu')
        >>> metric.update(torch.tensor([0.1, 0.4, 0.35, 0.8]), torch.tensor([0, 0, 1, 1]))
        >>> spec, threshold = metric.compute()
        >>> (round(float(spec), 4), round(float(threshold), 4))
        (1.0, 0.8)
    """

    is_differentiable: bool = False
    higher_is_better: Optional[bool] = None
    full_state_update: bool = False

    def __init__(
        self,
        min_sensitivity: float,
        thresholds: Thresholds = None,
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ) -> None:
        super().__init__(thresholds=thresholds, ignore_index=ignore_index, validate_args=False, **kwargs)
        if validate_args:
            _binary_specificity_at_sensitivity_arg_validation(min_sensitivity, thresholds, ignore_index)
        self.validate_args = validate_args
        self.min_sensitivity = min_sensitivity

    def compute(self) -> Tuple[Tensor, Tensor]:
        return _binary_specificity_at_sensitivity_compute(self._final_state(), self.thresholds, self.min_sensitivity)


class MulticlassSpecificityAtSensitivity(MulticlassPrecisionRecallCurve):
    """Per class, the largest specificity with sensitivity >= ``min_sensitivity``, and its threshold.

    Example:
        >>> import torch
        >>> from tpumetrics_torch.classification import MulticlassSpecificityAtSensitivity
        >>> metric = MulticlassSpecificityAtSensitivity(num_classes=3, min_sensitivity=0.5, device='cpu')
        >>> metric.update(torch.tensor([[0.8, 0.1, 0.1], [0.1, 0.8, 0.1], [0.1, 0.1, 0.8]]),
        ...               torch.tensor([0, 1, 2]))
        >>> spec, thresholds = metric.compute()
        >>> spec.tolist()
        [1.0, 1.0, 1.0]
    """

    is_differentiable: bool = False
    higher_is_better: Optional[bool] = None
    full_state_update: bool = False

    def __init__(
        self,
        num_classes: int,
        min_sensitivity: float,
        thresholds: Thresholds = None,
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ) -> None:
        super().__init__(
            num_classes=num_classes, thresholds=thresholds, average=None, ignore_index=ignore_index,
            validate_args=False, **kwargs,
        )
        if validate_args:
            _multiclass_specificity_at_sensitivity_arg_validation(
                num_classes, min_sensitivity, thresholds, ignore_index
            )
        self.validate_args = validate_args
        self.min_sensitivity = min_sensitivity

    def compute(self) -> Tuple[Tensor, Tensor]:
        return _multiclass_specificity_at_sensitivity_compute(
            self._final_state(), self.num_classes, self.thresholds, self.min_sensitivity
        )


class MultilabelSpecificityAtSensitivity(MultilabelPrecisionRecallCurve):
    """Per label, the largest specificity with sensitivity >= ``min_sensitivity``, and its threshold.

    Example:
        >>> import torch
        >>> from tpumetrics_torch.classification import MultilabelSpecificityAtSensitivity
        >>> metric = MultilabelSpecificityAtSensitivity(num_labels=2, min_sensitivity=0.5, device='cpu')
        >>> metric.update(torch.tensor([[0.8, 0.1], [0.1, 0.8]]), torch.tensor([[1, 0], [0, 1]]))
        >>> spec, thresholds = metric.compute()
        >>> spec.tolist()
        [1.0, 1.0]
    """

    is_differentiable: bool = False
    higher_is_better: Optional[bool] = None
    full_state_update: bool = False

    def __init__(
        self,
        num_labels: int,
        min_sensitivity: float,
        thresholds: Thresholds = None,
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ) -> None:
        super().__init__(
            num_labels=num_labels, thresholds=thresholds, ignore_index=ignore_index, validate_args=False, **kwargs
        )
        if validate_args:
            _multilabel_specificity_at_sensitivity_arg_validation(num_labels, min_sensitivity, thresholds, ignore_index)
        self.validate_args = validate_args
        self.min_sensitivity = min_sensitivity

    def compute(self) -> Tuple[Tensor, Tensor]:
        return _multilabel_specificity_at_sensitivity_compute(
            self._final_state(), self.num_labels, self.thresholds, self.ignore_index, self.min_sensitivity
        )


class SpecificityAtSensitivity(_ClassificationTaskWrapper):
    """Task-string wrapper for specificity at a fixed sensitivity; other
    keyword arguments (``device=`` among them) go to the metric it returns.

    Example:
        >>> import torch
        >>> from tpumetrics_torch import SpecificityAtSensitivity
        >>> probs = torch.tensor([0.11, 0.84, 0.22, 0.73, 0.33, 0.92])
        >>> target = torch.tensor([0, 1, 0, 1, 0, 1])
        >>> metric = SpecificityAtSensitivity(task="binary", min_sensitivity=0.5, device='cpu')
        >>> metric.update(probs, target)
        >>> [round(float(v), 4) for v in metric.compute()]
        [1.0, 0.84]
    """

    def __new__(  # type: ignore[misc]
        cls,
        task: str,
        min_sensitivity: float,
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
            return BinarySpecificityAtSensitivity(min_sensitivity, **kwargs)
        if task == ClassificationTask.MULTICLASS:
            return MulticlassSpecificityAtSensitivity(
                _check_task_size("num_classes", num_classes), min_sensitivity, **kwargs
            )
        return MultilabelSpecificityAtSensitivity(
            _check_task_size("num_labels", num_labels), min_sensitivity, **kwargs
        )
