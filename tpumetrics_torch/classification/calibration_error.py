"""Modular calibration error, binary and multiclass, and the
``CalibrationError`` task wrapper (port of
``tpumetrics/classification/calibration_error.py``).

The states are list states of float32 confidences and accuracies (``"cat"``
across ranks), element for element the JAX package's: ignored entries are
dropped by boolean indexing as there. List states keep a leader's update
eager beside the captured ones of a fused collection update.
"""

from __future__ import annotations

from typing import Any, List, Optional

import torch

from tpumetrics_torch.classification.base import _ClassificationTaskWrapper
from tpumetrics_torch.functional.classification.calibration_error import (
    _binary_calibration_error_arg_validation,
    _binary_calibration_error_format,
    _ce_compute,
    _multiclass_calibration_error_arg_validation,
    _multiclass_calibration_error_format,
)
from tpumetrics_torch.functional.classification.precision_recall_curve import (
    _binary_precision_recall_curve_tensor_validation,
)
from tpumetrics_torch.functional.classification.stat_scores import _multiclass_stat_scores_tensor_validation
from tpumetrics_torch.metric import Metric
from tpumetrics_torch.utils.checks import _check_task_size
from tpumetrics_torch.utils.data import dim_zero_cat
from tpumetrics_torch.utils.enums import ClassificationTaskNoMultilabel

Tensor = torch.Tensor


class _CalibrationError(Metric):
    """The confidences/accuracies list states of both calibration errors."""

    is_differentiable: bool = False
    higher_is_better: bool = False
    full_state_update: bool = False

    confidences: List[Tensor]
    accuracies: List[Tensor]

    def _create_state(self) -> None:
        self.add_state("confidences", [], dist_reduce_fx="cat")
        self.add_state("accuracies", [], dist_reduce_fx="cat")

    def compute(self) -> Tensor:
        confidences = dim_zero_cat(self.confidences)
        accuracies = dim_zero_cat(self.accuracies)
        return _ce_compute(confidences, accuracies, self.n_bins, self.norm)


class BinaryCalibrationError(_CalibrationError):
    """Top-label calibration error for binary tasks.

    Example:
        >>> import torch
        >>> from tpumetrics_torch.classification import BinaryCalibrationError
        >>> metric = BinaryCalibrationError(n_bins=2, norm='l1', device='cpu')
        >>> metric.update(torch.tensor([0.25, 0.25, 0.55, 0.75, 0.75]), torch.tensor([0, 0, 1, 1, 1]))
        >>> round(float(metric.compute()), 4)
        0.29
    """

    def __init__(
        self,
        n_bins: int = 15,
        norm: str = "l1",
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        if validate_args:
            _binary_calibration_error_arg_validation(n_bins, norm, ignore_index)
        self.n_bins = n_bins
        self.norm = norm
        self.ignore_index = ignore_index
        self.validate_args = validate_args
        self._create_state()

    def update(self, preds: Tensor, target: Tensor) -> None:
        if self.validate_args:
            _binary_precision_recall_curve_tensor_validation(preds, target, self.ignore_index)
        confidences, accuracies = _binary_calibration_error_format(preds, target, self.ignore_index)
        self.confidences.append(confidences)
        self.accuracies.append(accuracies)


class MulticlassCalibrationError(_CalibrationError):
    """Top-label calibration error for multiclass tasks.

    Example:
        >>> import torch
        >>> from tpumetrics_torch.classification import MulticlassCalibrationError
        >>> metric = MulticlassCalibrationError(num_classes=3, device='cpu')
        >>> metric.update(torch.tensor([[0.9, 0.05, 0.05], [0.1, 0.8, 0.1]]), torch.tensor([0, 1]))
        >>> round(float(metric.compute()), 4)
        0.15
    """

    def __init__(
        self,
        num_classes: int,
        n_bins: int = 15,
        norm: str = "l1",
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        if validate_args:
            _multiclass_calibration_error_arg_validation(num_classes, n_bins, norm, ignore_index)
        self.num_classes = num_classes
        self.n_bins = n_bins
        self.norm = norm
        self.ignore_index = ignore_index
        self.validate_args = validate_args
        self._create_state()

    def update(self, preds: Tensor, target: Tensor) -> None:
        if self.validate_args:
            _multiclass_stat_scores_tensor_validation(preds, target, self.num_classes, "global", self.ignore_index)
        confidences, accuracies = _multiclass_calibration_error_format(
            preds, target, self.num_classes, self.ignore_index
        )
        self.confidences.append(confidences)
        self.accuracies.append(accuracies)


class CalibrationError(_ClassificationTaskWrapper):
    """Task-string wrapper for the calibration error; other keyword arguments
    (``device=`` among them) go to the metric it returns.

    Example:
        >>> import torch
        >>> from tpumetrics_torch import CalibrationError
        >>> probs = torch.tensor([0.11, 0.84, 0.22, 0.73, 0.33, 0.92])
        >>> target = torch.tensor([0, 1, 0, 1, 0, 1])
        >>> metric = CalibrationError(task="binary", n_bins=4, device='cpu')
        >>> metric.update(probs, target)
        >>> round(float(metric.compute()), 4)
        0.195
    """

    def __new__(  # type: ignore[misc]
        cls,
        task: str,
        n_bins: int = 15,
        norm: str = "l1",
        num_classes: Optional[int] = None,
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ) -> Metric:
        task = ClassificationTaskNoMultilabel.from_str(task)
        kwargs.update({"n_bins": n_bins, "norm": norm, "ignore_index": ignore_index, "validate_args": validate_args})
        if task == ClassificationTaskNoMultilabel.BINARY:
            return BinaryCalibrationError(**kwargs)
        return MulticlassCalibrationError(_check_task_size("num_classes", num_classes), **kwargs)
