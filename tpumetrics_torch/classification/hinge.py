"""Modular hinge loss, binary and multiclass, and the ``HingeLoss`` task
wrapper (port of ``tpumetrics/classification/hinge.py``).

The states are a float32 sum of the measures (per class in one-vs-all mode)
and an int32 count. Ignored entries are masked, not dropped (see the
functional module), so an update reads nothing on the host and the fused
collection update captures and replays it.
"""

from __future__ import annotations

from typing import Any, Optional

import torch

from tpumetrics_torch.classification.base import _ClassificationTaskWrapper
from tpumetrics_torch.functional.classification.hinge import (
    _binary_hinge_loss_arg_validation,
    _binary_hinge_loss_format,
    _binary_hinge_loss_update,
    _hinge_loss_compute,
    _multiclass_hinge_loss_arg_validation,
    _multiclass_hinge_loss_format,
    _multiclass_hinge_loss_update,
)
from tpumetrics_torch.functional.classification.precision_recall_curve import (
    _binary_precision_recall_curve_tensor_validation,
    _multiclass_precision_recall_curve_tensor_validation,
)
from tpumetrics_torch.metric import Metric
from tpumetrics_torch.utils.checks import _check_task_size
from tpumetrics_torch.utils.data import _count_dtype
from tpumetrics_torch.utils.enums import ClassificationTaskNoMultilabel

Tensor = torch.Tensor


class _HingeLoss(Metric):
    """The measures/total state machine of both hinge losses."""

    is_differentiable: bool = True
    higher_is_better: bool = False
    full_state_update: bool = False

    measures: Tensor
    total: Tensor

    def _create_state(self, size: Optional[int]) -> None:
        self.add_state("measures", torch.zeros(() if size is None else (size,)), dist_reduce_fx="sum")
        self.add_state("total", torch.zeros((), dtype=_count_dtype()), dist_reduce_fx="sum")

    def _update_state(self, measures: Tensor, total: Tensor) -> None:
        self.measures = self.measures + measures
        self.total = self.total + total

    def compute(self) -> Tensor:
        return _hinge_loss_compute(self.measures, self.total)


class BinaryHingeLoss(_HingeLoss):
    """Mean hinge loss for binary tasks.

    Example:
        >>> import torch
        >>> from tpumetrics_torch.classification import BinaryHingeLoss
        >>> metric = BinaryHingeLoss(device='cpu')
        >>> metric.update(torch.tensor([0.25, 0.25, 0.55, 0.75, 0.75]), torch.tensor([0, 0, 1, 1, 1]))
        >>> round(float(metric.compute()), 4)
        0.69
    """

    def __init__(
        self,
        squared: bool = False,
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        if validate_args:
            _binary_hinge_loss_arg_validation(squared, ignore_index)
        self.squared = squared
        self.ignore_index = ignore_index
        self.validate_args = validate_args
        self._create_state(None)

    def update(self, preds: Tensor, target: Tensor) -> None:
        if self.validate_args:
            _binary_precision_recall_curve_tensor_validation(preds, target, self.ignore_index)
        preds, target, keep = _binary_hinge_loss_format(preds, target, self.ignore_index)
        self._update_state(*_binary_hinge_loss_update(preds, target, self.squared, keep))


class MulticlassHingeLoss(_HingeLoss):
    """Mean hinge loss for multiclass tasks: a scalar in crammer-singer mode,
    per class in one-vs-all mode.

    Example:
        >>> import torch
        >>> from tpumetrics_torch.classification import MulticlassHingeLoss
        >>> metric = MulticlassHingeLoss(num_classes=3, device='cpu')
        >>> metric.update(
        ...     torch.tensor([[0.25, 0.20, 0.55], [0.55, 0.05, 0.40], [0.10, 0.30, 0.60], [0.90, 0.05, 0.05]]),
        ...     torch.tensor([0, 1, 2, 0]))
        >>> round(float(metric.compute()), 4)
        0.9125
    """

    def __init__(
        self,
        num_classes: int,
        squared: bool = False,
        multiclass_mode: str = "crammer-singer",
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        if validate_args:
            _multiclass_hinge_loss_arg_validation(num_classes, squared, multiclass_mode, ignore_index)
        self.num_classes = num_classes
        self.squared = squared
        self.multiclass_mode = multiclass_mode
        self.ignore_index = ignore_index
        self.validate_args = validate_args
        self._create_state(None if multiclass_mode == "crammer-singer" else num_classes)

    def update(self, preds: Tensor, target: Tensor) -> None:
        if self.validate_args:
            _multiclass_precision_recall_curve_tensor_validation(preds, target, self.num_classes, self.ignore_index)
        preds, target, keep = _multiclass_hinge_loss_format(preds, target, self.num_classes, self.ignore_index)
        self._update_state(*_multiclass_hinge_loss_update(preds, target, self.squared, self.multiclass_mode, keep))


class HingeLoss(_ClassificationTaskWrapper):
    """Task-string wrapper for the hinge loss; other keyword arguments
    (``device=`` among them) go to the metric it returns.

    Example:
        >>> import torch
        >>> from tpumetrics_torch import HingeLoss
        >>> probs = torch.tensor([0.11, 0.84, 0.22, 0.73, 0.33, 0.92])
        >>> target = torch.tensor([0, 1, 0, 1, 0, 1])
        >>> metric = HingeLoss(task="binary", device='cpu')
        >>> metric.update(probs, target)
        >>> round(float(metric.compute()), 4)
        0.695
    """

    def __new__(  # type: ignore[misc]
        cls,
        task: str,
        num_classes: Optional[int] = None,
        squared: bool = False,
        multiclass_mode: str = "crammer-singer",
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ) -> Metric:
        task = ClassificationTaskNoMultilabel.from_str(task)
        kwargs.update({"squared": squared, "ignore_index": ignore_index, "validate_args": validate_args})
        if task == ClassificationTaskNoMultilabel.BINARY:
            return BinaryHingeLoss(**kwargs)
        return MulticlassHingeLoss(
            _check_task_size("num_classes", num_classes), multiclass_mode=multiclass_mode, **kwargs
        )
