"""Modular precision-recall curve, binned multiclass state (port of
``tpumetrics/classification/precision_recall_curve.py``).

The state is one ``(T, [C,] 2, 2)`` int32 confusion tensor summed over
batches; ``self.thresholds`` lives on the metric's device. ``thresholds=None``
(list states over raw preds) is not ported yet and raises.
"""

from __future__ import annotations

from typing import Any, Optional, Tuple, Union

import torch

from tpumetrics_torch.functional.classification.precision_recall_curve import (
    _EXACT_PATH_TODO,
    Thresholds,
    _adjust_threshold_arg,
    _multiclass_precision_recall_curve_arg_validation,
    _multiclass_precision_recall_curve_compute,
    _multiclass_precision_recall_curve_format,
    _multiclass_precision_recall_curve_tensor_validation,
    _multiclass_precision_recall_curve_update,
)
from tpumetrics_torch.metric import Metric
from tpumetrics_torch.utils.data import _count_dtype

Tensor = torch.Tensor


class MulticlassPrecisionRecallCurve(Metric):
    """Per-class precision-recall curves over binned thresholds.

    Example:
        >>> import torch
        >>> from tpumetrics_torch.classification import MulticlassPrecisionRecallCurve
        >>> metric = MulticlassPrecisionRecallCurve(num_classes=3, thresholds=5, device='cpu')
        >>> metric.update(torch.tensor([[0.8, 0.1, 0.1], [0.1, 0.8, 0.1]]), torch.tensor([0, 1]))
        >>> precision, recall, thresholds = metric.compute()
        >>> tuple(precision.shape)
        (3, 6)
    """

    is_differentiable: bool = False
    higher_is_better: Optional[bool] = None
    full_state_update: bool = False

    confmat: Tensor

    def __init__(
        self,
        num_classes: int,
        thresholds: Thresholds = None,
        average: Optional[str] = None,
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        if validate_args:
            _multiclass_precision_recall_curve_arg_validation(num_classes, thresholds, ignore_index, average)
        if thresholds is None:
            raise NotImplementedError(_EXACT_PATH_TODO)
        self.num_classes = num_classes
        self.average = average
        self.ignore_index = ignore_index
        self.validate_args = validate_args
        self.thresholds = _adjust_threshold_arg(thresholds, self.device)
        shape = (len(self.thresholds), 2, 2) if average == "micro" else (len(self.thresholds), num_classes, 2, 2)
        self.add_state("confmat", default=torch.zeros(shape, dtype=_count_dtype()), dist_reduce_fx="sum")

    def update(self, preds: Tensor, target: Tensor) -> None:
        if self.validate_args:
            _multiclass_precision_recall_curve_tensor_validation(preds, target, self.num_classes, self.ignore_index)
        preds, target, _ = _multiclass_precision_recall_curve_format(
            preds, target, self.num_classes, self.thresholds, self.ignore_index, self.average
        )
        state = _multiclass_precision_recall_curve_update(
            preds, target, self.num_classes, self.thresholds, self.average, self.ignore_index
        )
        self.confmat = self.confmat + state

    def compute(self) -> Tuple[Tensor, Tensor, Tensor]:
        return _multiclass_precision_recall_curve_compute(self.confmat, self.num_classes, self.thresholds, self.average)

    def to(self, device: Union[str, torch.device]) -> "MulticlassPrecisionRecallCurve":
        super().to(device)
        self.thresholds = self.thresholds.to(self.device)
        return self
