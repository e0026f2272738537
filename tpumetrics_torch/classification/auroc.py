"""Modular AUROC, binned multiclass state (port of ``tpumetrics/classification/auroc.py``)."""

from __future__ import annotations

from typing import Any, Optional

import torch

from tpumetrics_torch.classification.precision_recall_curve import MulticlassPrecisionRecallCurve
from tpumetrics_torch.functional.classification.auroc import (
    _multiclass_auroc_arg_validation,
    _multiclass_auroc_compute,
)
from tpumetrics_torch.functional.classification.precision_recall_curve import Thresholds


class MulticlassAUROC(MulticlassPrecisionRecallCurve):
    """AUROC over one-vs-rest curves for multiclass tasks, binned thresholds.

    Example:
        >>> import torch
        >>> from tpumetrics_torch.classification import MulticlassAUROC
        >>> metric = MulticlassAUROC(num_classes=3, thresholds=11, device='cpu')
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
        return _multiclass_auroc_compute(self.confmat, self.num_classes, self.average_auroc, self.thresholds)
