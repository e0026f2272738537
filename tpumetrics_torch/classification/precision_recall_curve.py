"""Modular precision-recall curves, binary, multiclass and multilabel, and
the ``PrecisionRecallCurve`` task wrapper (port of
``tpumetrics/classification/precision_recall_curve.py``).

Two state modes: with ``thresholds`` (int, list or tensor) one ``(T, [C,] 2,
2)`` int32 confusion tensor ``confmat`` summed over batches, the
thresholds kept on the metric's device; with ``thresholds=None`` (the
exact curve) the list states ``preds`` and ``target`` ("cat"), concatenated
at ``compute``. ROC and AUROC subclass these classes and override
``compute``.
"""

from __future__ import annotations

from typing import Any, List, Optional, Tuple, Union

import torch

from tpumetrics_torch.classification.base import _ClassificationTaskWrapper
from tpumetrics_torch.functional.classification.precision_recall_curve import (
    Curves,
    CurveState,
    Thresholds,
    _adjust_threshold_arg,
    _binary_precision_recall_curve_arg_validation,
    _binary_precision_recall_curve_compute,
    _binary_precision_recall_curve_format,
    _binary_precision_recall_curve_tensor_validation,
    _binary_precision_recall_curve_update,
    _multiclass_precision_recall_curve_arg_validation,
    _multiclass_precision_recall_curve_compute,
    _multiclass_precision_recall_curve_format,
    _multiclass_precision_recall_curve_tensor_validation,
    _multiclass_precision_recall_curve_update,
    _multilabel_precision_recall_curve_arg_validation,
    _multilabel_precision_recall_curve_compute,
    _multilabel_precision_recall_curve_format,
    _multilabel_precision_recall_curve_tensor_validation,
    _multilabel_precision_recall_curve_update,
)
from tpumetrics_torch.metric import Metric
from tpumetrics_torch.utils.checks import _check_task_size
from tpumetrics_torch.utils.data import _count_dtype, dim_zero_cat
from tpumetrics_torch.utils.enums import ClassificationTask

Tensor = torch.Tensor


class _CurveMetric(Metric):
    """The state machine the curve metrics share (see the module note)."""

    preds: List[Tensor]
    target: List[Tensor]
    confmat: Tensor

    def _create_curve_state(self, thresholds: Thresholds, binned_shape: Tuple[int, ...]) -> None:
        """Exact list states for ``thresholds=None``, else a zero
        ``(T, *binned_shape)`` confusion tensor."""
        self.thresholds = _adjust_threshold_arg(thresholds, self.device)
        if self.thresholds is None:
            self.add_state("preds", default=[], dist_reduce_fx="cat")
            self.add_state("target", default=[], dist_reduce_fx="cat")
        else:
            shape = (len(self.thresholds), *binned_shape)
            self.add_state("confmat", default=torch.zeros(shape, dtype=_count_dtype()), dist_reduce_fx="sum")

    def _update_curve_state(self, state: CurveState) -> None:
        if isinstance(state, tuple):
            self.preds.append(state[0])
            self.target.append(state[1])
        else:
            self.confmat = self.confmat + state

    def _final_state(self) -> CurveState:
        if self.thresholds is not None:
            return self.confmat
        return dim_zero_cat(self.preds), dim_zero_cat(self.target)

    def to(self, device: Union[str, torch.device]) -> "_CurveMetric":
        super().to(device)
        if self.thresholds is not None:
            self.thresholds = self.thresholds.to(self.device)
        return self


class BinaryPrecisionRecallCurve(_CurveMetric):
    """Precision-recall curve for binary tasks.

    Example:
        >>> import torch
        >>> from tpumetrics_torch.classification import BinaryPrecisionRecallCurve
        >>> metric = BinaryPrecisionRecallCurve(thresholds=5, device='cpu')
        >>> metric.update(torch.tensor([0.1, 0.4, 0.35, 0.8]), torch.tensor([0, 0, 1, 1]))
        >>> precision, recall, thresholds = metric.compute()
        >>> [round(v, 4) for v in precision.tolist()]
        [0.5, 0.6667, 1.0, 1.0, 0.0, 1.0]
    """

    is_differentiable: bool = False
    higher_is_better: Optional[bool] = None
    full_state_update: bool = False

    def __init__(
        self,
        thresholds: Thresholds = None,
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        if validate_args:
            _binary_precision_recall_curve_arg_validation(thresholds, ignore_index)
        self.ignore_index = ignore_index
        self.validate_args = validate_args
        self._create_curve_state(thresholds, (2, 2))

    def update(self, preds: Tensor, target: Tensor) -> None:
        if self.validate_args:
            _binary_precision_recall_curve_tensor_validation(preds, target, self.ignore_index)
        preds, target, _ = _binary_precision_recall_curve_format(preds, target, self.thresholds, self.ignore_index)
        self._update_curve_state(
            _binary_precision_recall_curve_update(preds, target, self.thresholds, self.ignore_index)
        )

    def compute(self) -> Tuple[Tensor, Tensor, Tensor]:
        return _binary_precision_recall_curve_compute(self._final_state(), self.thresholds)


class MulticlassPrecisionRecallCurve(_CurveMetric):
    """Per-class precision-recall curves for multiclass tasks.

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
        self.num_classes = num_classes
        self.average = average
        self.ignore_index = ignore_index
        self.validate_args = validate_args
        self._create_curve_state(thresholds, (2, 2) if average == "micro" else (num_classes, 2, 2))

    def update(self, preds: Tensor, target: Tensor) -> None:
        if self.validate_args:
            _multiclass_precision_recall_curve_tensor_validation(preds, target, self.num_classes, self.ignore_index)
        preds, target, _ = _multiclass_precision_recall_curve_format(
            preds, target, self.num_classes, self.thresholds, self.ignore_index, self.average
        )
        self._update_curve_state(
            _multiclass_precision_recall_curve_update(
                preds, target, self.num_classes, self.thresholds, self.average, self.ignore_index
            )
        )

    def compute(self) -> Curves:
        return _multiclass_precision_recall_curve_compute(
            self._final_state(), self.num_classes, self.thresholds, self.average
        )


class MultilabelPrecisionRecallCurve(_CurveMetric):
    """Per-label precision-recall curves for multilabel tasks.

    Example:
        >>> import torch
        >>> from tpumetrics_torch.classification import MultilabelPrecisionRecallCurve
        >>> metric = MultilabelPrecisionRecallCurve(num_labels=2, thresholds=5, device='cpu')
        >>> metric.update(torch.tensor([[0.8, 0.1], [0.1, 0.8]]), torch.tensor([[1, 0], [0, 1]]))
        >>> precision, recall, thresholds = metric.compute()
        >>> tuple(precision.shape)
        (2, 6)
    """

    is_differentiable: bool = False
    higher_is_better: Optional[bool] = None
    full_state_update: bool = False

    def __init__(
        self,
        num_labels: int,
        thresholds: Thresholds = None,
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        if validate_args:
            _multilabel_precision_recall_curve_arg_validation(num_labels, thresholds, ignore_index)
        self.num_labels = num_labels
        self.ignore_index = ignore_index
        self.validate_args = validate_args
        self._create_curve_state(thresholds, (num_labels, 2, 2))

    def update(self, preds: Tensor, target: Tensor) -> None:
        if self.validate_args:
            _multilabel_precision_recall_curve_tensor_validation(preds, target, self.num_labels, self.ignore_index)
        preds, target, _ = _multilabel_precision_recall_curve_format(
            preds, target, self.num_labels, self.thresholds, self.ignore_index
        )
        self._update_curve_state(
            _multilabel_precision_recall_curve_update(
                preds, target, self.num_labels, self.thresholds, self.ignore_index
            )
        )

    def compute(self) -> Curves:
        return _multilabel_precision_recall_curve_compute(
            self._final_state(), self.num_labels, self.thresholds, self.ignore_index
        )


class PrecisionRecallCurve(_ClassificationTaskWrapper):
    """Task-string wrapper; other keyword arguments (``device=`` among them)
    go to the metric it returns.

    Example:
        >>> import torch
        >>> from tpumetrics_torch import PrecisionRecallCurve
        >>> probs = torch.tensor([0.11, 0.84, 0.22, 0.73, 0.33, 0.92])
        >>> target = torch.tensor([0, 1, 0, 1, 0, 1])
        >>> metric = PrecisionRecallCurve(task="binary", thresholds=4, device='cpu')
        >>> metric.update(probs, target)
        >>> precision, recall, thresholds = metric.compute()
        >>> tuple(precision.shape), tuple(recall.shape), tuple(thresholds.shape)
        ((5,), (5,), (4,))
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
            return BinaryPrecisionRecallCurve(**kwargs)
        if task == ClassificationTask.MULTICLASS:
            return MulticlassPrecisionRecallCurve(_check_task_size("num_classes", num_classes), **kwargs)
        return MultilabelPrecisionRecallCurve(_check_task_size("num_labels", num_labels), **kwargs)
