"""Modular stat-scores metrics, binary, multiclass and multilabel, and the
``StatScores`` task wrapper (port of ``tpumetrics/classification/stat_scores.py``)."""

from __future__ import annotations

from typing import Any, Optional

import torch

from tpumetrics_torch.classification.base import _ClassificationTaskWrapper
from tpumetrics_torch.functional.classification.stat_scores import (
    _binary_stat_scores_arg_validation,
    _binary_stat_scores_compute,
    _binary_stat_scores_format,
    _binary_stat_scores_tensor_validation,
    _binary_stat_scores_update,
    _multiclass_stat_scores_arg_validation,
    _multiclass_stat_scores_compute,
    _multiclass_stat_scores_format,
    _multiclass_stat_scores_tensor_validation,
    _multiclass_stat_scores_update,
    _multilabel_stat_scores_arg_validation,
    _multilabel_stat_scores_compute,
    _multilabel_stat_scores_format,
    _multilabel_stat_scores_tensor_validation,
    _multilabel_stat_scores_update,
)
from tpumetrics_torch.metric import Metric
from tpumetrics_torch.utils.checks import _check_task_size
from tpumetrics_torch.utils.data import _count_dtype, dim_zero_cat
from tpumetrics_torch.utils.enums import ClassificationTask

Tensor = torch.Tensor


class _AbstractStatScores(Metric):
    """Shared tp/fp/tn/fn state machine: int32 tensor states with "sum" for
    ``multidim_average="global"``, list states with "cat" for ``"samplewise"``."""

    tp: Any
    fp: Any
    tn: Any
    fn: Any

    def _create_state(self, size: int, multidim_average: str = "global") -> None:
        for name in ("tp", "fp", "tn", "fn"):
            if multidim_average == "samplewise":
                self.add_state(name, [], dist_reduce_fx="cat")
            else:
                self.add_state(name, torch.zeros(size, dtype=_count_dtype()), dist_reduce_fx="sum")

    def _update_state(self, tp: Tensor, fp: Tensor, tn: Tensor, fn: Tensor) -> None:
        if isinstance(self.tp, list):
            self.tp.append(tp)
            self.fp.append(fp)
            self.tn.append(tn)
            self.fn.append(fn)
        else:
            self.tp = self.tp + tp
            self.fp = self.fp + fp
            self.tn = self.tn + tn
            self.fn = self.fn + fn

    def _final_state(self) -> tuple:
        """Concatenated list states, or the tensor states."""
        return dim_zero_cat(self.tp), dim_zero_cat(self.fp), dim_zero_cat(self.tn), dim_zero_cat(self.fn)


class BinaryStatScores(_AbstractStatScores):
    """tp/fp/tn/fn for binary classification.

    Example:
        >>> import torch
        >>> from tpumetrics_torch.classification import BinaryStatScores
        >>> target = torch.tensor([0, 1, 0, 1, 0, 1])
        >>> preds = torch.tensor([0, 0, 1, 1, 0, 1])
        >>> metric = BinaryStatScores(device='cpu')
        >>> metric.update(preds, target)
        >>> metric.compute().tolist()
        [2, 1, 2, 1, 3]
    """

    is_differentiable: bool = False
    higher_is_better: Optional[bool] = None
    full_state_update: bool = False

    def __init__(
        self,
        threshold: float = 0.5,
        multidim_average: str = "global",
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        if validate_args:
            _binary_stat_scores_arg_validation(threshold, multidim_average, ignore_index)
        self.threshold = threshold
        self.multidim_average = multidim_average
        self.ignore_index = ignore_index
        self.validate_args = validate_args
        self._create_state(size=1, multidim_average=multidim_average)

    def update(self, preds: Tensor, target: Tensor) -> None:
        if self.validate_args:
            _binary_stat_scores_tensor_validation(preds, target, self.multidim_average, self.ignore_index)
        preds, target, mask = _binary_stat_scores_format(preds, target, self.threshold, self.ignore_index)
        tp, fp, tn, fn = _binary_stat_scores_update(preds, target, mask, self.multidim_average)
        self._update_state(tp, fp, tn, fn)

    def compute(self) -> Tensor:
        tp, fp, tn, fn = self._final_state()
        return _binary_stat_scores_compute(tp, fp, tn, fn, self.multidim_average)


class MulticlassStatScores(_AbstractStatScores):
    """Per-class tp/fp/tn/fn for multiclass classification.

    Example:
        >>> import torch
        >>> from tpumetrics_torch.classification import MulticlassStatScores
        >>> target = torch.tensor([2, 1, 0, 0])
        >>> preds = torch.tensor([2, 1, 0, 1])
        >>> metric = MulticlassStatScores(num_classes=3, average='micro', device='cpu')
        >>> metric.update(preds, target)
        >>> metric.compute().tolist()
        [3, 1, 7, 1, 4]
    """

    is_differentiable: bool = False
    higher_is_better: Optional[bool] = None
    full_state_update: bool = False

    def __init__(
        self,
        num_classes: int,
        top_k: int = 1,
        average: Optional[str] = "macro",
        multidim_average: str = "global",
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        if validate_args:
            _multiclass_stat_scores_arg_validation(num_classes, top_k, average, multidim_average, ignore_index)
        self.num_classes = num_classes
        self.top_k = top_k
        self.average = average
        self.multidim_average = multidim_average
        self.ignore_index = ignore_index
        self.validate_args = validate_args
        self._create_state(size=num_classes, multidim_average=multidim_average)

    def update(self, preds: Tensor, target: Tensor) -> None:
        if self.validate_args:
            _multiclass_stat_scores_tensor_validation(
                preds, target, self.num_classes, self.multidim_average, self.ignore_index
            )
        preds, target, mask = _multiclass_stat_scores_format(
            preds, target, self.num_classes, self.ignore_index, self.top_k
        )
        tp, fp, tn, fn = _multiclass_stat_scores_update(
            preds, target, mask, self.num_classes, self.top_k, self.average, self.multidim_average
        )
        self._update_state(tp, fp, tn, fn)

    def compute(self) -> Tensor:
        tp, fp, tn, fn = self._final_state()
        return _multiclass_stat_scores_compute(tp, fp, tn, fn, self.average, self.multidim_average)


class MultilabelStatScores(_AbstractStatScores):
    """Per-label tp/fp/tn/fn for multilabel classification.

    Example:
        >>> import torch
        >>> from tpumetrics_torch.classification import MultilabelStatScores
        >>> target = torch.tensor([[0, 1, 0], [1, 0, 1]])
        >>> preds = torch.tensor([[0, 0, 1], [1, 0, 1]])
        >>> metric = MultilabelStatScores(num_labels=3, average='micro', device='cpu')
        >>> metric.update(preds, target)
        >>> metric.compute().tolist()
        [2, 1, 2, 1, 3]
    """

    is_differentiable: bool = False
    higher_is_better: Optional[bool] = None
    full_state_update: bool = False

    def __init__(
        self,
        num_labels: int,
        threshold: float = 0.5,
        average: Optional[str] = "macro",
        multidim_average: str = "global",
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        if validate_args:
            _multilabel_stat_scores_arg_validation(num_labels, threshold, average, multidim_average, ignore_index)
        self.num_labels = num_labels
        self.threshold = threshold
        self.average = average
        self.multidim_average = multidim_average
        self.ignore_index = ignore_index
        self.validate_args = validate_args
        self._create_state(size=num_labels, multidim_average=multidim_average)

    def update(self, preds: Tensor, target: Tensor) -> None:
        if self.validate_args:
            _multilabel_stat_scores_tensor_validation(
                preds, target, self.num_labels, self.multidim_average, self.ignore_index
            )
        preds, target, mask = _multilabel_stat_scores_format(
            preds, target, self.num_labels, self.threshold, self.ignore_index
        )
        tp, fp, tn, fn = _multilabel_stat_scores_update(preds, target, mask, self.multidim_average)
        self._update_state(tp, fp, tn, fn)

    def compute(self) -> Tensor:
        tp, fp, tn, fn = self._final_state()
        return _multilabel_stat_scores_compute(tp, fp, tn, fn, self.average, self.multidim_average)


def _check_top_k(top_k: Optional[int]) -> int:
    if not isinstance(top_k, int):
        raise ValueError(f"`top_k` is expected to be `int` but `{type(top_k)} was passed.`")
    return top_k


def _stat_scores_task_metric(
    binary: type,
    multiclass: type,
    multilabel: type,
    task: str,
    threshold: float,
    num_classes: Optional[int],
    num_labels: Optional[int],
    average: Optional[str],
    top_k: Optional[int],
    kwargs: dict,
) -> Metric:
    """The metric of ``task`` a stat-score task wrapper returns, from its
    binary, multiclass and multilabel classes."""
    task = ClassificationTask.from_str(task)
    if task == ClassificationTask.BINARY:
        return binary(threshold, **kwargs)
    if task == ClassificationTask.MULTICLASS:
        return multiclass(_check_task_size("num_classes", num_classes), _check_top_k(top_k), average, **kwargs)
    return multilabel(_check_task_size("num_labels", num_labels), threshold, average, **kwargs)


class StatScores(_ClassificationTaskWrapper):
    """Task-string wrapper: ``StatScores(task="binary", ...)`` returns the
    binary, multiclass or multilabel metric; other keyword arguments
    (``device=`` among them) go to that metric.

    Example:
        >>> import torch
        >>> from tpumetrics_torch import StatScores
        >>> probs = torch.tensor([0.11, 0.84, 0.22, 0.73, 0.33, 0.92])
        >>> target = torch.tensor([0, 1, 0, 1, 0, 1])
        >>> metric = StatScores(task="binary", device='cpu')
        >>> metric.update(probs, target)
        >>> metric.compute().tolist()
        [3, 0, 3, 0, 3]
    """

    def __new__(  # type: ignore[misc]
        cls,
        task: str,
        threshold: float = 0.5,
        num_classes: Optional[int] = None,
        num_labels: Optional[int] = None,
        average: Optional[str] = "micro",
        multidim_average: str = "global",
        top_k: Optional[int] = 1,
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ) -> Metric:
        kwargs.update(
            {"multidim_average": multidim_average, "ignore_index": ignore_index, "validate_args": validate_args}
        )
        return _stat_scores_task_metric(
            BinaryStatScores, MulticlassStatScores, MultilabelStatScores, task, threshold, num_classes, num_labels,
            average, top_k, kwargs,
        )
