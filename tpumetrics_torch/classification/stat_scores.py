"""Modular stat-scores metrics, multiclass part (port of
``tpumetrics/classification/stat_scores.py``)."""

from __future__ import annotations

from typing import Any, Optional

import torch

from tpumetrics_torch.functional.classification.stat_scores import (
    _multiclass_stat_scores_arg_validation,
    _multiclass_stat_scores_compute,
    _multiclass_stat_scores_format,
    _multiclass_stat_scores_tensor_validation,
    _multiclass_stat_scores_update,
)
from tpumetrics_torch.metric import Metric
from tpumetrics_torch.utils.data import _count_dtype, dim_zero_cat

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
