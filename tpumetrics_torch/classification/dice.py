"""Modular Dice score (port of ``tpumetrics/classification/dice.py``).

The ``tp``/``fp``/``fn`` states are float32, as in the JAX package: each
batch's int32 counts are cast to float32 and added in order, so the card and
the CPU hold the same states bit for bit, and past 2^24 per class a state
rounds as the JAX package's does. ``average="samples"`` and
``mdmc_average="samplewise"`` keep a float32 score sum and sample count
instead. With scores ``(N, C, ...)``, or a ``num_classes``, an update reads
nothing on the host, so the fused collection update captures and replays it.
"""

from __future__ import annotations

from typing import Any, Optional

import torch

from tpumetrics_torch.functional.classification.dice import (
    _check_mdmc,
    _dice_arg_validation,
    _dice_counts,
    _dice_format,
    _dice_reduce,
    _dice_samplewise,
    _dice_score,
    _drop_ignored_class,
)
from tpumetrics_torch.metric import Metric

Tensor = torch.Tensor


class Dice(Metric):
    """Dice = 2 TP / (2 TP + FP + FN). ``average='micro'``/``'samples'``
    keep scalar accumulators; the per-class averages (``'macro'``,
    ``'weighted'``, ``'none'``) need ``num_classes``.

    Example:
        >>> import torch
        >>> from tpumetrics_torch.classification import Dice
        >>> metric = Dice(average='micro', device='cpu')
        >>> metric.update(torch.tensor([2, 0, 2, 1]), torch.tensor([1, 1, 2, 0]))
        >>> round(float(metric.compute()), 4)
        0.25
    """

    is_differentiable: bool = False
    higher_is_better: bool = True
    full_state_update: bool = False

    def __init__(
        self,
        zero_division: int = 0,
        num_classes: Optional[int] = None,
        threshold: float = 0.5,
        average: Optional[str] = "micro",
        mdmc_average: Optional[str] = "global",
        ignore_index: Optional[int] = None,
        top_k: Optional[int] = None,
        multiclass: Optional[bool] = None,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        _dice_arg_validation(average, mdmc_average, multiclass)
        if average in ("macro", "weighted", "none", None) and num_classes is None:
            raise ValueError(f"When you set `average` as {average}, you have to provide the number of classes.")
        if num_classes is not None and ignore_index is not None and not 0 <= ignore_index < num_classes:
            raise ValueError(f"The `ignore_index` {ignore_index} is not valid for inputs with {num_classes} classes")
        if mdmc_average == "samplewise" and average not in ("micro", "macro"):
            raise ValueError("mdmc_average='samplewise' supports average in ('micro', 'macro') here")
        self.zero_division = zero_division
        self.num_classes = num_classes
        self.threshold = threshold
        self.average = average
        self.mdmc_average = mdmc_average
        self.ignore_index = ignore_index
        self.top_k = top_k
        self.multiclass = multiclass

        if self._samplewise:
            self.add_state("sample_score", torch.zeros(()), dist_reduce_fx="sum")
            self.add_state("sample_total", torch.zeros(()), dist_reduce_fx="sum")
        else:
            size = 1 if average == "micro" else num_classes
            for name in ("tp", "fp", "fn"):
                self.add_state(name, torch.zeros(size, dtype=torch.float32), dist_reduce_fx="sum")

    @property
    def _samplewise(self) -> bool:
        return self.average == "samples" or self.mdmc_average == "samplewise"

    def update(self, preds: Tensor, target: Tensor) -> None:
        preds_oh, target_oh, n_cls = _dice_format(preds, target, self.threshold, self.top_k, self.num_classes)
        preds_oh, target_oh = _drop_ignored_class(preds_oh, target_oh, n_cls, self.ignore_index)
        _check_mdmc(self.mdmc_average, target)
        if self.mdmc_average == "samplewise":
            score_sum, count = _dice_samplewise(
                preds, target, preds_oh, target_oh, n_cls, self.average, self.zero_division, self.ignore_index
            )
        elif self.average == "samples":
            tp, fp, fn = (x.to(torch.float32) for x in _dice_counts(preds_oh, target_oh, dim=1))
            scores = _dice_score(tp, fp, fn, self.zero_division)
            score_sum, count = scores.sum(), scores.shape[0]
        else:
            tp, fp, fn = (x.to(torch.float32) for x in _dice_counts(preds_oh, target_oh, dim=0))
            if self.average == "micro":
                tp, fp, fn = tp.sum(dim=0, keepdim=True), fp.sum(dim=0, keepdim=True), fn.sum(dim=0, keepdim=True)
            self.tp = self.tp + tp
            self.fp = self.fp + fp
            self.fn = self.fn + fn
            return
        self.sample_score = self.sample_score + score_sum
        self.sample_total = self.sample_total + count

    def compute(self) -> Tensor:
        if self._samplewise:
            return self.sample_score / self.sample_total
        if self.average == "micro":
            return _dice_score(self.tp[0], self.fp[0], self.fn[0], self.zero_division)
        return _dice_reduce(self.tp, self.fp, self.fn, self.average, self.zero_division, self.ignore_index)
