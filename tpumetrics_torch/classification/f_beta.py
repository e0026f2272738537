"""Modular F-beta / F1, multiclass part (port of ``tpumetrics/classification/f_beta.py``)."""

from __future__ import annotations

from typing import Any, Optional

import torch

from tpumetrics_torch.classification.stat_scores import MulticlassStatScores
from tpumetrics_torch.functional.classification.f_beta import _fbeta_reduce


class MulticlassFBetaScore(MulticlassStatScores):
    """Multiclass F-beta."""

    is_differentiable = False
    higher_is_better = True
    full_state_update: bool = False

    def __init__(
        self,
        beta: float,
        num_classes: int,
        top_k: int = 1,
        average: Optional[str] = "macro",
        multidim_average: str = "global",
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ) -> None:
        super().__init__(
            num_classes=num_classes,
            top_k=top_k,
            average=average,
            multidim_average=multidim_average,
            ignore_index=ignore_index,
            validate_args=validate_args,
            **kwargs,
        )
        if validate_args and not (isinstance(beta, float) and beta > 0):
            raise ValueError(f"Expected argument `beta` to be a float larger than 0, but got {beta}.")
        self.beta = beta

    def compute(self) -> torch.Tensor:
        tp, fp, tn, fn = self._final_state()
        return _fbeta_reduce(tp, fp, tn, fn, self.beta, average=self.average, multidim_average=self.multidim_average)


class MulticlassF1Score(MulticlassFBetaScore):
    """Multiclass F1 (beta=1).

    Example:
        >>> import torch
        >>> from tpumetrics_torch.classification import MulticlassF1Score
        >>> metric = MulticlassF1Score(num_classes=3, device='cpu')
        >>> metric.update(torch.tensor([2, 1, 0, 1]), torch.tensor([2, 1, 0, 0]))
        >>> round(float(metric.compute()), 4)
        0.7778
    """

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
        super().__init__(
            beta=1.0,
            num_classes=num_classes,
            top_k=top_k,
            average=average,
            multidim_average=multidim_average,
            ignore_index=ignore_index,
            validate_args=validate_args,
            **kwargs,
        )
