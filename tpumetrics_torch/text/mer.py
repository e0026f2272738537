"""MatchErrorRate (port of ``tpumetrics/text/mer.py``)."""

from __future__ import annotations

from typing import Any, List, Union

import torch

from tpumetrics_torch.functional.text.mer import _mer_compute, _mer_update
from tpumetrics_torch.metric import Metric

Tensor = torch.Tensor


class MatchErrorRate(Metric):
    """Match error rate accumulated over batches in float32 sum states. The update
    reads host strings.

    Example:
        >>> from tpumetrics_torch.text import MatchErrorRate
        >>> preds = ["this is the prediction", "there is an other sample"]
        >>> target = ["this is the reference", "there is another one"]
        >>> mer = MatchErrorRate(device="cpu")
        >>> round(float(mer(preds, target)), 4)
        0.4444
    """

    is_differentiable: bool = False
    higher_is_better: bool = False
    full_state_update: bool = False
    plot_lower_bound: float = 0.0
    _update_reads_host = True

    def __init__(self, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.add_state("errors", default=torch.zeros(()), dist_reduce_fx="sum")
        self.add_state("total", default=torch.zeros(()), dist_reduce_fx="sum")

    def update(self, preds: Union[str, List[str]], target: Union[str, List[str]]) -> None:
        """Accumulate the edit distances and the longer side's word counts."""
        errors, total = _mer_update(preds, target, self.device)
        self.errors = self.errors + errors
        self.total = self.total + total

    def compute(self) -> Tensor:
        return _mer_compute(self.errors, self.total)
