"""WordErrorRate (port of ``tpumetrics/text/wer.py``)."""

from __future__ import annotations

from typing import Any, List, Union

import torch

from tpumetrics_torch.functional.text.wer import _wer_compute, _wer_update
from tpumetrics_torch.metric import Metric

Tensor = torch.Tensor


class WordErrorRate(Metric):
    """Word error rate accumulated over batches in float32 sum states. The update
    reads host strings.

    Example:
        >>> from tpumetrics_torch.text import WordErrorRate
        >>> preds = ["this is the prediction", "there is an other sample"]
        >>> target = ["this is the reference", "there is another one"]
        >>> wer = WordErrorRate(device="cpu")
        >>> round(float(wer(preds, target)), 4)
        0.5
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
        """Accumulate the edit distances and the reference word counts."""
        errors, total = _wer_update(preds, target, self.device)
        self.errors = self.errors + errors
        self.total = self.total + total

    def compute(self) -> Tensor:
        return _wer_compute(self.errors, self.total)
