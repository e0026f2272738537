"""WordInfoLost (port of ``tpumetrics/text/wil.py``)."""

from __future__ import annotations

from typing import Any, List, Union

import torch

from tpumetrics_torch.functional.text.wil import _word_info_lost_compute, _word_info_lost_update
from tpumetrics_torch.metric import Metric

Tensor = torch.Tensor


class WordInfoLost(Metric):
    """Word information lost accumulated over batches in float32 sum states. The update
    reads host strings.

    Example:
        >>> from tpumetrics_torch.text import WordInfoLost
        >>> preds = ["this is the prediction", "there is an other sample"]
        >>> target = ["this is the reference", "there is another one"]
        >>> wil = WordInfoLost(device="cpu")
        >>> round(float(wil(preds, target)), 4)
        0.6528
    """

    is_differentiable: bool = False
    higher_is_better: bool = False
    full_state_update: bool = False
    plot_lower_bound: float = 0.0
    plot_upper_bound: float = 1.0
    _update_reads_host = True

    def __init__(self, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.add_state("errors", default=torch.zeros(()), dist_reduce_fx="sum")
        self.add_state("target_total", default=torch.zeros(()), dist_reduce_fx="sum")
        self.add_state("preds_total", default=torch.zeros(()), dist_reduce_fx="sum")

    def update(self, preds: Union[str, List[str]], target: Union[str, List[str]]) -> None:
        """Accumulate the word-hit statistics."""
        errors, target_total, preds_total = _word_info_lost_update(preds, target, self.device)
        self.errors = self.errors + errors
        self.target_total = self.target_total + target_total
        self.preds_total = self.preds_total + preds_total

    def compute(self) -> Tensor:
        return _word_info_lost_compute(self.errors, self.target_total, self.preds_total)
