"""CharErrorRate (port of ``tpumetrics/text/cer.py``)."""

from __future__ import annotations

from typing import Any, List, Union

import torch

from tpumetrics_torch.functional.text.cer import _cer_compute, _cer_update
from tpumetrics_torch.metric import Metric

Tensor = torch.Tensor


class CharErrorRate(Metric):
    """Character error rate accumulated over batches in float32 sum states. The update
    reads host strings.

    Example:
        >>> from tpumetrics_torch.text import CharErrorRate
        >>> preds = ["this is the prediction", "there is an other sample"]
        >>> target = ["this is the reference", "there is another one"]
        >>> cer = CharErrorRate(device="cpu")
        >>> round(float(cer(preds, target)), 4)
        0.3415
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
        """Accumulate the character edit distances and the reference character counts."""
        errors, total = _cer_update(preds, target, self.device)
        self.errors = self.errors + errors
        self.total = self.total + total

    def compute(self) -> Tensor:
        return _cer_compute(self.errors, self.total)
