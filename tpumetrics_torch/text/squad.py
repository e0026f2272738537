"""SQuAD (port of ``tpumetrics/text/squad.py``)."""

from __future__ import annotations

from typing import Any, Dict

import torch

from tpumetrics_torch.functional.text.squad import _squad_compute, _squad_input_check, _squad_update
from tpumetrics_torch.metric import Metric

Tensor = torch.Tensor


class SQuAD(Metric):
    """SQuAD v1.1 exact match and F1 accumulated over batches in float32 sum
    states. The update reads host strings.

    Example:
        >>> from tpumetrics_torch.text import SQuAD
        >>> preds = [{"prediction_text": "1976", "id": "56e10a3be3433e1400422b22"}]
        >>> target = [{"answers": {"answer_start": [97], "text": ["1976"]}, "id": "56e10a3be3433e1400422b22"}]
        >>> squad = SQuAD(device="cpu")
        >>> {k: float(v) for k, v in squad(preds, target).items()}
        {'exact_match': 100.0, 'f1': 100.0}
    """

    is_differentiable: bool = False
    higher_is_better: bool = True
    full_state_update: bool = False
    plot_lower_bound: float = 0.0
    plot_upper_bound: float = 100.0
    _update_reads_host = True

    def __init__(self, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.add_state("f1_score", default=torch.zeros(()), dist_reduce_fx="sum")
        self.add_state("exact_match", default=torch.zeros(()), dist_reduce_fx="sum")
        self.add_state("total", default=torch.zeros(()), dist_reduce_fx="sum")

    def update(self, preds: Any, target: Any) -> None:
        """Accumulate the exact-match and F1 sums."""
        preds_dict, target_dict = _squad_input_check(preds, target)
        f1, exact_match, total = _squad_update(preds_dict, target_dict, self.device)
        self.f1_score = self.f1_score + f1
        self.exact_match = self.exact_match + exact_match
        self.total = self.total + total

    def compute(self) -> Dict[str, Tensor]:
        return _squad_compute(self.f1_score, self.exact_match, self.total)
