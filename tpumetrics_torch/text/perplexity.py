"""Perplexity (port of ``tpumetrics/text/perplexity.py``)."""

from __future__ import annotations

from typing import Any, Optional

import torch

from tpumetrics_torch.functional.text.perplexity import _perplexity_compute, _perplexity_update
from tpumetrics_torch.metric import Metric

Tensor = torch.Tensor


class Perplexity(Metric):
    """Perplexity accumulated over batches: the summed negative
    log-probabilities and the token count are float32 sum states. All tensor
    work, through the ``token_nll`` kernel on a card, so a fused collection
    captures its update; differentiable.

    Example:
        >>> import torch
        >>> from tpumetrics_torch.text import Perplexity
        >>> gen = torch.Generator().manual_seed(22)
        >>> preds = torch.rand(2, 8, 5, generator=gen)
        >>> target = torch.randint(0, 5, (2, 8), generator=gen)
        >>> perp = Perplexity(device="cpu")
        >>> 4.0 < float(perp(preds, target)) < 6.0
        True
    """

    is_differentiable: bool = True
    higher_is_better: bool = False
    full_state_update: bool = False
    plot_lower_bound: float = 0.0

    def __init__(self, ignore_index: Optional[int] = None, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        if ignore_index is not None and not isinstance(ignore_index, int):
            raise ValueError(f"Argument `ignore_index` expected to either be `None` or an `int` but got {ignore_index}")
        self.ignore_index = ignore_index
        self.add_state("total_log_probs", default=torch.zeros(()), dist_reduce_fx="sum")
        self.add_state("count", default=torch.zeros(()), dist_reduce_fx="sum")

    def update(self, preds: Tensor, target: Tensor) -> None:
        """Accumulate the tokens' negative log-probabilities."""
        total_log_probs, count = _perplexity_update(preds, target, self.ignore_index)
        self.total_log_probs = self.total_log_probs + total_log_probs
        self.count = self.count + count

    def compute(self) -> Tensor:
        return _perplexity_compute(self.total_log_probs, self.count)
