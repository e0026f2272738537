"""BLEUScore (port of ``tpumetrics/text/bleu.py``)."""

from __future__ import annotations

from typing import Any, Optional, Sequence, Union

import numpy as np
import torch

from tpumetrics_torch.functional.text.bleu import _bleu_score_compute, _bleu_score_update, _tokenize_fn
from tpumetrics_torch.metric import Metric

Tensor = torch.Tensor


class BLEUScore(Metric):
    """BLEU accumulated over batches: the lengths and the n-gram count
    vectors are float32 sum states. The update reads host strings.

    Args:
        n_gram: the largest n-gram order.
        smooth: apply Lin and Och's (2004) add-one smoothing.
        weights: the weight of each order (uniform when omitted).

    Example:
        >>> from tpumetrics_torch.text import BLEUScore
        >>> preds = ['the cat is on the mat']
        >>> target = [['there is a cat on the mat', 'a cat is on the mat']]
        >>> bleu = BLEUScore(device="cpu")
        >>> round(float(bleu(preds, target)), 4)
        0.7598
    """

    is_differentiable: bool = False
    higher_is_better: bool = True
    full_state_update: bool = True
    plot_lower_bound: float = 0.0
    plot_upper_bound: float = 1.0
    _update_reads_host = True

    def __init__(
        self,
        n_gram: int = 4,
        smooth: bool = False,
        weights: Optional[Sequence[float]] = None,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        self.n_gram = n_gram
        self.smooth = smooth
        if weights is not None and len(weights) != n_gram:
            raise ValueError(f"List of weights has different weights than `n_gram`: {len(weights)} != {n_gram}")
        self.weights = weights if weights is not None else [1.0 / n_gram] * n_gram
        self.tokenizer = _tokenize_fn

        self.add_state("preds_len", default=torch.zeros(()), dist_reduce_fx="sum")
        self.add_state("target_len", default=torch.zeros(()), dist_reduce_fx="sum")
        self.add_state("numerator", default=torch.zeros(n_gram), dist_reduce_fx="sum")
        self.add_state("denominator", default=torch.zeros(n_gram), dist_reduce_fx="sum")

    def update(self, preds: Union[str, Sequence[str]], target: Union[Sequence[str], Sequence[Sequence[str]]]) -> None:
        """Accumulate the clipped n-gram matches."""
        preds_ = [preds] if isinstance(preds, str) else preds
        target_ = [[tgt] if isinstance(tgt, str) else tgt for tgt in target]
        if len(preds_) != len(target_):
            raise ValueError(f"Corpus has different size {len(preds_)} != {len(target_)}")

        numerator = np.zeros(self.n_gram)
        denominator = np.zeros(self.n_gram)
        preds_len, target_len = _bleu_score_update(
            preds_, target_, numerator, denominator, 0.0, 0.0, self.n_gram, self.tokenizer
        )
        self.preds_len = self.preds_len + preds_len
        self.target_len = self.target_len + target_len
        self.numerator = self.numerator + torch.as_tensor(numerator, dtype=torch.float32, device=self.device)
        self.denominator = self.denominator + torch.as_tensor(denominator, dtype=torch.float32, device=self.device)

    def compute(self) -> Tensor:
        return _bleu_score_compute(
            self.preds_len, self.target_len, self.numerator, self.denominator, self.n_gram, self.weights, self.smooth
        )
