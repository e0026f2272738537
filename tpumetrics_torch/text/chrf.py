"""CHRFScore (port of ``tpumetrics/text/chrf.py``)."""

from __future__ import annotations

from typing import Any, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from tpumetrics_torch.functional.text.chrf import _check_chrf_args, _chrf_score_compute, _chrf_score_update
from tpumetrics_torch.metric import Metric
from tpumetrics_torch.utils.data import dim_zero_cat

Tensor = torch.Tensor


class CHRFScore(Metric):
    """chrF or chrF++ accumulated over batches: one ``(6, max_order)``
    float32 sum state of the n-gram totals. The update reads host strings,
    and reads the totals back to add the batch's in float64, as the JAX
    package does.

    Example:
        >>> from tpumetrics_torch.text import CHRFScore
        >>> preds = ['the cat is on the mat']
        >>> target = [['there is a cat on the mat']]
        >>> chrf = CHRFScore(device="cpu")
        >>> round(float(chrf(preds, target)), 4)
        0.4942
    """

    is_differentiable: bool = False
    higher_is_better: bool = True
    full_state_update: bool = True
    plot_lower_bound: float = 0.0
    plot_upper_bound: float = 1.0
    _update_reads_host = True

    def __init__(
        self,
        n_char_order: int = 6,
        n_word_order: int = 2,
        beta: float = 2.0,
        lowercase: bool = False,
        whitespace: bool = False,
        return_sentence_level_score: bool = False,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        _check_chrf_args(n_char_order, n_word_order, beta)
        self.n_char_order = n_char_order
        self.n_word_order = n_word_order
        self.beta = beta
        self.lowercase = lowercase
        self.whitespace = whitespace
        self.return_sentence_level_score = return_sentence_level_score

        max_order = max(n_char_order, n_word_order, 1)
        self.add_state("totals", default=torch.zeros((6, max_order)), dist_reduce_fx="sum")
        if return_sentence_level_score:
            self.add_state("sentence_chrf_score", default=[], dist_reduce_fx="cat")

    def update(self, preds: Union[str, Sequence[str]], target: Union[Sequence[str], Sequence[Sequence[str]]]) -> None:
        """Accumulate the corpus n-gram totals."""
        sentence_scores: Optional[List[float]] = [] if self.return_sentence_level_score else None
        totals = self.totals.cpu().numpy().astype(np.float64)
        totals = _chrf_score_update(
            preds,
            target,
            totals,
            self.n_char_order,
            self.n_word_order,
            self.beta,
            self.lowercase,
            self.whitespace,
            sentence_scores,
        )
        self.totals = torch.as_tensor(totals, dtype=torch.float32, device=self.device)
        if sentence_scores is not None:
            self.sentence_chrf_score.append(torch.tensor(sentence_scores, dtype=torch.float32, device=self.device))

    def compute(self) -> Union[Tensor, Tuple[Tensor, Tensor]]:
        score = _chrf_score_compute(self.totals, self.n_char_order, self.n_word_order, self.beta)
        if self.return_sentence_level_score:
            return score, dim_zero_cat(self.sentence_chrf_score)
        return score
