"""TranslationEditRate (port of ``tpumetrics/text/ter.py``)."""

from __future__ import annotations

from typing import Any, List, Optional, Sequence, Tuple, Union

import torch

from tpumetrics_torch.functional.text.ter import _check_ter_args, _TercomTokenizer, _ter_compute, _ter_update
from tpumetrics_torch.metric import Metric
from tpumetrics_torch.utils.data import dim_zero_cat

Tensor = torch.Tensor


class TranslationEditRate(Metric):
    """Translation edit rate accumulated over batches: the edits and the
    reference lengths are float32 sum states. The update reads host strings.

    Example:
        >>> from tpumetrics_torch.text import TranslationEditRate
        >>> preds = ['the cat is on the mat']
        >>> target = [['there is a cat on the mat', 'a cat is on the mat']]
        >>> ter = TranslationEditRate(device="cpu")
        >>> round(float(ter(preds, target)), 4)
        0.1538
    """

    is_differentiable: bool = False
    higher_is_better: bool = False
    full_state_update: bool = False
    plot_lower_bound: float = 0.0
    _update_reads_host = True

    def __init__(
        self,
        normalize: bool = False,
        no_punctuation: bool = False,
        lowercase: bool = True,
        asian_support: bool = False,
        return_sentence_level_score: bool = False,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        _check_ter_args(normalize, no_punctuation, lowercase, asian_support)
        self.tokenizer = _TercomTokenizer(normalize, no_punctuation, lowercase, asian_support)
        self.return_sentence_level_score = return_sentence_level_score

        self.add_state("total_num_edits", default=torch.zeros(()), dist_reduce_fx="sum")
        self.add_state("total_tgt_length", default=torch.zeros(()), dist_reduce_fx="sum")
        if return_sentence_level_score:
            self.add_state("sentence_ter", default=[], dist_reduce_fx="cat")

    def update(self, preds: Union[str, Sequence[str]], target: Union[Sequence[str], Sequence[Sequence[str]]]) -> None:
        """Accumulate the edit counts and reference lengths."""
        sentence_scores: Optional[List[float]] = [] if self.return_sentence_level_score else None
        num_edits, tgt_length = _ter_update(preds, target, self.tokenizer, 0.0, 0.0, sentence_scores)
        self.total_num_edits = self.total_num_edits + num_edits
        self.total_tgt_length = self.total_tgt_length + tgt_length
        if sentence_scores is not None:
            self.sentence_ter.append(torch.tensor(sentence_scores, dtype=torch.float32, device=self.device))

    def compute(self) -> Union[Tensor, Tuple[Tensor, Tensor]]:
        score = _ter_compute(self.total_num_edits, self.total_tgt_length)
        if self.return_sentence_level_score:
            return score, dim_zero_cat(self.sentence_ter)
        return score
