"""ExtendedEditDistance (port of ``tpumetrics/text/eed.py``)."""

from __future__ import annotations

from typing import Any, Sequence, Tuple, Union

import torch

from tpumetrics_torch.functional.text.eed import _check_eed_params, _eed_update
from tpumetrics_torch.metric import Metric
from tpumetrics_torch.utils.data import dim_zero_cat

Tensor = torch.Tensor


class ExtendedEditDistance(Metric):
    """Extended edit distance accumulated over batches: the sentence scores
    are a float32 cat state. The update reads host strings.

    Example:
        >>> from tpumetrics_torch.text import ExtendedEditDistance
        >>> preds = ["this is the prediction", "here is an other sample"]
        >>> target = ["this is the reference", "here is another one"]
        >>> eed = ExtendedEditDistance(device="cpu")
        >>> round(float(eed(preds, target)), 4)
        0.3078
    """

    is_differentiable: bool = False
    higher_is_better: bool = False
    full_state_update: bool = False
    plot_lower_bound: float = 0.0
    plot_upper_bound: float = 1.0
    _update_reads_host = True

    def __init__(
        self,
        language: str = "en",
        return_sentence_level_score: bool = False,
        alpha: float = 2.0,
        rho: float = 0.3,
        deletion: float = 0.2,
        insertion: float = 1.0,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        if language not in ("en", "ja"):
            raise ValueError(f"Expected argument `language` to either be `en` or `ja` but got {language}")
        self.language = language
        self.return_sentence_level_score = return_sentence_level_score
        _check_eed_params(alpha, rho, deletion, insertion)
        self.alpha = alpha
        self.rho = rho
        self.deletion = deletion
        self.insertion = insertion

        self.add_state("sentence_eed", default=[], dist_reduce_fx="cat")

    def update(self, preds: Union[str, Sequence[str]], target: Sequence[Union[str, Sequence[str]]]) -> None:
        """Accumulate the sentence scores."""
        scores = _eed_update(preds, target, self.language, self.alpha, self.rho, self.deletion, self.insertion)
        if scores:
            self.sentence_eed.append(torch.tensor(scores, dtype=torch.float32, device=self.device))

    def compute(self) -> Union[Tensor, Tuple[Tensor, Tensor]]:
        if not self.sentence_eed:
            average = torch.zeros((), device=self.device)
            sentence_scores = torch.zeros((0,), dtype=torch.float32, device=self.device)
        else:
            sentence_scores = dim_zero_cat(self.sentence_eed)
            average = sentence_scores.mean()
        if self.return_sentence_level_score:
            return average, sentence_scores
        return average
