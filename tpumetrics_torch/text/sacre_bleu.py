"""SacreBLEUScore (port of ``tpumetrics/text/sacre_bleu.py``)."""

from __future__ import annotations

from typing import Any, Optional, Sequence

from tpumetrics_torch.functional.text.sacre_bleu import _SacreBLEUTokenizer
from tpumetrics_torch.text.bleu import BLEUScore


class SacreBLEUScore(BLEUScore):
    """BLEU with sacrebleu's tokenization; the count states of
    :class:`BLEUScore`.

    Args:
        n_gram: the largest n-gram order.
        smooth: apply add-one smoothing.
        tokenize: one of ``none``, ``13a``, ``zh``, ``intl`` (needs the
            ``regex`` package) and ``char``.
        lowercase: score case-insensitively.
        weights: the weight of each order (uniform when omitted).

    Example:
        >>> from tpumetrics_torch.text import SacreBLEUScore
        >>> preds = ['the cat is on the mat']
        >>> target = [['there is a cat on the mat', 'a cat is on the mat']]
        >>> sacre_bleu = SacreBLEUScore(device="cpu")
        >>> round(float(sacre_bleu(preds, target)), 4)
        0.7598
    """

    def __init__(
        self,
        n_gram: int = 4,
        smooth: bool = False,
        tokenize: str = "13a",
        lowercase: bool = False,
        weights: Optional[Sequence[float]] = None,
        **kwargs: Any,
    ) -> None:
        super().__init__(n_gram=n_gram, smooth=smooth, weights=weights, **kwargs)
        self.tokenizer = _SacreBLEUTokenizer(tokenize, lowercase)
