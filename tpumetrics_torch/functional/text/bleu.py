"""BLEU score (port of ``tpumetrics/functional/text/bleu.py``).

The n-grams are counted in host Python (strings); the four count
accumulators are float32 tensors with sum-reduce sync, and the brevity
penalty and geometric mean are torch ops on them, branch-free.
"""

from __future__ import annotations

from collections import Counter
from typing import Callable, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from tpumetrics_torch.metric import _resolve_device

Tensor = torch.Tensor


def _count_ngram(ngram_input_list: Sequence[str], n_gram: int) -> Counter:
    """All 1..n gram counts of a token list."""
    ngram_counter: Counter = Counter()
    for i in range(1, n_gram + 1):
        for j in range(len(ngram_input_list) - i + 1):
            ngram_counter[tuple(ngram_input_list[j : i + j])] += 1
    return ngram_counter


def _tokenize_fn(sentence: str) -> Sequence[str]:
    """Whitespace tokenization."""
    return sentence.split()


def _bleu_score_update(
    preds: Sequence[str],
    target: Sequence[Sequence[str]],
    numerator: np.ndarray,
    denominator: np.ndarray,
    preds_len: float,
    target_len: float,
    n_gram: int = 4,
    tokenizer: Callable[[str], Sequence[str]] = _tokenize_fn,
) -> Tuple[float, float]:
    """Accumulate the clipped n-gram matches of each order into the host
    arrays ``numerator`` and ``denominator`` (changed in place) and return
    the updated length sums."""
    target_tokens = [[tokenizer(line) if line else [] for line in t] for t in target]
    preds_tokens = [tokenizer(line) if line else [] for line in preds]

    for pred, targets in zip(preds_tokens, target_tokens):
        preds_len += len(pred)
        target_len_list = [len(tgt) for tgt in targets]
        target_len_diff = [abs(len(pred) - x) for x in target_len_list]
        target_len += target_len_list[target_len_diff.index(min(target_len_diff))]
        preds_counter = _count_ngram(pred, n_gram)
        target_counter: Counter = Counter()
        for tgt in targets:
            target_counter |= _count_ngram(tgt, n_gram)

        ngram_counter_clip = preds_counter & target_counter
        for counter_clip in ngram_counter_clip:
            numerator[len(counter_clip) - 1] += ngram_counter_clip[counter_clip]
        for counter in preds_counter:
            denominator[len(counter) - 1] += preds_counter[counter]

    return preds_len, target_len


def _bleu_score_compute(
    preds_len: Tensor,
    target_len: Tensor,
    numerator: Tensor,
    denominator: Tensor,
    n_gram: int,
    weights: Sequence[float],
    smooth: bool,
) -> Tensor:
    """Geometric mean of the n-gram precisions times the brevity penalty, in
    float32; the zero-match case and the brevity branch are masks."""
    device = numerator.device
    numerator = numerator.to(torch.float32)
    denominator = denominator.to(torch.float32)
    preds_len = torch.as_tensor(preds_len, dtype=torch.float32, device=device)
    target_len = torch.as_tensor(target_len, dtype=torch.float32, device=device)

    any_zero = torch.min(numerator) == 0.0
    safe_den = torch.where(denominator > 0, denominator, 1.0)
    if smooth:
        precision_scores = (numerator + 1.0) / (safe_den + 1.0)
        precision_scores = torch.cat([numerator[:1] / safe_den[:1], precision_scores[1:]])
    else:
        precision_scores = numerator / safe_den

    safe_precision = torch.where(precision_scores > 0, precision_scores, 1.0)
    log_precision_scores = torch.tensor(weights, dtype=torch.float32, device=device) * torch.log(safe_precision)
    geometric_mean = torch.exp(torch.sum(log_precision_scores))
    safe_preds_len = torch.where(preds_len > 0, preds_len, 1.0)
    brevity_penalty = torch.where(
        preds_len > target_len, torch.ones_like(preds_len), torch.exp(1 - (target_len / safe_preds_len))
    )
    return torch.where(any_zero, torch.zeros_like(preds_len), brevity_penalty * geometric_mean)


def bleu_score(
    preds: Union[str, Sequence[str]],
    target: Union[Sequence[str], Sequence[Sequence[str]]],
    n_gram: int = 4,
    smooth: bool = False,
    weights: Optional[Sequence[float]] = None,
    device: Optional[Union[str, torch.device]] = None,
) -> Tensor:
    """BLEU score of a translated corpus against its reference corpora.

    Example:
        >>> from tpumetrics_torch.functional.text import bleu_score
        >>> preds = ['the cat is on the mat']
        >>> target = [['there is a cat on the mat', 'a cat is on the mat']]
        >>> round(float(bleu_score(preds, target, device="cpu")), 4)
        0.7598
    """
    preds_ = [preds] if isinstance(preds, str) else preds
    target_ = [[tgt] if isinstance(tgt, str) else tgt for tgt in target]

    if len(preds_) != len(target_):
        raise ValueError(f"Corpus has different size {len(preds_)} != {len(target_)}")
    if weights is not None and len(weights) != n_gram:
        raise ValueError(f"List of weights has different weights than `n_gram`: {len(weights)} != {n_gram}")
    if weights is None:
        weights = [1.0 / n_gram] * n_gram

    device = _resolve_device(device)
    numerator = np.zeros(n_gram)
    denominator = np.zeros(n_gram)
    preds_len, target_len = _bleu_score_update(preds_, target_, numerator, denominator, 0.0, 0.0, n_gram)
    return _bleu_score_compute(
        preds_len,
        target_len,
        torch.as_tensor(numerator, dtype=torch.float32, device=device),
        torch.as_tensor(denominator, dtype=torch.float32, device=device),
        n_gram,
        weights,
        smooth,
    )
