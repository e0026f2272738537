"""chrF / chrF++ score (port of ``tpumetrics/functional/text/chrf.py``, after
Popović's chrF and sacrebleu).

The n-grams are counted in host Python; the per-order totals are one
``(6, max_order)`` float32 tensor with sum-reduce sync, rows
``[hyp_char, hyp_word, ref_char, ref_word, match_char, match_word]``.
"""

from __future__ import annotations

from collections import Counter, defaultdict
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from tpumetrics_torch.metric import _resolve_device

Tensor = torch.Tensor

_EPS_SMOOTHING = 1e-16
# from sacrebleu's chrF implementation
_PUNCTUATIONS = set("!\"#$%&'()*+,-./:;<=>?@[\\]^_`{|}~")


def _get_characters(sentence: str, whitespace: bool) -> List[str]:
    """The character stream, whitespace stripped unless ``whitespace``."""
    if whitespace:
        return list(sentence)
    return list(sentence.strip().replace(" ", ""))


def _separate_word_and_punctuation(word: str) -> List[str]:
    """Split one leading or trailing punctuation mark off a word."""
    if len(word) == 1:
        return [word]
    if word[-1] in _PUNCTUATIONS:
        return [word[:-1], word[-1]]
    if word[0] in _PUNCTUATIONS:
        return [word[0], word[1:]]
    return [word]


def _get_words_and_punctuation(sentence: str) -> List[str]:
    """Word tokens with punctuation separated."""
    return sum((_separate_word_and_punctuation(word) for word in sentence.strip().split()), [])


def _ngram_counts(tokens: List[str], n_gram_order: int) -> Dict[int, Counter]:
    """1..n gram counters."""
    ngrams: Dict[int, Counter] = defaultdict(Counter)
    for n in range(1, n_gram_order + 1):
        for i in range(len(tokens) - n + 1):
            ngrams[n][tuple(tokens[i : i + n])] += 1
    return ngrams


def _sentence_counts(
    sentence: str, n_char_order: int, n_word_order: int, lowercase: bool, whitespace: bool
) -> Tuple[Dict[int, Counter], Dict[int, Counter], np.ndarray, np.ndarray]:
    """Character and word n-gram counters and their per-order totals."""
    if lowercase:
        sentence = sentence.lower()
    char_n_grams = _ngram_counts(_get_characters(sentence, whitespace), n_char_order)
    word_n_grams = _ngram_counts(_get_words_and_punctuation(sentence), n_word_order)
    total_char = np.asarray([sum(char_n_grams[n].values()) for n in range(1, n_char_order + 1)], np.float64)
    total_word = np.asarray([sum(word_n_grams[n].values()) for n in range(1, n_word_order + 1)], np.float64)
    return char_n_grams, word_n_grams, total_char, total_word


def _matches(hyp: Dict[int, Counter], ref: Dict[int, Counter], order: int) -> np.ndarray:
    """Clipped n-gram matches of each order."""
    return np.asarray([sum((hyp[n] & ref[n]).values()) for n in range(1, order + 1)], np.float64)


def _fscore_from_counts(
    matching_char: np.ndarray,
    matching_word: np.ndarray,
    ref_char: np.ndarray,
    ref_word: np.ndarray,
    hyp_char: np.ndarray,
    hyp_word: np.ndarray,
    n_order: float,
    beta: float,
) -> np.ndarray:
    """The chrF F-score averaged over every order (float64, on the host)."""

    def per_order(matching, ref, hyp):
        precision = np.where(hyp > 0, matching / np.maximum(hyp, 1), 0.0)
        recall = np.where(ref > 0, matching / np.maximum(ref, 1), 0.0)
        denominator = np.maximum(beta**2 * precision + recall, _EPS_SMOOTHING)
        return (1 + beta**2) * precision * recall / denominator

    total = per_order(matching_char, ref_char, hyp_char).sum()
    if matching_word.size:
        total = total + per_order(matching_word, ref_word, hyp_word).sum()
    return total / n_order


def _chrf_score_update(
    preds: Union[str, Sequence[str]],
    target: Union[Sequence[str], Sequence[Sequence[str]]],
    totals: np.ndarray,
    n_char_order: int,
    n_word_order: int,
    beta: float,
    lowercase: bool,
    whitespace: bool,
    sentence_chrf_score: Optional[List[float]] = None,
) -> np.ndarray:
    """Accumulate the corpus n-gram statistics into the host ``(6,
    max_order)`` array ``totals``, taking for each sentence the reference
    with the best sentence-level F-score."""
    preds_ = [preds] if isinstance(preds, str) else list(preds)
    target_ = [[t] if isinstance(t, str) else list(t) for t in target]
    if len(preds_) != len(target_):
        raise ValueError(f"Corpus has different size {len(preds_)} != {len(target_)}")

    n_order = float(n_char_order + n_word_order)
    for pred, references in zip(preds_, target_):
        hyp_char, hyp_word, hyp_char_total, hyp_word_total = _sentence_counts(
            pred, n_char_order, n_word_order, lowercase, whitespace
        )
        best = None
        for ref in references:
            ref_char, ref_word, ref_char_total, ref_word_total = _sentence_counts(
                ref, n_char_order, n_word_order, lowercase, whitespace
            )
            matching_char = _matches(hyp_char, ref_char, n_char_order)
            matching_word = _matches(hyp_word, ref_word, n_word_order)
            f_score = _fscore_from_counts(
                matching_char, matching_word, ref_char_total, ref_word_total,
                hyp_char_total, hyp_word_total, n_order, beta,
            )
            if best is None or f_score > best[0]:
                best = (f_score, ref_char_total, ref_word_total, matching_char, matching_word)

        if best is None:
            raise ValueError("Expected at least one reference for every prediction")
        f_score, ref_char_total, ref_word_total, matching_char, matching_word = best
        totals[0, :n_char_order] += hyp_char_total
        totals[1, :n_word_order] += hyp_word_total
        totals[2, :n_char_order] += ref_char_total
        totals[3, :n_word_order] += ref_word_total
        totals[4, :n_char_order] += matching_char
        totals[5, :n_word_order] += matching_word
        if sentence_chrf_score is not None:
            sentence_chrf_score.append(float(f_score))

    return totals


def _chrf_score_compute(totals: Tensor, n_char_order: int, n_word_order: int, beta: float) -> Tensor:
    """Corpus chrF from the accumulated ``(6, max_order)`` totals, in float32."""
    totals = totals.to(torch.float32)
    hyp_char, hyp_word = totals[0, :n_char_order], totals[1, :n_word_order]
    ref_char, ref_word = totals[2, :n_char_order], totals[3, :n_word_order]
    match_char, match_word = totals[4, :n_char_order], totals[5, :n_word_order]

    def per_order(matching, ref, hyp):
        precision = torch.where(hyp > 0, matching / torch.clamp(hyp, min=1), 0.0)
        recall = torch.where(ref > 0, matching / torch.clamp(ref, min=1), 0.0)
        denominator = torch.clamp(beta**2 * precision + recall, min=_EPS_SMOOTHING)
        return (1 + beta**2) * precision * recall / denominator

    total = per_order(match_char, ref_char, hyp_char).sum()
    if n_word_order:
        total = total + per_order(match_word, ref_word, hyp_word).sum()
    return total / (n_char_order + n_word_order)


def _check_chrf_args(n_char_order: int, n_word_order: int, beta: float) -> None:
    if not isinstance(n_char_order, int) or n_char_order < 1:
        raise ValueError("Expected argument `n_char_order` to be an integer greater than or equal to 1.")
    if not isinstance(n_word_order, int) or n_word_order < 0:
        raise ValueError("Expected argument `n_word_order` to be an integer greater than or equal to 0.")
    if beta < 0:
        raise ValueError("Expected argument `beta` to be greater than 0.")


def chrf_score(
    preds: Union[str, Sequence[str]],
    target: Union[Sequence[str], Sequence[Sequence[str]]],
    n_char_order: int = 6,
    n_word_order: int = 2,
    beta: float = 2.0,
    lowercase: bool = False,
    whitespace: bool = False,
    return_sentence_level_score: bool = False,
    device: Optional[Union[str, torch.device]] = None,
) -> Union[Tensor, Tuple[Tensor, Tensor]]:
    """chrF (``n_word_order=0``) or chrF++ (``n_word_order=2``) score.

    Example:
        >>> from tpumetrics_torch.functional.text import chrf_score
        >>> preds = ['the cat is on the mat']
        >>> target = [['there is a cat on the mat']]
        >>> round(float(chrf_score(preds, target, device="cpu")), 4)
        0.4942
    """
    _check_chrf_args(n_char_order, n_word_order, beta)
    device = _resolve_device(device)
    max_order = max(n_char_order, n_word_order, 1)
    totals = np.zeros((6, max_order))
    sentence_scores: Optional[List[float]] = [] if return_sentence_level_score else None
    totals = _chrf_score_update(
        preds, target, totals, n_char_order, n_word_order, beta, lowercase, whitespace, sentence_scores
    )
    score = _chrf_score_compute(
        torch.as_tensor(totals, dtype=torch.float32, device=device), n_char_order, n_word_order, beta
    )
    if return_sentence_level_score:
        return score, torch.tensor(sentence_scores, dtype=torch.float32, device=device)
    return score
