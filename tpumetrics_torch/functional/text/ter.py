"""Translation edit rate (port of ``tpumetrics/functional/text/ter.py``,
after Snover et al. 2006 and sacrebleu's Tercom port).

A host string algorithm: the Tercom tokenizer, a beam-pruned Levenshtein
distance with an operation trace on numpy cost and operation matrices, and
the greedy shift search. Only the edit and length sums live on the device.
"""

from __future__ import annotations

import math
import re
from functools import lru_cache
from typing import Dict, Iterator, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from tpumetrics_torch.metric import _resolve_device

Tensor = torch.Tensor

# Tercom's limits
_MAX_SHIFT_SIZE = 10
_MAX_SHIFT_DIST = 50
_MAX_SHIFT_CANDIDATES = 1000
_BEAM_WIDTH = 25
_INT_INFINITY = int(1e16)

# op codes in the DP trace
_OP_NOTHING, _OP_SUBSTITUTE, _OP_INSERT, _OP_DELETE, _OP_UNDEFINED = 0, 1, 2, 3, 4


class _TercomTokenizer:
    """The Tercom normalizer."""

    _ASIAN_PUNCTUATION = r"([、。〈-】〔-〟｡-･・])"
    _FULL_WIDTH_PUNCTUATION = r"([．，？：；！＂（）])"

    def __init__(
        self,
        normalize: bool = False,
        no_punctuation: bool = False,
        lowercase: bool = True,
        asian_support: bool = False,
    ) -> None:
        self.normalize = normalize
        self.no_punctuation = no_punctuation
        self.lowercase = lowercase
        self.asian_support = asian_support

    @lru_cache(maxsize=2**16)  # noqa: B019
    def __call__(self, sentence: str) -> str:
        if not sentence:
            return ""
        if self.lowercase:
            sentence = sentence.lower()
        if self.normalize:
            sentence = self._normalize_general_and_western(sentence)
            if self.asian_support:
                sentence = self._normalize_asian(sentence)
        if self.no_punctuation:
            sentence = self._remove_punct(sentence)
            if self.asian_support:
                sentence = self._remove_asian_punct(sentence)
        return " ".join(sentence.split())

    @staticmethod
    def _normalize_general_and_western(sentence: str) -> str:
        sentence = f" {sentence} "
        rules = [
            (r"\n-", ""),
            (r"\n", " "),
            (r"&quot;", '"'),
            (r"&amp;", "&"),
            (r"&lt;", "<"),
            (r"&gt;", ">"),
            (r"([{-~[-` -&(-+:-@/])", r" \1 "),
            (r"'s ", r" 's "),
            (r"'s$", r" 's"),
            (r"([^0-9])([\.,])", r"\1 \2 "),
            (r"([\.,])([^0-9])", r" \1 \2"),
            (r"([0-9])(-)", r"\1 \2 "),
        ]
        for pattern, replacement in rules:
            sentence = re.sub(pattern, replacement, sentence)
        return sentence

    @classmethod
    def _normalize_asian(cls, sentence: str) -> str:
        sentence = re.sub(r"([一-鿿㐀-䶿])", r" \1 ", sentence)
        sentence = re.sub(r"([㇀-㇯⺀-⻿])", r" \1 ", sentence)
        sentence = re.sub(r"([㌀-㏿豈-﫿︰-﹏])", r" \1 ", sentence)
        sentence = re.sub(r"([㈀-㼢])", r" \1 ", sentence)
        sentence = re.sub(r"(^|^[぀-ゟ])([぀-ゟ]+)(?=$|^[぀-ゟ])", r"\1 \2 ", sentence)
        sentence = re.sub(r"(^|^[゠-ヿ])([゠-ヿ]+)(?=$|^[゠-ヿ])", r"\1 \2 ", sentence)
        sentence = re.sub(r"(^|^[ㇰ-ㇿ])([ㇰ-ㇿ]+)(?=$|^[ㇰ-ㇿ])", r"\1 \2 ", sentence)
        sentence = re.sub(cls._ASIAN_PUNCTUATION, r" \1 ", sentence)
        return re.sub(cls._FULL_WIDTH_PUNCTUATION, r" \1 ", sentence)

    @staticmethod
    def _remove_punct(sentence: str) -> str:
        return re.sub(r"[\.,\?:;!\"\(\)]", "", sentence)

    @classmethod
    def _remove_asian_punct(cls, sentence: str) -> str:
        sentence = re.sub(cls._ASIAN_PUNCTUATION, r"", sentence)
        return re.sub(cls._FULL_WIDTH_PUNCTUATION, r"", sentence)


def _preprocess_sentence(sentence: str, tokenizer: _TercomTokenizer) -> str:
    return tokenizer(sentence.rstrip())


def _beam_edit_distance(
    prediction_tokens: List[str], reference_tokens: List[str]
) -> Tuple[int, List[int]]:
    """Beam-pruned Levenshtein DP with an operation trace. Returns
    (distance, trace of op codes rewriting the prediction into the
    reference).

    Tercom's preference order (no-op/substitute, then delete, then insert —
    the swap of insert/delete compensates for the later trace flip) is kept
    by the tie-breaking order of the candidate comparison.
    """
    pred_len = len(prediction_tokens)
    ref_len = len(reference_tokens)

    cost = np.full((pred_len + 1, ref_len + 1), _INT_INFINITY, dtype=np.int64)
    op = np.full((pred_len + 1, ref_len + 1), _OP_UNDEFINED, dtype=np.int8)
    cost[0] = np.arange(ref_len + 1)
    op[0] = _OP_INSERT

    length_ratio = ref_len / pred_len if prediction_tokens else 1.0
    beam_width = math.ceil(length_ratio / 2 + _BEAM_WIDTH) if length_ratio / 2 > _BEAM_WIDTH else _BEAM_WIDTH

    for i in range(1, pred_len + 1):
        pseudo_diag = math.floor(i * length_ratio)
        min_j = max(0, pseudo_diag - beam_width)
        max_j = ref_len + 1 if i == pred_len else min(ref_len + 1, pseudo_diag + beam_width)

        for j in range(min_j, max_j):
            if j == 0:
                cost[i][j] = cost[i - 1][j] + 1
                op[i][j] = _OP_DELETE
            else:
                if prediction_tokens[i - 1] == reference_tokens[j - 1]:
                    sub_cost, sub_op = cost[i - 1][j - 1], _OP_NOTHING
                else:
                    sub_cost, sub_op = cost[i - 1][j - 1] + 1, _OP_SUBSTITUTE
                best_cost, best_op = sub_cost, sub_op
                if cost[i - 1][j] + 1 < best_cost:
                    best_cost, best_op = cost[i - 1][j] + 1, _OP_DELETE
                if cost[i][j - 1] + 1 < best_cost:
                    best_cost, best_op = cost[i][j - 1] + 1, _OP_INSERT
                cost[i][j] = best_cost
                op[i][j] = best_op

    # backtrack
    trace: List[int] = []
    i, j = pred_len, ref_len
    while i > 0 or j > 0:
        operation = int(op[i][j])
        trace.append(operation)
        if operation in (_OP_NOTHING, _OP_SUBSTITUTE):
            i -= 1
            j -= 1
        elif operation == _OP_INSERT:
            j -= 1
        elif operation == _OP_DELETE:
            i -= 1
        else:
            raise ValueError(f"Unknown operation code {operation}")
    trace.reverse()
    return int(cost[pred_len][ref_len]), trace


def _flip_trace(trace: List[int]) -> List[int]:
    """Swap insertions and deletions: a->b recipe becomes b->a."""
    flip = {_OP_INSERT: _OP_DELETE, _OP_DELETE: _OP_INSERT}
    return [flip.get(o, o) for o in trace]


def _trace_to_alignment(trace: List[int]) -> Tuple[Dict[int, int], List[int], List[int]]:
    """Aligned positions + per-position error flags."""
    reference_position = hypothesis_position = -1
    reference_errors: List[int] = []
    hypothesis_errors: List[int] = []
    alignments: Dict[int, int] = {}
    for operation in trace:
        if operation == _OP_NOTHING:
            hypothesis_position += 1
            reference_position += 1
            alignments[reference_position] = hypothesis_position
            reference_errors.append(0)
            hypothesis_errors.append(0)
        elif operation == _OP_SUBSTITUTE:
            hypothesis_position += 1
            reference_position += 1
            alignments[reference_position] = hypothesis_position
            reference_errors.append(1)
            hypothesis_errors.append(1)
        elif operation == _OP_INSERT:
            hypothesis_position += 1
            hypothesis_errors.append(1)
        elif operation == _OP_DELETE:
            reference_position += 1
            alignments[reference_position] = hypothesis_position
            reference_errors.append(1)
        else:
            raise ValueError(f"Unknown operation code {operation}.")
    return alignments, reference_errors, hypothesis_errors


def _find_shifted_pairs(pred_words: List[str], target_words: List[str]) -> Iterator[Tuple[int, int, int]]:
    """Matching sub-sequences eligible for a Tercom shift."""
    for pred_start in range(len(pred_words)):
        for target_start in range(len(target_words)):
            if abs(target_start - pred_start) > _MAX_SHIFT_DIST:
                continue
            for length in range(1, _MAX_SHIFT_SIZE):
                if pred_words[pred_start + length - 1] != target_words[target_start + length - 1]:
                    break
                yield pred_start, target_start, length
                if len(pred_words) == pred_start + length or len(target_words) == target_start + length:
                    break


def _perform_shift(words: List[str], start: int, length: int, target: int) -> List[str]:
    """Move words[start:start+length] to position ``target``."""
    if target < start:
        return words[:target] + words[start : start + length] + words[target:start] + words[start + length :]
    if target > start + length:
        return words[:start] + words[start + length : target] + words[start : start + length] + words[target:]
    return (
        words[:start]
        + words[start + length : length + target]
        + words[start : start + length]
        + words[length + target :]
    )


def _shift_words(
    pred_words: List[str],
    target_words: List[str],
    edit_distance_fn,
    checked_candidates: int,
) -> Tuple[int, List[str], int]:
    """One round of Tercom's greedy best-shift search."""
    edit_distance, inverted_trace = edit_distance_fn(pred_words)
    trace = _flip_trace(inverted_trace)
    alignments, target_errors, pred_errors = _trace_to_alignment(trace)

    best: Optional[Tuple[int, int, int, int, List[str]]] = None
    for pred_start, target_start, length in _find_shifted_pairs(pred_words, target_words):
        # corner cases: shift only if both sides
        # have errors in the span and the span is not already aligned inside
        if sum(pred_errors[pred_start : pred_start + length]) == 0:
            continue
        if sum(target_errors[target_start : target_start + length]) == 0:
            continue
        if pred_start <= alignments[target_start] < pred_start + length:
            continue

        prev_idx = -1
        for offset in range(-1, length):
            if target_start + offset == -1:
                idx = 0
            elif target_start + offset in alignments:
                idx = alignments[target_start + offset] + 1
            else:
                break
            if idx == prev_idx:
                continue
            prev_idx = idx

            shifted_words = _perform_shift(pred_words, pred_start, length, idx)
            candidate = (
                edit_distance - edit_distance_fn(shifted_words)[0],
                length,
                -pred_start,
                -idx,
                shifted_words,
            )
            checked_candidates += 1
            if not best or candidate > best:
                best = candidate

        if checked_candidates >= _MAX_SHIFT_CANDIDATES:
            break

    if not best:
        return 0, pred_words, checked_candidates
    best_score, _, _, _, shifted_words = best
    return best_score, shifted_words, checked_candidates


def _translation_edit_rate(pred_words: List[str], target_words: List[str]) -> float:
    """Edits to match one hypothesis/reference pair, shifting while it helps
   ."""
    if len(target_words) == 0:
        return 0.0

    cache: Dict[tuple, Tuple[int, List[int]]] = {}

    def edit_distance_fn(words: List[str]) -> Tuple[int, List[int]]:
        key = tuple(words)
        if key not in cache:
            if len(cache) > 10000:
                cache.clear()
            cache[key] = _beam_edit_distance(words, target_words)
        return cache[key]

    num_shifts = 0
    checked_candidates = 0
    input_words = pred_words
    while True:
        delta, new_input_words, checked_candidates = _shift_words(
            input_words, target_words, edit_distance_fn, checked_candidates
        )
        if checked_candidates >= _MAX_SHIFT_CANDIDATES or delta <= 0:
            break
        num_shifts += 1
        input_words = new_input_words

    edit_distance, _ = edit_distance_fn(input_words)
    return float(num_shifts + edit_distance)


def _compute_sentence_statistics(
    pred_words: List[str], target_words: List[List[str]]
) -> Tuple[float, float]:
    """Best edits over references + average reference length.

    The roles are swapped here, as in sacrebleu: each reference is shifted
    against the hypothesis (``_translation_edit_rate(tgt, pred)``)."""
    tgt_lengths = 0.0
    best_num_edits = float(_INT_INFINITY)
    for tgt_words in target_words:
        num_edits = _translation_edit_rate(tgt_words, pred_words)
        tgt_lengths += len(tgt_words)
        if num_edits < best_num_edits:
            best_num_edits = num_edits
    return best_num_edits, tgt_lengths / len(target_words)


def _ter_update(
    preds: Union[str, Sequence[str]],
    target: Union[Sequence[str], Sequence[Sequence[str]]],
    tokenizer: _TercomTokenizer,
    total_num_edits: float,
    total_tgt_length: float,
    sentence_ter: Optional[List[float]] = None,
) -> Tuple[float, float]:
    """Accumulate corpus edit/length totals."""
    preds_ = [preds] if isinstance(preds, str) else list(preds)
    target_ = [[t] if isinstance(t, str) else list(t) for t in target]
    if len(preds_) != len(target_):
        raise ValueError(f"Corpus has different size {len(preds_)} != {len(target_)}")

    for pred, tgt in zip(preds_, target_):
        tgt_words_ = [_preprocess_sentence(_tgt, tokenizer).split() for _tgt in tgt]
        pred_words_ = _preprocess_sentence(pred, tokenizer).split()
        num_edits, tgt_length = _compute_sentence_statistics(pred_words_, tgt_words_)
        total_num_edits += num_edits
        total_tgt_length += tgt_length
        if sentence_ter is not None:
            sentence_ter.append(float(num_edits / tgt_length) if tgt_length > 0 else (1.0 if num_edits else 0.0))
    return total_num_edits, total_tgt_length


def _ter_compute(total_num_edits: Tensor, total_tgt_length: Tensor) -> Tensor:
    return total_num_edits.to(torch.float32) / total_tgt_length.to(torch.float32)


def _check_ter_args(normalize: bool, no_punctuation: bool, lowercase: bool, asian_support: bool) -> None:
    if not isinstance(normalize, bool):
        raise ValueError(f"Expected argument `normalize` to be of type boolean but got {normalize}.")
    if not isinstance(no_punctuation, bool):
        raise ValueError(f"Expected argument `no_punctuation` to be of type boolean but got {no_punctuation}.")
    if not isinstance(lowercase, bool):
        raise ValueError(f"Expected argument `lowercase` to be of type boolean but got {lowercase}.")
    if not isinstance(asian_support, bool):
        raise ValueError(f"Expected argument `asian_support` to be of type boolean but got {asian_support}.")


def translation_edit_rate(
    preds: Union[str, Sequence[str]],
    target: Union[Sequence[str], Sequence[Sequence[str]]],
    normalize: bool = False,
    no_punctuation: bool = False,
    lowercase: bool = True,
    asian_support: bool = False,
    return_sentence_level_score: bool = False,
    device: Optional[Union[str, torch.device]] = None,
) -> Union[Tensor, Tuple[Tensor, Tensor]]:
    """Translation edit rate.

    Example:
        >>> from tpumetrics_torch.functional.text import translation_edit_rate
        >>> preds = ['the cat is on the mat']
        >>> target = [['there is a cat on the mat', 'a cat is on the mat']]
        >>> round(float(translation_edit_rate(preds, target, device="cpu")), 4)
        0.1538
    """
    _check_ter_args(normalize, no_punctuation, lowercase, asian_support)
    device = _resolve_device(device)
    tokenizer = _TercomTokenizer(normalize, no_punctuation, lowercase, asian_support)
    sentence_ter: Optional[List[float]] = [] if return_sentence_level_score else None
    total_num_edits, total_tgt_length = _ter_update(preds, target, tokenizer, 0.0, 0.0, sentence_ter)
    score = _ter_compute(
        torch.tensor(total_num_edits, dtype=torch.float32, device=device),
        torch.tensor(total_tgt_length, dtype=torch.float32, device=device),
    )
    if return_sentence_level_score:
        return score, torch.tensor(sentence_ter, dtype=torch.float32, device=device)
    return score
