"""Extended edit distance (port of ``tpumetrics/functional/text/eed.py``,
after Stanchev, Wang & Ney, WMT 2019).

A host dynamic program over the CDER alignment grid, rows in numpy; the
sentence scores accumulate in a cat state.
"""

from __future__ import annotations

import re
import unicodedata
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from tpumetrics_torch.metric import _resolve_device

Tensor = torch.Tensor


def _eed_function(
    hyp: str,
    ref: str,
    alpha: float = 2.0,
    rho: float = 0.3,
    deletion: float = 0.2,
    insertion: float = 1.0,
) -> float:
    """Sentence-level EED: the CDER grid with long jumps at blanks and a
    coverage penalty. The deletion chain within a row is a sequential
    min-scan; the substitution and insertion candidates go row by row in
    numpy."""
    n = len(hyp)
    visits = np.full(n + 1, -1, dtype=np.int64)
    row = np.ones(n + 1)
    row[0] = 0.0
    hyp_chars = np.asarray([ord(c) for c in hyp]) if n else np.zeros(0, np.int64)

    for w in range(1, len(ref) + 1):
        ref_char = ord(ref[w - 1])
        base = np.empty(n + 1)
        base[0] = row[0] + 1.0
        if n:
            sub = row[:-1] + (hyp_chars != ref_char)
            ins = row[1:] + insertion
            base[1:] = np.minimum(sub, ins)
        next_row = base
        running = next_row[0]
        for i in range(1, n + 1):
            running = min(next_row[i], running + deletion)
            next_row[i] = running

        min_index = int(np.argmin(next_row))
        visits[min_index] += 1

        if ref[w - 1] == " ":  # long jump
            jump = alpha + next_row[min_index]
            np.minimum(next_row, jump, out=next_row)

        row = next_row

    coverage = rho * float(np.where(visits >= 0, visits, 1).sum())
    return min(1.0, (row[-1] + coverage) / (float(len(ref)) + coverage))


def _preprocess_en(sentence: str) -> str:
    """English preprocessing: punctuation split off, abbreviations kept."""
    if not isinstance(sentence, str):
        raise ValueError(f"Only strings allowed during preprocessing step, found {type(sentence)} instead")
    sentence = sentence.rstrip()
    for pattern, replacement in ((".", " ."), ("!", " !"), ("?", " ?"), (",", " ,")):
        sentence = sentence.replace(pattern, replacement)
    for pattern, replacement in (
        (r"\s+", r" "),
        (r"(\d) ([.,]) (\d)", r"\1\2\3"),
        (r"(Dr|Jr|Prof|Rev|Gen|Mr|Mt|Mrs|Ms) .", r"\1."),
    ):
        sentence = re.sub(pattern, replacement, sentence)
    for pattern, replacement in (("e . g .", "e.g."), ("i . e .", "i.e."), ("U . S .", "U.S.")):
        sentence = sentence.replace(pattern, replacement)
    return " " + sentence + " "


def _preprocess_ja(sentence: str) -> str:
    """Japanese preprocessing: NFKC normalization."""
    if not isinstance(sentence, str):
        raise ValueError(f"Only strings allowed during preprocessing step, found {type(sentence)} instead")
    return unicodedata.normalize("NFKC", sentence.rstrip())


def _preprocess_sentences(
    preds: Union[str, Sequence[str]],
    target: Sequence[Union[str, Sequence[str]]],
    language: str,
) -> Tuple[Sequence[str], Sequence[Sequence[str]]]:
    """Check the corpora and preprocess them for ``language``."""
    if isinstance(preds, str):
        preds = [preds]
    if all(isinstance(ref, str) for ref in target):
        target = [target] if len(preds) == 1 else [[ref] for ref in target]  # type: ignore[list-item]
    if preds and all(ref for ref in target) and len(target) != len(preds):
        raise ValueError(f"Corpus has different size {len(target)} != {len(preds)}")

    if language == "en":
        preprocess_function = _preprocess_en
    elif language == "ja":
        preprocess_function = _preprocess_ja
    else:
        raise ValueError(f"Expected argument `language` to either be `en` or `ja` but got {language}")

    preds = [preprocess_function(pred) for pred in preds]
    target = [[preprocess_function(ref) for ref in reference] for reference in target]
    return preds, target


def _compute_sentence_statistics(
    preds_word: str,
    target_words: Sequence[str],
    alpha: float = 2.0,
    rho: float = 0.3,
    deletion: float = 0.2,
    insertion: float = 1.0,
) -> float:
    """The best (lowest) score over the references."""
    best_score = float("inf")
    for reference in target_words:
        score = _eed_function(preds_word, reference, alpha, rho, deletion, insertion)
        best_score = min(best_score, score)
    return best_score


def _eed_update(
    preds: Union[str, Sequence[str]],
    target: Sequence[Union[str, Sequence[str]]],
    language: str = "en",
    alpha: float = 2.0,
    rho: float = 0.3,
    deletion: float = 0.2,
    insertion: float = 1.0,
    sentence_eed: Optional[List[float]] = None,
) -> List[float]:
    """Per-sentence EED scores (host floats)."""
    preds_, target_ = _preprocess_sentences(preds, target, language)
    if sentence_eed is None:
        sentence_eed = []
    if not preds_ or not target_ or not target_[0]:
        return sentence_eed
    for hypothesis, references in zip(preds_, target_):
        sentence_eed.append(_compute_sentence_statistics(hypothesis, references, alpha, rho, deletion, insertion))
    return sentence_eed


def _eed_compute(sentence_level_scores: Sequence[float], device: Optional[torch.device] = None) -> Tensor:
    """The average of the sentence scores (float64 on the host, then float32)."""
    if len(sentence_level_scores) == 0:
        return torch.zeros((), device=device)
    return torch.tensor(float(np.mean(np.asarray(sentence_level_scores))), dtype=torch.float32, device=device)


def _check_eed_params(alpha: float, rho: float, deletion: float, insertion: float) -> None:
    for param_name, param in (("alpha", alpha), ("rho", rho), ("deletion", deletion), ("insertion", insertion)):
        if not isinstance(param, float) or param < 0:
            raise ValueError(f"Parameter `{param_name}` is expected to be a non-negative float.")


def extended_edit_distance(
    preds: Union[str, Sequence[str]],
    target: Sequence[Union[str, Sequence[str]]],
    language: str = "en",
    return_sentence_level_score: bool = False,
    alpha: float = 2.0,
    rho: float = 0.3,
    deletion: float = 0.2,
    insertion: float = 1.0,
    device: Optional[Union[str, torch.device]] = None,
) -> Union[Tensor, Tuple[Tensor, Tensor]]:
    """Extended edit distance.

    Example:
        >>> from tpumetrics_torch.functional.text import extended_edit_distance
        >>> preds = ["this is the prediction", "here is an other sample"]
        >>> target = ["this is the reference", "here is another one"]
        >>> round(float(extended_edit_distance(preds, target, device="cpu")), 4)
        0.3078
    """
    _check_eed_params(alpha, rho, deletion, insertion)
    device = _resolve_device(device)
    sentence_level_scores = _eed_update(preds, target, language, alpha, rho, deletion, insertion)
    average = _eed_compute(sentence_level_scores, device)
    if return_sentence_level_score:
        return average, torch.tensor(sentence_level_scores, dtype=torch.float32, device=device)
    return average
