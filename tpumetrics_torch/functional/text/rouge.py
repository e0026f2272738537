"""ROUGE score (port of ``tpumetrics/functional/text/rouge.py``, after Lin
(2004) and google-research/rouge)."""

from __future__ import annotations

import re
from collections import Counter
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from tpumetrics_torch.functional.text.helper import _token_ids
from tpumetrics_torch.metric import _resolve_device
from tpumetrics_torch.utils.imports import _NLTK_AVAILABLE
from tpumetrics_torch.utils.prints import rank_zero_warn

Tensor = torch.Tensor

ALLOWED_ROUGE_KEYS: Dict[str, Union[int, str]] = {
    "rouge1": 1,
    "rouge2": 2,
    "rouge3": 3,
    "rouge4": 4,
    "rouge5": 5,
    "rouge6": 6,
    "rouge7": 7,
    "rouge8": 8,
    "rouge9": 9,
    "rougeL": "L",
    "rougeLsum": "Lsum",
}
ALLOWED_ACCUMULATE_VALUES = ("avg", "best")

_PUNKT_STATE: dict = {}  # whether nltk's punkt data are present (looked up once a process), and the warning given


def _punkt_available() -> bool:
    """Whether nltk and its punkt sentence data are installed. Nothing is
    ever downloaded: without them rougeLsum takes the pinned fallback."""
    if "ok" not in _PUNKT_STATE:
        found = False
        if _NLTK_AVAILABLE:
            import nltk

            for path in ("tokenizers/punkt_tab/english/", "tokenizers/punkt"):
                try:
                    nltk.data.find(path)
                except LookupError:
                    continue
                found = True
                break
        _PUNKT_STATE["ok"] = found
    return _PUNKT_STATE["ok"]


def _split_sentence(x: str) -> Sequence[str]:
    """Sentence splitting for rougeLsum.

    With nltk's punkt data present this is ``nltk.sent_tokenize``. Without
    them the pinned fallback splits on newlines first (the ``rouge_score``
    package's own rougeLsum convention, one sentence a line), then on
    sentence-final punctuation within each line; where nltk is installed
    but its data are not, that is warned once a process."""
    x = re.sub("<n>", "", x)  # remove pegasus newline char
    if _punkt_available():
        import nltk

        try:
            return nltk.sent_tokenize(x)
        except LookupError:
            pass
    if _NLTK_AVAILABLE and not _PUNKT_STATE.get("warned"):
        _PUNKT_STATE["warned"] = True
        rank_zero_warn(
            "nltk punkt sentence tokenizer data is unavailable; rougeLsum falls back to"
            " newline-then-punctuation sentence splitting (the rouge_score newline"
            " convention). This is pinned behavior, warned once per process."
        )
    return [s for line in x.strip().splitlines() for s in re.split(r"(?<=[.!?])\s+", line.strip()) if s]


def _compute_metrics(hits_or_lcs: int, pred_len: int, target_len: int) -> Dict[str, float]:
    """precision/recall/F from a match count."""
    precision = hits_or_lcs / pred_len
    recall = hits_or_lcs / target_len
    if precision == recall == 0.0:
        return {"precision": 0.0, "recall": 0.0, "fmeasure": 0.0}
    fmeasure = 2 * precision * recall / (precision + recall)
    return {"precision": precision, "recall": recall, "fmeasure": fmeasure}


def _lcs_table(pred_tokens: Sequence[str], target_tokens: Sequence[str]) -> np.ndarray:
    """Full LCS DP table, numpy-vectorized over rows."""
    m, n = len(pred_tokens), len(target_tokens)
    table = np.zeros((n + 1, m + 1), dtype=np.int64)
    pred_ids, target_ids = _token_ids(pred_tokens, target_tokens)
    for i in range(1, n + 1):
        eq = pred_ids == target_ids[i - 1]
        row = table[i]
        prev = table[i - 1]
        for j in range(1, m + 1):
            row[j] = prev[j - 1] + 1 if eq[j - 1] else max(prev[j], row[j - 1])
    return table


def _lcs(pred_tokens: Sequence[str], target_tokens: Sequence[str]) -> int:
    return int(_lcs_table(pred_tokens, target_tokens)[-1, -1])


def _backtracked_lcs(
    lcs_table: np.ndarray, pred_tokens: Sequence[str], target_tokens: Sequence[str]
) -> Sequence[int]:
    """Indices of target tokens on one LCS path."""
    i = len(pred_tokens)
    j = len(target_tokens)
    backtracked: List[int] = []
    while i > 0 and j > 0:
        if pred_tokens[i - 1] == target_tokens[j - 1]:
            backtracked.insert(0, j - 1)
            i -= 1
            j -= 1
        elif lcs_table[j][i - 1] > lcs_table[j - 1][i]:
            i -= 1
        else:
            j -= 1
    return backtracked


def _union_lcs(pred_tokens_list: Sequence[Sequence[str]], target_tokens: Sequence[str]) -> Sequence[str]:
    """Union of per-sentence LCS matches."""
    def lcs_ind(pred_tokens: Sequence[str]) -> Sequence[int]:
        return _backtracked_lcs(_lcs_table(pred_tokens, target_tokens), pred_tokens, target_tokens)

    indices = sorted(set().union(*(lcs_ind(pred) for pred in pred_tokens_list)))
    return [target_tokens[i] for i in indices]


def _normalize_and_tokenize_text(
    text: str,
    stemmer: Optional[Any] = None,
    normalizer: Optional[Callable[[str], str]] = None,
    tokenizer: Optional[Callable[[str], Sequence[str]]] = None,
) -> Sequence[str]:
    """rouge-score compatible normalization + tokenization + optional Porter
    stemming."""
    text = normalizer(text) if callable(normalizer) else re.sub(r"[^a-z0-9]+", " ", text.lower())
    tokens = tokenizer(text) if callable(tokenizer) else re.split(r"\s+", text)
    if stemmer:
        tokens = [stemmer.stem(x) if len(x) > 3 else x for x in tokens]
    return [x for x in tokens if (isinstance(x, str) and len(x) > 0)]


def _create_ngrams(tokens: Sequence[str], n: int) -> Counter:
    ngrams: Counter = Counter()
    for i in range(len(tokens) - n + 1):
        ngrams[tuple(tokens[i : i + n])] += 1
    return ngrams


def _rouge_n_score(pred: Sequence[str], target: Sequence[str], n_gram: int) -> Dict[str, float]:
    """ROUGE-N."""
    pred_ngrams, target_ngrams = _create_ngrams(pred, n_gram), _create_ngrams(target, n_gram)
    pred_len, target_len = sum(pred_ngrams.values()), sum(target_ngrams.values())
    if 0 in (pred_len, target_len):
        return {"precision": 0.0, "recall": 0.0, "fmeasure": 0.0}
    hits = sum((pred_ngrams & target_ngrams).values())
    return _compute_metrics(hits, max(pred_len, 1), max(target_len, 1))


def _rouge_l_score(pred: Sequence[str], target: Sequence[str]) -> Dict[str, float]:
    """ROUGE-L."""
    pred_len, target_len = len(pred), len(target)
    if 0 in (pred_len, target_len):
        return {"precision": 0.0, "recall": 0.0, "fmeasure": 0.0}
    return _compute_metrics(_lcs(pred, target), pred_len, target_len)


def _rouge_lsum_score(pred: Sequence[Sequence[str]], target: Sequence[Sequence[str]]) -> Dict[str, float]:
    """ROUGE-Lsum over sentence-split summaries."""
    pred_len = sum(map(len, pred))
    target_len = sum(map(len, target))
    if 0 in (pred_len, target_len):
        return {"precision": 0.0, "recall": 0.0, "fmeasure": 0.0}

    def _get_token_counts(sentences: Sequence[Sequence[str]]) -> Counter:
        ngrams: Counter = Counter()
        for sentence in sentences:
            ngrams.update(sentence)
        return ngrams

    pred_tokens_count = _get_token_counts(pred)
    target_tokens_count = _get_token_counts(target)

    hits = 0
    for tgt in target:
        lcs = _union_lcs(pred, tgt)
        for token in lcs:
            if pred_tokens_count[token] > 0 and target_tokens_count[token] > 0:
                hits += 1
                pred_tokens_count[token] -= 1
                target_tokens_count[token] -= 1
    return _compute_metrics(hits, pred_len, target_len)


def _rouge_score_update(
    preds: Sequence[str],
    target: Sequence[Sequence[str]],
    rouge_keys_values: List[Union[int, str]],
    accumulate: str,
    stemmer: Optional[Any] = None,
    normalizer: Optional[Callable[[str], str]] = None,
    tokenizer: Optional[Callable[[str], Sequence[str]]] = None,
) -> Dict[Union[int, str], List[Dict[str, float]]]:
    """Per-pair rouge results, the references of a prediction accumulated by
    ``best`` or ``avg``."""
    results: Dict[Union[int, str], List[Dict[str, float]]] = {key: [] for key in rouge_keys_values}

    for pred_raw, target_raw in zip(preds, target):
        pred = _normalize_and_tokenize_text(pred_raw, stemmer, normalizer, tokenizer)
        if "Lsum" in rouge_keys_values:
            pred_lsum = [
                _normalize_and_tokenize_text(s, stemmer, normalizer, tokenizer)
                for s in _split_sentence(pred_raw)
            ]

        list_results = []
        for target_raw_inner in target_raw:
            tgt = _normalize_and_tokenize_text(target_raw_inner, stemmer, normalizer, tokenizer)
            if "Lsum" in rouge_keys_values:
                target_lsum = [
                    _normalize_and_tokenize_text(s, stemmer, normalizer, tokenizer)
                    for s in _split_sentence(target_raw_inner)
                ]
            result_inner: Dict[Union[int, str], Dict[str, float]] = {}
            for rouge_key in rouge_keys_values:
                if isinstance(rouge_key, int):
                    result_inner[rouge_key] = _rouge_n_score(pred, tgt, rouge_key)
                elif rouge_key == "L":
                    result_inner[rouge_key] = _rouge_l_score(pred, tgt)
                else:  # Lsum
                    result_inner[rouge_key] = _rouge_lsum_score(pred_lsum, target_lsum)
            list_results.append(result_inner)

        if accumulate == "best":
            key_curr = rouge_keys_values[0]
            highest_idx = int(np.argmax([v[key_curr]["fmeasure"] for v in list_results]))
            for rouge_key in rouge_keys_values:
                results[rouge_key].append(list_results[highest_idx][rouge_key])
        else:  # avg
            for rouge_key in rouge_keys_values:
                avg = {
                    t: float(np.mean([res[rouge_key][t] for res in list_results]))
                    for t in ("precision", "recall", "fmeasure")
                }
                results[rouge_key].append(avg)
    return results


def _check_rouge_args(use_stemmer: bool, accumulate: str, rouge_keys: Union[str, Tuple[str, ...]]) -> Tuple[str, ...]:
    """Check the arguments; return the keys as a tuple."""
    if use_stemmer and not _NLTK_AVAILABLE:
        raise ModuleNotFoundError("Stemmer requires that `nltk` is installed.")
    if accumulate not in ALLOWED_ACCUMULATE_VALUES:
        raise ValueError(
            f"Got unknown accumulate value {accumulate}. Expected to be one of {ALLOWED_ACCUMULATE_VALUES}"
        )
    if not isinstance(rouge_keys, tuple):
        rouge_keys = (rouge_keys,)
    for key in rouge_keys:
        if key not in ALLOWED_ROUGE_KEYS:
            raise ValueError(f"Got unknown rouge key {key}. Expected to be one of {list(ALLOWED_ROUGE_KEYS)}")
    return rouge_keys


def _porter_stemmer(use_stemmer: bool) -> Optional[Any]:
    if not use_stemmer:
        return None
    import nltk

    return nltk.stem.porter.PorterStemmer()


def _normalize_rouge_inputs(preds: Any, target: Any) -> Tuple[Sequence[str], Sequence[Sequence[str]]]:
    """Promote single strings: a list of strings as target is one reference
    a prediction (or the references of a single prediction)."""
    if isinstance(target, list) and all(isinstance(tgt, str) for tgt in target):
        target = [target] if isinstance(preds, str) else [[tgt] for tgt in target]
    if isinstance(preds, str):
        preds = [preds]
    if isinstance(target, str):
        target = [[target]]
    return preds, target


def rouge_score(
    preds: Union[str, Sequence[str]],
    target: Union[str, Sequence[str], Sequence[Sequence[str]]],
    accumulate: str = "best",
    use_stemmer: bool = False,
    normalizer: Optional[Callable[[str], str]] = None,
    tokenizer: Optional[Callable[[str], Sequence[str]]] = None,
    rouge_keys: Union[str, Tuple[str, ...]] = ("rouge1", "rouge2", "rougeL", "rougeLsum"),
    device: Optional[Union[str, torch.device]] = None,
) -> Dict[str, Tensor]:
    """ROUGE-N, ROUGE-L and ROUGE-Lsum.

    Example:
        >>> from tpumetrics_torch.functional.text import rouge_score
        >>> preds = "My name is John"
        >>> target = "Is your name John"
        >>> result = rouge_score(preds, target, rouge_keys="rouge1", device="cpu")
        >>> round(float(result["rouge1_fmeasure"]), 4)
        0.75
    """
    rouge_keys = _check_rouge_args(use_stemmer, accumulate, rouge_keys)
    device = _resolve_device(device)
    stemmer = _porter_stemmer(use_stemmer)
    rouge_keys_values = [ALLOWED_ROUGE_KEYS[key] for key in rouge_keys]
    preds, target = _normalize_rouge_inputs(preds, target)

    sentence_results = _rouge_score_update(
        preds, target, rouge_keys_values, accumulate, stemmer, normalizer, tokenizer
    )

    output: Dict[str, Tensor] = {}
    for rouge_key, results in sentence_results.items():
        suffix = rouge_key if isinstance(rouge_key, str) else str(rouge_key)
        prefix = f"rouge{suffix}"
        for t in ("precision", "recall", "fmeasure"):
            vals = [r[t] for r in results]
            output[f"{prefix}_{t}"] = torch.tensor(
                float(np.mean(vals)) if vals else 0.0, dtype=torch.float32, device=device
            )
    return output
