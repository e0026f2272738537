"""SacreBLEU (port of ``tpumetrics/functional/text/sacre_bleu.py``): BLEU
over sacrebleu-compatible tokenizations."""

from __future__ import annotations

import re
from typing import Optional, Sequence, Union

import numpy as np
import torch

from tpumetrics_torch.functional.text.bleu import _bleu_score_compute, _bleu_score_update
from tpumetrics_torch.metric import _resolve_device
from tpumetrics_torch.utils.imports import _REGEX_AVAILABLE

Tensor = torch.Tensor

AVAILABLE_TOKENIZERS = ("none", "13a", "zh", "intl", "char")


class _SacreBLEUTokenizer:
    """Sacrebleu-compatible tokenizers: ``13a`` (WMT mteval-v13a), ``zh``
    (Chinese characters split, then 13a), ``intl`` (mteval-v14
    international; needs the ``regex`` package, and raises without it),
    ``char`` and ``none``."""

    _REGEX = (
        (re.compile(r"([\{-\~\[-\` -\&\(-\+\:-\@\/])"), r" \1 "),
        (re.compile(r"([^0-9])([\.,])"), r"\1 \2 "),
        (re.compile(r"([\.,])([^0-9])"), r" \1 \2"),
        (re.compile(r"([0-9])(-)"), r"\1 \2 "),
    )

    if _REGEX_AVAILABLE:
        import regex

        _INT_REGEX = (
            (regex.compile(r"(\P{N})(\p{P})"), r"\1 \2 "),
            (regex.compile(r"(\p{P})(\P{N})"), r" \1 \2"),
            (regex.compile(r"(\p{S})"), r" \1 "),
        )

    def __init__(self, tokenize: str = "13a", lowercase: bool = False) -> None:
        self._check_tokenizers_validity(tokenize)
        self.tokenize_kind = tokenize
        self.lowercase = lowercase

    def __call__(self, line: str) -> Sequence[str]:
        tokenized = getattr(self, f"_tokenize_{self._fn_suffix(self.tokenize_kind)}")(line)
        if self.lowercase:
            tokenized = tokenized.lower()
        return tokenized.split()

    @staticmethod
    def _fn_suffix(tokenize: str) -> str:
        return {"none": "base", "13a": "13a", "zh": "zh", "intl": "international", "char": "char"}[tokenize]

    @classmethod
    def _check_tokenizers_validity(cls, tokenize: str) -> None:
        if tokenize not in AVAILABLE_TOKENIZERS:
            raise ValueError(f"Argument `tokenize` expected to be one of {AVAILABLE_TOKENIZERS} but got {tokenize}.")
        if tokenize == "intl" and not _REGEX_AVAILABLE:
            raise ModuleNotFoundError("`'intl'` tokenization requires the `regex` package, which is not installed.")

    def _tokenize_regex(self, line: str) -> str:
        for _re, repl in self._REGEX:
            line = _re.sub(repl, line)
        return " ".join(line.split())

    def _tokenize_base(self, line: str) -> str:
        return line

    def _tokenize_13a(self, line: str) -> str:
        line = line.replace("<skipped>", "").replace("-\n", "").replace("\n", " ")
        if "&" in line:
            line = line.replace("&quot;", '"').replace("&amp;", "&").replace("&lt;", "<").replace("&gt;", ">")
        return self._tokenize_regex(f" {line} ")

    @staticmethod
    def _is_chinese_char(char: str) -> bool:
        cp = ord(char)
        ranges = (
            (0x4E00, 0x9FFF), (0x3400, 0x4DBF), (0x20000, 0x2A6DF), (0x2A700, 0x2B73F),
            (0x2B740, 0x2B81F), (0x2B820, 0x2CEAF), (0xF900, 0xFAFF), (0x2F800, 0x2FA1F),
        )
        return any(lo <= cp <= hi for lo, hi in ranges)

    def _tokenize_zh(self, line: str) -> str:
        line = line.strip()
        out = []
        for char in line:
            out.append(f" {char} " if self._is_chinese_char(char) else char)
        return self._tokenize_regex("".join(out))

    def _tokenize_international(self, line: str) -> str:
        for _re, repl in self._INT_REGEX:
            line = _re.sub(repl, line)
        return " ".join(line.split())

    def _tokenize_char(self, line: str) -> str:
        return " ".join(char for char in line)


def sacre_bleu_score(
    preds: Sequence[str],
    target: Sequence[Sequence[str]],
    n_gram: int = 4,
    smooth: bool = False,
    tokenize: str = "13a",
    lowercase: bool = False,
    weights: Optional[Sequence[float]] = None,
    device: Optional[Union[str, torch.device]] = None,
) -> Tensor:
    """BLEU with sacrebleu's tokenization.

    Example:
        >>> from tpumetrics_torch.functional.text import sacre_bleu_score
        >>> preds = ['the cat is on the mat']
        >>> target = [['there is a cat on the mat', 'a cat is on the mat']]
        >>> round(float(sacre_bleu_score(preds, target, device="cpu")), 4)
        0.7598
    """
    if len(preds) != len(target):
        raise ValueError(f"Corpus has different size {len(preds)} != {len(target)}")
    if weights is not None and len(weights) != n_gram:
        raise ValueError(f"List of weights has different weights than `n_gram`: {len(weights)} != {n_gram}")
    if weights is None:
        weights = [1.0 / n_gram] * n_gram

    device = _resolve_device(device)
    tokenizer = _SacreBLEUTokenizer(tokenize, lowercase)
    numerator = np.zeros(n_gram)
    denominator = np.zeros(n_gram)
    preds_len, target_len = _bleu_score_update(preds, target, numerator, denominator, 0.0, 0.0, n_gram, tokenizer)
    return _bleu_score_compute(
        preds_len,
        target_len,
        torch.as_tensor(numerator, dtype=torch.float32, device=device),
        torch.as_tensor(denominator, dtype=torch.float32, device=device),
        n_gram,
        weights,
        smooth,
    )
