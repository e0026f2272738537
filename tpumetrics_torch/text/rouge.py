"""ROUGEScore (port of ``tpumetrics/text/rouge.py``)."""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Sequence, Tuple, Union

import torch

from tpumetrics_torch.functional.text.rouge import (
    ALLOWED_ROUGE_KEYS,
    _check_rouge_args,
    _normalize_rouge_inputs,
    _porter_stemmer,
    _rouge_score_update,
)
from tpumetrics_torch.metric import Metric
from tpumetrics_torch.utils.data import dim_zero_cat

Tensor = torch.Tensor


class ROUGEScore(Metric):
    """ROUGE-N, ROUGE-L and ROUGE-Lsum accumulated over batches: each key's
    precision, recall and F-measure of every sentence, as float32 cat
    states. An update appends one tensor of its batch's scores to each (the
    JAX package appends one a sentence; the concatenation is the same), so a
    card takes one copy a state an update. The update reads host strings.

    Example:
        >>> from tpumetrics_torch.text import ROUGEScore
        >>> rouge = ROUGEScore(rouge_keys="rouge1", device="cpu")
        >>> result = rouge(["My name is John"], ["Is your name John"])
        >>> round(float(result["rouge1_fmeasure"]), 4)
        0.75
    """

    is_differentiable: bool = False
    higher_is_better: bool = True
    full_state_update: bool = True
    plot_lower_bound: float = 0.0
    plot_upper_bound: float = 1.0
    _update_reads_host = True

    def __init__(
        self,
        use_stemmer: bool = False,
        normalizer: Optional[Callable[[str], str]] = None,
        tokenizer: Optional[Callable[[str], Sequence[str]]] = None,
        accumulate: str = "best",
        rouge_keys: Union[str, Tuple[str, ...]] = ("rouge1", "rouge2", "rougeL", "rougeLsum"),
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        rouge_keys = _check_rouge_args(use_stemmer, accumulate, rouge_keys)
        self.rouge_keys = rouge_keys
        self.rouge_keys_values = [ALLOWED_ROUGE_KEYS[key] for key in rouge_keys]
        self.use_stemmer = use_stemmer
        self.normalizer = normalizer
        self.tokenizer = tokenizer
        self.accumulate = accumulate
        self.stemmer = _porter_stemmer(use_stemmer)

        for rouge_key in self.rouge_keys:
            for score_type in ("fmeasure", "precision", "recall"):
                self.add_state(f"{rouge_key}_{score_type}", default=[], dist_reduce_fx="cat")

    def update(
        self,
        preds: Union[str, Sequence[str]],
        target: Union[str, Sequence[str], Sequence[Sequence[str]]],
    ) -> None:
        """Accumulate the sentences' rouge scores."""
        preds, target = _normalize_rouge_inputs(preds, target)
        output = _rouge_score_update(
            preds,
            target,
            self.rouge_keys_values,
            accumulate=self.accumulate,
            stemmer=self.stemmer,
            normalizer=self.normalizer,
            tokenizer=self.tokenizer,
        )
        for rouge_key, metrics in output.items():
            if not metrics:
                continue
            suffix = rouge_key if isinstance(rouge_key, str) else str(rouge_key)
            for score_type in ("fmeasure", "precision", "recall"):
                getattr(self, f"rouge{suffix}_{score_type}").append(
                    torch.tensor([m[score_type] for m in metrics], dtype=torch.float32, device=self.device)
                )

    def compute(self) -> Dict[str, Tensor]:
        """The mean of each key's and score type's sentence scores."""
        update_output = {}
        for rouge_key in self.rouge_keys:
            for score_type in ("fmeasure", "precision", "recall"):
                vals = getattr(self, f"{rouge_key}_{score_type}")
                update_output[f"{rouge_key}_{score_type}"] = (
                    torch.mean(dim_zero_cat(vals)) if vals else torch.zeros((), device=self.device)
                )
        return update_output
