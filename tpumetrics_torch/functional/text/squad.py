"""SQuAD exact match and F1 (port of ``tpumetrics/functional/text/squad.py``,
after the official SQuAD v1.1 evaluation script)."""

from __future__ import annotations

import re
import string
from collections import Counter
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

import torch

from tpumetrics_torch.metric import _resolve_device
from tpumetrics_torch.utils.prints import rank_zero_warn

Tensor = torch.Tensor

SQuAD_FORMAT = {
    "answers": {"answer_start": [1], "text": ["This is a test text"]},
    "context": "This is a test context.",
    "id": "1",
    "question": "Is this a test?",
    "title": "train test",
}


def _normalize_text(s: str) -> str:
    """Lowercase, strip punctuation/articles, squeeze whitespace."""
    s = s.lower()
    s = "".join(ch for ch in s if ch not in set(string.punctuation))
    s = re.sub(r"\b(a|an|the)\b", " ", s)
    return " ".join(s.split())


def _get_tokens(s: str) -> List[str]:
    return [] if not s else _normalize_text(s).split()


def _compute_f1_score(predicted_answer: str, target_answer: str) -> float:
    """Token-overlap F1 of one answer pair."""
    target_tokens = _get_tokens(target_answer)
    predicted_tokens = _get_tokens(predicted_answer)
    common = Counter(target_tokens) & Counter(predicted_tokens)
    num_same = sum(common.values())
    if len(target_tokens) == 0 or len(predicted_tokens) == 0:
        return float(target_tokens == predicted_tokens)
    if num_same == 0:
        return 0.0
    precision = num_same / len(predicted_tokens)
    recall = num_same / len(target_tokens)
    return (2 * precision * recall) / (precision + recall)


def _compute_exact_match_score(prediction: str, ground_truth: str) -> float:
    return float(_normalize_text(prediction) == _normalize_text(ground_truth))


def _metric_max_over_ground_truths(
    metric_fn: Callable[[str, str], float], prediction: str, ground_truths: List[str]
) -> float:
    return max(metric_fn(prediction, truth) for truth in ground_truths)


def _squad_input_check(preds: Any, targets: Any) -> Tuple[Dict[str, str], List[Dict]]:
    """Validate + normalize inputs to the official evaluation structure
   ."""
    if isinstance(preds, Dict):
        preds = [preds]
    if isinstance(targets, Dict):
        targets = [targets]

    for pred in preds:
        if "prediction_text" not in pred or "id" not in pred:
            raise KeyError(
                "Expected keys in a single prediction are 'prediction_text' and 'id'."
                "Please make sure that 'prediction_text' maps to the answer string and 'id' maps to the key string."
            )
    for target in targets:
        if "answers" not in target or "id" not in target:
            raise KeyError(
                "Expected keys in a single target are 'answers' and 'id'."
                "Please make sure that 'answers' maps to a `SQuAD` format dictionary and 'id' maps to the key"
                f" string.\nSQuAD Format: {SQuAD_FORMAT}"
            )
        if "text" not in target["answers"]:
            raise KeyError(
                "Expected keys in a 'answers' are 'text'."
                f"Please make sure that 'answer' maps to a `SQuAD` format dictionary.\nSQuAD Format: {SQuAD_FORMAT}"
            )

    preds_dict = {prediction["id"]: prediction["prediction_text"] for prediction in preds}
    _fn_answer = lambda tgt: {"answers": [{"text": txt} for txt in tgt["answers"]["text"]], "id": tgt["id"]}  # noqa: E731
    targets_dict = [{"paragraphs": [{"qas": [_fn_answer(target) for target in targets]}]}]
    return preds_dict, targets_dict


def _squad_update(
    preds: Dict[str, str], target: List[Dict], device: Optional[torch.device] = None
) -> Tuple[Tensor, Tensor, Tensor]:
    """F1 and exact match summed over the questions, and their count (float32)."""
    f1 = 0.0
    exact_match = 0.0
    total = 0
    for article in target:
        for paragraph in article["paragraphs"]:
            for qa in paragraph["qas"]:
                total += 1
                if qa["id"] not in preds:
                    rank_zero_warn(f"Unanswered question {qa['id']} will receive score 0.")
                    continue
                ground_truths = [x["text"] for x in qa["answers"]]
                pred = preds[qa["id"]]
                exact_match += _metric_max_over_ground_truths(_compute_exact_match_score, pred, ground_truths)
                f1 += _metric_max_over_ground_truths(_compute_f1_score, pred, ground_truths)
    return (
        torch.tensor(f1, dtype=torch.float32, device=device),
        torch.tensor(exact_match, dtype=torch.float32, device=device),
        torch.tensor(total, dtype=torch.float32, device=device),
    )


def _squad_compute(f1: Tensor, exact_match: Tensor, total: Tensor) -> Dict[str, Tensor]:
    return {"exact_match": 100.0 * exact_match / total, "f1": 100.0 * f1 / total}


def squad(preds: Any, target: Any, device: Optional[Union[str, torch.device]] = None) -> Dict[str, Tensor]:
    """SQuAD v1.1 exact match and F1.

    Example:
        >>> from tpumetrics_torch.functional.text import squad
        >>> preds = [{"prediction_text": "1976", "id": "56e10a3be3433e1400422b22"}]
        >>> target = [{"answers": {"answer_start": [97], "text": ["1976"]}, "id": "56e10a3be3433e1400422b22"}]
        >>> {k: float(v) for k, v in squad(preds, target, device="cpu").items()}
        {'exact_match': 100.0, 'f1': 100.0}
    """
    preds_dict, target_dict = _squad_input_check(preds, target)
    f1, exact_match, total = _squad_update(preds_dict, target_dict, _resolve_device(device))
    return _squad_compute(f1, exact_match, total)
