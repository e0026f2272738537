"""InfoLM (port of ``tpumetrics/functional/text/infolm.py``, after Colombo,
Staerman, Clavel & Piantanida, AAAI 2022).

Per sentence, each non-special token position is masked in its own copy and
the masked language model's vocabulary distribution there is collected; the
positionwise distributions aggregate into one per-sentence distribution
(idf-weighted optionally), and the candidate's and the reference's are
compared with an information measure. The MLM is pluggable: the port's own
:class:`~tpumetrics_torch.text._bert_encoder.BertForMaskedLM`, or any model
with ``model(input_ids=, attention_mask=).logits``; a hub id is gated where
``transformers`` or the checkpoint is absent.

The JAX package adds the positionwise distributions into their sentences'
rows with a scatter-add. On a card a float ``index_add_`` adds in atomic
order, so here each sentence's rows (contiguous: they come sorted from
``np.nonzero``) are laid into a padded ``(sentences, positions, vocab)``
tensor and summed over the positions, one fixed order: two runs give the
same bits.
"""

from __future__ import annotations

from typing import Any, List, Optional, Tuple, Union

import numpy as np
import torch

from tpumetrics_torch.functional.text.bert import _compute_idf, _tokenize_padded
from tpumetrics_torch.metric import _resolve_device
from tpumetrics_torch.utils.imports import _TRANSFORMERS_AVAILABLE

Tensor = torch.Tensor

_ALLOWED_INFORMATION_MEASURE = (
    "kl_divergence",
    "alpha_divergence",
    "beta_divergence",
    "ab_divergence",
    "renyi_divergence",
    "l1_distance",
    "l2_distance",
    "l_infinity_distance",
    "fisher_rao_distance",
)


class _InformationMeasure:
    """Information measures between discrete distributions."""

    def __init__(self, information_measure: str, alpha: Optional[float] = None, beta: Optional[float] = None) -> None:
        if information_measure not in _ALLOWED_INFORMATION_MEASURE:
            raise ValueError(
                f"Argument `information_measure` is expected to be one of {_ALLOWED_INFORMATION_MEASURE}"
            )
        if information_measure in ("alpha_divergence", "ab_divergence", "renyi_divergence"):
            if not isinstance(alpha, float) or alpha in (0, 1):
                raise ValueError(f"Parameter `alpha` is expected to be a float differing from 0 and 1, got {alpha}")
        if information_measure in ("beta_divergence", "ab_divergence"):
            if not isinstance(beta, float) or beta == 0:
                raise ValueError(f"Parameter `beta` is expected to be a non-zero float, got {beta}")
        if information_measure == "ab_divergence" and (alpha is not None and beta is not None and alpha + beta == 0):
            raise ValueError("Parameters `alpha` and `beta` cannot sum to 0 for `ab_divergence`")
        self.information_measure = information_measure
        self.alpha = alpha
        self.beta = beta

    def __call__(self, preds_distribution: Tensor, target_distribution: Tensor) -> Tensor:
        return getattr(self, f"_calculate_{self.information_measure}")(preds_distribution, target_distribution)

    @staticmethod
    def _calculate_kl_divergence(p: Tensor, t: Tensor) -> Tensor:
        """KL(t || p) = sum t log(t / p): non-negative, zero iff identical.

        The JAX package's deliberate deviation, kept: the reference computes
        ``sum t log(p / t)``, the negative KL, which inverts the
        lower-is-better ranking."""
        return torch.sum(t * torch.log(t / p), dim=-1)

    def _calculate_alpha_divergence(self, p: Tensor, t: Tensor) -> Tensor:
        denom = self.alpha * (self.alpha - 1)
        return (1 - torch.sum(t**self.alpha * p ** (1 - self.alpha), dim=-1)) / denom

    def _calculate_ab_divergence(self, p: Tensor, t: Tensor) -> Tensor:
        a = torch.log(torch.sum(t ** (self.beta + self.alpha), dim=-1)) / (self.beta * (self.beta + self.alpha))
        b = torch.log(torch.sum(p ** (self.beta + self.alpha), dim=-1)) / (self.alpha * (self.beta + self.alpha))
        c = torch.log(torch.sum(t**self.alpha * p**self.beta, dim=-1)) / (self.alpha * self.beta)
        return a + b - c

    def _calculate_beta_divergence(self, p: Tensor, t: Tensor) -> Tensor:
        self.alpha = 1.0
        return self._calculate_ab_divergence(p, t)

    def _calculate_renyi_divergence(self, p: Tensor, t: Tensor) -> Tensor:
        return torch.log(torch.sum(t**self.alpha * p ** (1 - self.alpha), dim=-1)) / (self.alpha - 1)

    @staticmethod
    def _calculate_l1_distance(p: Tensor, t: Tensor) -> Tensor:
        return torch.sum(torch.abs(t - p), dim=-1)

    @staticmethod
    def _calculate_l2_distance(p: Tensor, t: Tensor) -> Tensor:
        return torch.sqrt(torch.sum((t - p) ** 2, dim=-1))

    @staticmethod
    def _calculate_l_infinity_distance(p: Tensor, t: Tensor) -> Tensor:
        return torch.amax(torch.abs(t - p), dim=-1)

    @staticmethod
    def _calculate_fisher_rao_distance(p: Tensor, t: Tensor) -> Tensor:
        return 2 * torch.arccos(torch.clamp(torch.sum(torch.sqrt(p * t), dim=-1), 0, 1))


def _load_default_mlm(model_name_or_path: str):
    if not _TRANSFORMERS_AVAILABLE:
        raise ModuleNotFoundError(
            "`infolm` metric with default models requires `transformers` package be installed."
            " Either install with `pip install transformers>=4.4` or `pip install torchmetrics[text]`."
        )
    from transformers import AutoConfig

    try:
        # the configuration first: without a checkpoint this fails before the modeling code is imported
        AutoConfig.from_pretrained(model_name_or_path)
        from transformers import AutoModelForMaskedLM, AutoTokenizer

        tokenizer = AutoTokenizer.from_pretrained(model_name_or_path)
        model = AutoModelForMaskedLM.from_pretrained(model_name_or_path)
    except Exception as err:
        raise ModuleNotFoundError(
            f"Could not load pretrained MLM `{model_name_or_path}` (no cache/network?)."
            " Pass `model` and `user_tokenizer` for a locally constructed masked language model."
        ) from err
    return model.eval(), tokenizer


def _segment_sum(x: Tensor, rows: np.ndarray, n_segments: int) -> Tensor:
    """``out[s] = sum of x[i] over rows[i] == s``, for sorted ``rows``: each
    segment laid into a zero-padded slot and summed in one fixed order."""
    counts = np.bincount(rows, minlength=n_segments)
    width = int(counts.max()) if len(rows) else 0
    starts = np.cumsum(counts) - counts
    slot = np.arange(len(rows)) - starts[rows]
    dense = torch.zeros((n_segments, max(width, 1), *x.shape[1:]), dtype=x.dtype, device=x.device)
    index = (torch.from_numpy(rows).to(x.device), torch.from_numpy(slot).to(x.device))
    dense[index] = x  # each (row, slot) once: no accumulation
    return dense.sum(dim=1)


def _sentence_distribution(
    model: Any,
    input_ids: np.ndarray,
    attention_mask: np.ndarray,
    mask_token_id: int,
    special_ids: set,
    temperature: float,
    idf_weights: Optional[np.ndarray] = None,
    batch_size: int = 64,
    device: Optional[torch.device] = None,
) -> Tensor:
    """The aggregated masked-token distribution of each sentence, ``(n, vocab)``:
    every maskable position masked in its own copy, the copies run through the
    model in ``batch_size`` chunks padded to one shape, so the corpus size
    never sets the peak memory."""
    device = torch.device("cpu") if device is None else device
    n_sentences, seq_len = input_ids.shape
    maskable = (attention_mask == 1) & ~np.isin(input_ids, list(special_ids))

    rows, positions = np.nonzero(maskable)
    masked_inputs = input_ids[rows].copy()
    masked_inputs[np.arange(len(rows)), positions] = mask_token_id
    masks = attention_mask[rows]
    n = len(rows)
    step = max(1, batch_size)
    n_pad = -(-n // step) * step if n else 0
    ids_dev = torch.zeros((n_pad, seq_len), dtype=torch.int64)
    mask_dev = torch.zeros((n_pad, seq_len), dtype=torch.int64)
    pos_dev = torch.zeros(n_pad, dtype=torch.int64)
    ids_dev[:n] = torch.from_numpy(masked_inputs.astype(np.int64))
    mask_dev[:n] = torch.from_numpy(masks.astype(np.int64))
    pos_dev[:n] = torch.from_numpy(positions.astype(np.int64))
    ids_dev, mask_dev, pos_dev = ids_dev.to(device), mask_dev.to(device), pos_dev.to(device)

    prob_chunks = []
    with torch.no_grad():
        for lo in range(0, n_pad, step):
            logits = torch.as_tensor(model(input_ids=ids_dev[lo : lo + step], attention_mask=mask_dev[lo : lo + step]).logits)
            picked = logits[torch.arange(logits.shape[0], device=logits.device), pos_dev[lo : lo + step]]
            picked = picked.to(torch.promote_types(picked.dtype, torch.float32))  # float32, or a float64 model's
            prob_chunks.append(torch.softmax(picked / temperature, dim=-1))
    if not prob_chunks:
        return torch.zeros((n_sentences, 1), dtype=torch.float32, device=device)
    probs = torch.cat(prob_chunks)[:n]

    weights = np.ones(n) if idf_weights is None else idf_weights[rows, positions]
    weights_dev = torch.as_tensor(np.asarray(weights, np.float32), device=probs.device)
    summed = _segment_sum(probs * weights_dev[:, None], rows, n_sentences)
    norm = _segment_sum(weights_dev, rows, n_sentences)
    return summed / torch.clamp(norm, min=1e-12)[:, None]


def infolm(
    preds: Union[str, List[str]],
    target: Union[str, List[str]],
    model_name_or_path: str = "bert-base-uncased",
    temperature: float = 0.25,
    information_measure: str = "kl_divergence",
    idf: bool = True,
    alpha: Optional[float] = None,
    beta: Optional[float] = None,
    device: Optional[Union[str, torch.device]] = None,
    max_length: Optional[int] = None,
    batch_size: int = 64,
    num_threads: int = 0,
    verbose: bool = True,
    return_sentence_level_score: bool = False,
    model: Optional[Any] = None,
    user_tokenizer: Optional[Any] = None,
) -> Union[Tensor, Tuple[Tensor, Tensor]]:
    """InfoLM score between candidate and reference sentences.

    ``batch_size`` chunks the model's forward; the token ids go to ``device``
    (the card when omitted), where the model must run. ``num_threads`` and
    ``verbose`` are accepted and ignored.

    Example:
        >>> import torch
        >>> from types import SimpleNamespace
        >>> from tpumetrics_torch.functional.text import infolm
        >>> class Tok:
        ...     mask_token_id, pad_token_id, cls_token_id, sep_token_id = 3, 0, 1, 2
        ...     def __call__(self, s, **kw):
        ...         return {"input_ids": [[1] + [4 + len(w) for w in x.split()] + [2] for x in s],
        ...                 "attention_mask": [[1] * (len(x.split()) + 2) for x in s]}
        >>> table = torch.sin(torch.arange(144.0)).reshape(12, 12)
        >>> mlm = lambda input_ids, attention_mask: SimpleNamespace(logits=table[input_ids] + table[input_ids].mean(1, keepdim=True))
        >>> round(float(infolm(["a bb"], ["a ccc"], model=mlm, user_tokenizer=Tok(), idf=False, device="cpu")), 4)
        0.0017
    """
    if isinstance(preds, str):
        preds = [preds]
    if isinstance(target, str):
        target = [target]
    if len(preds) != len(target):
        raise ValueError(
            f"Expected argument `preds` and `target` to have same length, but got {len(preds)} and {len(target)}"
        )
    measure = _InformationMeasure(information_measure, alpha, beta)
    device = _resolve_device(device)

    if model is None:
        model, tokenizer = _load_default_mlm(model_name_or_path)
        model = model.to(device)
    else:
        if user_tokenizer is None:
            raise ValueError("`user_tokenizer` must be provided together with a custom `model`")
        tokenizer = user_tokenizer

    mask_token_id = getattr(tokenizer, "mask_token_id", 0) or 0
    special_ids = {
        tid
        for tid in (
            getattr(tokenizer, "pad_token_id", None),
            getattr(tokenizer, "cls_token_id", None),
            getattr(tokenizer, "sep_token_id", None),
        )
        if tid is not None
    }

    limit = max_length or 512
    preds_batch = _tokenize_padded(tokenizer, list(preds), limit)
    target_batch = _tokenize_padded(tokenizer, list(target), limit)
    p_ids, p_mask = preds_batch["input_ids"], preds_batch["attention_mask"]
    t_ids, t_mask = target_batch["input_ids"], target_batch["attention_mask"]

    idf_p = idf_t = None
    if idf:
        token_lists = [[int(t) for t, a in zip(r, ar) if a] for r, ar in zip(t_ids, t_mask)]
        idf_map = _compute_idf(token_lists, len(target))
        default_idf = idf_map.get("__default__", 0.0)
        idf_p = np.vectorize(lambda t: idf_map.get(int(t), default_idf))(p_ids)
        idf_t = np.vectorize(lambda t: idf_map.get(int(t), default_idf))(t_ids)

    preds_distribution = _sentence_distribution(
        model, p_ids, p_mask, mask_token_id, special_ids, temperature, idf_p, batch_size, device
    )
    target_distribution = _sentence_distribution(
        model, t_ids, t_mask, mask_token_id, special_ids, temperature, idf_t, batch_size, device
    )

    sentence_scores = measure(preds_distribution, target_distribution)
    if return_sentence_level_score:
        return sentence_scores.mean(), sentence_scores
    return sentence_scores.mean()
