"""InfoLM metric (port of ``tpumetrics/text/infolm.py``)."""

from __future__ import annotations

from types import SimpleNamespace
from typing import Any, List, Optional, Tuple, Union

import torch

from tpumetrics_torch.functional.text.infolm import _InformationMeasure, infolm
from tpumetrics_torch.metric import Metric
from tpumetrics_torch.text._sentence_state import HostSentenceStateMixin

Tensor = torch.Tensor


class _BackboneMLM:
    """A shared backbone handle as InfoLM's masked-LM protocol
    (``model(input_ids=, attention_mask=).logits``): the handle's forward is
    ``(params, input_ids, attention_mask) -> (B, S, V)`` logits, run by the
    shared engine (bucketed, staged, captured on a card)."""

    def __init__(self, handle: Any) -> None:
        self.handle = handle

    def __call__(self, input_ids: Any = None, attention_mask: Any = None, **_: Any) -> SimpleNamespace:
        logits = self.handle(input_ids, attention_mask)
        return SimpleNamespace(logits=logits[:, : input_ids.shape[1]])


class InfoLM(HostSentenceStateMixin, Metric):
    """InfoLM accumulated over batches: the sentences are stored (the update
    reads host strings) and the masked LM runs at ``compute``.

    Example:
        >>> import torch
        >>> from types import SimpleNamespace
        >>> from tpumetrics_torch.text import InfoLM
        >>> class Tok:
        ...     mask_token_id, pad_token_id, cls_token_id, sep_token_id = 3, 0, 1, 2
        ...     def __call__(self, s, **kw):
        ...         return {"input_ids": [[1] + [4 + len(w) for w in x.split()] + [2] for x in s],
        ...                 "attention_mask": [[1] * (len(x.split()) + 2) for x in s]}
        >>> table = torch.sin(torch.arange(144.0)).reshape(12, 12)
        >>> mlm = lambda input_ids, attention_mask: SimpleNamespace(logits=table[input_ids] + table[input_ids].mean(1, keepdim=True))
        >>> metric = InfoLM(model=mlm, user_tokenizer=Tok(), idf=False, information_measure="l1_distance", device="cpu")
        >>> metric.update(["a bb"], ["a bb"])
        >>> float(metric.compute())
        0.0
    """

    is_differentiable: bool = False
    higher_is_better: bool = False
    full_state_update: bool = False
    _update_reads_host = True

    def __init__(
        self,
        model_name_or_path: str = "bert-base-uncased",
        temperature: float = 0.25,
        information_measure: str = "kl_divergence",
        idf: bool = True,
        alpha: Optional[float] = None,
        beta: Optional[float] = None,
        device: Optional[Any] = None,
        max_length: Optional[int] = None,
        batch_size: int = 64,
        num_threads: int = 0,
        verbose: bool = True,
        return_sentence_level_score: bool = False,
        model: Optional[Any] = None,
        user_tokenizer: Optional[Any] = None,
        sentences_replicated: bool = False,
        backbone: Optional[Any] = None,
        **kwargs: Any,
    ) -> None:
        super().__init__(device=device, **kwargs)
        self.sentences_replicated = sentences_replicated
        _InformationMeasure(information_measure, alpha, beta)  # validate early
        if backbone is not None:
            if user_tokenizer is None:
                raise ValueError("`user_tokenizer` must be provided together with a `backbone`")
            if model is not None:
                raise ValueError("Pass either `model` or `backbone`, not both")
            self._backbone_handles = (backbone.acquire(),)  # released by release_backbones()
            self.backbone_key = backbone.key
            model = _BackboneMLM(backbone)
        self.model_name_or_path = model_name_or_path
        self.temperature = temperature
        self.information_measure = information_measure
        self.idf = idf
        self.alpha = alpha
        self.beta = beta
        self.max_length = max_length
        self.batch_size = batch_size
        self.return_sentence_level_score = return_sentence_level_score
        self.model = model
        self.user_tokenizer = user_tokenizer

        self._preds: List[str] = []
        self._target: List[str] = []
        self.add_state("dummy", torch.zeros(()), dist_reduce_fx="sum")

    def update(self, preds: Union[str, List[str]], target: Union[str, List[str]]) -> None:
        """Store the sentences for the compute-time model pass."""
        if isinstance(preds, str):
            preds = [preds]
        if isinstance(target, str):
            target = [target]
        if len(preds) != len(target):
            raise ValueError(
                f"Expected argument `preds` and `target` to have same length, but got {len(preds)} and {len(target)}"
            )
        self._preds.extend(preds)
        self._target.extend(target)

    def compute(self) -> Union[Tensor, Tuple[Tensor, Tensor]]:
        return infolm(
            self._preds,
            self._target,
            model_name_or_path=self.model_name_or_path,
            temperature=self.temperature,
            information_measure=self.information_measure,
            idf=self.idf,
            alpha=self.alpha,
            beta=self.beta,
            device=self.device,
            max_length=self.max_length,
            batch_size=self.batch_size,
            return_sentence_level_score=self.return_sentence_level_score,
            model=self.model,
            user_tokenizer=self.user_tokenizer,
        )

    def reset(self) -> None:
        super().reset()
        self._preds = []
        self._target = []
