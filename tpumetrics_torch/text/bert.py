"""BERTScore metric (port of ``tpumetrics/text/bert.py``)."""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Union

import torch
import torch.nn.functional as F

from tpumetrics_torch.functional.text.bert import _embed, _read_baseline_csv, _score_embeddings, bert_score
from tpumetrics_torch.metric import Metric
from tpumetrics_torch.text._sentence_state import HostSentenceStateMixin

Tensor = torch.Tensor


class BERTScore(HostSentenceStateMixin, Metric):
    """BERTScore accumulated over batches.

    The raw sentences are stored and embedded at ``compute`` (strings cannot
    live in tensor states); the update reads host strings. With a
    ``backbone`` (a handle from :func:`tpumetrics_torch.backbones.get_backbone`
    over an encoder forward ``(params, input_ids, attention_mask) -> (B, S, D)``
    or ``(B, L, S, D)``, plus ``user_tokenizer``) the metric embeds at stream
    time instead: each ``update`` batch runs through the shared engine at
    once and only the embeddings wait for ``compute``, which scores them
    (with ``idf``, which needs the whole reference corpus, it embeds at
    ``compute`` as without a backbone). The encoder must give mask-respecting,
    row-independent embeddings, since batches are embedded at their own
    padded length. The sentence lists are kept all the same, and snapshots
    carry them and not the embeddings: a restored metric embeds at
    ``compute``. Call ``release_backbones()`` when done.

    Args:
        model_name_or_path: ``transformers`` hub id (gated when it cannot load).
        model / user_tokenizer / user_forward_fn: a custom embedding stack.
        idf: inverse-document-frequency weighting over the reference corpus.
        device: where the states live, the model runs and the scores are made.
        backbone: a shared registry handle over the encoder (see above).

    Example:
        >>> import torch
        >>> from tpumetrics_torch.text import BERTScore
        >>> tok = lambda s, **kw: {"input_ids": [[0] + [len(w) for w in x.split()] + [0] for x in s],
        ...                        "attention_mask": [[1] * (len(x.split()) + 2) for x in s]}
        >>> metric = BERTScore(model=torch.eye(8), user_tokenizer=tok,
        ...                    user_forward_fn=lambda m, b: m[b["input_ids"]], device="cpu")
        >>> metric.update(["a bb ccc", "a bb"], ["a bb dddd", "a bb"])
        >>> [round(float(x), 4) for x in metric.compute()["f1"]]
        [0.6667, 1.0]
    """

    is_differentiable: bool = False
    higher_is_better: bool = True
    full_state_update: bool = False
    plot_lower_bound: float = 0.0
    plot_upper_bound: float = 1.0
    _update_reads_host = True

    def __init__(
        self,
        model_name_or_path: Optional[str] = None,
        num_layers: Optional[int] = None,
        all_layers: bool = False,
        model: Optional[Any] = None,
        user_tokenizer: Optional[Any] = None,
        user_forward_fn: Optional[Callable] = None,
        verbose: bool = False,
        idf: bool = False,
        device: Optional[Any] = None,
        max_length: int = 512,
        batch_size: int = 64,
        num_threads: int = 0,
        return_hash: bool = False,
        lang: str = "en",
        rescale_with_baseline: bool = False,
        baseline_path: Optional[str] = None,
        baseline_url: Optional[str] = None,
        sentences_replicated: bool = False,
        backbone: Optional[Any] = None,
        **kwargs: Any,
    ) -> None:
        super().__init__(device=device, **kwargs)
        self.backbone = backbone
        if backbone is not None:
            if user_tokenizer is None:
                raise ValueError("`user_tokenizer` must be provided together with a `backbone`")
            self._backbone_handles = (backbone.acquire(),)  # released by release_backbones()
            self.backbone_key = backbone.key
        self.sentences_replicated = sentences_replicated
        self.model_name_or_path = model_name_or_path
        self.num_layers = num_layers
        self.all_layers = all_layers
        self.model = model
        self.user_tokenizer = user_tokenizer
        self.user_forward_fn = user_forward_fn
        self.verbose = verbose
        self.idf = idf
        self.max_length = max_length
        self.batch_size = batch_size
        self.return_hash = return_hash
        self.lang = lang
        if rescale_with_baseline and not baseline_path:
            # fail at construction, not after an epoch of updates
            raise NotImplementedError(
                "Baseline rescaling without a local file requires downloading the bert-score"
                " baseline, which is not supported here. Save the baseline CSV locally and pass"
                " it via `baseline_path=`."
            )
        self.rescale_with_baseline = rescale_with_baseline
        self.baseline_path = baseline_path
        self.baseline_url = baseline_url

        self._preds: List[str] = []
        self._target: List[str] = []
        # stream-time embeddings (backbone mode): per update ((emb, scale, n) of preds, of target); not in snapshots
        self._streamed: List[Any] = []
        self.add_state("dummy", torch.zeros(()), dist_reduce_fx="sum")

    def update(self, preds: Union[str, List[str]], target: Union[str, List[str]]) -> None:
        """Store the sentences; with a ``backbone`` (and no ``idf``) embed the batch now."""
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
        if self.backbone is not None and not self.idf and preds:
            parts = []
            for sentences in (preds, target):
                emb, scale, _ = _embed(
                    list(sentences), None, self.user_tokenizer, None, self.all_layers, self.max_length, False, None,
                    self.num_layers, self.batch_size, self.backbone, self.device,
                )
                parts.append((emb, scale, len(sentences)))
            self._streamed.append(tuple(parts))

    @staticmethod
    def _cat_streamed(parts: List[Any]) -> Any:
        """Concatenate per-update ``(emb, scale, n)`` triples: the token axis
        padded with zeros to the longest (zero embeddings of zero weight, as
        in-batch padding), the rows stacked."""
        seq = max(p[0].shape[2] for p in parts)
        embs, scales = [], []
        for emb, scale, n in parts:
            pad = seq - emb.shape[2]
            if pad:
                emb = F.pad(emb, (0, 0, 0, pad))
                scale = F.pad(scale, (0, pad))
            embs.append(emb[:n])
            scales.append(scale[:n])
        return torch.cat(embs), torch.cat(scales)

    def compute(self) -> Dict[str, Tensor]:
        """Score the streamed embeddings when they cover every sentence, else embed everything now."""
        streamed_rows = sum(p[0][2] for p in self._streamed)
        if self.backbone is not None and self._streamed and streamed_rows == len(self._preds):
            preds_emb, preds_scale = self._cat_streamed([p[0] for p in self._streamed])
            target_emb, target_scale = self._cat_streamed([p[1] for p in self._streamed])
            baseline = _read_baseline_csv(self.baseline_path, self.device) if self.rescale_with_baseline else None
            precision, recall, f1 = _score_embeddings(
                preds_emb, target_emb, preds_scale, target_scale, self.batch_size, baseline, self.num_layers,
                self.all_layers,
            )
            output: Dict[str, Any] = {"precision": precision, "recall": recall, "f1": f1}
            if self.return_hash:
                output["hash"] = f"tpumetrics-bert_score-idf:{self.idf}"
            return output
        return bert_score(
            self._preds,
            self._target,
            model_name_or_path=self.model_name_or_path,
            num_layers=self.num_layers,
            all_layers=self.all_layers,
            model=self.model,
            user_tokenizer=self.user_tokenizer,
            user_forward_fn=self.user_forward_fn,
            verbose=self.verbose,
            idf=self.idf,
            device=self.device,
            max_length=self.max_length,
            batch_size=self.batch_size,
            return_hash=self.return_hash,
            lang=self.lang,
            rescale_with_baseline=self.rescale_with_baseline,
            baseline_path=self.baseline_path,
            baseline_url=self.baseline_url,
            backbone=self.backbone,
        )

    def reset(self) -> None:
        super().reset()
        self._preds = []
        self._target = []
        self._streamed = []

    def __getstate__(self) -> Dict[str, Any]:
        state = super().__getstate__()
        state["_streamed"] = []  # device embeddings do not snapshot: a restored metric embeds at compute
        return state
