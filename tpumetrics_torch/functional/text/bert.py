"""BERTScore (port of ``tpumetrics/functional/text/bert.py``).

Token embeddings come from a pluggable torch model: the port's own
:class:`~tpumetrics_torch.text._bert_encoder.BertEncoder`, any module with
the same call surface (``model(input_ids=, attention_mask=,
output_hidden_states=True)`` returning ``hidden_states`` and
``last_hidden_state``), a ``user_forward_fn(model, batch)`` returning
``(B, S, D)`` or ``(B, L, S, D)``, or a shared ``backbone=`` handle. A hub id
string is gated when ``transformers`` or the checkpoint is absent, with the
JAX package's messages. The greedy cosine matching is the hand-written
kernel ``ops.bert_match.bert_greedy_match`` on a card (one launch for the
whole corpus: it never writes the similarity tensor) and its plain version
on the CPU.

The JAX package runs its forward and its scoring as a ``lax.scan`` over
chunks of ``batch_size`` sentences; here the forward is a Python loop over
chunks padded to one shape (so a captured backbone replays one graph), and
the scoring one kernel call over every sentence (the plain version walks
chunks of ``batch_size``).
"""

from __future__ import annotations

from collections import Counter
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from tpumetrics_torch.metric import _resolve_device
from tpumetrics_torch.ops.bert_match import bert_greedy_match
from tpumetrics_torch.utils.imports import _TRANSFORMERS_AVAILABLE

Tensor = torch.Tensor


def _load_default_model(model_name_or_path: Optional[str], num_layers: Optional[int]):
    if not _TRANSFORMERS_AVAILABLE:
        raise ModuleNotFoundError(
            "`bert_score` metric with default models requires `transformers` package be installed."
            " Either install with `pip install transformers>=4.4` or `pip install torchmetrics[text]`."
        )
    from transformers import AutoConfig

    try:
        # the configuration first: without a checkpoint this fails before the modeling code is imported
        AutoConfig.from_pretrained(model_name_or_path)
        from transformers import AutoModel, AutoTokenizer

        tokenizer = AutoTokenizer.from_pretrained(model_name_or_path)
        model = AutoModel.from_pretrained(model_name_or_path)
    except Exception as err:
        raise ModuleNotFoundError(
            f"Could not load pretrained model `{model_name_or_path}` (no cache/network?)."
            " Pass your own `model` (+ `user_tokenizer`/`user_forward_fn`) instead: any callable"
            " producing token embeddings works — see the argument docs."
        ) from err
    return model.eval(), tokenizer


def _default_forward(model: Any, batch: Dict[str, Tensor], all_layers: bool, num_layers: Optional[int] = None) -> Tensor:
    """``(B, L, S, D)`` embeddings from an encoder returning every hidden state;
    ``num_layers`` selects one hidden layer."""
    out = model(input_ids=batch["input_ids"], attention_mask=batch["attention_mask"], output_hidden_states=True)
    if all_layers:
        return torch.stack(tuple(out.hidden_states), dim=1)
    if num_layers is not None:
        return out.hidden_states[num_layers][:, None]
    return out.last_hidden_state[:, None]


def _host(x: Any) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, Tensor) else np.asarray(x)


def _tokenize_padded(tokenizer: Any, sentences: List[str], max_length: int) -> Dict[str, np.ndarray]:
    """Tokenize with padding and truncation into host arrays; a tokenizer that
    returns ragged lists (no ``padding=True``) is padded here, one that
    refuses the keywords is called with the sentences alone."""
    try:
        batch = tokenizer(sentences, padding=True, truncation=True, max_length=max_length)
    except TypeError:
        batch = tokenizer(sentences)
    input_ids = batch["input_ids"]
    attention_mask = batch["attention_mask"]
    if isinstance(input_ids, list) and input_ids and isinstance(input_ids[0], list):
        longest = min(max(len(r) for r in input_ids), max_length)
        ids = np.zeros((len(input_ids), longest), np.int32)
        att = np.zeros((len(input_ids), longest), np.int32)
        for i, (row, arow) in enumerate(zip(input_ids, attention_mask)):
            row, arow = row[:longest], arow[:longest]
            ids[i, : len(row)] = row
            att[i, : len(arow)] = arow
        return {"input_ids": ids, "attention_mask": att}
    return {"input_ids": _host(input_ids), "attention_mask": _host(attention_mask)}


def _compute_idf(corpus_ids: List[List[int]], num_docs: int) -> Dict[Any, float]:
    """Inverse document frequencies over the reference corpus; tokens unseen
    in it default to log(N+1), as bert_score's defaultdict does."""
    df: Counter = Counter()
    for doc in corpus_ids:
        df.update(set(doc))
    idf: Dict[Any, float] = {tid: float(np.log((num_docs + 1) / (c + 1))) for tid, c in df.items()}
    idf["__default__"] = float(np.log(num_docs + 1))
    return idf


def _weight_mask(attention_mask: np.ndarray) -> np.ndarray:
    """The attention mask less the first position and the last attended one
    (the special tokens), found by the reference's padding-side-agnostic
    cumsum-argmax."""
    weight_mask = attention_mask.copy()
    if weight_mask.shape[1]:
        weight_mask[:, 0] = 0
        last = np.argmax(np.cumsum(attention_mask - 0.1, axis=1), axis=1)
        weight_mask[np.arange(weight_mask.shape[0]), last] = 0
    return weight_mask


def _forward_chunk(
    model: Any, user_forward_fn: Optional[Callable], backbone: Optional[Any], all_layers: bool,
    num_layers: Optional[int], ids: Tensor, mask: Tensor,
) -> Tensor:
    """One chunk's ``(B, L, S, D)`` embeddings, in float32."""
    if backbone is not None:
        part = torch.as_tensor(backbone(ids, mask))
    elif user_forward_fn is not None:
        part = torch.as_tensor(user_forward_fn(model, {"input_ids": ids, "attention_mask": mask}))
    else:
        part = _default_forward(model, {"input_ids": ids, "attention_mask": mask}, all_layers, num_layers)
    if part.ndim == 3:
        part = part[:, None]
    # a backbone pads the sequence axis to its bucket; the embeddings past the batch's tokens are dropped
    return part[:, :, : ids.shape[1]].to(torch.float32)


def _embed(
    sentences: List[str],
    model: Any,
    tokenizer: Any,
    user_forward_fn: Optional[Callable],
    all_layers: bool,
    max_length: int,
    idf: bool,
    idf_map: Optional[Dict[Any, float]] = None,
    num_layers: Optional[int] = None,
    batch_size: int = 64,
    backbone: Optional[Any] = None,
    device: Optional[torch.device] = None,
) -> Tuple[Tensor, Tensor, List[List[int]]]:
    """Tokenize, embed, unit-normalize and mask: ``(embeddings (n, L, S, D),
    token weights (n, S), token id lists)``, the tensors on ``device``. The
    model runs in chunks of ``batch_size`` sentences, the last padded with
    empty rows, so the corpus size never sets the device memory and every
    chunk has one shape."""
    device = torch.device("cpu") if device is None else device
    batch = _tokenize_padded(tokenizer, sentences, max_length)
    input_ids, attention_mask = batch["input_ids"], batch["attention_mask"]
    n = len(sentences)
    step = max(1, batch_size)
    n_pad = -(-n // step) * step if n else 0
    weight_mask = _weight_mask(attention_mask)

    ids_dev = torch.zeros((n_pad, input_ids.shape[1]), dtype=torch.int64)
    mask_dev = torch.zeros((n_pad, input_ids.shape[1]), dtype=torch.int64)
    ids_dev[:n], mask_dev[:n] = torch.from_numpy(input_ids.astype(np.int64)), torch.from_numpy(attention_mask.astype(np.int64))
    ids_dev, mask_dev = ids_dev.to(device), mask_dev.to(device)
    wm_dev = torch.from_numpy(weight_mask.astype(np.float32)).to(device)

    chunks = []
    with torch.no_grad():
        for lo in range(0, n_pad, step):
            part = _forward_chunk(model, user_forward_fn, backbone, all_layers, num_layers,
                                  ids_dev[lo : lo + step], mask_dev[lo : lo + step])
            chunks.append(part[: max(0, min(step, n - lo))])
    if chunks:
        emb = torch.cat(chunks) if len(chunks) > 1 else chunks[0]
        emb = emb / torch.linalg.vector_norm(emb, dim=-1, keepdim=True).clamp(min=1e-12)
        emb = emb * wm_dev[:, None, :, None]
    else:
        emb = torch.zeros((0, 1, 0, 0), device=device)

    token_lists = [[int(t) for t, a in zip(row, arow) if a] for row, arow in zip(input_ids, attention_mask)]
    if idf and idf_map is not None:
        weights = np.zeros_like(attention_mask, dtype=np.float32)
        default = idf_map.get("__default__", 0.0)
        for i, row in enumerate(input_ids):
            for j, (tid, a) in enumerate(zip(row, weight_mask[i])):
                if a:
                    weights[i, j] = idf_map.get(int(tid), default)
        sums = weights.sum(axis=1, keepdims=True)
        scale = weights / np.where(sums > 0, sums, 1.0)
    else:
        maskf = weight_mask.astype(np.float32)
        counts = maskf.sum(axis=1, keepdims=True)
        scale = maskf / np.where(counts > 0, counts, 1.0)
    return emb, torch.from_numpy(np.asarray(scale, np.float32)).to(device), token_lists


def _read_baseline_csv(baseline_path: str, device: Optional[torch.device] = None) -> Tensor:
    """A bert-score rescale-baseline CSV from a local file: the header row
    skipped, the first column (the layer index) dropped, the rest per-layer
    (precision, recall, f1) baselines."""
    import csv

    with open(baseline_path) as fname:
        rows = [[float(item) for item in row] for idx, row in enumerate(csv.reader(fname)) if idx > 0]
    return torch.tensor(rows, dtype=torch.float32, device=device)[:, 1:]


def _rescale_with_baseline(
    precision: Tensor,
    recall: Tensor,
    f1_score: Tensor,
    baseline: Tensor,
    num_layers: Optional[int] = None,
    all_layers: bool = False,
) -> Tuple[Tensor, Tensor, Tensor]:
    """``(x - b) / (1 - b)`` per layer."""
    if num_layers is None and all_layers is False:
        num_layers = -1
    all_metrics = torch.stack([precision, recall, f1_score], dim=-1)
    baseline_scale = baseline[:, None, :] if all_layers else baseline[num_layers]
    all_metrics = (all_metrics - baseline_scale) / (1 - baseline_scale)
    return all_metrics[..., 0], all_metrics[..., 1], all_metrics[..., 2]


def _score_embeddings(
    preds_emb: Tensor,
    target_emb: Tensor,
    preds_scale: Tensor,
    target_scale: Tensor,
    batch_size: int = 64,
    baseline: Optional[Tensor] = None,
    num_layers: Optional[int] = None,
    all_layers: bool = False,
) -> Tuple[Tensor, Tensor, Tensor]:
    """``(precision, recall, f1)`` of pre-computed ``(n, L, S, D)`` embeddings
    and ``(n, S)`` token weights: ``(n,)`` each for one layer, ``(L, n)`` for
    several. Shared with the stream-time path of :class:`~tpumetrics_torch.text.bert.BERTScore`."""
    n = preds_emb.shape[0]
    if n:
        outs = bert_greedy_match(
            preds_emb.to(torch.float32), target_emb.to(torch.float32), preds_scale.to(torch.float32),
            target_scale.to(torch.float32), chunk_rows=max(1, batch_size),
        )
        # (n, L) -> (n,) for one layer, (L, n) for several
        precision, recall, f1 = (x[:, 0] if x.shape[1] == 1 else x.T for x in outs)
    else:
        precision = recall = f1 = torch.zeros((0,), dtype=torch.float32, device=preds_emb.device)
    if baseline is not None:
        precision, recall, f1 = _rescale_with_baseline(precision, recall, f1, baseline, num_layers, all_layers)
    return precision, recall, f1


def bert_score(
    preds: Union[str, List[str]],
    target: Union[str, List[str]],
    model_name_or_path: Optional[str] = None,
    num_layers: Optional[int] = None,
    all_layers: bool = False,
    model: Optional[Any] = None,
    user_tokenizer: Optional[Any] = None,
    user_forward_fn: Optional[Callable] = None,
    verbose: bool = False,
    idf: bool = False,
    device: Optional[Union[str, torch.device]] = None,
    max_length: int = 512,
    batch_size: int = 64,
    num_threads: int = 0,
    return_hash: bool = False,
    lang: str = "en",
    rescale_with_baseline: bool = False,
    baseline_path: Optional[str] = None,
    baseline_url: Optional[str] = None,
    backbone: Optional[Any] = None,
) -> Dict[str, Tensor]:
    """BERTScore: greedy cosine matching of contextual token embeddings.

    Pass ``model`` + ``user_tokenizer`` (+ optionally ``user_forward_fn``) to
    use any embedding model, or ``backbone`` (a shared handle from
    :func:`tpumetrics_torch.backbones.get_backbone` over a forward
    ``(params, input_ids, attention_mask) -> (B, S, D)`` or ``(B, L, S, D)``)
    with ``user_tokenizer``; a hub id loads through ``transformers``, gated
    where that or the checkpoint is absent. The token ids go to ``device``
    (the card when omitted), where the model must run and the scores are
    made. ``num_threads`` and ``verbose`` are accepted and ignored.

    Example:
        >>> import torch
        >>> from tpumetrics_torch.functional.text import bert_score
        >>> table = torch.eye(8)
        >>> tok = lambda s, **kw: {"input_ids": [[0] + [len(w) for w in x.split()] + [0] for x in s],
        ...                        "attention_mask": [[1] * (len(x.split()) + 2) for x in s]}
        >>> out = bert_score(["a bb ccc"], ["a bb dddd"], model=table, user_tokenizer=tok,
        ...                  user_forward_fn=lambda m, b: m[b["input_ids"]], device="cpu")
        >>> [round(float(out[k][0]), 4) for k in ("precision", "recall", "f1")]
        [0.6667, 0.6667, 0.6667]
    """
    if isinstance(preds, str):
        preds = [preds]
    if isinstance(target, str):
        target = [target]
    if len(preds) != len(target):
        raise ValueError(
            f"Expected argument `preds` and `target` to have same length, but got {len(preds)} and {len(target)}"
        )
    device = _resolve_device(device)
    baseline = None
    if rescale_with_baseline:
        if not baseline_path:
            raise NotImplementedError(
                "Baseline rescaling without a local file requires downloading the bert-score"
                " baseline (reference bert.py:202-222), which is not supported here. Save the"
                " baseline CSV locally and pass it via `baseline_path=`."
            )
        baseline = _read_baseline_csv(baseline_path, device)

    if backbone is not None:
        if user_tokenizer is None:
            raise ValueError("`user_tokenizer` must be provided together with a `backbone`")
        tokenizer = user_tokenizer
    elif model is None:
        model, tokenizer = _load_default_model(model_name_or_path or "roberta-large", num_layers)
        model = model.to(device)
    else:
        if user_tokenizer is None:
            raise ValueError("`user_tokenizer` must be provided together with a custom `model`")
        tokenizer = user_tokenizer

    idf_map: Optional[Dict[Any, float]] = None
    if idf:
        target_batch = _tokenize_padded(tokenizer, list(target), max_length)
        token_lists = [
            [int(t) for t, a in zip(row, arow) if a]
            for row, arow in zip(target_batch["input_ids"], target_batch["attention_mask"])
        ]
        idf_map = _compute_idf(token_lists, len(target))

    preds_emb, preds_scale, _ = _embed(
        list(preds), model, tokenizer, user_forward_fn, all_layers, max_length, idf, idf_map,
        num_layers, batch_size, backbone, device,
    )
    target_emb, target_scale, _ = _embed(
        list(target), model, tokenizer, user_forward_fn, all_layers, max_length, idf, idf_map,
        num_layers, batch_size, backbone, device,
    )
    precision, recall, f1 = _score_embeddings(
        preds_emb, target_emb, preds_scale, target_scale, batch_size, baseline, num_layers, all_layers,
    )
    output: Dict[str, Any] = {"precision": precision, "recall": recall, "f1": f1}
    if return_hash:
        output["hash"] = f"tpumetrics-bert_score-idf:{idf}"
    return output
