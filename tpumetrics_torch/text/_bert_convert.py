"""Carry the weights of ``transformers``' Flax BERT / RoBERTa models into the
port's :mod:`~tpumetrics_torch.text._bert_encoder` modules.

``bert_params_from_flax(model.params)`` takes a ``FlaxBertModel``'s or
``FlaxRobertaModel``'s parameter tree (arrays of either framework or numpy)
and returns a :class:`~tpumetrics_torch.text._bert_encoder.BertEncoder`
``state_dict``; ``mlm_params_from_flax`` a ``FlaxBertForMaskedLM``'s, for
:class:`~tpumetrics_torch.text._bert_encoder.BertForMaskedLM`. A Flax
``Dense`` kernel is ``(in, out)`` and a torch ``Linear`` weight ``(out, in)``,
so kernels are transposed; LayerNorm ``scale`` is torch's ``weight``. The
masked LM's decoder is tied to the word embeddings in both, so only its bias
is carried. The pooler is not used by the metrics and is dropped. Nothing
here imports JAX or Flax.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

Tensor = torch.Tensor


def _array(x: Any) -> Tensor:
    return torch.from_numpy(np.array(x, dtype=np.float32))


def _dense(tree: Mapping[str, Any]) -> Dict[str, Tensor]:
    return {"weight": _array(tree["kernel"]).T.contiguous(), "bias": _array(tree["bias"])}


def _norm(tree: Mapping[str, Any]) -> Dict[str, Tensor]:
    return {"weight": _array(tree["scale"]), "bias": _array(tree["bias"])}


def _put(out: Dict[str, Tensor], prefix: str, parts: Dict[str, Tensor]) -> None:
    for name, value in parts.items():
        out[f"{prefix}.{name}"] = value


def bert_params_from_flax(params: Mapping[str, Any], prefix: str = "") -> Dict[str, Tensor]:
    """A ``BertEncoder`` ``state_dict`` from a Flax BERT or RoBERTa model's
    ``params`` (the pooler dropped); ``prefix`` is prepended to every key."""
    emb = params["embeddings"]
    out: Dict[str, Tensor] = {
        f"{prefix}embeddings.word.weight": _array(emb["word_embeddings"]["embedding"]),
        f"{prefix}embeddings.position.weight": _array(emb["position_embeddings"]["embedding"]),
        f"{prefix}embeddings.token_type.weight": _array(emb["token_type_embeddings"]["embedding"]),
    }
    _put(out, f"{prefix}embeddings.norm", _norm(emb["LayerNorm"]))
    layers = params["encoder"]["layer"]
    for i in range(len(layers)):
        layer, name = layers[str(i)], f"{prefix}layers.{i}"
        attn = layer["attention"]
        for part in ("query", "key", "value"):
            _put(out, f"{name}.{part}", _dense(attn["self"][part]))
        _put(out, f"{name}.attn_out", _dense(attn["output"]["dense"]))
        _put(out, f"{name}.attn_norm", _norm(attn["output"]["LayerNorm"]))
        _put(out, f"{name}.ffn_in", _dense(layer["intermediate"]["dense"]))
        _put(out, f"{name}.ffn_out", _dense(layer["output"]["dense"]))
        _put(out, f"{name}.ffn_norm", _norm(layer["output"]["LayerNorm"]))
    return out


def mlm_params_from_flax(params: Mapping[str, Any]) -> Dict[str, Tensor]:
    """A ``BertForMaskedLM`` ``state_dict`` from a ``FlaxBertForMaskedLM``'s
    ``params``: the encoder under ``encoder.``, the head's transform, and the
    decoder's bias (its matrix is the tied word embeddings)."""
    out = bert_params_from_flax(params["bert"], prefix="encoder.")
    head = params["cls"]["predictions"]
    _put(out, "dense", _dense(head["transform"]["dense"]))
    _put(out, "norm", _norm(head["transform"]["LayerNorm"]))
    out["decoder_bias"] = _array(head["bias"])
    return out
