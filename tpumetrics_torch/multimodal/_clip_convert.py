"""Carry the weights of ``transformers``' ``FlaxCLIPModel`` into the port's
:class:`~tpumetrics_torch.multimodal._clip.CLIPModel`.

``clip_params_from_flax(model.params)`` takes the Flax parameter tree (arrays
of either framework or numpy) and returns the ``state_dict``: ``Dense``
kernels ``(in, out)`` transposed to ``Linear`` weights ``(out, in)``, the
patch convolution's ``(kh, kw, in, out)`` kernel to ``(out, in, kh, kw)``,
LayerNorm ``scale`` to ``weight``. ``logit_scale`` is not used by the
metrics and is dropped. Nothing here imports JAX or Flax.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import torch

from tpumetrics_torch.text._bert_convert import _array, _dense, _norm, _put

Tensor = torch.Tensor


def _layers(out: Dict[str, Tensor], prefix: str, layers: Mapping[str, Any]) -> None:
    for i in range(len(layers)):
        layer, name = layers[str(i)], f"{prefix}.layers.{i}"
        _put(out, f"{name}.norm1", _norm(layer["layer_norm1"]))
        _put(out, f"{name}.norm2", _norm(layer["layer_norm2"]))
        for src, dst in (("q_proj", "query"), ("k_proj", "key"), ("v_proj", "value"), ("out_proj", "out")):
            _put(out, f"{name}.{dst}", _dense(layer["self_attn"][src]))
        _put(out, f"{name}.fc1", _dense(layer["mlp"]["fc1"]))
        _put(out, f"{name}.fc2", _dense(layer["mlp"]["fc2"]))


def clip_params_from_flax(params: Mapping[str, Any]) -> Dict[str, Tensor]:
    """A ``CLIPModel`` ``state_dict`` from a ``FlaxCLIPModel``'s ``params``."""
    text, vision = params["text_model"], params["vision_model"]
    out: Dict[str, Tensor] = {
        "text.token.weight": _array(text["embeddings"]["token_embedding"]["embedding"]),
        "text.position.weight": _array(text["embeddings"]["position_embedding"]["embedding"]),
        "vision.class_embedding": _array(vision["embeddings"]["class_embedding"]),
        "vision.patch.weight": _array(vision["embeddings"]["patch_embedding"]["kernel"]).permute(3, 2, 0, 1).contiguous(),
        "vision.position.weight": _array(vision["embeddings"]["position_embedding"]["embedding"]),
        "text_projection.weight": _array(params["text_projection"]["kernel"]).T.contiguous(),
        "visual_projection.weight": _array(params["visual_projection"]["kernel"]).T.contiguous(),
    }
    _layers(out, "text", text["encoder"]["layers"])
    _put(out, "text.final_norm", _norm(text["final_layer_norm"]))
    _layers(out, "vision", vision["encoder"]["layers"])
    _put(out, "vision.pre_norm", _norm(vision["pre_layrnorm"]))
    _put(out, "vision.post_norm", _norm(vision["post_layernorm"]))
    return out
