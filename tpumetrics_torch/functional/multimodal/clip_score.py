"""CLIPScore (port of ``tpumetrics/functional/multimodal/clip_score.py``).

The model is the port's own :class:`~tpumetrics_torch.multimodal._clip.CLIPModel`
or any model with ``get_text_features(input_ids, attention_mask)``,
``get_image_features(pixel_values)`` and
``config.text_config.max_position_embeddings``, passed with its processor as
a ``(model, processor)`` pair; a hub id string loads through
``transformers``, gated where that or the checkpoint is absent. The
processor protocol is the JAX package's: it takes host copies of the images
(``processor(text=, images=, return_tensors="np", padding=True)``), so an
update reads the host.
"""

from __future__ import annotations

from typing import Any, List, Optional, Tuple, Union

import numpy as np
import torch

from tpumetrics_torch.functional.text.bert import _host
from tpumetrics_torch.metric import _resolve_device
from tpumetrics_torch.utils.imports import _TRANSFORMERS_AVAILABLE
from tpumetrics_torch.utils.prints import rank_zero_warn

Tensor = torch.Tensor


def _get_clip_model_and_processor(
    model_name_or_path: Union[str, Tuple[Any, Any]], device: Optional[Union[str, torch.device]] = None
) -> Tuple[Any, Any]:
    """Resolve a hub id or an explicit (model, processor) pair. A model loaded
    from a hub id goes to ``device`` (the card when omitted); a pair stays
    where its caller put it."""
    if isinstance(model_name_or_path, tuple):
        model, processor = model_name_or_path
        return model, processor
    if not _TRANSFORMERS_AVAILABLE:
        raise ModuleNotFoundError(
            "`clip_score` metric requires `transformers` package be installed."
            " Either install with `pip install transformers>=4.10.0` or `pip install torchmetrics[multimodal]`."
        )
    from transformers import CLIPConfig

    try:
        # the configuration first: without a checkpoint this fails before the modeling code is imported
        CLIPConfig.from_pretrained(model_name_or_path)
        from transformers import CLIPModel, CLIPProcessor

        model = CLIPModel.from_pretrained(model_name_or_path)
        processor = CLIPProcessor.from_pretrained(model_name_or_path)
    except Exception as err:  # offline environments cannot download checkpoints
        raise ModuleNotFoundError(
            f"Could not load pretrained CLIP `{model_name_or_path}` (no model cache/network?)."
            " Pass an explicit `(model, processor)` tuple instead — e.g. a FlaxCLIPModel you"
            " constructed or loaded locally, and a callable processor(text=..., images=...) returning"
            " a dict with `pixel_values`, `input_ids` and `attention_mask` arrays."
        ) from err
    return model.eval().to(_resolve_device(device)), processor


def _model_device(model: Any) -> torch.device:
    """Where a torch model's weights are (the CPU for a model without parameters)."""
    params = getattr(model, "parameters", None)
    if callable(params):
        for p in params():
            return p.device
    return torch.device("cpu")


def _unit(x: Tensor) -> Tensor:
    return x / torch.linalg.vector_norm(x, dim=-1, keepdim=True)


def _image_features(model: Any, pixel_values: Any) -> Tensor:
    """Unit-normalized image embeddings of processed pixels, on the model's device."""
    pixels = torch.as_tensor(np.asarray(pixel_values), device=_model_device(model))
    with torch.no_grad():
        return _unit(torch.as_tensor(model.get_image_features(pixels)))


def _text_features(model: Any, input_ids: Any, attention_mask: Any) -> Tensor:
    """Unit-normalized text embeddings of token ids, on the model's device."""
    device = _model_device(model)
    ids = torch.as_tensor(np.asarray(input_ids), device=device)
    mask = torch.as_tensor(np.asarray(attention_mask), device=device)
    with torch.no_grad():
        return _unit(torch.as_tensor(model.get_text_features(ids, mask)))


def _clip_score_update(
    images: Union[Tensor, List[Tensor]],
    text: Union[str, List[str]],
    model: Any,
    processor: Any,
) -> Tuple[Tensor, int]:
    """100 x the cosine similarity of each image and caption, on the model's device."""
    if not isinstance(images, list):
        images = [images] if images.ndim == 3 else list(images)
    if not all(i.ndim == 3 for i in images):
        raise ValueError("Expected all images to be 3d but found image that has either more or less")
    if not isinstance(text, list):
        text = [text]
    if len(text) != len(images):
        raise ValueError(
            f"Expected the number of images and text examples to be the same but got {len(images)} and {len(text)}"
        )

    processed = processor(text=text, images=[_host(i) for i in images], return_tensors="np", padding=True)

    max_position_embeddings = model.config.text_config.max_position_embeddings
    if processed["attention_mask"].shape[-1] > max_position_embeddings:
        rank_zero_warn(
            f"Encountered caption longer than max_position_embeddings={max_position_embeddings}."
            " Will truncate captions to this length.",
            UserWarning,
        )
        processed["attention_mask"] = processed["attention_mask"][..., :max_position_embeddings]
        processed["input_ids"] = processed["input_ids"][..., :max_position_embeddings]

    img_features = _image_features(model, processed["pixel_values"])
    txt_features = _text_features(model, processed["input_ids"], processed["attention_mask"])
    score = 100 * torch.sum(img_features * txt_features, dim=-1)
    return score, len(text)


def clip_score(
    images: Union[Tensor, List[Tensor]],
    text: Union[str, List[str]],
    model_name_or_path: Union[str, Tuple[Any, Any]] = "openai/clip-vit-large-patch14",
    device: Optional[Union[str, torch.device]] = None,
) -> Tensor:
    """CLIPScore: 100 x the cosine similarity of CLIP's image and caption
    embeddings, averaged and floored at 0, on the model's device. A model
    loaded from a hub id runs on ``device`` (the card when omitted).

    Example:
        >>> import torch
        >>> from tpumetrics_torch.functional.multimodal import clip_score
        >>> from tpumetrics_torch.multimodal._clip import CLIPConfig, CLIPModel, CLIPTextConfig, CLIPVisionConfig
        >>> _ = torch.manual_seed(0)
        >>> model = CLIPModel(CLIPConfig(CLIPTextConfig(100, 32, 64, 2, 1, 16), CLIPVisionConfig(32, 64, 2, 1, 32, 8), 16))
        >>> processor = lambda text, images, **kw: {
        ...     "input_ids": torch.tensor([[1, 2 + len(t), 99] for t in text]).numpy(),
        ...     "attention_mask": torch.ones(len(text), 3, dtype=torch.int64).numpy(),
        ...     "pixel_values": torch.stack([torch.as_tensor(i) for i in images]).numpy()}
        >>> float(clip_score(torch.rand(2, 3, 32, 32), ["a cat", "a dog"], (model, processor))) >= 0
        True
    """
    model, processor = _get_clip_model_and_processor(model_name_or_path, device)
    score, _ = _clip_score_update(images, text, model, processor)
    return torch.clamp(score.mean(), min=0.0)
