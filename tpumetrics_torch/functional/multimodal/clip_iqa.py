"""CLIP Image Quality Assessment (port of
``tpumetrics/functional/multimodal/clip_iqa.py``, after Wang, Chan & Loy 2022)."""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple, Union

import torch

from tpumetrics_torch.functional.multimodal.clip_score import (
    _get_clip_model_and_processor,
    _host,
    _image_features,
    _model_device,
    _text_features,
    _unit,
)
from tpumetrics_torch.utils.compute import _safe_matmul

Tensor = torch.Tensor

_PROMPTS: Dict[str, Tuple[str, str]] = {
    "quality": ("Good photo.", "Bad photo."),
    "brightness": ("Bright photo.", "Dark photo."),
    "noisiness": ("Clean photo.", "Noisy photo."),
    "colorfullness": ("Colorful photo.", "Dull photo."),
    "sharpness": ("Sharp photo.", "Blurry photo."),
    "contrast": ("High contrast photo.", "Low contrast photo."),
    "complexity": ("Complex photo.", "Simple photo."),
    "natural": ("Natural photo.", "Synthetic photo."),
    "happy": ("Happy photo.", "Sad photo."),
    "scary": ("Scary photo.", "Peaceful photo."),
    "new": ("New photo.", "Old photo."),
    "warm": ("Warm photo.", "Cold photo."),
    "real": ("Real photo.", "Abstract photo."),
    "beautiful": ("Beautiful photo.", "Ugly photo."),
    "lonely": ("Lonely photo.", "Sociable photo."),
    "relaxing": ("Relaxing photo.", "Stressful photo."),
}


def _clip_iqa_format_prompts(prompts: Tuple[Union[str, Tuple[str, str]], ...]) -> Tuple[List[str], List[str]]:
    """Resolve built-in prompt names and custom (positive, negative) pairs."""
    if not isinstance(prompts, tuple):
        raise ValueError("Argument `prompts` must be a tuple")
    prompts_names: List[str] = []
    prompts_list: List[str] = []
    count = 0
    for p in prompts:
        if not isinstance(p, (str, tuple)):
            raise ValueError("Argument `prompts` must be a tuple containing strings or tuples of strings")
        if isinstance(p, str):
            if p not in _PROMPTS:
                raise ValueError(
                    f"All elements of `prompts` must be one of {list(_PROMPTS)} if not custom tuple prompts,"
                    f" got {p}."
                )
            prompts_names.append(p)
            prompts_list.extend(_PROMPTS[p])
        else:
            if len(p) != 2:
                raise ValueError("If a tuple is provided in argument `prompts`, it must be of length 2")
            prompts_names.append(f"user_defined_{count}")
            prompts_list.extend(p)
            count += 1
    return prompts_names, prompts_list


def _clip_iqa_text_features(model: Any, processor: Any, prompts_list: Any) -> Tensor:
    """Unit-normalized anchor embeddings of the antonym prompts, on the
    model's device; they depend only on the prompts, so a caller streaming
    many image batches computes them once (the metric class does so at
    construction)."""
    processed = processor(text=prompts_list, return_tensors="np", padding=True)
    return _text_features(model, processed["input_ids"], processed["attention_mask"])


def clip_image_quality_assessment(
    images: Tensor,
    model_name_or_path: Union[str, Tuple[Any, Any]] = "clip_iqa",
    data_range: float = 1.0,
    prompts: Tuple[Union[str, Tuple[str, str]], ...] = ("quality",),
    text_features: Optional[Tensor] = None,
    device: Optional[Union[str, torch.device]] = None,
) -> Union[Tensor, Dict[str, Tensor]]:
    """CLIP-IQA: the softmax of each image's similarity to antonym prompt
    pairs, on the model's device.

    ``model_name_or_path`` takes an explicit ``(model, processor)`` pair for
    offline or custom CLIP models. ``text_features`` skips the text tower
    with precomputed anchors (see :func:`_clip_iqa_text_features`). A model
    loaded from a hub id runs on ``device`` (the card when omitted).
    """
    prompts_names, prompts_list = _clip_iqa_format_prompts(prompts)
    model, processor = _get_clip_model_and_processor(model_name_or_path, device)

    images = torch.as_tensor(images).to(torch.float32) / float(data_range)
    if images.ndim != 4:
        raise ValueError(f"Expected 4D (N, C, H, W) image input but got {tuple(images.shape)}")

    processed = processor(images=list(_host(images)), return_tensors="np")
    img_features = _image_features(model, processed["pixel_values"])
    if text_features is not None:
        txt_features = torch.as_tensor(text_features, device=_model_device(model))
        if txt_features.ndim != 2 or txt_features.shape[0] != len(prompts_list):
            raise ValueError(
                f"Expected `text_features` of shape ({len(prompts_list)}, D) — one row per"
                f" positive/negative prompt — but got {tuple(txt_features.shape)}"
            )
        # re-normalize: raw embeddings would turn the 100x-scaled softmax into garbage silently
        txt_features = _unit(txt_features.to(img_features.dtype))
    else:
        txt_features = _clip_iqa_text_features(model, processor, prompts_list)

    logits = 100 * _safe_matmul(img_features, txt_features)  # (N, 2 * prompts)
    logits = logits.reshape(logits.shape[0], -1, 2)
    probs = torch.softmax(logits, dim=-1)[..., 0]  # P(positive prompt)
    if len(prompts_names) == 1:
        return probs.squeeze(-1)
    return {name: probs[:, i] for i, name in enumerate(prompts_names)}
