"""The port's own CLIP (text and vision towers and their projections).

The JAX package takes CLIP from ``transformers``' ``FlaxCLIPModel``
(``tpumetrics/functional/multimodal/clip_score.py``), which the card's
machine lacks. This module computes the same network in torch from a
configuration written in code; :data:`CLIP_VIT_L_14` carries the published
widths of ``openai/clip-vit-large-patch14`` (its Hugging Face
``config.json``, named, not fetched).

:class:`CLIPModel` offers the surface the metrics call:
``get_text_features(input_ids, attention_mask)``,
``get_image_features(pixel_values)`` (NCHW) and
``config.text_config.max_position_embeddings``.

- Both towers are pre-LN blocks (LayerNorm, attention, residual; LayerNorm,
  an MLP with ``quick_gelu``, residual), attention as in
  :func:`~tpumetrics_torch.text._bert_encoder.attention` (the query scaled
  first, an additive mask, a float32 softmax).
- Text: token and position embeddings, a causal mask joined with the padding
  mask, the final LayerNorm, then the pooled position as Flax CLIP takes it:
  ``input_ids.argmax(-1)`` when ``eos_token_id == 2`` (the legacy default,
  where the end token is the largest id), else the first ``eos_token_id``.
- Vision: a patch convolution without bias, the class embedding before the
  patches, position embeddings, ``pre_layrnorm`` before the layers, and
  ``post_layernorm`` on the class token.
- The projections have no bias.

Every product and the patch convolution run in full float32, never TF32.
The weights come as a ``state_dict`` (``_clip_convert`` carries a Flax
model's over) or from :func:`random_clip_params`.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from tpumetrics_torch.text._bert_encoder import additive_mask, attention, load_module, random_params
from tpumetrics_torch.utils.compute import _ieee_float32, _ieee_float32_matmul

Tensor = torch.Tensor


@dataclass(frozen=True)
class CLIPTextConfig:
    vocab_size: int = 49_408
    hidden_size: int = 768
    intermediate_size: int = 3_072
    num_attention_heads: int = 12
    num_hidden_layers: int = 12
    max_position_embeddings: int = 77
    layer_norm_eps: float = 1e-5
    hidden_act: str = "quick_gelu"
    eos_token_id: int = 2


@dataclass(frozen=True)
class CLIPVisionConfig:
    hidden_size: int = 1_024
    intermediate_size: int = 4_096
    num_attention_heads: int = 16
    num_hidden_layers: int = 24
    image_size: int = 224
    patch_size: int = 14
    num_channels: int = 3
    layer_norm_eps: float = 1e-5
    hidden_act: str = "quick_gelu"


@dataclass(frozen=True)
class CLIPConfig:
    text_config: CLIPTextConfig = field(default_factory=CLIPTextConfig)
    vision_config: CLIPVisionConfig = field(default_factory=CLIPVisionConfig)
    projection_dim: int = 768


#: ``openai/clip-vit-large-patch14`` (Hugging Face ``config.json``): 257 tokens an image (16 x 16 patches and
#: the class token), 77 text positions, ``eos_token_id`` 2
CLIP_VIT_L_14 = CLIPConfig()

_ACTIVATIONS = {"quick_gelu": lambda x: x * torch.sigmoid(1.702 * x), "gelu": F.gelu}


class _Layer(nn.Module):
    def __init__(self, config) -> None:
        super().__init__()
        d, eps = config.hidden_size, config.layer_norm_eps
        self.heads = config.num_attention_heads
        self.act = _ACTIVATIONS[config.hidden_act]
        self.norm1, self.norm2 = nn.LayerNorm(d, eps=eps), nn.LayerNorm(d, eps=eps)
        self.query, self.key, self.value, self.out = (nn.Linear(d, d) for _ in range(4))
        self.fc1, self.fc2 = nn.Linear(d, config.intermediate_size), nn.Linear(config.intermediate_size, d)

    def forward(self, x: Tensor, bias: Optional[Tensor]) -> Tensor:
        x = x + self.out(attention(self.norm1(x), self.query, self.key, self.value, self.heads, bias))
        return x + self.fc2(self.act(self.fc1(self.norm2(x))))


class _TextTower(nn.Module):
    def __init__(self, config: CLIPTextConfig) -> None:
        super().__init__()
        self.config = config
        self.token = nn.Embedding(config.vocab_size, config.hidden_size)
        self.position = nn.Embedding(config.max_position_embeddings, config.hidden_size)
        self.layers = nn.ModuleList(_Layer(config) for _ in range(config.num_hidden_layers))
        self.final_norm = nn.LayerNorm(config.hidden_size, eps=config.layer_norm_eps)

    def forward(self, input_ids: Tensor, attention_mask: Optional[Tensor], position_ids: Optional[Tensor]) -> Tensor:
        b, s = input_ids.shape
        if position_ids is None:
            position_ids = torch.arange(s, device=input_ids.device).expand(b, s)
        keep = torch.ones(s, s, dtype=torch.bool, device=input_ids.device).tril()[None, None]
        if attention_mask is not None:
            keep = keep & (attention_mask[:, None, None, :] > 0)
        bias = additive_mask(keep)
        x = self.token(input_ids) + self.position(position_ids)
        for layer in self.layers:
            x = layer(x, bias)
        x = self.final_norm(x)
        if self.config.eos_token_id == 2:  # legacy: the end token is the largest id of a row
            last = input_ids.argmax(dim=-1)
        else:
            last = (input_ids == self.config.eos_token_id).to(torch.int32).argmax(dim=-1)
        return x[torch.arange(b, device=x.device), last]


class _VisionTower(nn.Module):
    def __init__(self, config: CLIPVisionConfig) -> None:
        super().__init__()
        d = config.hidden_size
        self.patch_size = config.patch_size
        self.class_embedding = nn.Parameter(torch.zeros(d))
        self.patch = nn.Conv2d(config.num_channels, d, config.patch_size, stride=config.patch_size, bias=False)
        self.position = nn.Embedding((config.image_size // config.patch_size) ** 2 + 1, d)
        self.pre_norm = nn.LayerNorm(d, eps=config.layer_norm_eps)
        self.layers = nn.ModuleList(_Layer(config) for _ in range(config.num_hidden_layers))
        self.post_norm = nn.LayerNorm(d, eps=config.layer_norm_eps)

    def forward(self, pixel_values: Tensor) -> Tensor:
        with _ieee_float32(torch.backends.cudnn.conv, torch.backends.mkldnn.conv):
            patches = self.patch(pixel_values).flatten(2).transpose(1, 2)
        cls = self.class_embedding.expand(patches.shape[0], 1, -1)
        x = self.pre_norm(torch.cat([cls, patches], dim=1) + self.position.weight)
        for layer in self.layers:
            x = layer(x, None)
        return self.post_norm(x[:, 0])


class CLIPModel(nn.Module):
    """CLIP's two towers and projections, in eval use only.

    Example:
        >>> import torch
        >>> from tpumetrics_torch.multimodal._clip import CLIPConfig, CLIPModel, CLIPTextConfig, CLIPVisionConfig
        >>> tiny = CLIPConfig(CLIPTextConfig(100, 32, 64, 2, 1, 16), CLIPVisionConfig(32, 64, 2, 1, 32, 8), 16)
        >>> model = CLIPModel(tiny)
        >>> tuple(model.get_text_features(torch.tensor([[5, 9, 2]]), torch.ones(1, 3)).shape)
        (1, 16)
        >>> tuple(model.get_image_features(torch.zeros(2, 3, 32, 32)).shape)
        (2, 16)
    """

    def __init__(self, config: CLIPConfig) -> None:
        super().__init__()
        self.config = config
        self.text = _TextTower(config.text_config)
        self.vision = _VisionTower(config.vision_config)
        self.text_projection = nn.Linear(config.text_config.hidden_size, config.projection_dim, bias=False)
        self.visual_projection = nn.Linear(config.vision_config.hidden_size, config.projection_dim, bias=False)

    def _device(self) -> torch.device:
        return self.text_projection.weight.device

    def get_text_features(
        self, input_ids: Tensor, attention_mask: Optional[Tensor] = None, position_ids: Optional[Tensor] = None
    ) -> Tensor:
        """The projected pooled text embedding, ``(B, projection_dim)``."""
        device = self._device()
        input_ids = torch.as_tensor(input_ids, device=device).to(torch.int64)
        if attention_mask is not None:
            attention_mask = torch.as_tensor(attention_mask, device=device)
        with _ieee_float32_matmul():
            return self.text_projection(self.text(input_ids, attention_mask, position_ids))

    def get_image_features(self, pixel_values: Tensor) -> Tensor:
        """The projected class-token embedding of ``(B, C, H, W)`` pixels, ``(B, projection_dim)``."""
        weight = self.visual_projection.weight
        pixel_values = torch.as_tensor(pixel_values, device=weight.device).to(weight.dtype)
        with _ieee_float32_matmul():
            return self.visual_projection(self.vision(pixel_values))


def random_clip_params(config: CLIPConfig, seed: int = 0, device: Optional[torch.device] = None) -> Dict[str, Tensor]:
    """Random weights of the CLIP of ``config``: N(0, 0.02) matrices, embeddings and biases, LayerNorms at 1 and 0
    (:func:`~tpumetrics_torch.text._bert_encoder.random_params`)."""
    return random_params(lambda: CLIPModel(config), seed, device)


def build_clip(config: CLIPConfig, params: Dict[str, Tensor], device: Optional[torch.device] = None,
               dtype: torch.dtype = torch.float32) -> CLIPModel:
    """The :class:`CLIPModel` of ``config`` holding ``params`` on ``device``, in eval mode."""
    return load_module(lambda: CLIPModel(config), params, device, dtype)
