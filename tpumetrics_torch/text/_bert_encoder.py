"""The port's own BERT / RoBERTa encoder and BERT's masked-LM head.

The JAX package takes its encoders from ``transformers``' Flax classes
(``FlaxAutoModel`` in ``tpumetrics/functional/text/bert.py``,
``FlaxAutoModelForMaskedLM`` in ``functional/text/infolm.py``). The card's
machine has no ``transformers``, so the port computes the same networks in
torch, from a configuration written in code:

- :data:`ROBERTA_LARGE` and :data:`BERT_BASE_UNCASED` carry the published
  widths of the Hugging Face ``config.json`` of ``roberta-large`` and
  ``bert-base-uncased`` (named here, never fetched);
- :class:`BertEncoder` is BERT's and RoBERTa's encoder (post-LN blocks,
  exact GELU) and returns every hidden state, the embeddings' first;
  RoBERTa's position ids are ``transformers``' ``create_position_ids_from_input_ids``:
  a cumsum of the non-pad mask, plus ``pad_token_id`` on real tokens, so that
  they start at ``pad_token_id + 1``;
- :class:`BertForMaskedLM` adds the MLM head (dense, GELU, LayerNorm, then
  the decoder tied to the word embeddings plus its own bias).

Attention is a matmul, an additive mask (0 or float32's lowest), a float32
softmax and a matmul, with the query scaled first, as Flax's
``dot_product_attention_weights`` computes it; ``scaled_dot_product_attention``
is not used (a library kernel, and it reduces in another order). Every
product runs in full float32 (``_ieee_float32_matmul``), never TF32. The
weights come as a ``state_dict`` (``_bert_convert`` carries the Flax
models' over) or from :func:`random_bert_params`.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from tpumetrics_torch.utils.compute import _ieee_float32_matmul

Tensor = torch.Tensor


@dataclass(frozen=True)
class BertConfig:
    """An encoder's widths, in the names of ``transformers``' ``BertConfig``.

    ``roberta_positions`` selects RoBERTa's position ids (from the pad mask)
    over BERT's ``arange``."""

    vocab_size: int
    hidden_size: int
    num_hidden_layers: int
    num_attention_heads: int
    intermediate_size: int
    max_position_embeddings: int
    type_vocab_size: int
    layer_norm_eps: float
    pad_token_id: int
    roberta_positions: bool = False


#: ``roberta-large``'s ``config.json`` (Hugging Face): BERTScore's default encoder
ROBERTA_LARGE = BertConfig(
    vocab_size=50_265, hidden_size=1_024, num_hidden_layers=24, num_attention_heads=16, intermediate_size=4_096,
    max_position_embeddings=514, type_vocab_size=1, layer_norm_eps=1e-5, pad_token_id=1, roberta_positions=True,
)
#: ``bert-base-uncased``'s ``config.json`` (Hugging Face): InfoLM's default masked LM
BERT_BASE_UNCASED = BertConfig(
    vocab_size=30_522, hidden_size=768, num_hidden_layers=12, num_attention_heads=12, intermediate_size=3_072,
    max_position_embeddings=512, type_vocab_size=2, layer_norm_eps=1e-12, pad_token_id=0,
)


class EncoderOutput:
    """What the metrics read of a forward: ``last_hidden_state``,
    ``hidden_states`` (every layer's, the embeddings' first) and, for the
    masked LM, ``logits``."""

    def __init__(self, hidden_states: Tuple[Tensor, ...], logits: Optional[Tensor] = None) -> None:
        self.hidden_states = hidden_states
        self.last_hidden_state = hidden_states[-1]
        self.logits = logits


def position_ids(input_ids: Tensor, config: BertConfig) -> Tensor:
    """BERT's ``arange``, or RoBERTa's ids from the pad mask."""
    if config.roberta_positions:
        mask = (input_ids != config.pad_token_id).to(torch.int64)
        return torch.cumsum(mask, dim=1) * mask + config.pad_token_id
    return torch.arange(input_ids.shape[1], device=input_ids.device).expand(input_ids.shape)


def additive_mask(keep: Tensor) -> Tensor:
    """0 where ``keep`` holds, float32's lowest elsewhere (Flax's bias)."""
    zero = torch.zeros((), dtype=torch.float32, device=keep.device)
    return torch.where(keep, zero, torch.finfo(torch.float32).min)


def attention(x: Tensor, q: nn.Linear, k: nn.Linear, v: nn.Linear, heads: int, bias: Optional[Tensor]) -> Tensor:
    """Multi-head attention over ``x`` (B, S, D) with an additive ``bias``
    broadcast to (B, H, S, S), or none: the query scaled by 1/sqrt(head width), a
    matmul, the bias, a float32 softmax, a matmul; the heads merged."""
    b, s, d = x.shape
    width = d // heads

    def split(t: Tensor) -> Tensor:
        return t.reshape(b, s, heads, width).transpose(1, 2)

    query = split(q(x)) / math.sqrt(width)
    scores = torch.matmul(query, split(k(x)).transpose(-1, -2))
    if bias is not None:
        scores = scores + bias
    weights = torch.softmax(scores, dim=-1, dtype=torch.promote_types(scores.dtype, torch.float32)).to(x.dtype)
    return torch.matmul(weights, split(v(x))).transpose(1, 2).reshape(b, s, d)


class _Layer(nn.Module):
    """One post-LN block: attention, residual, LayerNorm; FFN (exact GELU), residual, LayerNorm."""

    def __init__(self, config: BertConfig) -> None:
        super().__init__()
        d, eps = config.hidden_size, config.layer_norm_eps
        self.heads = config.num_attention_heads
        self.query, self.key, self.value = nn.Linear(d, d), nn.Linear(d, d), nn.Linear(d, d)
        self.attn_out = nn.Linear(d, d)
        self.attn_norm = nn.LayerNorm(d, eps=eps)
        self.ffn_in = nn.Linear(d, config.intermediate_size)
        self.ffn_out = nn.Linear(config.intermediate_size, d)
        self.ffn_norm = nn.LayerNorm(d, eps=eps)

    def forward(self, x: Tensor, bias: Tensor) -> Tensor:
        x = self.attn_norm(self.attn_out(attention(x, self.query, self.key, self.value, self.heads, bias)) + x)
        return self.ffn_norm(self.ffn_out(F.gelu(self.ffn_in(x))) + x)


class _Embeddings(nn.Module):
    def __init__(self, config: BertConfig) -> None:
        super().__init__()
        self.config = config
        self.word = nn.Embedding(config.vocab_size, config.hidden_size)
        self.position = nn.Embedding(config.max_position_embeddings, config.hidden_size)
        self.token_type = nn.Embedding(config.type_vocab_size, config.hidden_size)
        self.norm = nn.LayerNorm(config.hidden_size, eps=config.layer_norm_eps)

    def forward(self, input_ids: Tensor, token_type_ids: Tensor) -> Tensor:
        x = self.word(input_ids) + self.token_type(token_type_ids) + self.position(position_ids(input_ids, self.config))
        return self.norm(x)


class BertEncoder(nn.Module):
    """BERT's or RoBERTa's encoder.

    ``model(input_ids=..., attention_mask=..., output_hidden_states=True)``
    returns an :class:`EncoderOutput` whose ``hidden_states`` are the
    embeddings' and every layer's output, ``(B, S, D)`` each: the surface
    ``bert_score`` calls on a Flax model.

    Example:
        >>> import torch
        >>> from tpumetrics_torch.text._bert_encoder import BertConfig, BertEncoder
        >>> tiny = BertEncoder(BertConfig(100, 32, 1, 2, 64, 16, 1, 1e-5, 1, roberta_positions=True))
        >>> out = tiny(input_ids=torch.tensor([[0, 9, 2, 1]]), attention_mask=torch.tensor([[1, 1, 1, 0]]))
        >>> len(out.hidden_states), tuple(out.last_hidden_state.shape)
        (2, (1, 4, 32))
    """

    def __init__(self, config: BertConfig) -> None:
        super().__init__()
        self.config = config
        self.embeddings = _Embeddings(config)
        self.layers = nn.ModuleList(_Layer(config) for _ in range(config.num_hidden_layers))

    def forward(
        self,
        input_ids: Tensor,
        attention_mask: Optional[Tensor] = None,
        token_type_ids: Optional[Tensor] = None,
        output_hidden_states: bool = True,
    ) -> EncoderOutput:
        input_ids = torch.as_tensor(input_ids).to(torch.int64)
        if attention_mask is None:
            attention_mask = torch.ones_like(input_ids)
        attention_mask = torch.as_tensor(attention_mask, device=input_ids.device)
        if token_type_ids is None:
            token_type_ids = torch.zeros_like(input_ids)
        bias = additive_mask(attention_mask[:, None, None, :] > 0)
        with _ieee_float32_matmul():
            x = self.embeddings(input_ids, token_type_ids)
            states = [x]
            for layer in self.layers:
                x = layer(x, bias)
                states.append(x)
        return EncoderOutput(tuple(states))


class BertForMaskedLM(nn.Module):
    """BERT with its masked-LM head: ``model(input_ids=..., attention_mask=...).logits``
    is ``(B, S, vocab)``, the surface InfoLM calls on a Flax masked LM."""

    def __init__(self, config: BertConfig) -> None:
        super().__init__()
        self.config = config
        self.encoder = BertEncoder(config)
        self.dense = nn.Linear(config.hidden_size, config.hidden_size)
        self.norm = nn.LayerNorm(config.hidden_size, eps=config.layer_norm_eps)
        self.decoder_bias = nn.Parameter(torch.zeros(config.vocab_size))

    def forward(
        self,
        input_ids: Tensor,
        attention_mask: Optional[Tensor] = None,
        token_type_ids: Optional[Tensor] = None,
        output_hidden_states: bool = False,
    ) -> EncoderOutput:
        out = self.encoder(input_ids, attention_mask, token_type_ids)
        with _ieee_float32_matmul():
            h = self.norm(F.gelu(self.dense(out.last_hidden_state)))
            logits = F.linear(h, self.encoder.embeddings.word.weight, self.decoder_bias)
        return EncoderOutput(out.hidden_states, logits)


def random_params(make: Callable[[], nn.Module], seed: int = 0, device: Optional[torch.device] = None) -> Dict[str, Tensor]:
    """A ``state_dict`` of random weights for the module ``make()`` builds, made
    from the seed on ``device`` (the module itself is built on the meta device,
    with no weights): LayerNorms at 1 and 0, every other entry N(0, 0.02)
    (``transformers``' initializer range)."""
    with torch.device("meta"):
        module = make()
    norms = {f"{name}.{p}" for name, m in module.named_modules() if isinstance(m, nn.LayerNorm) for p in ("weight", "bias")}
    gen = torch.Generator(device=device or "cpu").manual_seed(seed)
    out = {}
    for key, value in module.state_dict().items():
        if key in norms:
            out[key] = (torch.ones if key.endswith("weight") else torch.zeros)(value.shape, device=device)
        else:
            out[key] = torch.randn(value.shape, generator=gen, device=device) * 0.02
    return out


def load_module(make: Callable[[], nn.Module], params: Dict[str, Tensor], device: Optional[torch.device] = None,
                dtype: torch.dtype = torch.float32) -> nn.Module:
    """The module ``make()`` builds, holding ``params`` on ``device`` in ``dtype``, in eval mode."""
    with torch.device("meta"):
        module = make()
    module = module.to_empty(device=device or "cpu")
    module.load_state_dict({k: torch.as_tensor(v) for k, v in params.items()})
    return module.to(dtype).eval().requires_grad_(False)


def random_bert_params(
    config: BertConfig, seed: int = 0, mlm: bool = False, device: Optional[torch.device] = None
) -> Dict[str, Tensor]:
    """Random weights of the encoder of ``config`` (with ``mlm`` the masked LM's): :func:`random_params`."""
    return random_params(lambda: (BertForMaskedLM if mlm else BertEncoder)(config), seed, device)


def build(config: BertConfig, params: Dict[str, Tensor], mlm: bool = False,
          device: Optional[torch.device] = None, dtype: torch.dtype = torch.float32) -> nn.Module:
    """The encoder of ``config`` (with ``mlm`` the masked LM) holding ``params``: :func:`load_module`."""
    return load_module(lambda: (BertForMaskedLM if mlm else BertEncoder)(config), params, device, dtype)
