"""Perplexity (port of ``tpumetrics/functional/text/perplexity.py``).

All tensor work: the sum of the tokens' negative log-likelihoods and their
count come from :func:`tpumetrics_torch.ops.token_nll.token_nll`, the
hand-written kernel on a card (one read of the logits, no float32 copy and
no log-probabilities written) and its plain version, a float32
``log_softmax`` and ``gather``, on the CPU.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from tpumetrics_torch.ops.token_nll import token_nll

Tensor = torch.Tensor


def _check_shape_and_type_consistency(preds: Tensor, target: Tensor) -> None:
    """Shape and dtype checks."""
    if preds.ndim != 3:
        raise ValueError(
            "Input tensor `preds` is expected to have 3 dimensions, [batch_size, seq_len, vocab_size],"
            f" but got {preds.ndim}."
        )
    if target.ndim != 2:
        raise ValueError(
            f"Input tensor `target` is expected to have 2 dimensions, [batch_size, seq_len], but got {target.ndim}."
        )
    if preds.shape[:2] != target.shape:
        raise ValueError(
            "Input tensors `preds` and `target` are expected to have equaling first two dimensions,"
            f" [batch_size, seq_len], but got {preds.shape[:2]} and {target.shape}."
        )
    if not preds.is_floating_point():
        raise TypeError(f"Input tensor `preds` is expected to be of a type one of the floating types, got {preds.dtype}.")
    if target.is_floating_point() or target.is_complex() or target.dtype == torch.bool:
        raise TypeError(f"Input tensor `target` is expected to be of a type one of the integer types, got {target.dtype}.")


def _perplexity_update(preds: Tensor, target: Tensor, ignore_index: Optional[int] = None) -> Tuple[Tensor, Tensor]:
    """The summed negative log-probabilities of the targets and their count (float32)."""
    _check_shape_and_type_consistency(preds, target)
    return token_nll(preds, target, ignore_index)


def _perplexity_compute(total: Tensor, count: Tensor) -> Tensor:
    return torch.exp(total / count)


def perplexity(preds: Tensor, target: Tensor, ignore_index: Optional[int] = None) -> Tensor:
    """Perplexity of a language model's token scores.

    Example:
        >>> import torch
        >>> from tpumetrics_torch.functional.text import perplexity
        >>> gen = torch.Generator().manual_seed(22)
        >>> preds = torch.rand(2, 8, 5, generator=gen)
        >>> target = torch.randint(0, 5, (2, 8), generator=gen)
        >>> 4.0 < float(perplexity(preds, target)) < 6.0
        True
    """
    total, count = _perplexity_update(preds, target, ignore_index)
    return _perplexity_compute(total, count)
