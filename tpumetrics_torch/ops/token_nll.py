"""Per-token negative log-likelihood of a language model's logits, the sum
behind perplexity (port of ``tpumetrics/functional/text/perplexity.py``
``_perplexity_update``, which XLA fused; no Pallas kernel).

For logits ``(B, S, V)`` in float32, bfloat16 or float16 (float64 is cast
to float32 first, as the JAX package does) and integer targets ``(B, S)``,
:func:`token_nll` returns ``(total, count)``: the float32 sum over the
counted tokens of ``logsumexp(x) - x[t]``, with the arithmetic of a float32
cast, and the count of those tokens as float32. A target equal to
``ignore_index`` counts nothing and is not counted; a target in ``[-V, -1]``
wraps to ``t + V``, and one outside ``[-V, V)`` makes its NLL, and so the
total, NaN, as JAX's ``take_along_axis`` does.

On a CUDA tensor the hand-written kernel in ``csrc/token_nll.cu`` computes
each row's NLL in one read of the logits, whose V axis must be contiguous:
any strides on B and S are read as they are (the shifted ``logits[:, :-1]``
of a causal LM costs no copy), and any other layout is made contiguous here,
with a warning. It launches on the current stream with no host sync, so a
CUDA graph can capture the call. On a CPU tensor the plain version below
runs: a float32 ``log_softmax``, a ``gather`` and a masked sum. There is no
fallback: a CUDA tensor launches the kernel or raises. The rows are summed
in float64 in one fixed order, so two calls on the same input give the same
bits. The gradient (``torch.autograd.Function``) is ``softmax - onehot`` of
each counted row, from the row's saved logsumexp, in plain torch ops.
"""

from __future__ import annotations

import ctypes
import functools
import warnings
from typing import Optional, Tuple

import torch

from tpumetrics_torch.ops import _build

Tensor = torch.Tensor

#: kernel launches in this process; callers may set it to 0 to count a run
launches = 0
#: kernel calls recorded into CUDA graphs (each replay launches them again)
captured = 0

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


@functools.cache
def _kernel() -> ctypes._CFuncPtr:
    fn = _build.load("token_nll").token_nll
    # (logits, dtype, batch, seq, stride_b, stride_s, vocab, target, ignore_index, has_ignore, nll, lse, stream)
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_longlong, ctypes.c_longlong, ctypes.c_longlong,
        ctypes.c_longlong, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    return fn


def _check_inputs(logits: Tensor, target: Tensor) -> None:
    if logits.ndim != 3 or target.ndim != 2 or tuple(logits.shape[:2]) != tuple(target.shape):
        raise ValueError(
            f"Expected logits (B, S, V) and target (B, S), got {tuple(logits.shape)} and {tuple(target.shape)}"
        )
    if logits.dtype not in _DTYPE_CODES:
        raise TypeError(f"Expected float32, bfloat16 or float16 logits, got {logits.dtype}")
    if target.is_floating_point() or target.is_complex() or target.dtype == torch.bool:
        raise TypeError(f"Expected integer targets, got {target.dtype}")
    if target.device != logits.device:
        raise ValueError(f"Expected `target` on {logits.device}, got {target.device}")
    if logits.shape[2] < 1:
        raise ValueError("Expected a vocabulary of at least 1 class")


def _targets(target: Tensor, vocab: int, ignore_index: Optional[int]) -> Tuple[Tensor, Tensor, Tensor]:
    """``(mask, index, in_range)`` of the flat targets: the counted rows, each
    row's class after the wrap (0 where it is ignored or out of range), and
    whether a counted row's target lies in ``[-V, V)``."""
    t = target.reshape(-1).to(torch.int64)
    mask = t != ignore_index if ignore_index is not None else torch.ones_like(t, dtype=torch.bool)
    t = torch.where(mask, t, 0)
    in_range = (t >= -vocab) & (t < vocab)
    index = torch.where(in_range, torch.where(t < 0, t + vocab, t), 0)
    return mask, index, in_range


def _plain_rows(logits: Tensor, target: Tensor, ignore_index: Optional[int], with_lse: bool):
    """Each row's NLL by a float32 ``log_softmax`` and ``gather`` (0 on ignored
    rows, NaN on out-of-range targets), the counted rows' mask, and each row's
    logsumexp when ``with_lse``."""
    _check_inputs(logits, target)
    vocab = logits.shape[2]
    with torch.autocast(device_type=logits.device.type, enabled=False):
        x = logits.reshape(-1, vocab).to(torch.float32)
        log_probs = torch.log_softmax(x, dim=-1)
        lse = torch.logsumexp(x, dim=-1) if with_lse else None
    mask, index, in_range = _targets(target, vocab, ignore_index)
    picked = torch.where(in_range, log_probs.gather(1, index[:, None])[:, 0], float("nan"))
    return torch.where(mask, -picked, 0.0), mask, lse


def token_nll_rows_plain(logits: Tensor, target: Tensor, ignore_index: Optional[int] = None) -> Tuple[Tensor, Tensor]:
    """The plain version of the kernel: ``(nll, lse)``, each ``(B * S,)``
    float32 (``nll`` 0 on ignored rows, NaN on out-of-range targets)."""
    nll, _, lse = _plain_rows(logits, target, ignore_index, with_lse=True)
    return nll, lse


def token_nll_plain(logits: Tensor, target: Tensor, ignore_index: Optional[int] = None) -> Tuple[Tensor, Tensor]:
    """The plain version of :func:`token_nll`: a float32 ``log_softmax``, a
    ``gather`` and a masked sum, differentiable by autograd."""
    if logits.dtype == torch.float64:
        logits = logits.to(torch.float32)
    rows, mask, _ = _plain_rows(logits, target, ignore_index, with_lse=False)
    return _sum_rows(rows), mask.sum().to(torch.float32)


def _sum_rows(rows: Tensor) -> Tensor:
    """The float32 total of the rows, summed in float64 (one order on each device)."""
    return rows.sum(dtype=torch.float64).to(torch.float32)


def _launch(logits: Tensor, target: Tensor, ignore_index: Optional[int]) -> Tuple[Tensor, Tensor]:
    """``(nll, lse)`` of every row from the kernel."""
    batch, seq, vocab = logits.shape
    if logits.stride(2) != 1:
        warnings.warn(
            "token_nll reads logits whose V axis is contiguous; these were copied to a contiguous tensor first",
            stacklevel=3,
        )
        logits = logits.contiguous()
    rows = batch * seq
    if rows >= 1 << 31:
        raise ValueError(f"At most 2^31 - 1 rows per call, got {batch} x {seq}")
    nll = torch.empty(rows, dtype=torch.float32, device=logits.device)
    lse = torch.empty(rows, dtype=torch.float32, device=logits.device)
    if rows == 0:
        return nll, lse
    target = target.to(torch.int64).contiguous()
    with torch.cuda.device(logits.device):
        err = _kernel()(
            logits.data_ptr(), _DTYPE_CODES[logits.dtype], batch, seq, logits.stride(0), logits.stride(1), vocab,
            target.data_ptr(), 0 if ignore_index is None else int(ignore_index), int(ignore_index is not None),
            nll.data_ptr(), lse.data_ptr(), torch.cuda.current_stream().cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"token_nll kernel launch failed with CUDA error {err}")
    global launches, captured
    if torch.cuda.is_current_stream_capturing():
        captured += 1
    else:
        launches += 1
    return nll, lse


def token_nll_rows(logits: Tensor, target: Tensor, ignore_index: Optional[int] = None) -> Tuple[Tensor, Tensor]:
    """``(nll, lse)`` of every row, each ``(B * S,)`` float32: the kernel on a
    CUDA tensor, the plain version on a CPU tensor."""
    _check_inputs(logits, target)
    if logits.device.type == "cuda":
        return _launch(logits, target, ignore_index)
    if logits.device.type != "cpu":
        raise ValueError(f"token_nll runs on cpu or cuda tensors, got {logits.device}")
    return token_nll_rows_plain(logits, target, ignore_index)


def token_nll_reference(
    logits: Tensor, target: Tensor, ignore_index: Optional[int] = None, chunk_rows: int = 1024
) -> Tensor:
    """Each row's NLL in float64, on the logits' device, ``chunk_rows`` rows
    at a time: the yardstick of the kernel and of the plain version."""
    _check_inputs(logits, target)
    vocab = logits.shape[2]
    x = logits.reshape(-1, vocab)
    mask, index, in_range = _targets(target, vocab, ignore_index)
    out = torch.empty(x.shape[0], dtype=torch.float64, device=logits.device)
    for start in range(0, x.shape[0], chunk_rows):
        rows = x[start : start + chunk_rows].to(torch.float64)
        picked = rows.gather(1, index[start : start + chunk_rows, None])[:, 0]
        out[start : start + chunk_rows] = torch.logsumexp(rows, dim=-1) - picked
    out = torch.where(in_range, out, float("nan"))
    return torch.where(mask, out, 0.0)


def row_error(got: Tensor, want: Tensor) -> Tensor:
    """Each row's error against the float64 ``want``: absolute below one nat,
    relative above (0 where both are NaN, inf where one is)."""
    got = got.to(torch.float64)
    err = (got - want).abs() / want.abs().clamp(min=1.0)
    both_nan = got.isnan() & want.isnan()
    one_nan = got.isnan() ^ want.isnan()
    return torch.where(both_nan, 0.0, torch.where(one_nan, float("inf"), err))


#: the kernel's contract against the float64 reference, row by row:
#: row_error(kernel) <= REL_SLACK * row_error(plain version) + REL_FLOOR
REL_SLACK, REL_FLOOR = 2.0, 1e-6


class _TokenNLL(torch.autograd.Function):
    """Each row's NLL (the kernel on a card, the plain rows on the CPU); the
    backward is ``softmax - onehot`` of each counted row, scaled by its
    incoming gradient, from the saved logsumexp."""

    @staticmethod
    def forward(ctx, logits: Tensor, target: Tensor, ignore_index: Optional[int]) -> Tensor:
        nll, lse = token_nll_rows(logits, target, ignore_index)
        ctx.save_for_backward(logits, target, lse)
        ctx.ignore_index = ignore_index
        return nll

    @staticmethod
    def backward(ctx, grad_rows: Tensor):
        logits, target, lse = ctx.saved_tensors
        vocab = logits.shape[2]
        mask, index, in_range = _targets(target, vocab, ctx.ignore_index)
        scale = torch.where(mask, grad_rows, 0.0)
        x = logits.reshape(-1, vocab).to(torch.float32)
        grad = torch.exp(x - lse[:, None]) * scale[:, None]
        grad = grad.scatter_add(1, index[:, None], -torch.where(in_range, scale, 0.0)[:, None])
        return grad.reshape(logits.shape).to(logits.dtype), None, None


def token_nll(logits: Tensor, target: Tensor, ignore_index: Optional[int] = None) -> Tuple[Tensor, Tensor]:
    """``(total, count)`` of the tokens' negative log-likelihoods: the kernel
    on a CUDA tensor, the plain rows on a CPU tensor.

    Example:
        >>> import torch
        >>> from tpumetrics_torch.ops.token_nll import token_nll
        >>> logits = torch.log(torch.tensor([[[0.5, 0.25, 0.25], [0.1, 0.8, 0.1]]]))
        >>> total, count = token_nll(logits, torch.tensor([[0, 1]]))
        >>> round(float(total), 4), float(count)
        (0.9163, 2.0)
    """
    if logits.dtype == torch.float64:
        logits = logits.to(torch.float32)
    _check_inputs(logits, target)
    rows = _TokenNLL.apply(logits, target, ignore_index)
    if ignore_index is None:  # a fill, not a copy from the host: a CUDA graph captures it
        count = torch.full((), float(target.numel()), dtype=torch.float32, device=logits.device)
    else:
        count = (target != ignore_index).sum().to(torch.float32)
    return _sum_rows(rows), count
