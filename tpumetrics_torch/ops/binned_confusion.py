"""Fused multi-threshold confusion counts (port of ``tpumetrics/ops/binned_confusion.py``).

The binned PR-curve/ROC/AUROC update needs, for every threshold ``t`` and
class ``c``::

    tp[t, c]      = Σ_n (preds[n, c] >= thr[t]) · y[n, c]
    predpos[t, c] = Σ_n (preds[n, c] >= thr[t]) · v[n, c]

with ``y`` (target bit · valid) and ``v`` (valid) 0/1 masks. On a CUDA
tensor the hand-written kernels in ``csrc/binned_confusion.cu`` compute them
in one pass over the inputs: the thresholds are ranked on the device, each
element is bucketed into a shared-memory histogram by a search over them,
and suffix sums of the histogram become the counts, with int32 atomics that
are exact up to 2^31 per call (the source's note gives its bound and
design). One call makes two device launches and no host sync, so it can be
captured into a CUDA graph (its launches then go to the capture stream and
its buffers come from the graph's pool). On a CPU
tensor the plain version below runs: the
``_binned_confusion_contract`` formula in plain torch, which the tests and
``chip_smoke.py`` also hold the kernel against. There is no fallback: a CUDA
tensor launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from tpumetrics_torch.ops import _build

Tensor = torch.Tensor

#: kernel launches in this process; callers may set it to 0 to count a run
launches = 0
#: kernel calls recorded into CUDA graphs (a capture launches nothing: each
#: replay of the graph launches them again)
captured = 0


@functools.cache
def _kernel() -> ctypes._CFuncPtr:
    fn = _build.load("binned_confusion").binned_confusion_counts
    # (preds, y, v, thresholds, out, scratch, n, c, t, stream)
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check_inputs(preds: Tensor, y: Tensor, v: Tensor, thresholds: Tensor) -> None:
    if preds.ndim != 2 or y.shape != preds.shape or v.shape != preds.shape:
        raise ValueError(
            f"Expected preds, y and v of one shape (N, C), got {tuple(preds.shape)}, {tuple(y.shape)}, {tuple(v.shape)}"
        )
    if thresholds.ndim != 1:
        raise ValueError(f"Expected 1-D thresholds, got shape {tuple(thresholds.shape)}")
    for name, x in (("preds", preds), ("y", y), ("v", v), ("thresholds", thresholds)):
        if x.dtype != torch.float32:
            raise TypeError(f"Expected `{name}` to be float32, got {x.dtype}")
        if x.device != preds.device:
            raise ValueError(f"Expected `{name}` on {preds.device}, got {x.device}")
        if not x.is_contiguous():
            raise ValueError(f"Expected `{name}` to be contiguous")
    if preds.shape[0] >= 1 << 31:
        raise ValueError(f"At most 2^31 - 1 rows per call keep the int32 counts exact, got {preds.shape[0]}")


def binned_confusion_plain(preds: Tensor, y: Tensor, v: Tensor, thresholds: Tensor) -> Tuple[Tensor, Tensor]:
    """The plain version: ``(tp, predpos)`` as ``(T, C)`` float32, through the
    ``(N, C, T)`` comparison. Exact while every count is below 2^24."""
    with torch.autocast(device_type=preds.device.type, enabled=False):
        pos = (preds[:, :, None] >= thresholds[None, None, :]).to(torch.float32)
        return torch.einsum("nct,nc->tc", pos, y), torch.einsum("nct,nc->tc", pos, v)


def binned_confusion_counts(preds: Tensor, y: Tensor, v: Tensor, thresholds: Tensor) -> Tuple[Tensor, Tensor]:
    """``(tp, predpos)`` as ``(T, C)`` int32: the kernel on a CUDA tensor,
    the plain version, rounded, on a CPU tensor."""
    _check_inputs(preds, y, v, thresholds)
    if preds.device.type == "cpu":
        tp, pp = binned_confusion_plain(preds, y, v, thresholds)
        return torch.round(tp).to(torch.int32), torch.round(pp).to(torch.int32)
    if preds.device.type != "cuda":
        raise ValueError(f"binned_confusion runs on cpu or cuda tensors, got {preds.device}")
    n, c = preds.shape
    t = thresholds.shape[0]
    if n == 0 or c == 0 or t == 0:
        out = torch.zeros((2, t, c), dtype=torch.int32, device=preds.device)
        return out[0], out[1]
    out = torch.empty((2, t, c), dtype=torch.int32, device=preds.device)  # tp, predpos; the kernel zeroes it
    scratch = torch.empty((2 * t,), dtype=torch.int32, device=preds.device)  # sorted thresholds, their indices
    with torch.cuda.device(preds.device):
        err = _kernel()(
            preds.data_ptr(), y.data_ptr(), v.data_ptr(), thresholds.data_ptr(), out.data_ptr(), scratch.data_ptr(),
            n, c, t, torch.cuda.current_stream().cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"binned_confusion kernel launch failed with CUDA error {err}")
    global launches, captured
    if torch.cuda.is_current_stream_capturing():
        captured += 1
    else:
        launches += 1
    return out[0], out[1]


def binned_confusion_fused(preds: Tensor, y: Tensor, v: Tensor, thresholds: Tensor) -> Tuple[Tensor, Tensor]:
    """Return ``(tp, predpos)``, each ``(T, C)`` float32 holding exact integers
    (the JAX function's signature, without its ``interpret`` switch).

    ``preds``/``y``/``v`` are ``(N, C)`` float32, ``y``/``v`` 0/1 masks;
    ``thresholds`` is ``(T,)`` float32, in any order. Ties count as positive
    and NaN preds fall below every threshold.

    Example:
        >>> import torch
        >>> from tpumetrics_torch.ops import binned_confusion_fused
        >>> preds = torch.tensor([[0.2], [0.7], [0.9]])
        >>> y = torch.tensor([[0.0], [1.0], [1.0]])
        >>> tp, predpos = binned_confusion_fused(preds, y, torch.ones(3, 1), torch.tensor([0.5]))
        >>> float(tp[0, 0]), float(predpos[0, 0])
        (2.0, 2.0)
    """
    tp, pp = binned_confusion_counts(preds, y, v, thresholds)
    return tp.to(torch.float32), pp.to(torch.float32)
