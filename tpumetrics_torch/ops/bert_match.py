"""BERTScore's greedy cosine matching (port of
``tpumetrics/functional/text/bert.py`` ``_get_precision_recall_f1``, which
XLA fused; no Pallas kernel).

For unit-normalized float32 token embeddings ``pe (n, L, Sp, D)`` and
``te (n, L, St, D)`` and float32 token scales ``ps (n, Sp)``, ``ts (n, St)``,
:func:`bert_greedy_match` returns ``(precision, recall, f1)``, each
``(n, L)`` float32:

- ``P[b, l] = sum_p ps[b, p] * max_r <pe[b, l, p], te[b, l, r]>``;
- ``R`` the same with the roles swapped;
- ``F1 = 2 P R / (P + R)``, with NaN set to 0.

The maxima run over every row and column, zero ones included.

On a CUDA tensor the hand-written kernel in ``csrc/bert_greedy_match.cu``
computes each (sentence, layer) cell in one block, keeping the similarity
matrix on the chip in square tiles sized to the cell (:func:`tile`): one
launch a call, on the current stream, with no host read, and two calls give
the same bits. On a CPU tensor the plain version
runs: the JAX computation in torch ops (a full-float32 ``einsum`` into the
``(b, l, p, r)`` similarities, their maxima, two weighted sums), ``chunk_rows``
sentences at a time. There is no fallback: a CUDA tensor launches the
kernel or raises. :func:`bert_greedy_match_reference` is the same in float64,
the yardstick of both: the kernel's contract is ``|kernel - ref| <= 2
|plain - ref| + 1e-6`` for each cell.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from tpumetrics_torch.ops import _build
from tpumetrics_torch.utils.compute import _ieee_float32_matmul

Tensor = torch.Tensor

#: kernel launches in this process; callers may set it to 0 to count a run
launches = 0
#: kernel calls recorded into CUDA graphs (each replay launches them again)
captured = 0

#: the kernel's contract against the float64 reference, cell by cell:
#: |kernel - ref| <= ERR_SLACK * |plain - ref| + ERR_FLOOR
ERR_SLACK, ERR_FLOOR = 2.0, 1e-6


@functools.cache
def _kernel() -> ctypes._CFuncPtr:
    fn = _build.load("bert_greedy_match").bert_greedy_match
    # (pe, te, ps, ts, n, layers, sp, st, dim, precision, recall, f1, stream)
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _tile_fn() -> ctypes._CFuncPtr:
    fn = _build.load("bert_greedy_match").bert_greedy_match_tile
    fn.argtypes = [ctypes.c_int, ctypes.c_int]
    fn.restype = ctypes.c_int
    return fn


def tile(sp: int, st: int) -> int:
    """The kernel's tile, in tokens a side (64, 96 or 128), for cells of
    ``sp`` x ``st`` tokens: the choice the built kernel makes (it needs the
    CUDA build)."""
    return int(_tile_fn()(sp, st))


def _check_inputs(pe: Tensor, te: Tensor, ps: Tensor, ts: Tensor, dtype: torch.dtype = torch.float32) -> None:
    if pe.ndim != 4 or te.ndim != 4 or ps.ndim != 2 or ts.ndim != 2:
        raise ValueError(
            "Expected pe (n, L, Sp, D), te (n, L, St, D), ps (n, Sp) and ts (n, St), got"
            f" {tuple(pe.shape)}, {tuple(te.shape)}, {tuple(ps.shape)} and {tuple(ts.shape)}"
        )
    n, layers, sp, dim = pe.shape
    if te.shape[0] != n or te.shape[1] != layers or te.shape[3] != dim:
        raise ValueError(f"pe {tuple(pe.shape)} and te {tuple(te.shape)} differ outside their token axes")
    if tuple(ps.shape) != (n, sp) or tuple(ts.shape) != (n, te.shape[2]):
        raise ValueError(f"Expected ps ({n}, {sp}) and ts ({n}, {te.shape[2]}), got {tuple(ps.shape)} and {tuple(ts.shape)}")
    if sp < 1 or te.shape[2] < 1 or dim < 1:
        raise ValueError("Expected at least one token on each side and an embedding width of at least 1")
    for name, t in (("pe", pe), ("te", te), ("ps", ps), ("ts", ts)):
        if t.dtype != dtype:
            raise TypeError(f"Expected {dtype} `{name}`, got {t.dtype}")
        if t.device != pe.device:
            raise ValueError(f"Expected `{name}` on {pe.device}, got {t.device}")


def _match(pe: Tensor, te: Tensor, ps: Tensor, ts: Tensor, chunk_rows: int) -> Tuple[Tensor, Tensor, Tensor]:
    """The JAX computation in torch ops, ``chunk_rows`` sentences at a time."""
    outs = []
    for lo in range(0, pe.shape[0], chunk_rows):
        hi = lo + chunk_rows
        with _ieee_float32_matmul():
            cos = torch.einsum("blpd,blrd->blpr", pe[lo:hi], te[lo:hi])
            precision = torch.einsum("blp,bp->bl", cos.amax(dim=-1), ps[lo:hi])
            recall = torch.einsum("blr,br->bl", cos.amax(dim=-2), ts[lo:hi])
        del cos
        outs.append((precision, recall))
    precision = torch.cat([p for p, _ in outs])
    recall = torch.cat([r for _, r in outs])
    f1 = 2 * precision * recall / (precision + recall)
    return precision, recall, torch.where(torch.isnan(f1), 0.0, f1)


def bert_greedy_match_plain(
    pe: Tensor, te: Tensor, ps: Tensor, ts: Tensor, chunk_rows: int = 64
) -> Tuple[Tensor, Tensor, Tensor]:
    """The plain version of the kernel: ``(precision, recall, f1)``, each ``(n, L)`` float32."""
    _check_inputs(pe, te, ps, ts)
    return _match(pe, te, ps, ts, max(1, chunk_rows))


def bert_greedy_match_reference(
    pe: Tensor, te: Tensor, ps: Tensor, ts: Tensor, chunk_rows: int = 16
) -> Tuple[Tensor, Tensor, Tensor]:
    """The same function in float64 on the inputs' device (float32 or float64
    inputs): the yardstick of the kernel and of the plain version."""
    _check_inputs(pe, te, ps, ts, pe.dtype if pe.dtype == torch.float64 else torch.float32)
    outs = [
        _match(pe[lo : lo + chunk_rows].double(), te[lo : lo + chunk_rows].double(),
               ps[lo : lo + chunk_rows].double(), ts[lo : lo + chunk_rows].double(), chunk_rows)
        for lo in range(0, pe.shape[0], chunk_rows)
    ]
    return tuple(torch.cat([o[i] for o in outs]) for i in range(3))  # type: ignore[return-value]


def _launch(pe: Tensor, te: Tensor, ps: Tensor, ts: Tensor) -> Tuple[Tensor, Tensor, Tensor]:
    n, layers, sp, dim = pe.shape
    st = te.shape[2]
    if max(sp, st, dim) >= 1 << 31 or n * layers >= 1 << 31:
        raise ValueError(f"At most 2^31 - 1 cells, tokens and embedding entries, got pe {tuple(pe.shape)}, te {tuple(te.shape)}")
    out = torch.empty(3, n, layers, dtype=torch.float32, device=pe.device)
    if n == 0 or layers == 0:
        return out[0], out[1], out[2]
    pe, te, ps, ts = (t.contiguous() for t in (pe, te, ps, ts))
    with torch.cuda.device(pe.device):
        err = _kernel()(
            pe.data_ptr(), te.data_ptr(), ps.data_ptr(), ts.data_ptr(), n, layers, sp, st, dim,
            out[0].data_ptr(), out[1].data_ptr(), out[2].data_ptr(), torch.cuda.current_stream().cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"bert_greedy_match kernel launch failed with CUDA error {err}")
    global launches, captured
    if torch.cuda.is_current_stream_capturing():
        captured += 1
    else:
        launches += 1
    return out[0], out[1], out[2]


def bert_greedy_match(pe: Tensor, te: Tensor, ps: Tensor, ts: Tensor, chunk_rows: int = 64) -> Tuple[Tensor, Tensor, Tensor]:
    """``(precision, recall, f1)`` of every (sentence, layer) cell, each ``(n, L)``
    float32: the kernel on a CUDA tensor (one launch for every cell), the plain
    version on a CPU tensor (``chunk_rows`` sentences at a time).

    Example:
        >>> import torch
        >>> from tpumetrics_torch.ops.bert_match import bert_greedy_match
        >>> e = torch.tensor([[[[0.0, 0.0], [1.0, 0.0], [0.0, 1.0]]]])
        >>> s = torch.tensor([[0.0, 0.5, 0.5]])
        >>> [round(float(x), 4) for x in bert_greedy_match(e, e, s, s)[2][0]]
        [1.0]
    """
    _check_inputs(pe, te, ps, ts)
    if pe.device.type == "cuda":
        return _launch(pe, te, ps, ts)
    if pe.device.type != "cpu":
        raise ValueError(f"bert_greedy_match runs on cpu or cuda tensors, got {pe.device}")
    return _match(pe, te, ps, ts, max(1, chunk_rows))


def cell_excess(got: Tuple[Tensor, ...], plain: Tuple[Tensor, ...], ref: Tuple[Tensor, ...]) -> Tensor:
    """The largest excess of the kernel's error over its contract, over the
    three outputs and every cell (<= 0 when it holds): ``|got - ref| -
    (2 |plain - ref| + 1e-6)`` against the float64 ``ref``."""
    worst = []
    for g, p, r in zip(got, plain, ref):
        err, err_plain = (g.double() - r).abs(), (p.double() - r).abs()
        worst.append((err - (ERR_SLACK * err_plain + ERR_FLOOR)).max())
    return torch.stack(worst).max()
