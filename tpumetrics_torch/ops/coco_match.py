"""COCO's greedy detection-to-ground-truth match over the (image, class)
cells of an evaluation (the matcher of ``tpumetrics/detection/_coco_eval.py``
``_match_cells_batched`` and of the JAX package's jitted program,
``tpumetrics/detection/_coco_eval_jax.py`` :217-281).

Inputs, flat and cell-sorted: ``det_boxes (Nd, 4)`` float64 xyxy, each
cell's detections consecutive in score order and capped at the largest
max-det; ``gt_boxes (Ng, 4)`` float64 xyxy, ``gt_crowd (Ng,)`` uint8 and
``gt_area (Ng,)`` float64 (the effective area: the user's, or the box's
where the user gave 0), each cell's ground truths consecutive; ``cells
(N, 4)`` int32, one row a cell: ``(det_start, det_count, gt_start,
gt_count)``; ``thresholds (T,)`` float64 (already ``min(thr, 1 - 1e-10)``)
and ``area_ranges (A, 2)`` float64. Every detection row belongs to exactly
one cell. Output: ``(det_matches, det_ignore)``, ``(Nd, A, T)`` uint8, one
row a detection, bit for bit ``_match_cells_batched``'s.

On a CUDA tensor the hand-written kernel in ``csrc/coco_greedy_match.cu``
runs, one launch for every cell (one block a cell; its source gives the
design and the bound); the wrapper reads the largest cell's two counts on
the host to size the kernel's shared memory. On a CPU tensor the plain
version below runs: the cells padded into power-of-two (detections, ground
truths) buckets, and the batched loop over each bucket's detection slots as
torch ops. There is no fallback: a CUDA tensor launches the kernel or
raises.
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
#: kernel calls recorded into CUDA graphs: always 0, the wrapper reads the host, so no graph captures it
captured = 0

_DTYPES = (
    ("det_boxes", torch.float64, 2),
    ("gt_boxes", torch.float64, 2),
    ("gt_crowd", torch.uint8, 1),
    ("gt_area", torch.float64, 1),
    ("cells", torch.int32, 2),
    ("thresholds", torch.float64, 1),
    ("area_ranges", torch.float64, 2),
)


@functools.cache
def _kernel() -> ctypes._CFuncPtr:
    fn = _build.load("coco_greedy_match").coco_greedy_match
    # (det_boxes, gt_boxes, gt_crowd, gt_area, cells, thr, lo, hi, matches, ignore, n, max_det, max_gt, A, T, stream)
    fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_longlong] + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check(*args: Tensor) -> Tuple[int, int, int, int]:
    """Check types, ranks, shapes and devices; return ``(Nd, N, A, T)``."""
    for (name, dtype, ndim), t in zip(_DTYPES, args):
        if not isinstance(t, Tensor) or t.dtype != dtype or t.ndim != ndim:
            raise TypeError(f"Expected `{name}` a {ndim}-d {dtype} tensor, got {getattr(t, 'dtype', type(t))}"
                            f" {tuple(getattr(t, 'shape', ()))}")
        if t.device != args[0].device:
            raise ValueError(f"Expected `{name}` on {args[0].device}, got {t.device}")
    det_boxes, gt_boxes, gt_crowd, gt_area, cells, thr, ranges = args
    nd, ng, n = det_boxes.shape[0], gt_boxes.shape[0], cells.shape[0]
    want = {"det_boxes": (nd, 4), "gt_boxes": (ng, 4), "gt_crowd": (ng,), "gt_area": (ng,), "cells": (n, 4),
            "area_ranges": (ranges.shape[0], 2)}
    for (name, _, _), t in zip(_DTYPES, args):
        if name in want and tuple(t.shape) != want[name]:
            raise ValueError(f"Expected `{name}` of shape {want[name]}, got {tuple(t.shape)}")
    if thr.numel() < 1 or ranges.shape[0] < 1:
        raise ValueError(f"Need T and A >= 1, got {thr.numel()}, {ranges.shape[0]}")
    if nd >= 1 << 31 or ng >= 1 << 31:
        raise ValueError(f"Row indices must fit int32, got {nd} detections and {ng} ground truths")
    return nd, n, ranges.shape[0], thr.numel()


def _geometry(det_boxes: Tensor, gt_boxes: Tensor, gt_crowd: Tensor) -> Tuple[Tensor, Tensor]:
    """``(ious (N, Dp, Gp), det_area (N, Dp))`` in numpy's order of operations
    (``_coco_eval._pairwise_geometry`` and ``coco_evaluate``): areas
    ``(x2-x1)*(y2-y1)``, ``wh = clip(min(rb) - max(lt), 0)``, ``inter = w*h``,
    ``union = (da + ga) - inter`` (``da`` for a crowd), ``inter / union``
    where ``union > 0`` else over 1."""
    da = (det_boxes[..., 2] - det_boxes[..., 0]) * (det_boxes[..., 3] - det_boxes[..., 1])
    ga = (gt_boxes[..., 2] - gt_boxes[..., 0]) * (gt_boxes[..., 3] - gt_boxes[..., 1])
    lt = torch.maximum(det_boxes[:, :, None, :2], gt_boxes[:, None, :, :2])
    rb = torch.minimum(det_boxes[:, :, None, 2:], gt_boxes[:, None, :, 2:])
    wh = torch.clamp(rb - lt, min=0)
    inter = wh[..., 0] * wh[..., 1]
    union = da[:, :, None] + ga[:, None, :] - inter
    union = torch.where(gt_crowd.bool()[:, None, :], da[:, :, None], union)
    return inter / torch.where(union > 0, union, torch.ones_like(union)), da


def _match_padded(
    det_boxes: Tensor, gt_boxes: Tensor, det_count: Tensor, gt_count: Tensor, gt_crowd: Tensor, gt_area: Tensor,
    thresholds: Tensor, area_ranges: Tensor,
) -> Tuple[Tensor, Tensor]:
    """``_match_cells_batched``'s loop over ``n`` cells padded to ``Dp``
    detection and ``Gp`` ground-truth slots (whatever lies in a pad slot is
    never read into a result): ``(det_matches, det_ignore)``, ``(n, A, T, Dp)``
    bool."""
    n, dp = det_boxes.shape[:2]
    gp = gt_boxes.shape[1]
    num_areas, num_thrs = area_ranges.shape[0], thresholds.numel()
    dev = det_boxes.device
    det_valid = torch.arange(dp, device=dev)[None, :] < det_count[:, None]
    gt_valid = torch.arange(gp, device=dev)[None, :] < gt_count[:, None]
    crowd = gt_crowd.bool() & gt_valid
    ious, da = _geometry(det_boxes, gt_boxes, gt_crowd)
    ious = torch.where(det_valid[:, :, None] & gt_valid[:, None, :], ious, torch.full_like(ious, -1.0))
    lo, hi = area_ranges[:, 0], area_ranges[:, 1]
    # (N, A, G): crowd / out-of-range gts absorb matches without counting; pads are ignored AND unavailable
    gt_ignore = (
        crowd[:, None, :] | (gt_area[:, None, :] < lo[None, :, None]) | (gt_area[:, None, :] > hi[None, :, None])
        | ~gt_valid[:, None, :]
    )
    real = ~gt_ignore
    thr = thresholds[None, None, :, None]
    det_matches = torch.zeros((n, num_areas, num_thrs, dp), dtype=torch.bool, device=dev)
    det_ignore = torch.zeros_like(det_matches)
    avail = gt_valid[:, None, None, :].expand(n, num_areas, num_thrs, gp).clone()
    g_idx = torch.arange(gp, device=dev)
    ign4 = gt_ignore[:, :, None, :].expand(n, num_areas, num_thrs, gp)
    crowd4 = crowd[:, None, None, :].expand(n, num_areas, num_thrs, gp)
    for d in range(min(int(det_count.max()), dp)):
        iou_row = ious[:, d, :][:, None, None, :]  # (N, 1, 1, G)
        cand = avail & (iou_row >= thr)
        cand_real = cand & real[:, :, None, :]
        use_real = cand_real.any(dim=3, keepdim=True)  # non-ignored gts take precedence
        pick = torch.where(use_real, cand_real, cand & gt_ignore[:, :, None, :])
        has = pick.any(dim=3) & det_valid[:, None, None, d]
        vals = torch.where(pick, iou_row, torch.full_like(iou_row, -1.0))
        best = gp - 1 - torch.argmax(vals.flip(3), dim=3, keepdim=True)  # last-wins argmax
        det_matches[..., d] = has
        det_ignore[..., d] = has & torch.gather(ign4, 3, best)[..., 0]
        claimed = has & ~torch.gather(crowd4, 3, best)[..., 0]  # crowd gts absorb without being claimed
        avail &= ~(claimed[..., None] & (g_idx == best))
    # unmatched detections outside the area range are ignored
    det_out = (da[:, None, :] < lo[None, :, None]) | (da[:, None, :] > hi[None, :, None])
    det_ignore |= ~det_matches & det_out[:, :, None, :] & det_valid[:, None, None, :]
    return det_matches, det_ignore


def _pow2(x: Tensor) -> Tensor:
    """Elementwise smallest power of two >= max(x, 1)."""
    x = x.clamp(min=1)
    p = torch.exp2(torch.ceil(torch.log2(x.to(torch.float64)))).to(torch.int64)
    return torch.where(p < x, 2 * p, p)


def coco_greedy_match_plain(
    det_boxes: Tensor, gt_boxes: Tensor, gt_crowd: Tensor, gt_area: Tensor, cells: Tensor, thresholds: Tensor,
    area_ranges: Tensor,
) -> Tuple[Tensor, Tensor]:
    """The plain version: the cells gathered into power-of-two (detections,
    ground truths) buckets, so the padding stays within twice the cells' own
    sizes, and ``_match_cells_batched``'s loop over each bucket's detection
    slots as torch ops (the slot counts read on the host). Rows that belong
    to no cell are 0."""
    nd_rows, n, num_areas, num_thrs = _check(det_boxes, gt_boxes, gt_crowd, gt_area, cells, thresholds, area_ranges)
    dev = det_boxes.device
    det_matches = torch.zeros((nd_rows, num_areas, num_thrs), dtype=torch.uint8, device=dev)
    det_ignore = torch.zeros_like(det_matches)
    c = cells.to(torch.int64)
    c = c[c[:, 1] > 0]  # a cell without detections matches nothing
    if c.shape[0] == 0:
        return det_matches, det_ignore
    # a zero row past each array's end stands in the pad slots
    d_box = torch.cat([det_boxes, det_boxes.new_zeros((1, 4))])
    g_box = torch.cat([gt_boxes, gt_boxes.new_zeros((1, 4))])
    g_crowd = torch.cat([gt_crowd, gt_crowd.new_zeros((1,))])
    g_area = torch.cat([gt_area, gt_area.new_zeros((1,))])
    key = _pow2(c[:, 1]) << 32 | _pow2(c[:, 3])
    for k in torch.unique(key).tolist():
        sel = c[key == k]
        dp, gp = k >> 32, k & 0xFFFFFFFF
        d_slot, g_slot = torch.arange(dp, device=dev)[None, :], torch.arange(gp, device=dev)[None, :]
        d_in = d_slot < sel[:, 1:2]
        d_idx = torch.where(d_in, sel[:, 0:1] + d_slot, nd_rows)
        g_idx = torch.where(g_slot < sel[:, 3:4], sel[:, 2:3] + g_slot, gt_boxes.shape[0])
        m, ig = _match_padded(d_box[d_idx], g_box[g_idx], sel[:, 1], sel[:, 3], g_crowd[g_idx], g_area[g_idx],
                              thresholds, area_ranges)
        rows = d_idx[d_in]
        det_matches[rows] = m.permute(0, 3, 1, 2)[d_in].to(torch.uint8)
        det_ignore[rows] = ig.permute(0, 3, 1, 2)[d_in].to(torch.uint8)
    return det_matches, det_ignore


def coco_greedy_match(
    det_boxes: Tensor, gt_boxes: Tensor, gt_crowd: Tensor, gt_area: Tensor, cells: Tensor, thresholds: Tensor,
    area_ranges: Tensor,
) -> Tuple[Tensor, Tensor]:
    """``(det_matches, det_ignore)``: the kernel on a CUDA tensor, the plain
    version on a CPU tensor.

    Example:
        >>> import torch
        >>> from tpumetrics_torch.ops.coco_match import coco_greedy_match
        >>> det = torch.tensor([[0.0, 0.0, 10.0, 10.0], [0.0, 0.0, 10.0, 9.0]], dtype=torch.float64)
        >>> gt = torch.tensor([[0.0, 0.0, 10.0, 10.0]], dtype=torch.float64)
        >>> cells = torch.tensor([[0, 2, 0, 1]], dtype=torch.int32)  # two detections, one ground truth
        >>> m, ig = coco_greedy_match(det, gt, torch.zeros(1, dtype=torch.uint8),
        ...                           torch.full((1,), 100.0, dtype=torch.float64), cells,
        ...                           torch.tensor([0.5], dtype=torch.float64),
        ...                           torch.tensor([[0.0, 1e10]], dtype=torch.float64))
        >>> m.tolist()  # the first detection claims the ground truth, the second finds none left
        [[[1]], [[0]]]
    """
    args = (det_boxes, gt_boxes, gt_crowd, gt_area, cells, thresholds, area_ranges)
    if det_boxes.device.type not in ("cpu", "cuda"):
        raise ValueError(f"coco_greedy_match runs on cpu or cuda tensors, got {det_boxes.device}")
    if det_boxes.device.type == "cpu":
        return coco_greedy_match_plain(*args)
    nd_rows, n, num_areas, num_thrs = _check(*args)
    det_matches = torch.empty((nd_rows, num_areas, num_thrs), dtype=torch.uint8, device=det_boxes.device)
    det_ignore = torch.empty_like(det_matches)
    if n == 0:
        return det_matches, det_ignore
    args = tuple(a.contiguous() for a in args)
    max_det, max_gt = (int(v) for v in torch.amax(args[4][:, 1::2], dim=0).tolist())  # sizes shared memory
    lo, hi = args[6][:, 0].contiguous(), args[6][:, 1].contiguous()
    with torch.cuda.device(det_boxes.device):
        err = _kernel()(
            *(a.data_ptr() for a in args[:6]), lo.data_ptr(), hi.data_ptr(), det_matches.data_ptr(),
            det_ignore.data_ptr(), n, max_det, max_gt, num_areas, num_thrs, torch.cuda.current_stream().cuda_stream,
        )
    if err != 0:
        raise RuntimeError(
            f"coco_greedy_match kernel launch failed with CUDA error {err} (N={n}, largest cell {max_det} x {max_gt},"
            f" A={num_areas}, T={num_thrs})"
        )
    global launches
    launches += 1
    return det_matches, det_ignore
