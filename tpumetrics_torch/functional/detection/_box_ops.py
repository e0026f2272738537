"""Bounding-box primitives as batched float32 tensor ops (port of
``tpumetrics/functional/detection/_box_ops.py``): ``box_convert``,
``box_area``, ``box_iou``, ``generalized_box_iou``, ``distance_box_iou`` and
``complete_box_iou``, each over two xyxy box sets at once."""

from __future__ import annotations

import math

import torch

Tensor = torch.Tensor


def box_convert(boxes: Tensor, in_fmt: str, out_fmt: str) -> Tensor:
    """Convert between xyxy / xywh / cxcywh box formats."""
    if in_fmt == out_fmt:
        return boxes
    # normalize to xyxy first
    if in_fmt == "xywh":
        x, y, w, h = boxes.unbind(-1)
        xyxy = torch.stack([x, y, x + w, y + h], dim=-1)
    elif in_fmt == "cxcywh":
        cx, cy, w, h = boxes.unbind(-1)
        xyxy = torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], dim=-1)
    elif in_fmt == "xyxy":
        xyxy = boxes
    else:
        raise ValueError(f"Unsupported box format {in_fmt}")

    if out_fmt == "xyxy":
        return xyxy
    x1, y1, x2, y2 = xyxy.unbind(-1)
    if out_fmt == "xywh":
        return torch.stack([x1, y1, x2 - x1, y2 - y1], dim=-1)
    if out_fmt == "cxcywh":
        return torch.stack([(x1 + x2) / 2, (y1 + y2) / 2, x2 - x1, y2 - y1], dim=-1)
    raise ValueError(f"Unsupported box format {out_fmt}")


def box_area(boxes: Tensor) -> Tensor:
    """Areas of xyxy boxes."""
    return (boxes[..., 2] - boxes[..., 0]) * (boxes[..., 3] - boxes[..., 1])


def _pairwise_intersection(boxes1: Tensor, boxes2: Tensor) -> Tensor:
    """(N, M) intersection areas of two xyxy box sets."""
    lt = torch.maximum(boxes1[:, None, :2], boxes2[None, :, :2])
    rb = torch.minimum(boxes1[:, None, 2:], boxes2[None, :, 2:])
    wh = torch.clamp(rb - lt, min=0)
    return wh[..., 0] * wh[..., 1]


def _union(boxes1: Tensor, boxes2: Tensor, inter: Tensor) -> Tensor:
    return box_area(boxes1)[:, None] + box_area(boxes2)[None, :] - inter


def _safe(x: Tensor) -> Tensor:
    """``x`` where it is positive, else 1: the divisor of an empty union or hull."""
    return torch.where(x > 0, x, torch.ones_like(x))


def box_iou(boxes1: Tensor, boxes2: Tensor) -> Tensor:
    """(N, M) IoU matrix of two xyxy box sets."""
    inter = _pairwise_intersection(boxes1, boxes2)
    return inter / _safe(_union(boxes1, boxes2, inter))


def _enclosing_box(boxes1: Tensor, boxes2: Tensor) -> Tensor:
    """(N, M, 4) smallest boxes enclosing every pair."""
    lt = torch.minimum(boxes1[:, None, :2], boxes2[None, :, :2])
    rb = torch.maximum(boxes1[:, None, 2:], boxes2[None, :, 2:])
    return torch.cat([lt, rb], dim=-1)


def generalized_box_iou(boxes1: Tensor, boxes2: Tensor) -> Tensor:
    """GIoU (Rezatofighi et al. 2019): IoU - (hull - union)/hull."""
    inter = _pairwise_intersection(boxes1, boxes2)
    union = _union(boxes1, boxes2, inter)
    iou = inter / _safe(union)
    hull = _enclosing_box(boxes1, boxes2)
    hull_area = (hull[..., 2] - hull[..., 0]) * (hull[..., 3] - hull[..., 1])
    return iou - (hull_area - union) / _safe(hull_area)


def _center_distance_sq(boxes1: Tensor, boxes2: Tensor) -> Tensor:
    c1 = (boxes1[:, None, :2] + boxes1[:, None, 2:]) / 2
    c2 = (boxes2[None, :, :2] + boxes2[None, :, 2:]) / 2
    d = c1 - c2
    return d[..., 0] ** 2 + d[..., 1] ** 2


def distance_box_iou(boxes1: Tensor, boxes2: Tensor, eps: float = 1e-7) -> Tensor:
    """DIoU (Zheng et al. 2020): IoU - center distance² / hull diagonal²."""
    iou = box_iou(boxes1, boxes2)
    hull = _enclosing_box(boxes1, boxes2)
    diag_sq = (hull[..., 2] - hull[..., 0]) ** 2 + (hull[..., 3] - hull[..., 1]) ** 2
    return iou - _center_distance_sq(boxes1, boxes2) / (diag_sq + eps)


def complete_box_iou(boxes1: Tensor, boxes2: Tensor, eps: float = 1e-7) -> Tensor:
    """CIoU (Zheng et al. 2020): DIoU - alpha * v (aspect-ratio consistency)."""
    iou = box_iou(boxes1, boxes2)
    diou = distance_box_iou(boxes1, boxes2, eps)
    w1 = boxes1[:, None, 2] - boxes1[:, None, 0]
    h1 = boxes1[:, None, 3] - boxes1[:, None, 1]
    w2 = boxes2[None, :, 2] - boxes2[None, :, 0]
    h2 = boxes2[None, :, 3] - boxes2[None, :, 1]
    v = (4 / (math.pi**2)) * (torch.atan(w2 / (h2 + eps)) - torch.atan(w1 / (h1 + eps))) ** 2
    alpha = v / (1 - iou + v + eps)
    return diou - alpha.detach() * v
