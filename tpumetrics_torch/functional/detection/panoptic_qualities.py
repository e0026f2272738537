"""Panoptic / Modified Panoptic Quality (port of
``tpumetrics/functional/detection/panoptic_qualities.py``)."""

from __future__ import annotations

from typing import Collection

import torch

from tpumetrics_torch.functional.detection._panoptic_quality_common import (
    _get_category_id_to_continuous_id,
    _get_void_color,
    _panoptic_quality_compute,
    _panoptic_quality_update,
    _parse_categories,
    _prepocess_inputs,
    _validate_inputs,
)

Tensor = torch.Tensor


def _pq(preds: Tensor, target: Tensor, things, stuffs, allow_unknown_preds_category: bool, modified: bool) -> Tensor:
    things_set, stuffs_set = _parse_categories(things, stuffs)
    _validate_inputs(preds, target)
    void_color = _get_void_color(things_set, stuffs_set)
    cat_id_to_continuous_id = _get_category_id_to_continuous_id(things_set, stuffs_set)
    flatten_preds = _prepocess_inputs(things_set, stuffs_set, preds, void_color, allow_unknown_preds_category)
    flatten_target = _prepocess_inputs(things_set, stuffs_set, target, void_color, True)
    sums = _panoptic_quality_update(
        flatten_preds, flatten_target, cat_id_to_continuous_id, void_color,
        modified_metric_stuffs=stuffs_set if modified else None,
    )
    return _panoptic_quality_compute(*sums)


def panoptic_quality(
    preds: Tensor,
    target: Tensor,
    things: Collection[int],
    stuffs: Collection[int],
    allow_unknown_preds_category: bool = False,
) -> Tensor:
    """Panoptic Quality: PQ = IoU / (TP + FP/2 + FN/2) over matched segments
    (reference panoptic_qualities.py:29-104).

    Example:
        >>> import torch
        >>> from tpumetrics_torch.functional.detection import panoptic_quality
        >>> preds = torch.tensor([[[[6, 0], [0, 0], [6, 0], [6, 0]],
        ...                        [[0, 0], [0, 0], [6, 0], [0, 1]],
        ...                        [[0, 0], [0, 0], [6, 0], [0, 1]],
        ...                        [[0, 0], [7, 0], [6, 0], [1, 0]],
        ...                        [[0, 0], [7, 0], [7, 0], [7, 0]]]])
        >>> target = torch.tensor([[[[6, 0], [0, 1], [6, 0], [0, 1]],
        ...                         [[0, 1], [0, 1], [6, 0], [0, 1]],
        ...                         [[0, 1], [0, 1], [6, 0], [1, 0]],
        ...                         [[0, 1], [7, 0], [1, 0], [1, 0]],
        ...                         [[0, 1], [7, 0], [7, 0], [7, 0]]]])
        >>> round(float(panoptic_quality(preds, target, things={0, 1}, stuffs={6, 7})), 4)
        0.5463
    """
    return _pq(preds, target, things, stuffs, allow_unknown_preds_category, modified=False)


def modified_panoptic_quality(
    preds: Tensor,
    target: Tensor,
    things: Collection[int],
    stuffs: Collection[int],
    allow_unknown_preds_category: bool = False,
) -> Tensor:
    """Modified PQ (Porzi et al. 2019): stuff classes score IoU / #segments
    instead of requiring IoU > 0.5 matches (reference panoptic_qualities.py:107-180).

    Example:
        >>> import torch
        >>> from tpumetrics_torch.functional.detection import modified_panoptic_quality
        >>> preds = torch.tensor([[[0, 0], [0, 1], [6, 0], [7, 0], [0, 2], [1, 0]]])
        >>> target = torch.tensor([[[0, 1], [0, 0], [6, 0], [7, 0], [6, 0], [255, 0]]])
        >>> round(float(modified_panoptic_quality(preds, target, things={0, 1}, stuffs={6, 7})), 4)
        0.7667
    """
    return _pq(preds, target, things, stuffs, allow_unknown_preds_category, modified=True)
