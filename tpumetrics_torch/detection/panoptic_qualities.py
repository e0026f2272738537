"""PanopticQuality / ModifiedPanopticQuality (port of
``tpumetrics/detection/panoptic_qualities.py``)."""

from __future__ import annotations

from typing import Any, Collection

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
from tpumetrics_torch.metric import Metric

Tensor = torch.Tensor


class PanopticQuality(Metric):
    """Panoptic Quality accumulated over batches: four per-category float32
    sum states (iou_sum, TP, FP, FN), one all-reduce on sync. Each update
    matches the batch's segments on the metric's device
    (:func:`~tpumetrics_torch.functional.detection._panoptic_quality_common._panoptic_quality_update`),
    which reads segment counts on the host: a fused collection keeps it eager.

    Example:
        >>> import torch
        >>> from tpumetrics_torch.detection import PanopticQuality
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
        >>> metric = PanopticQuality(things={0, 1}, stuffs={6, 7}, device="cpu")
        >>> metric.update(preds, target)
        >>> round(float(metric.compute()), 4)
        0.5463
    """

    is_differentiable: bool = False
    higher_is_better: bool = True
    full_state_update: bool = False
    plot_lower_bound: float = 0.0
    plot_upper_bound: float = 1.0
    _update_reads_host = True

    _modified_variant: bool = False

    def __init__(
        self,
        things: Collection[int],
        stuffs: Collection[int],
        allow_unknown_preds_category: bool = False,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        things_set, stuffs_set = _parse_categories(things, stuffs)
        self.things = things_set
        self.stuffs = stuffs_set
        self.void_color = _get_void_color(things_set, stuffs_set)
        self.cat_id_to_continuous_id = _get_category_id_to_continuous_id(things_set, stuffs_set)
        self.allow_unknown_preds_category = allow_unknown_preds_category

        num_categories = len(things_set) + len(stuffs_set)
        self.add_state("iou_sum", default=torch.zeros(num_categories), dist_reduce_fx="sum")
        self.add_state("true_positives", default=torch.zeros(num_categories), dist_reduce_fx="sum")
        self.add_state("false_positives", default=torch.zeros(num_categories), dist_reduce_fx="sum")
        self.add_state("false_negatives", default=torch.zeros(num_categories), dist_reduce_fx="sum")

    def update(self, preds: Tensor, target: Tensor) -> None:
        """Match the segments of one batch (reference detection/panoptic_qualities.py update)."""
        _validate_inputs(preds, target)
        flatten_preds = _prepocess_inputs(
            self.things, self.stuffs, preds, self.void_color, self.allow_unknown_preds_category
        )
        flatten_target = _prepocess_inputs(self.things, self.stuffs, target, self.void_color, True)
        iou_sum, true_positives, false_positives, false_negatives = _panoptic_quality_update(
            flatten_preds,
            flatten_target,
            self.cat_id_to_continuous_id,
            self.void_color,
            modified_metric_stuffs=self.stuffs if self._modified_variant else None,
        )
        self.iou_sum = self.iou_sum + iou_sum
        self.true_positives = self.true_positives + true_positives
        self.false_positives = self.false_positives + false_positives
        self.false_negatives = self.false_negatives + false_negatives

    def compute(self) -> Tensor:
        return _panoptic_quality_compute(self.iou_sum, self.true_positives, self.false_positives, self.false_negatives)


class ModifiedPanopticQuality(PanopticQuality):
    """Modified PQ (Porzi et al. 2019): stuff classes score IoU / #segments
    (reference detection/panoptic_qualities.py ModifiedPanopticQuality).

    Example:
        >>> import torch
        >>> from tpumetrics_torch.detection import ModifiedPanopticQuality
        >>> preds = torch.tensor([[[0, 0], [0, 1], [6, 0], [7, 0], [0, 2], [1, 0]]])
        >>> target = torch.tensor([[[0, 1], [0, 0], [6, 0], [7, 0], [6, 0], [255, 0]]])
        >>> metric = ModifiedPanopticQuality(things={0, 1}, stuffs={6, 7}, device="cpu")
        >>> metric.update(preds, target)
        >>> round(float(metric.compute()), 4)
        0.7667
    """

    _modified_variant: bool = True
