"""Detection functional metrics of the port (counterpart of
``tpumetrics/functional/detection``)."""

from tpumetrics_torch.functional.detection.ciou import complete_intersection_over_union
from tpumetrics_torch.functional.detection.diou import distance_intersection_over_union
from tpumetrics_torch.functional.detection.giou import generalized_intersection_over_union
from tpumetrics_torch.functional.detection.iou import intersection_over_union
from tpumetrics_torch.functional.detection.panoptic_qualities import (
    modified_panoptic_quality,
    panoptic_quality,
)

__all__ = [
    "complete_intersection_over_union",
    "distance_intersection_over_union",
    "generalized_intersection_over_union",
    "intersection_over_union",
    "modified_panoptic_quality",
    "panoptic_quality",
]
