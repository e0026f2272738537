"""Detection metrics of the port (counterpart of ``tpumetrics/detection``):
COCO mAP, the IoU family and panoptic quality."""

from tpumetrics_torch.detection.ciou import CompleteIntersectionOverUnion
from tpumetrics_torch.detection.diou import DistanceIntersectionOverUnion
from tpumetrics_torch.detection.giou import GeneralizedIntersectionOverUnion
from tpumetrics_torch.detection.iou import IntersectionOverUnion
from tpumetrics_torch.detection.mean_ap import MeanAveragePrecision
from tpumetrics_torch.detection.packing import pack_detection_batch  # noqa: F401
from tpumetrics_torch.detection.panoptic_qualities import ModifiedPanopticQuality, PanopticQuality

# as in the JAX package, __all__ lists the metric classes; pack_detection_batch
# is public but a helper, imported by name
__all__ = [
    "CompleteIntersectionOverUnion",
    "DistanceIntersectionOverUnion",
    "GeneralizedIntersectionOverUnion",
    "IntersectionOverUnion",
    "MeanAveragePrecision",
    "ModifiedPanopticQuality",
    "PanopticQuality",
]
