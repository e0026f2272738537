"""tpumetrics_torch: the PyTorch/CUDA port of ``tpumetrics``.

States are ``torch.Tensor``s on one device, CUDA unless ``device=`` says
otherwise; the port imports neither JAX nor the JAX package. This slice
holds the classification main path (multiclass accuracy, F-beta/F1, stat
scores, binned precision-recall curve and AUROC, in a ``MetricCollection``)
and its one CUDA kernel, ``ops.binned_confusion``.
"""

from tpumetrics_torch.classification import (
    MulticlassAccuracy,
    MulticlassAUROC,
    MulticlassF1Score,
    MulticlassFBetaScore,
    MulticlassPrecisionRecallCurve,
    MulticlassStatScores,
)
from tpumetrics_torch.collections import MetricCollection
from tpumetrics_torch.metric import Metric

__all__ = [
    "Metric",
    "MetricCollection",
    "MulticlassAUROC",
    "MulticlassAccuracy",
    "MulticlassF1Score",
    "MulticlassFBetaScore",
    "MulticlassPrecisionRecallCurve",
    "MulticlassStatScores",
]
