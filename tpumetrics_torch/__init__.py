"""tpumetrics_torch: the PyTorch/CUDA port of ``tpumetrics``.

States are ``torch.Tensor``s on one device, CUDA unless ``device=`` says
otherwise; the port imports neither JAX nor the JAX package. It holds the
classification families stat scores, accuracy, F-beta/F1, precision,
recall, specificity, Hamming distance, exact match, confusion matrix,
Jaccard index, Matthews correlation, Cohen's kappa, precision-recall curve,
ROC, AUROC, average precision and recall or precision at a fixed point of
the curve (binary, multiclass and multilabel, binned or exact curves, and
the task-string wrappers such as ``Accuracy(task=...)``), the
aggregation metrics (``SumMetric``, ``MeanMetric``, ...), metric arithmetic
(``CompositionalMetric``), the ``MetricCollection``, cross-rank sync over
``torch.distributed`` (``parallel``), fixed-capacity list states
(``buffers``), the collection update captured as CUDA graphs
(``MetricCollection(fused_update=True)``, ``parallel.FusedCollectionStep``),
and their one CUDA kernel, ``ops.binned_confusion``.
"""

from tpumetrics_torch.aggregation import (
    CatMetric,
    MaxMetric,
    MeanMetric,
    MinMetric,
    RunningMean,
    RunningSum,
    SumMetric,
)
from tpumetrics_torch.classification import *  # noqa: F401,F403
from tpumetrics_torch.classification import __all__ as _classification_all
from tpumetrics_torch.collections import MetricCollection
from tpumetrics_torch.metric import CompositionalMetric, Metric

__all__ = [
    "CatMetric",
    "CompositionalMetric",
    "MaxMetric",
    "MeanMetric",
    "Metric",
    "MetricCollection",
    "MinMetric",
    "RunningMean",
    "RunningSum",
    "SumMetric",
    *_classification_all,
]
