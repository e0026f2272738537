"""tpumetrics_torch: the PyTorch/CUDA port of ``tpumetrics``.

States are ``torch.Tensor``s on one device, CUDA unless ``device=`` says
otherwise; the port imports neither JAX nor the JAX package. It holds the
classification domain of the JAX package: stat scores, accuracy,
F-beta/F1, precision, recall, specificity, Hamming distance, exact match,
confusion matrix, Jaccard index, Matthews correlation, Cohen's kappa,
precision-recall curve, ROC, AUROC, average precision, recall, precision or
specificity at a fixed point of the curve, hinge loss, calibration error,
the multilabel ranking metrics, group fairness and Dice (binary, multiclass
and multilabel, binned or exact curves, and the task-string wrappers such
as ``Accuracy(task=...)``), the regression domain (``regression``: errors,
R2, explained variance, Pearson, concordance, Spearman, Kendall, cosine
similarity, KL divergence, Tweedie deviance), the clustering domain
(``clustering``: mutual information and its normalized and adjusted forms,
homogeneity, completeness, V-measure, Rand, adjusted Rand, Fowlkes-Mallows,
Calinski-Harabasz, Davies-Bouldin, Dunn), the nominal domain (``nominal``:
Cramer's V, Tschuprow's T, Pearson's contingency coefficient, Theil's U,
Fleiss kappa), the wrappers (``wrappers``:
``MinMaxMetric``, ``MultioutputWrapper``, ``ClasswiseWrapper``,
``MultitaskWrapper``, ``BootStrapper``, ``MetricTracker``, ``Running``), the
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
from tpumetrics_torch.clustering import *  # noqa: F401,F403
from tpumetrics_torch.clustering import __all__ as _clustering_all
from tpumetrics_torch.collections import MetricCollection
from tpumetrics_torch.metric import CompositionalMetric, Metric
from tpumetrics_torch.nominal import *  # noqa: F401,F403
from tpumetrics_torch.nominal import __all__ as _nominal_all
from tpumetrics_torch.regression import *  # noqa: F401,F403
from tpumetrics_torch.regression import __all__ as _regression_all
from tpumetrics_torch.wrappers import (
    BootStrapper,
    ClasswiseWrapper,
    MetricTracker,
    MinMaxMetric,
    MultioutputWrapper,
    MultitaskWrapper,
)

__all__ = [
    "BootStrapper",
    "CatMetric",
    "ClasswiseWrapper",
    "CompositionalMetric",
    "MaxMetric",
    "MeanMetric",
    "Metric",
    "MetricCollection",
    "MetricTracker",
    "MinMaxMetric",
    "MinMetric",
    "MultioutputWrapper",
    "MultitaskWrapper",
    "RunningMean",
    "RunningSum",
    "SumMetric",
    *_classification_all,
    *_clustering_all,
    *_nominal_all,
    *_regression_all,
]
