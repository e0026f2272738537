"""Functional classification metrics of the port: the binary, multiclass and
multilabel variants. The task-string dispatchers (``accuracy``, ``auroc``,
...) share their names with modules of this package, so they are exported
from ``tpumetrics_torch.functional`` and the names here stay the modules."""

from tpumetrics_torch.functional.classification.accuracy import (
    binary_accuracy,
    multiclass_accuracy,
    multilabel_accuracy,
)
from tpumetrics_torch.functional.classification.auroc import binary_auroc, multiclass_auroc, multilabel_auroc
from tpumetrics_torch.functional.classification.average_precision import (
    binary_average_precision,
    multiclass_average_precision,
    multilabel_average_precision,
)
from tpumetrics_torch.functional.classification.confusion_matrix import (
    binary_confusion_matrix,
    multiclass_confusion_matrix,
    multilabel_confusion_matrix,
)
from tpumetrics_torch.functional.classification.f_beta import (
    binary_f1_score,
    binary_fbeta_score,
    multiclass_f1_score,
    multiclass_fbeta_score,
    multilabel_f1_score,
    multilabel_fbeta_score,
)
from tpumetrics_torch.functional.classification.precision_recall_curve import (
    binary_precision_recall_curve,
    multiclass_precision_recall_curve,
    multilabel_precision_recall_curve,
)
from tpumetrics_torch.functional.classification.roc import binary_roc, multiclass_roc, multilabel_roc
from tpumetrics_torch.functional.classification.stat_scores import (
    binary_stat_scores,
    multiclass_stat_scores,
    multilabel_stat_scores,
)

__all__ = [
    "binary_accuracy",
    "binary_auroc",
    "binary_average_precision",
    "binary_confusion_matrix",
    "binary_f1_score",
    "binary_fbeta_score",
    "binary_precision_recall_curve",
    "binary_roc",
    "binary_stat_scores",
    "multiclass_accuracy",
    "multiclass_auroc",
    "multiclass_average_precision",
    "multiclass_confusion_matrix",
    "multiclass_f1_score",
    "multiclass_fbeta_score",
    "multiclass_precision_recall_curve",
    "multiclass_roc",
    "multiclass_stat_scores",
    "multilabel_accuracy",
    "multilabel_auroc",
    "multilabel_average_precision",
    "multilabel_confusion_matrix",
    "multilabel_f1_score",
    "multilabel_fbeta_score",
    "multilabel_precision_recall_curve",
    "multilabel_roc",
    "multilabel_stat_scores",
]
