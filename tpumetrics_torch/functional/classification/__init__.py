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
from tpumetrics_torch.functional.classification.cohen_kappa import binary_cohen_kappa, multiclass_cohen_kappa
from tpumetrics_torch.functional.classification.confusion_matrix import (
    binary_confusion_matrix,
    multiclass_confusion_matrix,
    multilabel_confusion_matrix,
)
from tpumetrics_torch.functional.classification.exact_match import multiclass_exact_match, multilabel_exact_match
from tpumetrics_torch.functional.classification.f_beta import (
    binary_f1_score,
    binary_fbeta_score,
    multiclass_f1_score,
    multiclass_fbeta_score,
    multilabel_f1_score,
    multilabel_fbeta_score,
)
from tpumetrics_torch.functional.classification.hamming import (
    binary_hamming_distance,
    multiclass_hamming_distance,
    multilabel_hamming_distance,
)
from tpumetrics_torch.functional.classification.jaccard import (
    binary_jaccard_index,
    multiclass_jaccard_index,
    multilabel_jaccard_index,
)
from tpumetrics_torch.functional.classification.matthews_corrcoef import (
    binary_matthews_corrcoef,
    multiclass_matthews_corrcoef,
    multilabel_matthews_corrcoef,
)
from tpumetrics_torch.functional.classification.precision_fixed_recall import (
    binary_precision_at_fixed_recall,
    multiclass_precision_at_fixed_recall,
    multilabel_precision_at_fixed_recall,
)
from tpumetrics_torch.functional.classification.precision_recall import (
    binary_precision,
    binary_recall,
    multiclass_precision,
    multiclass_recall,
    multilabel_precision,
    multilabel_recall,
)
from tpumetrics_torch.functional.classification.precision_recall_curve import (
    binary_precision_recall_curve,
    multiclass_precision_recall_curve,
    multilabel_precision_recall_curve,
)
from tpumetrics_torch.functional.classification.recall_fixed_precision import (
    binary_recall_at_fixed_precision,
    multiclass_recall_at_fixed_precision,
    multilabel_recall_at_fixed_precision,
)
from tpumetrics_torch.functional.classification.roc import binary_roc, multiclass_roc, multilabel_roc
from tpumetrics_torch.functional.classification.specificity import (
    binary_specificity,
    multiclass_specificity,
    multilabel_specificity,
)
from tpumetrics_torch.functional.classification.stat_scores import (
    binary_stat_scores,
    multiclass_stat_scores,
    multilabel_stat_scores,
)

__all__ = [
    "binary_accuracy",
    "binary_auroc",
    "binary_average_precision",
    "binary_cohen_kappa",
    "binary_confusion_matrix",
    "binary_f1_score",
    "binary_fbeta_score",
    "binary_hamming_distance",
    "binary_jaccard_index",
    "binary_matthews_corrcoef",
    "binary_precision",
    "binary_precision_at_fixed_recall",
    "binary_precision_recall_curve",
    "binary_recall",
    "binary_recall_at_fixed_precision",
    "binary_roc",
    "binary_specificity",
    "binary_stat_scores",
    "multiclass_accuracy",
    "multiclass_auroc",
    "multiclass_average_precision",
    "multiclass_cohen_kappa",
    "multiclass_confusion_matrix",
    "multiclass_exact_match",
    "multiclass_f1_score",
    "multiclass_fbeta_score",
    "multiclass_hamming_distance",
    "multiclass_jaccard_index",
    "multiclass_matthews_corrcoef",
    "multiclass_precision",
    "multiclass_precision_at_fixed_recall",
    "multiclass_precision_recall_curve",
    "multiclass_recall",
    "multiclass_recall_at_fixed_precision",
    "multiclass_roc",
    "multiclass_specificity",
    "multiclass_stat_scores",
    "multilabel_accuracy",
    "multilabel_auroc",
    "multilabel_average_precision",
    "multilabel_confusion_matrix",
    "multilabel_exact_match",
    "multilabel_f1_score",
    "multilabel_fbeta_score",
    "multilabel_hamming_distance",
    "multilabel_jaccard_index",
    "multilabel_matthews_corrcoef",
    "multilabel_precision",
    "multilabel_precision_at_fixed_recall",
    "multilabel_precision_recall_curve",
    "multilabel_recall",
    "multilabel_recall_at_fixed_precision",
    "multilabel_roc",
    "multilabel_specificity",
    "multilabel_stat_scores",
]
