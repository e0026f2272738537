"""Functional classification metrics of the port (multiclass main path)."""

from tpumetrics_torch.functional.classification.accuracy import multiclass_accuracy
from tpumetrics_torch.functional.classification.auroc import multiclass_auroc
from tpumetrics_torch.functional.classification.f_beta import multiclass_f1_score, multiclass_fbeta_score
from tpumetrics_torch.functional.classification.precision_recall_curve import multiclass_precision_recall_curve
from tpumetrics_torch.functional.classification.roc import multiclass_roc
from tpumetrics_torch.functional.classification.stat_scores import multiclass_stat_scores

__all__ = [
    "multiclass_accuracy",
    "multiclass_auroc",
    "multiclass_f1_score",
    "multiclass_fbeta_score",
    "multiclass_precision_recall_curve",
    "multiclass_roc",
    "multiclass_stat_scores",
]
