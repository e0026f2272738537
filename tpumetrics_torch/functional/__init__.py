"""Functional metrics of the port (counterpart of ``tpumetrics/functional``)."""

from tpumetrics_torch.functional.classification import (
    multiclass_accuracy,
    multiclass_auroc,
    multiclass_f1_score,
    multiclass_fbeta_score,
    multiclass_precision_recall_curve,
    multiclass_roc,
    multiclass_stat_scores,
)

__all__ = [
    "multiclass_accuracy",
    "multiclass_auroc",
    "multiclass_f1_score",
    "multiclass_fbeta_score",
    "multiclass_precision_recall_curve",
    "multiclass_roc",
    "multiclass_stat_scores",
]
