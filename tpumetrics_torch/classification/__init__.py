"""Modular classification metrics of the port (multiclass main path)."""

from tpumetrics_torch.classification.accuracy import MulticlassAccuracy
from tpumetrics_torch.classification.auroc import MulticlassAUROC
from tpumetrics_torch.classification.f_beta import MulticlassF1Score, MulticlassFBetaScore
from tpumetrics_torch.classification.precision_recall_curve import MulticlassPrecisionRecallCurve
from tpumetrics_torch.classification.stat_scores import MulticlassStatScores

__all__ = [
    "MulticlassAUROC",
    "MulticlassAccuracy",
    "MulticlassF1Score",
    "MulticlassFBetaScore",
    "MulticlassPrecisionRecallCurve",
    "MulticlassStatScores",
]
