"""Modular classification metrics of the port: binary, multiclass and
multilabel variants and their task-string wrappers."""

from tpumetrics_torch.classification.accuracy import Accuracy, BinaryAccuracy, MulticlassAccuracy, MultilabelAccuracy
from tpumetrics_torch.classification.auroc import AUROC, BinaryAUROC, MulticlassAUROC, MultilabelAUROC
from tpumetrics_torch.classification.f_beta import (
    BinaryF1Score,
    BinaryFBetaScore,
    F1Score,
    FBetaScore,
    MulticlassF1Score,
    MulticlassFBetaScore,
    MultilabelF1Score,
    MultilabelFBetaScore,
)
from tpumetrics_torch.classification.precision_recall_curve import (
    BinaryPrecisionRecallCurve,
    MulticlassPrecisionRecallCurve,
    MultilabelPrecisionRecallCurve,
    PrecisionRecallCurve,
)
from tpumetrics_torch.classification.roc import ROC, BinaryROC, MulticlassROC, MultilabelROC
from tpumetrics_torch.classification.stat_scores import (
    BinaryStatScores,
    MulticlassStatScores,
    MultilabelStatScores,
    StatScores,
)

__all__ = [
    "AUROC",
    "Accuracy",
    "BinaryAUROC",
    "BinaryAccuracy",
    "BinaryF1Score",
    "BinaryFBetaScore",
    "BinaryPrecisionRecallCurve",
    "BinaryROC",
    "BinaryStatScores",
    "F1Score",
    "FBetaScore",
    "MulticlassAUROC",
    "MulticlassAccuracy",
    "MulticlassF1Score",
    "MulticlassFBetaScore",
    "MulticlassPrecisionRecallCurve",
    "MulticlassROC",
    "MulticlassStatScores",
    "MultilabelAUROC",
    "MultilabelAccuracy",
    "MultilabelF1Score",
    "MultilabelFBetaScore",
    "MultilabelPrecisionRecallCurve",
    "MultilabelROC",
    "MultilabelStatScores",
    "PrecisionRecallCurve",
    "ROC",
    "StatScores",
]
