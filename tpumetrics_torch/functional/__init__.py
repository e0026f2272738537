"""Functional metrics of the port (counterpart of ``tpumetrics/functional``):
the classification functions and their task-string dispatchers."""

from tpumetrics_torch.functional.classification import *  # noqa: F401,F403
from tpumetrics_torch.functional.classification import __all__ as _classification_all
from tpumetrics_torch.functional.classification.accuracy import accuracy
from tpumetrics_torch.functional.classification.auroc import auroc
from tpumetrics_torch.functional.classification.average_precision import average_precision
from tpumetrics_torch.functional.classification.calibration_error import calibration_error
from tpumetrics_torch.functional.classification.cohen_kappa import cohen_kappa
from tpumetrics_torch.functional.classification.confusion_matrix import confusion_matrix
from tpumetrics_torch.functional.classification.dice import dice
from tpumetrics_torch.functional.classification.exact_match import exact_match
from tpumetrics_torch.functional.classification.f_beta import f1_score, fbeta_score
from tpumetrics_torch.functional.classification.hamming import hamming_distance
from tpumetrics_torch.functional.classification.hinge import hinge_loss
from tpumetrics_torch.functional.classification.jaccard import jaccard_index
from tpumetrics_torch.functional.classification.matthews_corrcoef import matthews_corrcoef
from tpumetrics_torch.functional.classification.precision_recall import precision, recall
from tpumetrics_torch.functional.classification.precision_recall_curve import precision_recall_curve
from tpumetrics_torch.functional.classification.roc import roc
from tpumetrics_torch.functional.classification.specificity import specificity
from tpumetrics_torch.functional.classification.stat_scores import stat_scores

__all__ = [
    *_classification_all,
    "accuracy",
    "auroc",
    "average_precision",
    "calibration_error",
    "cohen_kappa",
    "confusion_matrix",
    "dice",
    "exact_match",
    "f1_score",
    "fbeta_score",
    "hamming_distance",
    "hinge_loss",
    "jaccard_index",
    "matthews_corrcoef",
    "precision",
    "precision_recall_curve",
    "recall",
    "roc",
    "specificity",
    "stat_scores",
]
