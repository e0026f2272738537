"""Modular regression metrics of the port (counterpart of ``tpumetrics/regression``)."""

from tpumetrics_torch.regression.concordance import ConcordanceCorrCoef
from tpumetrics_torch.regression.cosine_similarity import CosineSimilarity
from tpumetrics_torch.regression.explained_variance import ExplainedVariance
from tpumetrics_torch.regression.kendall import KendallRankCorrCoef
from tpumetrics_torch.regression.kl_divergence import KLDivergence
from tpumetrics_torch.regression.log_cosh import LogCoshError
from tpumetrics_torch.regression.log_mse import MeanSquaredLogError
from tpumetrics_torch.regression.mae import MeanAbsoluteError
from tpumetrics_torch.regression.mape import MeanAbsolutePercentageError
from tpumetrics_torch.regression.minkowski import MinkowskiDistance
from tpumetrics_torch.regression.mse import MeanSquaredError
from tpumetrics_torch.regression.pearson import PearsonCorrCoef
from tpumetrics_torch.regression.r2 import R2Score
from tpumetrics_torch.regression.rse import RelativeSquaredError
from tpumetrics_torch.regression.spearman import SpearmanCorrCoef
from tpumetrics_torch.regression.symmetric_mape import SymmetricMeanAbsolutePercentageError
from tpumetrics_torch.regression.tweedie_deviance import TweedieDevianceScore
from tpumetrics_torch.regression.wmape import WeightedMeanAbsolutePercentageError

__all__ = [
    "ConcordanceCorrCoef",
    "CosineSimilarity",
    "ExplainedVariance",
    "KLDivergence",
    "KendallRankCorrCoef",
    "LogCoshError",
    "MeanAbsoluteError",
    "MeanAbsolutePercentageError",
    "MeanSquaredError",
    "MeanSquaredLogError",
    "MinkowskiDistance",
    "PearsonCorrCoef",
    "R2Score",
    "RelativeSquaredError",
    "SpearmanCorrCoef",
    "SymmetricMeanAbsolutePercentageError",
    "TweedieDevianceScore",
    "WeightedMeanAbsolutePercentageError",
]
