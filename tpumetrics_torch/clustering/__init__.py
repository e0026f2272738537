"""Modular clustering metrics of the port (counterpart of ``tpumetrics/clustering``)."""

from tpumetrics_torch.clustering.adjusted_mutual_info_score import AdjustedMutualInfoScore
from tpumetrics_torch.clustering.adjusted_rand_score import AdjustedRandScore
from tpumetrics_torch.clustering.calinski_harabasz_score import CalinskiHarabaszScore
from tpumetrics_torch.clustering.davies_bouldin_score import DaviesBouldinScore
from tpumetrics_torch.clustering.dunn_index import DunnIndex
from tpumetrics_torch.clustering.fowlkes_mallows_index import FowlkesMallowsIndex
from tpumetrics_torch.clustering.homogeneity_completeness_v_measure import (
    CompletenessScore,
    HomogeneityScore,
    VMeasureScore,
)
from tpumetrics_torch.clustering.mutual_info_score import MutualInfoScore
from tpumetrics_torch.clustering.normalized_mutual_info_score import NormalizedMutualInfoScore
from tpumetrics_torch.clustering.rand_score import RandScore

__all__ = [
    "AdjustedMutualInfoScore",
    "AdjustedRandScore",
    "CalinskiHarabaszScore",
    "CompletenessScore",
    "DaviesBouldinScore",
    "DunnIndex",
    "FowlkesMallowsIndex",
    "HomogeneityScore",
    "MutualInfoScore",
    "NormalizedMutualInfoScore",
    "RandScore",
    "VMeasureScore",
]
