"""Modular retrieval metrics of the port (counterpart of ``tpumetrics/retrieval``)."""

from tpumetrics_torch.retrieval.average_precision import RetrievalMAP
from tpumetrics_torch.retrieval.base import RetrievalMetric
from tpumetrics_torch.retrieval.fall_out import RetrievalFallOut
from tpumetrics_torch.retrieval.hit_rate import RetrievalHitRate
from tpumetrics_torch.retrieval.ndcg import RetrievalNormalizedDCG
from tpumetrics_torch.retrieval.precision import RetrievalPrecision
from tpumetrics_torch.retrieval.precision_recall_curve import (
    RetrievalPrecisionRecallCurve,
    RetrievalRecallAtFixedPrecision,
)
from tpumetrics_torch.retrieval.r_precision import RetrievalRPrecision
from tpumetrics_torch.retrieval.recall import RetrievalRecall
from tpumetrics_torch.retrieval.reciprocal_rank import RetrievalMRR

__all__ = [
    "RetrievalFallOut",
    "RetrievalHitRate",
    "RetrievalMAP",
    "RetrievalMRR",
    "RetrievalMetric",
    "RetrievalNormalizedDCG",
    "RetrievalPrecision",
    "RetrievalPrecisionRecallCurve",
    "RetrievalRecall",
    "RetrievalRecallAtFixedPrecision",
    "RetrievalRPrecision",
]
