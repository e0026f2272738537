"""Retrieval functional metrics of the port (counterpart of
``tpumetrics/functional/retrieval``)."""

from tpumetrics_torch.functional.retrieval.average_precision import retrieval_average_precision
from tpumetrics_torch.functional.retrieval.fall_out import retrieval_fall_out
from tpumetrics_torch.functional.retrieval.hit_rate import retrieval_hit_rate
from tpumetrics_torch.functional.retrieval.ndcg import retrieval_normalized_dcg
from tpumetrics_torch.functional.retrieval.precision import retrieval_precision
from tpumetrics_torch.functional.retrieval.precision_recall_curve import retrieval_precision_recall_curve
from tpumetrics_torch.functional.retrieval.r_precision import retrieval_r_precision
from tpumetrics_torch.functional.retrieval.recall import retrieval_recall
from tpumetrics_torch.functional.retrieval.reciprocal_rank import retrieval_reciprocal_rank

__all__ = [
    "retrieval_average_precision",
    "retrieval_fall_out",
    "retrieval_hit_rate",
    "retrieval_normalized_dcg",
    "retrieval_precision",
    "retrieval_precision_recall_curve",
    "retrieval_r_precision",
    "retrieval_recall",
    "retrieval_reciprocal_rank",
]
