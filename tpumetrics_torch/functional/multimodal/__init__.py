"""Multimodal functional metrics of the port (counterpart of
``tpumetrics/functional/multimodal``)."""

from tpumetrics_torch.functional.multimodal.clip_iqa import clip_image_quality_assessment
from tpumetrics_torch.functional.multimodal.clip_score import clip_score

__all__ = [
    "clip_image_quality_assessment",
    "clip_score",
]
