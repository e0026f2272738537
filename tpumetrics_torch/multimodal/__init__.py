"""Multimodal metrics of the port (counterpart of ``tpumetrics/multimodal``):
CLIPScore and CLIP-IQA on the port's own CLIP (``multimodal._clip``) or any
``(model, processor)`` pair with the same surface."""

from tpumetrics_torch.multimodal.clip_iqa import CLIPImageQualityAssessment
from tpumetrics_torch.multimodal.clip_score import CLIPScore

__all__ = [
    "CLIPImageQualityAssessment",
    "CLIPScore",
]
