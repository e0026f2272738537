"""CLIPImageQualityAssessment metric (port of ``tpumetrics/multimodal/clip_iqa.py``)."""

from __future__ import annotations

from typing import Any, Dict, Tuple, Union

import torch

from tpumetrics_torch.functional.multimodal.clip_iqa import (
    _clip_iqa_format_prompts,
    _clip_iqa_text_features,
    clip_image_quality_assessment,
)
from tpumetrics_torch.functional.multimodal.clip_score import _get_clip_model_and_processor
from tpumetrics_torch.metric import Metric

Tensor = torch.Tensor


class CLIPImageQualityAssessment(Metric):
    """CLIP-IQA accumulated over batches: per-prompt probability sums and a
    count. The prompts' text anchors are encoded once, at construction. The
    update hands host copies of the images to the processor, so it reads the
    host.

    Example:
        >>> import torch
        >>> from tpumetrics_torch.multimodal import CLIPImageQualityAssessment
        >>> from tpumetrics_torch.multimodal._clip import CLIPConfig, CLIPModel, CLIPTextConfig, CLIPVisionConfig
        >>> _ = torch.manual_seed(0)
        >>> model = CLIPModel(CLIPConfig(CLIPTextConfig(100, 32, 64, 2, 1, 16), CLIPVisionConfig(32, 64, 2, 1, 32, 8), 16))
        >>> def processor(text=None, images=None, **kw):
        ...     out = {}
        ...     if text is not None:
        ...         out["input_ids"] = torch.tensor([[1, 2 + len(t), 99] for t in text]).numpy()
        ...         out["attention_mask"] = torch.ones(len(text), 3, dtype=torch.int64).numpy()
        ...     if images is not None:
        ...         out["pixel_values"] = torch.stack([torch.as_tensor(i) for i in images]).numpy()
        ...     return out
        >>> metric = CLIPImageQualityAssessment((model, processor), prompts=("quality", "sharpness"), device="cpu")
        >>> metric.update(torch.rand(2, 3, 32, 32))
        >>> sorted(metric.compute())
        ['quality', 'sharpness']
    """

    is_differentiable: bool = False
    higher_is_better: bool = True
    full_state_update: bool = True
    plot_lower_bound: float = 0.0
    plot_upper_bound: float = 1.0
    _update_reads_host = True

    def __init__(
        self,
        model_name_or_path: Union[str, Tuple[Any, Any]] = "clip_iqa",
        data_range: float = 1.0,
        prompts: Tuple[Union[str, Tuple[str, str]], ...] = ("quality",),
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        self.prompts_names, prompts_list = _clip_iqa_format_prompts(prompts)
        self.prompts = prompts
        self.model, self.processor = _get_clip_model_and_processor(model_name_or_path, self.device)
        self.model_name_or_path = (self.model, self.processor)
        self.data_range = data_range
        # the anchors depend only on `prompts`: encoded once, reused by every update
        self._text_features = _clip_iqa_text_features(self.model, self.processor, prompts_list)
        self.add_state("score_sums", torch.zeros(len(self.prompts_names)), dist_reduce_fx="sum")
        self.add_state("n_samples", torch.zeros(()), dist_reduce_fx="sum")

    def update(self, images: Tensor) -> None:
        """Accumulate the per-prompt probability sums."""
        out = clip_image_quality_assessment(
            images, self.model_name_or_path, self.data_range, self.prompts, text_features=self._text_features,
        )
        if isinstance(out, dict):
            sums = torch.stack([out[name].sum() for name in self.prompts_names])
        else:
            sums = out.sum()[None]
        self.score_sums = self.score_sums + sums.to(self.device)
        self.n_samples = self.n_samples + float(images.shape[0])

    def compute(self) -> Union[Tensor, Dict[str, Tensor]]:
        means = self.score_sums / self.n_samples
        if len(self.prompts_names) == 1:
            return means[0]
        return {name: means[i] for i, name in enumerate(self.prompts_names)}
