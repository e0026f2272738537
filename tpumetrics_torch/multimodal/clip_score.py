"""CLIPScore metric (port of ``tpumetrics/multimodal/clip_score.py``)."""

from __future__ import annotations

from typing import Any, List, Tuple, Union

import torch

from tpumetrics_torch.functional.multimodal.clip_score import _clip_score_update, _get_clip_model_and_processor
from tpumetrics_torch.metric import Metric

Tensor = torch.Tensor


class CLIPScore(Metric):
    """CLIPScore accumulated over batches: a float32 sum of the scores and a
    count. The update hands host copies of the images to the processor (the
    JAX package's protocol), so it reads the host.

    Args:
        model_name_or_path: a CLIP hub id (gated when it cannot load; the
            loaded model runs on the metric's device), or an explicit ``(model, processor)`` pair such as the port's own
            :class:`~tpumetrics_torch.multimodal._clip.CLIPModel` with a
            processor.

    Example:
        >>> import torch
        >>> from tpumetrics_torch.multimodal import CLIPScore
        >>> from tpumetrics_torch.multimodal._clip import CLIPConfig, CLIPModel, CLIPTextConfig, CLIPVisionConfig
        >>> _ = torch.manual_seed(0)
        >>> model = CLIPModel(CLIPConfig(CLIPTextConfig(100, 32, 64, 2, 1, 16), CLIPVisionConfig(32, 64, 2, 1, 32, 8), 16))
        >>> processor = lambda text, images, **kw: {
        ...     "input_ids": torch.tensor([[1, 2 + len(t), 99] for t in text]).numpy(),
        ...     "attention_mask": torch.ones(len(text), 3, dtype=torch.int64).numpy(),
        ...     "pixel_values": torch.stack([torch.as_tensor(i) for i in images]).numpy()}
        >>> metric = CLIPScore((model, processor), device="cpu")
        >>> metric.update(torch.rand(2, 3, 32, 32), ["a cat", "a dog"])
        >>> float(metric.compute()) >= 0
        True
    """

    is_differentiable: bool = False
    higher_is_better: bool = True
    full_state_update: bool = True
    plot_lower_bound: float = 0.0
    plot_upper_bound: float = 100.0
    _update_reads_host = True

    def __init__(
        self,
        model_name_or_path: Union[str, Tuple[Any, Any]] = "openai/clip-vit-large-patch14",
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        self.model, self.processor = _get_clip_model_and_processor(model_name_or_path, self.device)
        self.add_state("score", torch.zeros(()), dist_reduce_fx="sum")
        self.add_state("n_samples", torch.zeros(()), dist_reduce_fx="sum")

    def update(self, images: Union[Tensor, List[Tensor]], text: Union[str, List[str]]) -> None:
        """Accumulate the similarity sum and the count."""
        score, n_samples = _clip_score_update(images, text, self.model, self.processor)
        self.score = self.score + score.sum().to(self.device)
        self.n_samples = self.n_samples + n_samples

    def compute(self) -> Tensor:
        return torch.clamp(self.score / self.n_samples, min=0.0)
