"""InceptionScore (port of ``tpumetrics/image/inception.py``)."""

from __future__ import annotations

from typing import Any, Callable, Optional, Tuple, Union

import numpy as np
import torch

from tpumetrics_torch.image.fid import _adopt_backbone, _resolve_feature_extractor
from tpumetrics_torch.metric import Metric
from tpumetrics_torch.utils.data import dim_zero_cat

Tensor = torch.Tensor


class InceptionScore(Metric):
    """IS: exp of the mean split-KL between the conditional and marginal
    class distributions of a classifier's logits.

    Args:
        feature: callable image->(N, num_classes) logits extractor, or a
            tap of the pretrained InceptionV3 (see FID).
        splits: number of splits for the mean/std estimate.
        seed: feature-shuffling seed; the shuffle is numpy's
            ``default_rng(seed)`` permutation, the JAX package's draw.

    Example:
        >>> import torch
        >>> from tpumetrics_torch.image import InceptionScore
        >>> logits = lambda imgs: imgs.reshape(imgs.shape[0], -1)[:, :10].float()
        >>> inception = InceptionScore(feature=logits, splits=2, device="cpu")
        >>> imgs = torch.randint(0, 255, (16, 3, 8, 8), generator=torch.Generator().manual_seed(0), dtype=torch.uint8)
        >>> inception.update(imgs)
        >>> score_mean, score_std = inception.compute()
        >>> bool(score_mean >= 1.0)
        True
    """

    is_differentiable: bool = False
    higher_is_better: bool = True
    full_state_update: bool = False
    plot_lower_bound: float = 0.0

    def __init__(
        self,
        feature: Union[int, str, Callable] = "logits_unbiased",
        splits: int = 10,
        normalize: bool = False,
        seed: Optional[int] = None,
        feature_extractor_weights_path: Optional[str] = None,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        self.inception, _ = _resolve_feature_extractor(
            feature, type(self).__name__, feature_extractor_weights_path, acquire=True, device=self.device
        )
        _adopt_backbone(self, self.inception)
        if not isinstance(normalize, bool):
            raise ValueError("Argument `normalize` expected to be a bool")
        self.normalize = normalize
        self.splits = splits
        self._rng = np.random.default_rng(seed)
        self.add_state("features", default=[], dist_reduce_fx=None)

    def update(self, imgs: Tensor) -> None:
        """Extract and store classifier logits."""
        imgs = (imgs * 255).to(torch.uint8) if self.normalize else imgs
        features = torch.as_tensor(self.inception(imgs)).to(torch.float32)
        self.features.append(features)

    def compute(self) -> Tuple[Tensor, Tensor]:
        """exp(KL) per split, mean/std over splits."""
        features = dim_zero_cat(self.features)
        idx = torch.from_numpy(self._rng.permutation(features.shape[0])).to(features.device)
        features = features[idx]

        prob = torch.softmax(features, dim=1)
        log_prob = torch.log_softmax(features, dim=1)

        # torch.chunk semantics: chunk size ceil(n/splits) yields at most
        # `splits` chunks, all non-empty
        n = int(prob.shape[0])
        chunk = -(-n // self.splits) if n else 1
        bounds = list(range(0, n, chunk)) or [0]
        kl_list = []
        for i in bounds:
            p, log_p = prob[i : i + chunk], log_prob[i : i + chunk]
            mean_prob = p.mean(dim=0, keepdim=True)
            # p == 0 contributes 0 to the KL; the raw expression is
            # 0 * log(0) = NaN when a class prob underflows
            kl = torch.where(p > 0, p * (log_p - torch.log(mean_prob)), 0.0)
            kl_list.append(torch.exp(kl.sum(dim=1).mean()))
        kl_arr = torch.stack(kl_list)
        return kl_arr.mean(), kl_arr.std(correction=0)
