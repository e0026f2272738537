"""MemorizationInformedFrechetInceptionDistance (port of
``tpumetrics/image/mifid.py``)."""

from __future__ import annotations

from typing import Any, Callable, Optional, Union

import numpy as np
import torch

from tpumetrics_torch.image.fid import _adopt_backbone, _compute_fid, _resolve_feature_extractor
from tpumetrics_torch.metric import Metric
from tpumetrics_torch.utils.compute import _ieee_float32_matmul, _safe_matmul
from tpumetrics_torch.utils.data import dim_zero_cat

Tensor = torch.Tensor


def _compute_cosine_distance(features1: Tensor, features2: Tensor, cosine_distance_eps: float = 0.1) -> Tensor:
    """Mean minimum cosine distance, thresholded. The all-zero rows are
    dropped by a mask read on the host (the float32 row sums in numpy, as
    the JAX package reads them): this runs in ``compute()``, never in an
    update."""
    keep1 = np.sum(features1.detach().cpu().numpy(), axis=1) != 0
    keep2 = np.sum(features2.detach().cpu().numpy(), axis=1) != 0
    features1 = features1[torch.from_numpy(keep1).to(features1.device)]
    features2 = features2[torch.from_numpy(keep2).to(features2.device)]
    norm_f1 = features1 / torch.linalg.norm(features1, dim=1, keepdim=True)
    norm_f2 = features2 / torch.linalg.norm(features2, dim=1, keepdim=True)
    d = 1.0 - torch.abs(_safe_matmul(norm_f1, norm_f2))
    mean_min_d = torch.mean(d.min(dim=1).values)
    return torch.where(mean_min_d < cosine_distance_eps, mean_min_d, torch.ones_like(mean_min_d))


def _mifid_compute(
    mu1: Tensor,
    sigma1: Tensor,
    features1: Tensor,
    mu2: Tensor,
    sigma2: Tensor,
    features2: Tensor,
    cosine_distance_eps: float = 0.1,
) -> Tensor:
    """FID weighted by the memorization distance."""
    fid_value = _compute_fid(mu1, sigma1, mu2, sigma2)
    distance = _compute_cosine_distance(features1, features2, cosine_distance_eps)
    return torch.where(fid_value > 1e-8, fid_value / (distance + 1e-14), torch.zeros_like(fid_value))


class MemorizationInformedFrechetInceptionDistance(Metric):
    """MiFID = FID / memorization distance: penalizes generators that copy
    the training set.

    Example:
        >>> import torch
        >>> from tpumetrics_torch.image import MemorizationInformedFrechetInceptionDistance
        >>> extract = lambda imgs: imgs.reshape(imgs.shape[0], -1)[:, :8].float()
        >>> mifid = MemorizationInformedFrechetInceptionDistance(feature=extract, device="cpu")
        >>> g = torch.Generator().manual_seed(0)
        >>> real = torch.randint(0, 255, (8, 3, 8, 8), generator=g, dtype=torch.uint8)
        >>> fake = torch.randint(0, 255, (8, 3, 8, 8), generator=g, dtype=torch.uint8)
        >>> mifid.update(real, real=True)
        >>> mifid.update(fake, real=False)
        >>> float(mifid.compute()) >= 0
        True
    """

    is_differentiable: bool = False
    higher_is_better: bool = False
    full_state_update: bool = False
    plot_lower_bound: float = 0.0

    def __init__(
        self,
        feature: Union[int, str, Callable] = 2048,
        reset_real_features: bool = True,
        normalize: bool = False,
        cosine_distance_eps: float = 0.1,
        feature_extractor_weights_path: Optional[str] = None,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        self.inception, _ = _resolve_feature_extractor(
            feature, type(self).__name__, feature_extractor_weights_path, acquire=True, device=self.device
        )
        _adopt_backbone(self, self.inception)
        if not isinstance(reset_real_features, bool):
            raise ValueError("Argument `reset_real_features` expected to be a bool")
        self.reset_real_features = reset_real_features
        if not isinstance(normalize, bool):
            raise ValueError("Argument `normalize` expected to be a bool")
        self.normalize = normalize
        if not (isinstance(cosine_distance_eps, float) and 1 >= cosine_distance_eps > 0):
            raise ValueError("Argument `cosine_distance_eps` expected to be a float greater than 0 and less than 1")
        self.cosine_distance_eps = cosine_distance_eps

        self.add_state("real_features", default=[], dist_reduce_fx=None)
        self.add_state("fake_features", default=[], dist_reduce_fx=None)

    def update(self, imgs: Tensor, real: bool) -> None:
        """Extract and store features."""
        imgs = (imgs * 255).to(torch.uint8) if self.normalize else imgs
        features = torch.as_tensor(self.inception(imgs)).to(torch.float32)
        if features.ndim == 1:
            features = features[None]
        if real:
            self.real_features.append(features)
        else:
            self.fake_features.append(features)

    def compute(self) -> Tensor:
        """MiFID over all stored features (the covariances' products in full float32)."""
        real_features = dim_zero_cat(self.real_features)
        fake_features = dim_zero_cat(self.fake_features)
        mean_real, mean_fake = real_features.mean(dim=0), fake_features.mean(dim=0)
        with _ieee_float32_matmul():
            cov_real = torch.cov(real_features.T)
            cov_fake = torch.cov(fake_features.T)
        return _mifid_compute(
            mean_real, cov_real, real_features, mean_fake, cov_fake, fake_features, self.cosine_distance_eps
        )

    def reset(self) -> None:
        if not self.reset_real_features:
            real = self.real_features
            super().reset()
            self.real_features = real
        else:
            super().reset()
