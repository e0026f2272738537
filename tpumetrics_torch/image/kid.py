"""KernelInceptionDistance (port of ``tpumetrics/image/kid.py``)."""

from __future__ import annotations

from typing import Any, Callable, Optional, Tuple, Union

import numpy as np
import torch

from tpumetrics_torch.image.fid import _adopt_backbone, _resolve_feature_extractor
from tpumetrics_torch.metric import Metric
from tpumetrics_torch.utils.compute import _safe_matmul
from tpumetrics_torch.utils.data import dim_zero_cat

Tensor = torch.Tensor


def poly_kernel(f1: Tensor, f2: Tensor, degree: int = 3, gamma: Optional[float] = None, coef: float = 1.0) -> Tensor:
    """Polynomial kernel; the product in full float32 (``_safe_matmul``)."""
    if gamma is None:
        gamma = 1.0 / f1.shape[1]
    return (_safe_matmul(f1, f2) * gamma + coef) ** degree


def _np_poly_mmd(
    f_real: "np.ndarray", f_fake: "np.ndarray", degree: int = 3, gamma: Optional[float] = None, coef: float = 1.0
) -> float:
    """Host float64 unbiased polynomial-kernel MMD (the compute-time path)."""
    if gamma is None:
        gamma = 1.0 / f_real.shape[1]
    k_11 = (f_real @ f_real.T * gamma + coef) ** degree
    k_22 = (f_fake @ f_fake.T * gamma + coef) ** degree
    k_12 = (f_real @ f_fake.T * gamma + coef) ** degree
    m = k_11.shape[0]
    value = ((k_11.sum() - np.trace(k_11)) + (k_22.sum() - np.trace(k_22))) / (m * (m - 1))
    return float(value - 2 * k_12.sum() / (m**2))


def poly_mmd(
    f_real: Tensor, f_fake: Tensor, degree: int = 3, gamma: Optional[float] = None, coef: float = 1.0
) -> Tensor:
    """Unbiased polynomial-kernel MMD."""
    k_11 = poly_kernel(f_real, f_real, degree, gamma, coef)
    k_22 = poly_kernel(f_fake, f_fake, degree, gamma, coef)
    k_12 = poly_kernel(f_real, f_fake, degree, gamma, coef)

    m = k_11.shape[0]
    diag_x = torch.diagonal(k_11)
    diag_y = torch.diagonal(k_22)

    kt_xx_sums = k_11.sum(dim=-1) - diag_x
    kt_yy_sums = k_22.sum(dim=-1) - diag_y
    k_xy_sums = k_12.sum(dim=0)

    value = (kt_xx_sums.sum() + kt_yy_sums.sum()) / (m * (m - 1))
    return value - 2 * k_xy_sums.sum() / (m**2)


class KernelInceptionDistance(Metric):
    """KID: mean/std of the unbiased polynomial MMD over random feature subsets.

    Args:
        feature: callable image->(N, D) extractor, or an int tap (see FID).
        subsets / subset_size: subset sampling configuration.
        degree / gamma / coef: polynomial kernel parameters.
        seed: subset-sampling seed; the subsets are numpy's
            ``default_rng(seed)`` permutations, the JAX package's draws.

    Example:
        >>> import torch
        >>> from tpumetrics_torch.image import KernelInceptionDistance
        >>> extract = lambda imgs: imgs.reshape(imgs.shape[0], -1)[:, :8].float()
        >>> kid = KernelInceptionDistance(feature=extract, subsets=3, subset_size=8, device="cpu")
        >>> g = torch.Generator().manual_seed(0)
        >>> real = torch.randint(0, 255, (16, 3, 8, 8), generator=g, dtype=torch.uint8)
        >>> fake = torch.randint(0, 255, (16, 3, 8, 8), generator=g, dtype=torch.uint8)
        >>> kid.update(real, real=True)
        >>> kid.update(fake, real=False)
        >>> kid_mean, kid_std = kid.compute()
        >>> bool(torch.isfinite(kid_mean))
        True
    """

    is_differentiable: bool = False
    higher_is_better: bool = False
    full_state_update: bool = False
    plot_lower_bound: float = 0.0

    def __init__(
        self,
        feature: Union[int, str, Callable] = 2048,
        subsets: int = 100,
        subset_size: int = 1000,
        degree: int = 3,
        gamma: Optional[float] = None,
        coef: float = 1.0,
        reset_real_features: bool = True,
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

        if not (isinstance(subsets, int) and subsets > 0):
            raise ValueError("Argument `subsets` expected to be integer larger than 0")
        self.subsets = subsets
        if not (isinstance(subset_size, int) and subset_size > 0):
            raise ValueError("Argument `subset_size` expected to be integer larger than 0")
        self.subset_size = subset_size
        if not (isinstance(degree, int) and degree > 0):
            raise ValueError("Argument `degree` expected to be integer larger than 0")
        self.degree = degree
        if gamma is not None and not (isinstance(gamma, float) and gamma > 0):
            raise ValueError("Argument `gamma` expected to be `None` or float larger than 0")
        self.gamma = gamma
        if not (isinstance(coef, float) and coef > 0):
            raise ValueError("Argument `coef` expected to be float larger than 0")
        self.coef = coef
        if not isinstance(reset_real_features, bool):
            raise ValueError("Argument `reset_real_features` expected to be a bool")
        self.reset_real_features = reset_real_features
        if not isinstance(normalize, bool):
            raise ValueError("Argument `normalize` expected to be a bool")
        self.normalize = normalize
        self._rng = np.random.default_rng(seed)

        self.add_state("real_features", default=[], dist_reduce_fx=None)
        self.add_state("fake_features", default=[], dist_reduce_fx=None)

    def update(self, imgs: Tensor, real: bool) -> None:
        """Extract and store features."""
        imgs = (imgs * 255).to(torch.uint8) if self.normalize else imgs
        features = torch.as_tensor(self.inception(imgs)).to(torch.float32)
        if real:
            self.real_features.append(features)
        else:
            self.fake_features.append(features)

    def compute(self) -> Tuple[Tensor, Tensor]:
        """Subset-sampled MMD mean/std.

        The cubed polynomial kernel of raw feature magnitudes overflows
        float32 precision, so the compute-time MMD runs on the host in
        float64, as in the JAX package."""
        real_features = dim_zero_cat(self.real_features).detach().cpu().numpy().astype(np.float64)
        fake_features = dim_zero_cat(self.fake_features).detach().cpu().numpy().astype(np.float64)
        if real_features.shape[0] < self.subset_size or fake_features.shape[0] < self.subset_size:
            raise ValueError("Argument `subset_size` should be smaller than the number of samples")

        kid_scores = []
        for _ in range(self.subsets):
            perm = self._rng.permutation(real_features.shape[0])[: self.subset_size]
            f_real = real_features[perm]
            perm = self._rng.permutation(fake_features.shape[0])[: self.subset_size]
            f_fake = fake_features[perm]
            kid_scores.append(_np_poly_mmd(f_real, f_fake, self.degree, self.gamma, self.coef))
        kid_scores_arr = np.asarray(kid_scores)
        return (
            torch.tensor(kid_scores_arr.mean(), dtype=torch.float32, device=self.device),
            torch.tensor(kid_scores_arr.std(), dtype=torch.float32, device=self.device),
        )

    def reset(self) -> None:
        if not self.reset_real_features:
            real = self.real_features
            super().reset()
            self.real_features = real
        else:
            super().reset()
