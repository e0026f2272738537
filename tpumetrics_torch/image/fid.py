"""FrechetInceptionDistance (port of ``tpumetrics/image/fid.py``)."""

from __future__ import annotations

from typing import Any, Callable, Optional, Union

import numpy as np
import torch

from tpumetrics_torch.metric import Metric
from tpumetrics_torch.utils.checks import _is_capturing
from tpumetrics_torch.utils.compute import _safe_matmul

Tensor = torch.Tensor


def _resolve_feature_extractor(
    feature: Union[int, str, Callable],
    metric_name: str,
    weights_path: Optional[str] = None,
    *,
    dtype_policy: str = "float32",
    acquire: bool = False,
    device: Union[str, torch.device, None] = None,
):
    """Resolve the ``feature`` argument: a callable extractor (any function
    mapping an image batch to (N, D) features) is used directly; an int/str
    selects a tap of the FID InceptionV3 (``_inception.py``), resolved
    through the process-global backbone registry on ``device`` from
    converted weights (``weights_path`` / ``TPUMETRICS_INCEPTION_WEIGHTS``),
    raising with the conversion recipe when none are available.
    ``acquire=True`` makes the caller own a registry reference (see
    :func:`_adopt_backbone`)."""
    if callable(feature):
        return feature, None
    if isinstance(feature, (int, str)):
        from tpumetrics_torch.image._inception import inception_feature_extractor

        handle = inception_feature_extractor(
            feature, weights_path, dtype_policy=dtype_policy, acquire=acquire, device=device
        )
        return handle, feature
    raise TypeError("Got unknown input to argument `feature`")


def _adopt_backbone(metric: Metric, extractor: Callable) -> None:
    """Record an acquired :class:`~tpumetrics_torch.backbones.registry.
    BackboneHandle` on ``metric``: the handle joins ``_backbone_handles``
    (released by ``Metric.release_backbones()``) and its registry key becomes
    the public ``backbone_key`` attribute."""
    if hasattr(extractor, "key") and hasattr(extractor, "close"):
        metric._backbone_handles = getattr(metric, "_backbone_handles", ()) + (extractor,)
        metric.backbone_key = extractor.key


def _placement_token(extractor: Callable) -> Any:
    """What a graph captured around ``extractor`` depends on besides its
    inputs: a handle's weights placement (None for other callables)."""
    return getattr(extractor, "generation", None)


def _tap_num_features(tap: Union[int, str, None]) -> Optional[int]:
    """Feature dimensionality of a named InceptionV3 tap (None for callables)."""
    if tap is None:
        return None
    if isinstance(tap, str) and tap.startswith("logits"):
        from tpumetrics_torch.image._inception import NUM_CLASSES

        return NUM_CLASSES
    return int(tap)


def _compute_fid(mu1: Tensor, sigma1: Tensor, mu2: Tensor, sigma2: Tensor) -> Tensor:
    """Fréchet distance via the sqrtm-free eigenvalue identity:
    d² = |mu1-mu2|² + tr(s1)+tr(s2) - 2·Σ√eig(s1·s2).

    The nonsymmetric eigendecomposition runs on the host in float64 at
    compute time, as in the JAX package; it cannot run under a capture."""
    a = torch.sum((mu1 - mu2) ** 2, dim=-1)
    b = torch.trace(sigma1) + torch.trace(sigma2)
    if _is_capturing():
        raise NotImplementedError(
            "FID's eigenvalue term runs on the host; call compute() outside a CUDA graph capture."
        )
    prod = sigma1.detach().cpu().numpy().astype(np.float64) @ sigma2.detach().cpu().numpy().astype(np.float64)
    eigvals = np.linalg.eigvals(prod)
    c = np.sqrt(eigvals.astype(np.complex128)).real.sum()
    return (a + b - 2 * torch.tensor(c, dtype=torch.float32, device=a.device)).to(torch.float32)


class FrechetInceptionDistance(Metric):
    """FID with streaming mean/covariance sum states: constant memory over
    any number of images, synced with six sums.

    Args:
        feature: a callable image->(N, D) feature extractor, or one of
            64/192/768/2048 selecting a tap of the FID InceptionV3 (built
            from converted weights, see ``feature_extractor_weights_path``,
            on the metric's device).
        reset_real_features: whether ``reset()`` clears the real statistics.
        normalize: inputs are [0,1] floats instead of [0,255] bytes.
        num_features: feature dimensionality; inferred from the tap or by
            probing the extractor with a tiny batch when not given.
        feature_extractor_weights_path: ``.npz`` produced by
            ``python -m tpumetrics_torch.image._inception_convert`` from the
            reference's ``pt_inception-2015-12-05`` checkpoint; defaults to
            the ``TPUMETRICS_INCEPTION_WEIGHTS`` environment variable.

    The update (extractor plus moments) runs as one CUDA graph per batch
    signature on a card (``JitWithEagerFallback``), with no host read; an
    extractor that cannot be captured falls back to eager with one warning.

    Example:
        >>> import torch
        >>> from tpumetrics_torch.image import FrechetInceptionDistance
        >>> extract = lambda imgs: imgs.reshape(imgs.shape[0], -1)[:, :16].float()
        >>> fid = FrechetInceptionDistance(feature=extract, num_features=16, device="cpu")
        >>> g = torch.Generator().manual_seed(0)
        >>> real = torch.randint(0, 255, (8, 3, 16, 16), generator=g, dtype=torch.uint8)
        >>> fake = torch.randint(0, 255, (8, 3, 16, 16), generator=g, dtype=torch.uint8)
        >>> fid.update(real, real=True)
        >>> fid.update(fake, real=False)
        >>> float(fid.compute()) >= 0
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
        num_features: Optional[int] = None,
        feature_extractor_weights_path: Optional[str] = None,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        self.inception, tap = _resolve_feature_extractor(
            feature, type(self).__name__, feature_extractor_weights_path, acquire=True, device=self.device
        )
        _adopt_backbone(self, self.inception)
        if num_features is None:
            num_features = _tap_num_features(tap)
        if num_features is None:
            probe = torch.zeros((1, 3, 299, 299), dtype=torch.float32, device=self.device)
            num_features = int(torch.as_tensor(self.inception(probe)).shape[-1])
        self.num_features = num_features

        if not isinstance(reset_real_features, bool):
            raise ValueError("Argument `reset_real_features` expected to be a bool")
        self.reset_real_features = reset_real_features
        if not isinstance(normalize, bool):
            raise ValueError("Argument `normalize` expected to be a bool")
        self.normalize = normalize

        self._jit_accum = None  # built lazily; cached across updates
        mx = (num_features, num_features)
        self.add_state("real_features_sum", torch.zeros(num_features), dist_reduce_fx="sum")
        self.add_state("real_features_cov_sum", torch.zeros(mx), dist_reduce_fx="sum")
        self.add_state("real_features_num_samples", torch.zeros(()), dist_reduce_fx="sum")
        self.add_state("fake_features_sum", torch.zeros(num_features), dist_reduce_fx="sum")
        self.add_state("fake_features_cov_sum", torch.zeros(mx), dist_reduce_fx="sum")
        self.add_state("fake_features_num_samples", torch.zeros(()), dist_reduce_fx="sum")

    def update(self, imgs: Tensor, real: bool) -> None:
        """Extract features and accumulate first and second moments, the
        product ``fᵀf`` in full float32 (``_safe_matmul``)."""
        if self._jit_accum is None:
            inception, normalize = self.inception, self.normalize

            def accum(feat_sum, cov_sum, n, imgs):
                x = (imgs * 255).to(torch.uint8) if normalize else imgs
                f = torch.as_tensor(inception(x)).to(torch.float32)
                if f.ndim == 1:
                    f = f[None]
                ft = f.T
                return feat_sum + f.sum(dim=0), cov_sum + _safe_matmul(ft, ft), n + imgs.shape[0]

            from tpumetrics_torch.utils.jit_fallback import JitWithEagerFallback

            self._jit_accum = JitWithEagerFallback(
                accum, f"The `feature` extractor of {type(self).__name__}", key_fn=lambda: _placement_token(inception)
            )
        prefix = "real" if real else "fake"
        states = tuple(getattr(self, f"{prefix}_features_{s}") for s in ("sum", "cov_sum", "num_samples"))
        out = self._jit_accum(*states, imgs)
        for s, val in zip(("sum", "cov_sum", "num_samples"), out):
            setattr(self, f"{prefix}_features_{s}", val)

    def __getstate__(self):
        state = super().__getstate__()
        state.pop("_jit_accum", None)  # holds CUDA graphs; rebuilt lazily
        return state

    def __setstate__(self, state):
        super().__setstate__(state)
        self._jit_accum = None

    def compute(self) -> Tensor:
        """FID from the accumulated moments; the covariance is
        ``(S - n·μμᵀ) / (n - 1)`` in float32, as in the JAX package."""
        if bool(self.real_features_num_samples < 2) or bool(self.fake_features_num_samples < 2):
            raise RuntimeError("More than one sample is required for both the real and fake distributed to compute FID")
        mean_real = self.real_features_sum / self.real_features_num_samples
        mean_fake = self.fake_features_sum / self.fake_features_num_samples
        cov_real = (self.real_features_cov_sum - self.real_features_num_samples * torch.outer(mean_real, mean_real)) / (
            self.real_features_num_samples - 1
        )
        cov_fake = (self.fake_features_cov_sum - self.fake_features_num_samples * torch.outer(mean_fake, mean_fake)) / (
            self.fake_features_num_samples - 1
        )
        return _compute_fid(mean_real, cov_real, mean_fake, cov_fake)

    def reset(self) -> None:
        """Optionally keep the (expensive) real statistics."""
        if not self.reset_real_features:
            real_sum = self.real_features_sum
            real_cov = self.real_features_cov_sum
            real_n = self.real_features_num_samples
            super().reset()
            self.real_features_sum = real_sum
            self.real_features_cov_sum = real_cov
            self.real_features_num_samples = real_n
        else:
            super().reset()
