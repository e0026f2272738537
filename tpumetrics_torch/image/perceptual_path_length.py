"""PerceptualPathLength (port of ``tpumetrics/image/perceptual_path_length.py``)."""

from __future__ import annotations

import math
from typing import Any, Callable, Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F

from tpumetrics_torch.functional.image.lpips import learned_perceptual_image_patch_similarity, resolve_lpips_net
from tpumetrics_torch.metric import Metric

Tensor = torch.Tensor


def _interpolate(
    latents1: Tensor, latents2: Tensor, epsilon: Union[float, Tensor], interpolation_method: str
) -> Tensor:
    """Lerp/slerp the fraction-``epsilon`` point on the latents1->latents2
    path; ``epsilon`` may be a per-sample (B, 1) tensor."""
    eps = epsilon
    if interpolation_method == "lerp":
        return latents1 + (latents2 - latents1) * eps
    if interpolation_method in ("slerp_any", "slerp_unit"):
        ndims = tuple(range(1, latents1.ndim))
        unit1 = latents1 / torch.linalg.vector_norm(latents1, dim=ndims, keepdim=True)
        unit2 = latents2 / torch.linalg.vector_norm(latents2, dim=ndims, keepdim=True)
        cos = torch.sum(unit1 * unit2, dim=ndims, keepdim=True)
        omega = torch.arccos(torch.clamp(cos, -1 + 1e-7, 1 - 1e-7))
        so = torch.sin(omega)
        res = (torch.sin((1.0 - eps) * omega) / so) * latents1 + (torch.sin(eps * omega) / so) * latents2
        if interpolation_method == "slerp_unit":
            res = res / torch.linalg.vector_norm(res, dim=ndims, keepdim=True)
        return res
    raise ValueError(f"Interpolation method {interpolation_method} not supported.")


def _resize(img: Tensor, size: int) -> Tensor:
    """Half-pixel bilinear resize, antialiased when it shrinks: the
    counterpart of ``jax.image.resize(..., "bilinear")``."""
    return F.interpolate(img, size=(size, size), mode="bilinear", align_corners=False, antialias=True)


def _ppl_step(
    generator: Callable[[Tensor], Tensor],
    z1: Tensor,
    z2: Tensor,
    t: Tensor,
    epsilon: float,
    interpolation_method: str,
    resize: Optional[int],
    sim_net: Callable,
    layer_weights: Optional[Sequence],
) -> Tensor:
    """One batch of paths: the LPIPS distance of the images at ``t`` and
    ``t + epsilon`` on each z1->z2 path, over epsilon²."""
    img1 = generator(_interpolate(z1, z2, t, interpolation_method))
    img2 = generator(_interpolate(z1, z2, t + epsilon, interpolation_method))
    if resize is not None:
        img1 = _resize(img1, resize)
        img2 = _resize(img2, resize)
    per_pair = learned_perceptual_image_patch_similarity(img1, img2, sim_net, layer_weights, reduction="none")
    return per_pair / (epsilon**2)


def _discard(
    dist: Tensor, lower_discard: Optional[float], upper_discard: Optional[float]
) -> Tuple[Tensor, Tensor]:
    """Mean and std of the distances between the two quantiles (inclusive),
    computed on the device with no host read."""
    if lower_discard is None and upper_discard is None:
        return dist.mean(), dist.std(correction=0)
    lo = torch.quantile(dist, lower_discard) if lower_discard is not None else -math.inf
    hi = torch.quantile(dist, upper_discard) if upper_discard is not None else math.inf
    mask = (dist >= lo) & (dist <= hi)
    kept = torch.where(mask, dist, 0.0)
    n = torch.clamp(mask.sum(), min=1)
    mean = kept.sum() / n
    std = torch.sqrt(torch.where(mask, (dist - mean) ** 2, 0.0).sum() / n)
    return mean, std


def perceptual_path_length(
    generator: Callable[[Tensor], Tensor],
    num_samples: int = 10_000,
    conditional: bool = False,
    batch_size: int = 64,
    interpolation_method: str = "lerp",
    epsilon: float = 1e-4,
    resize: Optional[int] = 64,
    lower_discard: Optional[float] = 0.01,
    upper_discard: Optional[float] = 0.99,
    sim_net: Optional[Union[str, Callable]] = None,
    latent_dim: int = 128,
    key: Optional[torch.Generator] = None,
    backbone_params: Optional[Sequence] = None,
) -> Tuple[Tensor, Tensor, Tensor]:
    """PPL (Karras et al. 2019): LPIPS distance between images generated from
    epsilon-separated latents, scaled by 1/eps², with percentile discarding.

    ``generator`` maps latent batches to image batches; ``sim_net`` is the
    perceptual backbone: a callable feature stack, or one of
    ``"alex"``/``"vgg"``/``"squeeze"`` with the offline-converted conv
    weights passed as ``backbone_params`` (resolved through the shared
    backbone registry, as LPIPS itself). ``key`` is a ``torch.Generator``;
    the latents are drawn from it on its device (z1, z2 and t for each batch,
    in that order). Without one, a generator on the current card seeded 0
    is used, as the JAX package uses ``PRNGKey(0)``.

    Returns (mean, std, per-pair distances).
    """
    if sim_net is None:
        raise ModuleNotFoundError(
            "perceptual_path_length requires a perceptual backbone: pass `sim_net` (see"
            " LearnedPerceptualImagePatchSimilarity: the pretrained default is unavailable here)."
        )
    if key is None:
        from tpumetrics_torch.metric import _resolve_device

        key = torch.Generator(device=_resolve_device(None)).manual_seed(0)
    device = key.device
    layer_weights = None
    if isinstance(sim_net, str):
        sim_net, layer_weights = resolve_lpips_net(sim_net, backbone_params, None, arg_name="sim_net", device=device)
        layer_weights = [torch.as_tensor(w, device=device) for w in layer_weights]
    if conditional:
        raise NotImplementedError(
            "Conditional PPL (sampling labels alongside latents) is not implemented;"
            " evaluate with conditional=False or close over fixed labels in `generator`."
        )
    distances = []
    num_batches = -(-num_samples // batch_size)  # ceil: sample at least num_samples
    for _ in range(num_batches):
        z1 = torch.randn((batch_size, latent_dim), generator=key, device=device)
        z2 = torch.randn((batch_size, latent_dim), generator=key, device=device)
        # sample t ~ U[0,1) per path and measure the segment t -> t+epsilon
        # ON the z1->z2 path (Karras et al. 2019)
        t = torch.rand((batch_size, 1), generator=key, device=device)
        distances.append(
            _ppl_step(generator, z1, z2, t, epsilon, interpolation_method, resize, sim_net, layer_weights)
        )
    dist = torch.cat(distances)[:num_samples]
    mean, std = _discard(dist, lower_discard, upper_discard)
    return mean, std, dist


class PerceptualPathLength(Metric):
    """PPL as a metric object: ``update`` registers the generator, which
    ``compute`` samples (the reference's design, where the metric owns the
    sampling loop). The latents come from a ``torch.Generator`` on the
    metric's device seeded 0 at every ``compute``.

    Example:
        >>> import torch
        >>> from tpumetrics_torch.image import PerceptualPathLength
        >>> def generator(z):
        ...     img = torch.tanh(z[:, :48].reshape(z.shape[0], 3, 4, 4))
        ...     return img.repeat_interleave(4, dim=2).repeat_interleave(4, dim=3)
        >>> def sim_net(x):  # toy perceptual feature stack
        ...     return [x[:, :, ::2, ::2], torch.tanh(x).mean(dim=1, keepdim=True)]
        >>> metric = PerceptualPathLength(num_samples=8, batch_size=8, sim_net=sim_net,
        ...                               resize=None, latent_dim=64, device="cpu")
        >>> metric.update(generator)
        >>> mean, std, dist = metric.compute()
        >>> bool(torch.isfinite(mean)), tuple(dist.shape)
        (True, (8,))
    """

    is_differentiable: bool = False
    higher_is_better: bool = False
    full_state_update: bool = False

    def __init__(
        self,
        num_samples: int = 10_000,
        conditional: bool = False,
        batch_size: int = 128,
        interpolation_method: str = "lerp",
        epsilon: float = 1e-4,
        resize: Optional[int] = 64,
        lower_discard: Optional[float] = 0.01,
        upper_discard: Optional[float] = 0.99,
        sim_net: Optional[Union[str, Callable]] = None,
        latent_dim: int = 128,
        backbone_params: Optional[Sequence] = None,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        self.num_samples = num_samples
        self.conditional = conditional
        self.batch_size = batch_size
        self.interpolation_method = interpolation_method
        self.epsilon = epsilon
        self.resize = resize
        self.lower_discard = lower_discard
        self.upper_discard = upper_discard
        self.sim_net = sim_net
        self.backbone_params = backbone_params
        if isinstance(sim_net, str):
            # acquire the shared registry handle up front so this instance
            # owns a reference (released by release_backbones()); compute()
            # re-resolves against the same resident handle
            handle, _ = resolve_lpips_net(
                sim_net, backbone_params, None, arg_name="sim_net", acquire=True, device=self.device
            )
            self._backbone_handles = (handle,)
            self.backbone_key = handle.key
        self.latent_dim = latent_dim
        self._generator: Optional[Callable] = None
        self.add_state("dummy", torch.zeros(()), dist_reduce_fx="sum")

    def update(self, generator: Callable[[Tensor], Tensor]) -> None:
        """Register the generator to be path-sampled at compute."""
        self._generator = generator

    def compute(self) -> Tuple[Tensor, Tensor, Tensor]:
        if self._generator is None:
            raise RuntimeError("No generator registered; call update(generator) first.")
        return perceptual_path_length(
            self._generator,
            num_samples=self.num_samples,
            conditional=self.conditional,
            batch_size=self.batch_size,
            interpolation_method=self.interpolation_method,
            epsilon=self.epsilon,
            resize=self.resize,
            lower_discard=self.lower_discard,
            upper_discard=self.upper_discard,
            sim_net=self.sim_net,
            latent_dim=self.latent_dim,
            key=torch.Generator(device=self.device).manual_seed(0),
            backbone_params=self.backbone_params,
        )
