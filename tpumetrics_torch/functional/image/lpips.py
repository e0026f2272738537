"""LPIPS machinery (port of ``tpumetrics/functional/image/lpips.py``, itself
a port of richzhang/PerceptualSimilarity).

The perceptual distance is: per backbone layer, unit-normalize the feature
maps along channels, take squared differences, weight per channel, average
spatially, and sum over layers. The backbone is pluggable (any callable
returning a list of (N, C_i, H_i, W_i) feature maps), because pretrained
AlexNet/VGG weights cannot be downloaded here; the trained linear heads are
bundled (``image/_lpips_weights/lpips_heads.npz``, the JAX package's file).
Every operation is capturable: the scaling constants are filled on the
device, nothing is read on the host."""

from __future__ import annotations

import os
from functools import lru_cache
from typing import Callable, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

Tensor = torch.Tensor

# ImageNet scaling constants of the original LPIPS ScalingLayer
_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)


@lru_cache(maxsize=None)
def _load_head_file() -> dict:
    here = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    with np.load(os.path.join(here, "image", "_lpips_weights", "lpips_heads.npz")) as data:
        return dict(data)


def lpips_head_weights(net_type: str) -> List[np.ndarray]:
    """The trained LPIPS linear-head channel weights, bundled with the package.

    Converted from the reference's vendored ``lpips_models/{alex,vgg,squeeze}.pth``
    (originally richzhang/PerceptualSimilarity, BSD-2-Clause, Copyright (c)
    2018 Richard Zhang et al.). Returns one non-negative (C_i,) array per
    backbone layer.
    """
    heads = _load_head_file()
    keys = sorted((k for k in heads if k.startswith(f"{net_type}_lin")), key=lambda k: int(k.rsplit("lin", 1)[1]))
    if not keys:
        raise ValueError(f"No bundled LPIPS heads for net_type={net_type!r} (have alex/vgg/squeeze)")
    return [heads[k] for k in keys]


def resolve_lpips_net(
    net: Union[str, Callable],
    backbone_params: Optional[Sequence] = None,
    layer_weights: Optional[Sequence] = None,
    arg_name: str = "net_type",
    *,
    dtype_policy: str = "float32",
    mesh: Optional[object] = None,
    acquire: bool = False,
    device: Union[str, torch.device, None] = None,
) -> Tuple[Callable, Optional[Sequence]]:
    """Resolve a ``net`` spec into (backbone callable, layer weights).

    A string net (``alex``/``vgg``/``squeeze``) requires ``backbone_params``
    (offline-converted convs, see :mod:`tpumetrics_torch.image._backbones`)
    and defaults ``layer_weights`` to the bundled trained heads; the weights
    are placed ONCE on ``device`` through the process-global backbone
    registry, so every LPIPS instance and functional call over the same
    converted params shares one resident weight set. A callable passes
    through unchanged. Shared by the functional (``arg_name="net"``,
    ``acquire=False``) and the Metric class (``arg_name="net_type"``,
    ``acquire=True``: the metric owns a registry reference and releases it
    in ``release_backbones()``)."""
    if isinstance(net, str):
        if net not in ("alex", "vgg", "squeeze"):
            raise ValueError(f"Argument `{arg_name}` must be 'alex', 'vgg', 'squeeze' or a callable, got {net!r}")
        if backbone_params is None:
            raise ModuleNotFoundError(
                f"LPIPS with the pretrained `{net}` backbone needs its conv weights, which cannot be"
                " downloaded in an offline environment. Convert them once with torchvision (recipe in"
                " tpumetrics_torch.image._backbones) and pass them as `backbone_params`; the trained LPIPS"
                " linear heads are bundled and applied automatically. Alternatively pass a callable"
                " backbone."
            )
        if layer_weights is None:
            layer_weights = lpips_head_weights(net)
        from tpumetrics_torch.backbones.registry import get_backbone
        from tpumetrics_torch.image._backbones import _PARAM_COUNTS, _check_params

        # the wrong param count raises here, not at the first forward
        _check_params(net, backbone_params, _PARAM_COUNTS[net])
        net = get_backbone(
            f"lpips:{net}", backbone_params, dtype_policy=dtype_policy, mesh=mesh, acquire=acquire, device=device
        )
    if not callable(net):
        raise ValueError(f"Argument `{arg_name}` must be a string or a callable backbone")
    return net, layer_weights


def _normalize_tensor(in_feat: Tensor, eps: float = 1e-8) -> Tensor:
    """Unit-normalize along the channel axis (the eps inside the sqrt,
    following PerceptualSimilarity PR#114)."""
    norm_factor = torch.sqrt(eps + torch.sum(in_feat**2, dim=1, keepdim=True))
    return in_feat / norm_factor


def _spatial_average(in_tens: Tensor, keepdim: bool = True) -> Tensor:
    """Mean over the spatial dims."""
    return in_tens.mean(dim=(2, 3), keepdim=keepdim)


def _constant(values: Sequence[float], like: Tensor) -> Tensor:
    """``values`` as a (1, C, 1, 1) float32 tensor on ``like``'s device, made
    by fills (no host copy, so a capture can record it)."""
    return torch.cat([torch.full((1,), v, dtype=torch.float32, device=like.device) for v in values]).reshape(1, -1, 1, 1)


def _scaling_layer(x: Tensor) -> Tensor:
    return (x - _constant(_SHIFT, x)) / _constant(_SCALE, x)


def learned_perceptual_image_patch_similarity(
    img1: Tensor,
    img2: Tensor,
    net: Union[str, Callable[[Tensor], Sequence[Tensor]]] = "alex",
    layer_weights: Optional[Sequence[Tensor]] = None,
    normalize: bool = False,
    reduction: str = "mean",
    backbone_params: Optional[Sequence[Tuple[Tensor, Tensor]]] = None,
) -> Tensor:
    """LPIPS distance between two image batches given a feature backbone.

    Args:
        img1 / img2: (N, 3, H, W) images in [-1, 1] (or [0, 1] with
            ``normalize=True``).
        net: callable returning the list of per-layer feature maps, OR one of
            ``"alex"``/``"vgg"``/``"squeeze"``: then ``backbone_params``
            (conv weights converted offline, see
            :mod:`tpumetrics_torch.image._backbones`) must be given, and the
            bundled trained linear heads are applied automatically; the
            weights are placed on ``img1``'s device.
        layer_weights: optional per-layer channel weights (C_i,): the
            trained linear heads of the original LPIPS; uniform weighting
            (the paper's "baseline" variant) otherwise. Defaults to the
            bundled trained heads when ``net`` is a string.
        reduction: ``mean``, ``sum`` or ``none`` (per-image values) over the batch.
        backbone_params: converted conv ``(weight, bias)`` pairs for a string
            ``net`` (torch OIHW layout).

    Example:
        >>> import torch
        >>> from tpumetrics_torch.functional.image import learned_perceptual_image_patch_similarity
        >>> def toy_net(x):
        ...     return [x[:, :, ::2, ::2], x.mean(dim=1, keepdim=True)]
        >>> g = torch.Generator().manual_seed(0)
        >>> img1 = torch.rand(2, 3, 16, 16, generator=g) * 2 - 1
        >>> img2 = torch.rand(2, 3, 16, 16, generator=g) * 2 - 1
        >>> float(learned_perceptual_image_patch_similarity(img1, img2, toy_net)) > 0
        True
    """
    net, layer_weights = resolve_lpips_net(net, backbone_params, layer_weights, arg_name="net", device=img1.device)

    if normalize:  # [0,1] -> [-1,1]
        img1 = 2 * img1 - 1
        img2 = 2 * img2 - 1

    feats1: List[Tensor] = net(_scaling_layer(img1))
    feats2: List[Tensor] = net(_scaling_layer(img2))
    if len(feats1) != len(feats2):
        raise ValueError("Backbone returned different numbers of feature maps for the two inputs")

    total: Tensor = torch.zeros((img1.shape[0], 1, 1, 1), device=img1.device)
    for layer_idx, (f1, f2) in enumerate(zip(feats1, feats2)):
        d = (_normalize_tensor(f1) - _normalize_tensor(f2)) ** 2
        if layer_weights is not None:
            w = torch.as_tensor(layer_weights[layer_idx], device=d.device).reshape(1, -1, 1, 1)
            d = d * w
            total = total + _spatial_average(d.sum(dim=1, keepdim=True), keepdim=True)
        else:
            total = total + _spatial_average(d.mean(dim=1, keepdim=True), keepdim=True)

    per_image = total.reshape(-1)
    if reduction == "mean":
        return per_image.mean()
    if reduction == "sum":
        return per_image.sum()
    if reduction in ("none", None):
        return per_image
    raise ValueError(f"Argument `reduction` must be 'mean', 'sum' or 'none', got {reduction}")
