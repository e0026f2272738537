"""LPIPS feature backbones in torch (port of ``tpumetrics/image/_backbones.py``).

The LPIPS metric needs the feature stacks of AlexNet / VGG-16 /
SqueezeNet-1.1 sliced at specific ReLUs (a port of
richzhang/PerceptualSimilarity, BSD-2-Clause). Pretrained ImageNet weights
cannot be downloaded here, so these forwards take the convolution
parameters as data: a flat list of ``(weight, bias)`` pairs in torch's OIHW
layout, which a user converts offline from torchvision with::

    feats = torchvision.models.alexnet(weights="IMAGENET1K_V1").features
    params = [(m.weight.detach().numpy(), m.bias.detach().numpy())
              for m in feats.modules() if isinstance(m, torch.nn.Conv2d)]

(for SqueezeNet each Fire module contributes its squeeze / expand1x1 /
expand3x3 convs, in that order: the order ``Conv2d`` modules appear in
``features.modules()``). :func:`lpips_conv_params` carries such a list (the
JAX package's numpy pairs) to tensors on a device.

Under the ``float32`` policy every convolution runs in full float32
(``_ieee_float32``), never TF32, whatever ``cudnn.allow_tf32`` says.
"""

from __future__ import annotations

from typing import Callable, List, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from tpumetrics_torch.utils.compute import _ieee_float32

Tensor = torch.Tensor
ConvParams = Tuple[Tensor, Tensor]

# per-layer feature channels each backbone must emit: the bundled LPIPS
# heads (lpips_head_weights) are trained against exactly these widths
LPIPS_CHANNELS = {
    "alex": [64, 192, 384, 256, 256],
    "vgg": [64, 128, 256, 512, 512],
    "squeeze": [64, 128, 256, 384, 384, 512, 512],
}
_PARAM_COUNTS = {"alex": 5, "vgg": 13, "squeeze": 25}


def _conv(x: Tensor, wb: ConvParams, stride: int = 1, padding: int = 0) -> Tensor:
    w, b = wb
    # params normally arrive in the forward's dtype (the backbone registry
    # casts the whole tree once at placement); the casts only act for
    # direct callers with mismatched params
    if w.dtype != x.dtype:
        w = w.to(x.dtype)
    if b.dtype != x.dtype:
        b = b.to(x.dtype)
    return F.conv2d(x, w, stride=stride, padding=padding) + b.reshape(1, -1, 1, 1)


def _maxpool(x: Tensor, kernel: int = 3, stride: int = 2, ceil_mode: bool = False) -> Tensor:
    """``MaxPool2d(kernel, stride)``; ``ceil_mode`` counts the partial windows
    at the bottom/right edge (SqueezeNet uses ceil_mode=True)."""
    return F.max_pool2d(x, kernel, stride=stride, ceil_mode=ceil_mode)


def _check_params(net_type: str, params: Sequence, expected: int) -> None:
    if len(params) != expected:
        raise ValueError(
            f"LPIPS `{net_type}` backbone expects {expected} (weight, bias) conv-parameter pairs"
            f" in torch Conv2d order, got {len(params)}"
        )


def _full_float32(forward: Callable[[Tensor], List[Tensor]]) -> Callable[[Tensor], List[Tensor]]:
    def wrapped(x: Tensor) -> List[Tensor]:
        with _ieee_float32(torch.backends.cudnn.conv, torch.backends.mkldnn.conv):
            return forward(x)

    return wrapped


def alexnet_features(params: Sequence[ConvParams]) -> Callable[[Tensor], List[Tensor]]:
    """AlexNet feature stack sliced at the 5 LPIPS ReLUs."""
    _check_params("alex", params, 5)

    def forward(x: Tensor) -> List[Tensor]:
        outs = []
        h = torch.relu(_conv(x, params[0], stride=4, padding=2))
        outs.append(h)  # relu1 (64)
        h = torch.relu(_conv(_maxpool(h), params[1], padding=2))
        outs.append(h)  # relu2 (192)
        h = torch.relu(_conv(_maxpool(h), params[2], padding=1))
        outs.append(h)  # relu3 (384)
        h = torch.relu(_conv(h, params[3], padding=1))
        outs.append(h)  # relu4 (256)
        h = torch.relu(_conv(h, params[4], padding=1))
        outs.append(h)  # relu5 (256)
        return outs

    return _full_float32(forward)


def vgg16_features(params: Sequence[ConvParams]) -> Callable[[Tensor], List[Tensor]]:
    """VGG-16 feature stack sliced at relu{1_2,2_2,3_3,4_3,5_3}."""
    _check_params("vgg", params, 13)
    # conv counts per slice; a maxpool precedes every slice but the first
    blocks = [2, 2, 3, 3, 3]

    def forward(x: Tensor) -> List[Tensor]:
        outs = []
        h = x
        idx = 0
        for block_i, n_convs in enumerate(blocks):
            if block_i:
                h = _maxpool(h, kernel=2, stride=2)
            for _ in range(n_convs):
                h = torch.relu(_conv(h, params[idx], padding=1))
                idx += 1
            outs.append(h)
        return outs

    return _full_float32(forward)


def squeezenet_features(params: Sequence[ConvParams]) -> Callable[[Tensor], List[Tensor]]:
    """SqueezeNet-1.1 feature stack sliced at the 7 LPIPS points.

    ``params``: conv0 then 8 Fire modules x (squeeze, expand1x1, expand3x3) = 25 pairs.
    """
    _check_params("squeeze", params, 25)

    def fire(h: Tensor, base: int) -> Tensor:
        s = torch.relu(_conv(h, params[base]))
        e1 = torch.relu(_conv(s, params[base + 1]))
        e3 = torch.relu(_conv(s, params[base + 2], padding=1))
        return torch.cat([e1, e3], dim=1)

    def forward(x: Tensor) -> List[Tensor]:
        outs = []
        h = torch.relu(_conv(x, params[0], stride=2))
        outs.append(h)  # relu1 (64)
        h = _maxpool(h, ceil_mode=True)
        h = fire(h, 1)
        h = fire(h, 4)
        outs.append(h)  # relu2 (128)
        h = _maxpool(h, ceil_mode=True)
        h = fire(h, 7)
        h = fire(h, 10)
        outs.append(h)  # relu3 (256)
        h = _maxpool(h, ceil_mode=True)
        h = fire(h, 13)
        outs.append(h)  # relu4 (384)
        h = fire(h, 16)
        outs.append(h)  # relu5 (384)
        h = fire(h, 19)
        outs.append(h)  # relu6 (512)
        h = fire(h, 22)
        outs.append(h)  # relu7 (512)
        return outs

    return _full_float32(forward)


_BACKBONE_BUILDERS = {
    "alex": alexnet_features,
    "vgg": vgg16_features,
    "squeeze": squeezenet_features,
}


def lpips_backbone(net_type: str, params: Sequence[ConvParams]) -> Callable[[Tensor], List[Tensor]]:
    """Build the named LPIPS backbone forward from converted conv parameters."""
    if net_type not in _BACKBONE_BUILDERS:
        raise ValueError(f"Argument `net_type` must be one of {tuple(_BACKBONE_BUILDERS)}, got {net_type}")
    return _BACKBONE_BUILDERS[net_type](params)


def lpips_param_spec(net_type: str) -> List[Tuple[Tuple[int, int, int, int], Tuple[int]]]:
    """The ``(weight, bias)`` shapes of a backbone's convolutions, in torch Conv2d order."""
    if net_type == "alex":
        convs = [(64, 3, 11), (192, 64, 5), (384, 192, 3), (256, 384, 3), (256, 256, 3)]
    elif net_type == "vgg":
        widths = [3, 64, 64, 128, 128, 256, 256, 256, 512, 512, 512, 512, 512, 512]
        convs = [(widths[i + 1], widths[i], 3) for i in range(13)]
    elif net_type == "squeeze":
        convs, cin = [(64, 3, 3)], 64
        for squeeze, expand in [(16, 64), (16, 64), (32, 128), (32, 128), (48, 192), (48, 192), (64, 256), (64, 256)]:
            convs += [(squeeze, cin, 1), (expand, squeeze, 1), (expand, squeeze, 3)]
            cin = 2 * expand
    else:
        raise ValueError(f"Argument `net_type` must be one of {tuple(_BACKBONE_BUILDERS)}, got {net_type}")
    return [((cout, cin, k, k), (cout,)) for cout, cin, k in convs]


def random_lpips_params(net_type: str, seed: int = 0) -> List[Tuple[np.ndarray, np.ndarray]]:
    """Random-but-stable float32 conv parameters of a backbone (He-scaled
    weights, small biases), for runs without the pretrained convs."""
    rng = np.random.default_rng(seed)
    out = []
    for w_shape, b_shape in lpips_param_spec(net_type):
        fan_in = int(np.prod(w_shape[1:]))
        w = (rng.standard_normal(w_shape) * np.sqrt(2.0 / fan_in)).astype(np.float32)
        out.append((w, (0.01 * rng.standard_normal(b_shape)).astype(np.float32)))
    return out


def lpips_conv_params(
    params: Sequence[Tuple["np.ndarray", "np.ndarray"]],
    device: Union[str, torch.device],
    dtype: torch.dtype = torch.float32,
) -> List[ConvParams]:
    """Carry a backbone's ``(weight, bias)`` OIHW pairs across: the JAX
    package's numpy pairs to tensors on ``device`` in ``dtype``."""
    return [
        tuple(torch.as_tensor(np.asarray(t)).to(device=device, dtype=dtype, copy=True) for t in pair)
        for pair in params
    ]
