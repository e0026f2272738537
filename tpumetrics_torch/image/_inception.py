"""FID InceptionV3 feature extractor in torch (port of
``tpumetrics/image/_inception.py``).

The reference's default feature extractor for FID/KID/IS/MiFID is the
TF-ported "pt_inception-2015-12-05" network, whose quirks define the metric:

- the **TF1-compatible bilinear resize** to 299x299 (``src = dst * in/out``,
  *no* half-pixel offset; ``F.interpolate`` is not this), ported here as the
  JAX package's gather-and-lerp;
- ``(x - 128) / 128`` input scaling from uint8;
- torchvision's InceptionV3 topology with the FID deviations: the pooling
  branches of the A/C/E_1 blocks average with ``count_include_pad=False``,
  and ``Mixed_7c`` (E_2) pools with **max**;
- inference BN folded to a scale and shift in the weights' dtype with eps
  1e-3, as the JAX forward folds it (not ``F.batch_norm``, so the roundings
  line up);
- feature taps ``64`` / ``192`` / ``768`` / ``2048`` / ``logits_unbiased``
  / ``logits`` (1008 classes).

Pretrained weights are not bundled and cannot be downloaded, so the forward
takes its parameters as data: a flat ``{torch_state_dict_key: array}``
mapping converted offline from the reference's checkpoint with::

    python -m tpumetrics_torch.image._inception_convert pt_inception-2015-12-05-6726825d.pth inception.npz

:func:`inception_v3_features` runs the forward over such a mapping of
tensors (what the backbone registry places); :class:`InceptionV3` is the
same network as an ``nn.Module`` whose ``state_dict`` keys are the file's
keys, and :func:`inception_module` carries a parameter dict (the JAX
package's numpy arrays) to it on a device. Under the ``float32`` policy every
convolution runs in full float32 (``_ieee_float32``), never TF32, and the
logits' product in full float32 (``_safe_matmul``). With ``bfloat16`` weights
a floating batch (which the engine casts to bfloat16) runs its convolutions
in bfloat16, on the tensor cores, and everything between them (the resize,
the BN, the pools) in float32; a uint8 batch runs float32 convolutions over
the rounded weights, as the JAX forward does. Every operation is
capturable: the resize tables are made on the device, nothing is read on
the host.
"""

from __future__ import annotations

import hashlib
import os
from typing import Callable, Dict, List, Mapping, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from tpumetrics_torch.utils.compute import _ieee_float32, _safe_matmul

Tensor = torch.Tensor

INPUT_IMAGE_SIZE = 299
NUM_CLASSES = 1008
VALID_INT_FEATURES = (64, 192, 768, 2048)
VALID_STR_FEATURES = ("logits_unbiased", "logits")
_BN_EPS = 1e-3


# ------------------------------------------------------------ architecture
# every BasicConv2d as (name, in_ch, out_ch, (kh, kw), stride, (ph, pw));
# block topology mirrors torch-fidelity's FeatureExtractorInceptionV3


def _inception_a(name: str, in_ch: int, pool_features: int):
    return [
        (f"{name}.branch1x1", in_ch, 64, (1, 1), 1, (0, 0)),
        (f"{name}.branch5x5_1", in_ch, 48, (1, 1), 1, (0, 0)),
        (f"{name}.branch5x5_2", 48, 64, (5, 5), 1, (2, 2)),
        (f"{name}.branch3x3dbl_1", in_ch, 64, (1, 1), 1, (0, 0)),
        (f"{name}.branch3x3dbl_2", 64, 96, (3, 3), 1, (1, 1)),
        (f"{name}.branch3x3dbl_3", 96, 96, (3, 3), 1, (1, 1)),
        (f"{name}.branch_pool", in_ch, pool_features, (1, 1), 1, (0, 0)),
    ]


def _inception_b(name: str, in_ch: int):
    return [
        (f"{name}.branch3x3", in_ch, 384, (3, 3), 2, (0, 0)),
        (f"{name}.branch3x3dbl_1", in_ch, 64, (1, 1), 1, (0, 0)),
        (f"{name}.branch3x3dbl_2", 64, 96, (3, 3), 1, (1, 1)),
        (f"{name}.branch3x3dbl_3", 96, 96, (3, 3), 2, (0, 0)),
    ]


def _inception_c(name: str, in_ch: int, c7: int):
    return [
        (f"{name}.branch1x1", in_ch, 192, (1, 1), 1, (0, 0)),
        (f"{name}.branch7x7_1", in_ch, c7, (1, 1), 1, (0, 0)),
        (f"{name}.branch7x7_2", c7, c7, (1, 7), 1, (0, 3)),
        (f"{name}.branch7x7_3", c7, 192, (7, 1), 1, (3, 0)),
        (f"{name}.branch7x7dbl_1", in_ch, c7, (1, 1), 1, (0, 0)),
        (f"{name}.branch7x7dbl_2", c7, c7, (7, 1), 1, (3, 0)),
        (f"{name}.branch7x7dbl_3", c7, c7, (1, 7), 1, (0, 3)),
        (f"{name}.branch7x7dbl_4", c7, c7, (7, 1), 1, (3, 0)),
        (f"{name}.branch7x7dbl_5", c7, 192, (1, 7), 1, (0, 3)),
        (f"{name}.branch_pool", in_ch, 192, (1, 1), 1, (0, 0)),
    ]


def _inception_d(name: str, in_ch: int):
    return [
        (f"{name}.branch3x3_1", in_ch, 192, (1, 1), 1, (0, 0)),
        (f"{name}.branch3x3_2", 192, 320, (3, 3), 2, (0, 0)),
        (f"{name}.branch7x7x3_1", in_ch, 192, (1, 1), 1, (0, 0)),
        (f"{name}.branch7x7x3_2", 192, 192, (1, 7), 1, (0, 3)),
        (f"{name}.branch7x7x3_3", 192, 192, (7, 1), 1, (3, 0)),
        (f"{name}.branch7x7x3_4", 192, 192, (3, 3), 2, (0, 0)),
    ]


def _inception_e(name: str, in_ch: int):
    return [
        (f"{name}.branch1x1", in_ch, 320, (1, 1), 1, (0, 0)),
        (f"{name}.branch3x3_1", in_ch, 384, (1, 1), 1, (0, 0)),
        (f"{name}.branch3x3_2a", 384, 384, (1, 3), 1, (0, 1)),
        (f"{name}.branch3x3_2b", 384, 384, (3, 1), 1, (1, 0)),
        (f"{name}.branch3x3dbl_1", in_ch, 448, (1, 1), 1, (0, 0)),
        (f"{name}.branch3x3dbl_2", 448, 384, (3, 3), 1, (1, 1)),
        (f"{name}.branch3x3dbl_3a", 384, 384, (1, 3), 1, (0, 1)),
        (f"{name}.branch3x3dbl_3b", 384, 384, (3, 1), 1, (1, 0)),
        (f"{name}.branch_pool", in_ch, 192, (1, 1), 1, (0, 0)),
    ]


_CONV_SPECS: List[Tuple[str, int, int, Tuple[int, int], int, Tuple[int, int]]] = [
    ("Conv2d_1a_3x3", 3, 32, (3, 3), 2, (0, 0)),
    ("Conv2d_2a_3x3", 32, 32, (3, 3), 1, (0, 0)),
    ("Conv2d_2b_3x3", 32, 64, (3, 3), 1, (1, 1)),
    ("Conv2d_3b_1x1", 64, 80, (1, 1), 1, (0, 0)),
    ("Conv2d_4a_3x3", 80, 192, (3, 3), 1, (0, 0)),
    *_inception_a("Mixed_5b", 192, 32),
    *_inception_a("Mixed_5c", 256, 64),
    *_inception_a("Mixed_5d", 288, 64),
    *_inception_b("Mixed_6a", 288),
    *_inception_c("Mixed_6b", 768, 128),
    *_inception_c("Mixed_6c", 768, 160),
    *_inception_c("Mixed_6d", 768, 160),
    *_inception_c("Mixed_6e", 768, 192),
    *_inception_d("Mixed_7a", 768),
    *_inception_e("Mixed_7b", 1280),
    *_inception_e("Mixed_7c", 2048),
]
_PLAN = {name: (k, s, pad) for name, _ci, _co, k, s, pad in _CONV_SPECS}
_TAPS = tuple(str(f) for f in VALID_INT_FEATURES) + VALID_STR_FEATURES


def inception_param_spec() -> Dict[str, Tuple[int, ...]]:
    """``{torch_state_dict_key: shape}`` for every parameter of the network."""
    spec: Dict[str, Tuple[int, ...]] = {}
    for name, cin, cout, (kh, kw), _stride, _pad in _CONV_SPECS:
        spec[f"{name}.conv.weight"] = (cout, cin, kh, kw)
        spec[f"{name}.bn.weight"] = (cout,)
        spec[f"{name}.bn.bias"] = (cout,)
        spec[f"{name}.bn.running_mean"] = (cout,)
        spec[f"{name}.bn.running_var"] = (cout,)
    spec["fc.weight"] = (NUM_CLASSES, 2048)
    spec["fc.bias"] = (NUM_CLASSES,)
    return spec


def random_inception_params(seed: int = 0) -> Dict[str, np.ndarray]:
    """Random-but-stable parameters (BN stats kept benign so activations stay
    O(1) through the 94-conv stack): the JAX package's draws, bit for bit."""
    rng = np.random.default_rng(seed)
    params: Dict[str, np.ndarray] = {}
    for key, shape in inception_param_spec().items():
        if key.endswith("conv.weight") or key == "fc.weight":
            fan_in = int(np.prod(shape[1:]))
            params[key] = (rng.standard_normal(shape) / np.sqrt(fan_in)).astype(np.float32)
        elif key.endswith("running_var"):
            params[key] = rng.uniform(0.5, 1.5, shape).astype(np.float32)
        elif key.endswith("bn.weight"):
            params[key] = (1.0 + 0.1 * rng.standard_normal(shape)).astype(np.float32)
        else:  # bn.bias / running_mean / fc.bias
            params[key] = (0.1 * rng.standard_normal(shape)).astype(np.float32)
    return params


def check_inception_params(params: Mapping[str, "np.ndarray"]) -> None:
    spec = inception_param_spec()
    missing = sorted(set(spec) - set(params))
    if missing:
        raise ValueError(
            f"InceptionV3 parameters are missing {len(missing)} entries, e.g. {missing[:4]};"
            " convert the reference checkpoint with"
            " `python -m tpumetrics_torch.image._inception_convert <pt_inception.pth> <out.npz>`."
        )
    for key, shape in spec.items():
        got = tuple(params[key].shape)
        if got != shape:
            raise ValueError(f"InceptionV3 parameter `{key}` has shape {got}, expected {shape}")


_PARAMS_CACHE: Dict[Tuple[str, float], Dict[str, np.ndarray]] = {}


def load_inception_params(path: str) -> Dict[str, np.ndarray]:
    """Load a converted ``.npz`` parameter file (see ``_inception_convert``).

    Cached per (absolute path, mtime) as HOST numpy arrays: device residency
    belongs to the backbone registry (:mod:`tpumetrics_torch.backbones`),
    which places exactly one copy per (weights, device, dtype policy) however
    many FID/KID/IS instances load the same file. Treat the returned mapping
    as read-only.
    """
    key = (os.path.abspath(path), os.path.getmtime(path))
    if key in _PARAMS_CACHE:
        return _PARAMS_CACHE[key]
    with np.load(path) as data:
        params = {k: np.asarray(data[k]) for k in data.files}
    check_inception_params(params)
    _PARAMS_CACHE.clear()  # keep at most one weight set cached
    _PARAMS_CACHE[key] = params
    return params


def _inception_weights_key(path: str) -> str:
    """Registry weights identity for a converted checkpoint file: a hash of
    the (absolute path, mtime) pair stands in for digesting the ~95 MB tree."""
    return hashlib.sha1(f"{os.path.abspath(path)}:{os.path.getmtime(path)}".encode()).hexdigest()


# ---------------------------------------------------------------- kernels


def tf1_bilinear_resize(x: Tensor, size: Tuple[int, int]) -> Tensor:
    """TF1 ``resize_bilinear(align_corners=False)`` on NCHW input.

    The source coordinate is ``dst * (in / out)``, the legacy TF1 projection
    with no half-pixel offset (what torch-fidelity's
    ``interpolate_bilinear_2d_like_tensorflow1x`` replicates and FID scores
    depend on). Gather and lerp per axis, the tables made on the input's
    device in its floating dtype (float32 for integer input).
    """
    out_h, out_w = size
    _, _, in_h, in_w = x.shape
    dtype = x.dtype if x.is_floating_point() else torch.float32

    def axis_tables(in_size: int, out_size: int):
        scale = in_size / out_size
        src = torch.arange(out_size, dtype=dtype, device=x.device) * scale
        lo = torch.floor(src).to(torch.int64).clamp(0, in_size - 1)
        hi = torch.clamp(lo + 1, max=in_size - 1)
        frac = src - lo.to(dtype)
        return lo, hi, frac

    h_lo, h_hi, h_frac = axis_tables(in_h, out_h)
    w_lo, w_hi, w_frac = axis_tables(in_w, out_w)

    x = x.to(dtype)
    top = x.index_select(2, h_lo)
    bottom = x.index_select(2, h_hi)
    rows = top + (bottom - top) * h_frac[None, None, :, None]
    left = rows.index_select(3, w_lo)
    right = rows.index_select(3, w_hi)
    return left + (right - left) * w_frac[None, None, None, :]


def _avgpool3_no_pad_count(x: Tensor) -> Tensor:
    """``avg_pool2d(kernel=3, stride=1, padding=1, count_include_pad=False)``:
    the FID-variant pooling in the A/C/E_1 blocks."""
    return F.avg_pool2d(x, 3, stride=1, padding=1, count_include_pad=False)


def _maxpool3(x: Tensor, stride: int, padding: int = 0) -> Tensor:
    return F.max_pool2d(x, 3, stride=stride, padding=padding)


def _global_avgpool(x: Tensor) -> Tensor:
    return torch.mean(x, dim=(2, 3))


class _Net:
    """Bound parameters + per-BasicConv2d conv -> folded BN -> relu. The
    convolutions run in ``compute``; their inputs and outputs, the BN, the
    pools and the concatenations stay in the activations' dtype."""

    def __init__(self, params: Mapping[str, Tensor], compute: torch.dtype):
        self.p = params
        self.compute = compute

    def conv(self, x: Tensor, name: str) -> Tensor:
        kernel, stride, (ph, pw) = _PLAN[name]
        w = self.p[f"{name}.conv.weight"]
        if w.dtype != self.compute:
            # uint8 input or direct callers: registry-placed params arrive in the policy dtype
            w = w.to(self.compute)
        out = F.conv2d(x.to(self.compute), w, stride=stride, padding=(ph, pw)).to(x.dtype)
        # inference BN folded to a scale and shift in the weights' dtype (float32 for bfloat16 weights), as the
        # JAX forward folds it
        bn = [self.p[f"{name}.bn.{k}"] for k in ("weight", "bias", "running_mean", "running_var")]
        fold = torch.promote_types(bn[0].dtype, torch.float32)
        gamma, beta, mean, var = (t.to(fold) for t in bn)
        scale = (gamma / torch.sqrt(var + _BN_EPS)).to(x.dtype).reshape(1, -1, 1, 1)
        shift = (beta - gamma * mean / torch.sqrt(var + _BN_EPS)).to(x.dtype).reshape(1, -1, 1, 1)
        return torch.relu(out * scale + shift)

    def block_a(self, x: Tensor, name: str) -> Tensor:
        b1 = self.conv(x, f"{name}.branch1x1")
        b5 = self.conv(self.conv(x, f"{name}.branch5x5_1"), f"{name}.branch5x5_2")
        b3 = self.conv(
            self.conv(self.conv(x, f"{name}.branch3x3dbl_1"), f"{name}.branch3x3dbl_2"),
            f"{name}.branch3x3dbl_3",
        )
        bp = self.conv(_avgpool3_no_pad_count(x), f"{name}.branch_pool")
        return torch.cat([b1, b5, b3, bp], dim=1)

    def block_b(self, x: Tensor, name: str) -> Tensor:
        b3 = self.conv(x, f"{name}.branch3x3")
        bd = self.conv(
            self.conv(self.conv(x, f"{name}.branch3x3dbl_1"), f"{name}.branch3x3dbl_2"),
            f"{name}.branch3x3dbl_3",
        )
        bp = _maxpool3(x, stride=2)
        return torch.cat([b3, bd, bp], dim=1)

    def block_c(self, x: Tensor, name: str) -> Tensor:
        b1 = self.conv(x, f"{name}.branch1x1")
        b7 = self.conv(
            self.conv(self.conv(x, f"{name}.branch7x7_1"), f"{name}.branch7x7_2"),
            f"{name}.branch7x7_3",
        )
        bd = x
        for i in range(1, 6):
            bd = self.conv(bd, f"{name}.branch7x7dbl_{i}")
        bp = self.conv(_avgpool3_no_pad_count(x), f"{name}.branch_pool")
        return torch.cat([b1, b7, bd, bp], dim=1)

    def block_d(self, x: Tensor, name: str) -> Tensor:
        b3 = self.conv(self.conv(x, f"{name}.branch3x3_1"), f"{name}.branch3x3_2")
        b7 = x
        for i in range(1, 5):
            b7 = self.conv(b7, f"{name}.branch7x7x3_{i}")
        bp = _maxpool3(x, stride=2)
        return torch.cat([b3, b7, bp], dim=1)

    def block_e(self, x: Tensor, name: str, pool: str) -> Tensor:
        b1 = self.conv(x, f"{name}.branch1x1")
        b3 = self.conv(x, f"{name}.branch3x3_1")
        b3 = torch.cat([self.conv(b3, f"{name}.branch3x3_2a"), self.conv(b3, f"{name}.branch3x3_2b")], dim=1)
        bd = self.conv(self.conv(x, f"{name}.branch3x3dbl_1"), f"{name}.branch3x3dbl_2")
        bd = torch.cat([self.conv(bd, f"{name}.branch3x3dbl_3a"), self.conv(bd, f"{name}.branch3x3dbl_3b")], dim=1)
        # E_2 (Mixed_7c) uses a max pool where E_1 averages: the TF port's
        # deviation from torchvision that FID features depend on
        pooled = _maxpool3(x, stride=1, padding=1) if pool == "max" else _avgpool3_no_pad_count(x)
        bp = self.conv(pooled, f"{name}.branch_pool")
        return torch.cat([b1, b3, bd, bp], dim=1)


def _check_taps(features: Sequence[str]) -> None:
    for f in features:
        if f not in _TAPS:
            raise ValueError(f"InceptionV3 feature must be one of {_TAPS}, got {f!r}")


def inception_v3_features(
    params: Mapping[str, Tensor], features: Sequence[str] = ("2048",)
) -> Callable[[Tensor], Tuple[Tensor, ...]]:
    """Build the forward: uint8 (or [0, 255] floating) NCHW images -> tuple of
    the requested feature taps, over a mapping of parameter tensors.

    ``features`` entries are the reference's names: "64", "192", "768",
    "2048", "logits_unbiased", "logits". The network is truncated after the
    deepest requested tap.
    """
    features = [str(f) for f in features]
    _check_taps(features)
    check_inception_params(params)
    depth_order = list(_TAPS)
    deepest = max(depth_order.index(f) for f in features)

    def forward(x: Tensor) -> Tuple[Tensor, ...]:
        if x.ndim != 4 or x.shape[1] != 3:
            raise ValueError(f"Expected (N, 3, H, W) image batch, got shape {tuple(x.shape)}")
        out: Dict[str, Tensor] = {}
        # the convolutions run in the input's floating dtype (bfloat16 on the tensor cores when the engine cast a
        # float batch to that policy; float32 for uint8 input), everything else in at least float32
        compute = x.dtype if x.is_floating_point() else torch.float32
        net = _Net(params, compute)
        with _ieee_float32(torch.backends.cudnn.conv, torch.backends.mkldnn.conv):
            h = x.to(torch.promote_types(compute, torch.float32))
            h = tf1_bilinear_resize(h, (INPUT_IMAGE_SIZE, INPUT_IMAGE_SIZE))
            h = (h - 128.0) / 128.0

            h = net.conv(h, "Conv2d_1a_3x3")
            h = net.conv(h, "Conv2d_2a_3x3")
            h = net.conv(h, "Conv2d_2b_3x3")
            h = _maxpool3(h, stride=2)
            if "64" in features:
                out["64"] = _global_avgpool(h)
            if deepest > depth_order.index("64"):
                h = net.conv(h, "Conv2d_3b_1x1")
                h = net.conv(h, "Conv2d_4a_3x3")
                h = _maxpool3(h, stride=2)
                if "192" in features:
                    out["192"] = _global_avgpool(h)
            if deepest > depth_order.index("192"):
                h = net.block_a(h, "Mixed_5b")
                h = net.block_a(h, "Mixed_5c")
                h = net.block_a(h, "Mixed_5d")
                h = net.block_b(h, "Mixed_6a")
                h = net.block_c(h, "Mixed_6b")
                h = net.block_c(h, "Mixed_6c")
                h = net.block_c(h, "Mixed_6d")
                h = net.block_c(h, "Mixed_6e")
                if "768" in features:
                    out["768"] = _global_avgpool(h)
            if deepest > depth_order.index("768"):
                h = net.block_d(h, "Mixed_7a")
                h = net.block_e(h, "Mixed_7b", pool="avg")
                h = net.block_e(h, "Mixed_7c", pool="max")
                h = _global_avgpool(h)
                if "2048" in features:
                    out["2048"] = h
        if deepest > depth_order.index("2048"):
            fc_w, fc_b = params["fc.weight"].to(h.dtype), params["fc.bias"].to(h.dtype)
            logits = _safe_matmul(h, fc_w)
            if "logits_unbiased" in features:
                out["logits_unbiased"] = logits
            if "logits" in features:
                out["logits"] = logits + fc_b[None]
        return tuple(out[f] for f in features)

    return forward


class InceptionV3(nn.Module):
    """The FID InceptionV3 as an ``nn.Module``: its ``state_dict`` keys are
    the converted checkpoint's keys (``Mixed_5b.branch1x1.conv.weight``, ...,
    ``fc.bias``), held as buffers, and its forward returns the requested
    taps (:func:`inception_v3_features` over those buffers)."""

    def __init__(self, features: Sequence[Union[int, str]] = ("2048",)) -> None:
        super().__init__()
        self.features = tuple(str(f) for f in features)
        _check_taps(self.features)
        for key, shape in inception_param_spec().items():
            *path, leaf = key.split(".")
            mod: nn.Module = self
            for name in path:
                if name not in mod._modules:
                    mod.add_module(name, nn.Module())
                mod = mod._modules[name]
            mod.register_buffer(leaf, torch.zeros(shape))

    def forward(self, x: Tensor) -> Tuple[Tensor, ...]:
        return inception_v3_features(dict(self.named_buffers()), self.features)(x)


def inception_module(
    params: Mapping[str, "np.ndarray"],
    device: Union[str, torch.device],
    dtype: torch.dtype = torch.float32,
    features: Sequence[Union[int, str]] = ("2048",),
) -> InceptionV3:
    """Carry a parameter dict across: the JAX package's ``{key: numpy array}``
    (``random_inception_params``, ``load_inception_params``) to the port's
    :class:`InceptionV3` on ``device`` in ``dtype``."""
    check_inception_params(params)
    module = InceptionV3(features)
    module.load_state_dict({k: torch.as_tensor(np.asarray(v)) for k, v in params.items()})
    return module.to(device=device, dtype=dtype).eval()


def inception_feature_extractor(
    feature,
    weights_path: Optional[str] = None,
    *,
    dtype_policy: str = "float32",
    mesh=None,
    acquire: bool = False,
    device: Union[str, torch.device, None] = None,
):
    """Resolve an int/str ``feature`` request into a single-tap extractor.

    The converted-weights path comes from ``weights_path`` or the
    ``TPUMETRICS_INCEPTION_WEIGHTS`` environment variable; without one this
    raises with the conversion recipe.

    Returns a :class:`~tpumetrics_torch.backbones.registry.BackboneHandle`
    from the process-global registry on ``device`` (the current card when
    omitted): FID + KID + IS over the same converted file share ONE resident
    weight set. With ``acquire=True`` the caller owns a reference and must
    ``close()`` it (the Metric classes route that through
    ``release_backbones()``).
    """
    tap = str(feature)
    if tap not in _TAPS:
        raise ValueError(
            f"Integer/str `feature` must be one of {VALID_INT_FEATURES + VALID_STR_FEATURES}, got {feature!r}"
        )
    path = weights_path or os.environ.get("TPUMETRICS_INCEPTION_WEIGHTS")
    if not path:
        raise ModuleNotFoundError(
            f"feature={feature!r} requests the pretrained FID InceptionV3, whose weights are not"
            " bundled and cannot be downloaded here. Convert the reference checkpoint offline with"
            " `python -m tpumetrics_torch.image._inception_convert pt_inception-2015-12-05-6726825d.pth"
            " inception.npz` and pass feature_extractor_weights_path='inception.npz' (or set"
            " TPUMETRICS_INCEPTION_WEIGHTS). Alternatively pass any callable image->(N, D)"
            " feature extractor."
        )
    from tpumetrics_torch.backbones.registry import get_backbone

    return get_backbone(
        f"inception:{tap}",
        load_inception_params(path),
        key=_inception_weights_key(path),
        dtype_policy=dtype_policy,
        mesh=mesh,
        acquire=acquire,
        device=device,
    )
