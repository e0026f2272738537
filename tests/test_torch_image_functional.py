"""The port's functional image metrics, held against the JAX package on the CPU.

The same numpy inputs, made from a seed, go through each JAX function and
its counterpart in ``tpumetrics_torch.functional.image``. One input shape
per JAX function, so that its eager ops compile once: ``2x3x64x64`` RGB,
``2x1x64x64`` grayscale (PSNR-B), ``2x8x32x32`` multispectral (ERGAS, SAM,
RMSE-SW, RASE, D-lambda), ``2x1x16x16x16`` volumes (3-D SSIM). The JAX
JAX side runs under ``jax.jit`` (one compile a call, a few times cheaper
than its eager ops with a cold compile cache), and its results are cached
per module. Tolerances, all float32 against float32:

- ``RTOL`` = 1e-5 relative (and ``ATOL`` = 1e-6 absolute) on every score:
  the same arithmetic, convolutions and sums taken in another order (the
  differences measured are at most 1.7e-6 relative, D-lambda's p=2; the
  rest below 1.1e-6);
- ``MAP_ATOL`` = 1e-5 on full SSIM and RMSE maps, whose border pixels
  cancel (E[x²] - mu² of values up to 1; measured 5.5e-6);
- windows within 1e-6 relative (``exp`` rounds apart by an ulp); the image
  gradients, PSNR-B's blocked effect and scipy's border exactly;
- gradients within 1e-5 relative of ``jax.grad``.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpumetrics.functional.image as jax_fn
import tpumetrics_torch.functional.image as fn
from tpumetrics.functional.image import helper as jax_helper
from tpumetrics.functional.image import vif as jax_vif
from tpumetrics_torch.functional.image import helper
from tpumetrics_torch.functional.image import vif as vif_module

RTOL, ATOL = 1e-5, 1e-6
MAP_ATOL = 1e-5


def _pair(shape, seed, offset=0.0):
    """``(preds, target)`` float32: a target uniform in [offset, 1 + offset)
    and a prediction 0.05-noisy around it."""
    rng = np.random.default_rng(seed)
    target = (rng.random(shape) + offset).astype(np.float32)
    preds = np.clip(target + 0.05 * rng.standard_normal(shape), offset, 1 + offset).astype(np.float32)
    return preds, target


RGB = _pair((2, 3, 64, 64), 0)
GRAY = _pair((2, 1, 64, 64), 1)
SPEC = _pair((2, 8, 32, 32), 2, offset=0.1)
VOL = _pair((2, 1, 16, 16, 16), 3)
INPUTS = {"rgb": RGB, "gray": GRAY, "spec": SPEC, "vol": VOL}


def _jit(f, *args, **kwargs):
    """``f(*args, **kwargs)`` under ``jax.jit``, the keyword arguments static."""
    return jax.jit(functools.partial(f, **kwargs))(*(jnp.asarray(a) for a in args))


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _close(got, want, rtol=RTOL, atol=ATOL):
    got, want = _np(got).astype(np.float64), _np(want).astype(np.float64)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)


@pytest.fixture(scope="module")
def jax_results():
    """JAX results by case, computed on first use and kept for the module."""
    cache = {}

    def get(key, fn_name, inputs, **kwargs):
        if key not in cache:
            cache[key] = _jit(getattr(jax_fn, fn_name), *INPUTS[inputs], **kwargs)
        return cache[key]

    return get


def _check(jax_results, key, name, inputs, atol=ATOL, **kwargs):
    want = jax_results(key, name, inputs, **kwargs)
    got = getattr(fn, name)(*(torch.from_numpy(x) for x in INPUTS[inputs]), **kwargs)
    want = want if isinstance(want, tuple) else (want,)
    got = got if isinstance(got, tuple) else (got,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        _close(g, w, atol=atol if g.ndim > 1 else ATOL)


def test_windows_equal_jax():
    """The Gaussian windows of SSIM/UQI (1-D, 2-D, 3-D, equal and unequal
    sigmas) and VIF's four, built with torch ops, equal the JAX package's."""
    def windows():
        out = [jax_helper._gaussian(size, sigma) for size, sigma in ((11, 1.5), (7, 1.0), (3, 0.5))]
        out.append(jax_helper._gaussian_kernel_2d(3, (11, 9), (1.5, 1.2)))
        out.append(jax_helper._gaussian_kernel_3d(2, (11, 7, 5), (1.5, 1.0, 0.5)))
        return out + [jax_vif._filter(n, n / 5) for n in (17, 9, 5, 3)]

    got = [helper._gaussian(size, sigma) for size, sigma in ((11, 1.5), (7, 1.0), (3, 0.5))]
    got.append(helper._gaussian_kernel_2d(3, (11, 9), (1.5, 1.2)))
    got.append(helper._gaussian_kernel_3d(2, (11, 7, 5), (1.5, 1.0, 0.5)))
    got += [vif_module._filter(n, n / 5) for n in (17, 9, 5, 3)]
    for g, w in zip(got, jax.jit(windows)(), strict=True):
        _close(g, w, rtol=1e-6, atol=0)


def test_scipy_border_and_uniform_filter_equal_jax():
    x = SPEC[0]
    for window_size in (8, 7, 1):
        for dim in (2, 3):
            got = helper._single_dimension_pad(torch.from_numpy(x), dim, window_size // 2, window_size % 2)
            want = _jit(jax_helper._single_dimension_pad, x, dim=dim, pad=window_size // 2, outer_pad=window_size % 2)
            assert np.array_equal(_np(got), np.asarray(want))
        _close(helper._uniform_filter(torch.from_numpy(x), window_size),
               _jit(jax_helper._uniform_filter, x, window_size=window_size), rtol=1e-6, atol=1e-7)


SSIM_CASES = {
    "default": {},
    "float-range-sum": {"data_range": 1.0, "reduction": "sum"},
    "tuple-range-none": {"data_range": (0.1, 0.9), "reduction": "none"},
    "uniform-window": {"gaussian_kernel": False, "kernel_size": 7, "reduction": None},
    "sigmas-k1-k2": {"sigma": (1.5, 1.0), "kernel_size": (11, 9), "k1": 0.02, "k2": 0.05, "data_range": 1.0},
    "full-image": {"data_range": 1.0, "return_full_image": True},
    "contrast-sensitivity": {"data_range": 1.0, "return_contrast_sensitivity": True, "reduction": "none"},
}


@pytest.mark.parametrize("case", SSIM_CASES)
def test_ssim_matches_jax(jax_results, case):
    _check(jax_results, f"ssim-{case}", "structural_similarity_index_measure", "rgb", atol=MAP_ATOL,
           **SSIM_CASES[case])


@pytest.mark.parametrize("sigma", [1.5, (1.5, 1.0, 0.5)], ids=["equal-sigmas", "unequal-sigmas-nan"])
def test_ssim_3d_follows_the_jax_crop(jax_results, sigma):
    """3-D SSIM pads H and W by each other's border and crops D, H, W by the
    H, W and D borders, as the JAX package does: invisible with equal
    sigmas. With (1.5, 1.0, 0.5) the windows are 11, 9 and 5 wide; D, padded
    by 2 at each end and convolved with the 11-tap window, keeps 10 planes,
    which the crop by 5 at each end empties: the score is NaN in both."""
    kwargs = {"sigma": sigma, "data_range": 1.0, "reduction": "none"}
    want = np.asarray(jax_results(f"ssim3d-{sigma}", "structural_similarity_index_measure", "vol", **kwargs))
    got = fn.structural_similarity_index_measure(*(torch.from_numpy(x) for x in VOL), **kwargs)
    if isinstance(sigma, tuple):
        assert np.isnan(want).all() and torch.isnan(got).all()
    else:
        assert np.isfinite(want).all()
        _close(got, want)


@pytest.mark.parametrize("normalize,reduction", [("relu", "elementwise_mean"), ("simple", "sum"), (None, "none")])
def test_ms_ssim_matches_jax(jax_results, normalize, reduction):
    _check(jax_results, f"msssim-{normalize}", "multiscale_structural_similarity_index_measure", "rgb",
           betas=(0.3, 0.3, 0.4), data_range=1.0, normalize=normalize, reduction=reduction)


@pytest.mark.parametrize("kwargs", [{}, {"reduction": "sum"}, {"reduction": "none", "kernel_size": (7, 5),
                                                               "sigma": (1.0, 0.8)}], ids=["mean", "sum", "none-map"])
def test_uqi_matches_jax(jax_results, kwargs):
    _check(jax_results, f"uqi-{kwargs}", "universal_image_quality_index", "rgb", atol=MAP_ATOL, **kwargs)


PSNR_CASES = {
    "target-range": {},
    "float-range-base-2": {"data_range": 1.0, "base": 2.0},
    "tuple-range": {"data_range": (0.2, 0.8)},
    "per-image": {"data_range": 1.0, "dim": (1, 2, 3), "reduction": "none"},
    "per-channel-sum": {"data_range": 1.0, "dim": (2, 3), "reduction": "sum"},
}


@pytest.mark.parametrize("case", PSNR_CASES)
def test_psnr_matches_jax(jax_results, case):
    _check(jax_results, f"psnr-{case}", "peak_signal_noise_ratio", "rgb", **PSNR_CASES[case])


def test_psnrb_matches_jax(jax_results):
    for block_size in (8, 4):
        _check(jax_results, f"psnrb-{block_size}", "peak_signal_noise_ratio_with_blocked_effect", "gray",
               block_size=block_size)
    # the blocked-effect factor itself, exactly: both sum the same squares
    from tpumetrics.functional.image.psnrb import _compute_bef as jax_bef
    from tpumetrics_torch.functional.image.psnrb import _compute_bef

    x = GRAY[0] * 255
    _close(_compute_bef(torch.from_numpy(x), 8), _jit(jax_bef, x, block_size=8), rtol=1e-6, atol=0)


def test_vif_matches_jax(jax_results):
    for sigma_n_sq in (2.0, 0.01):
        _check(jax_results, f"vif-{sigma_n_sq}", "visual_information_fidelity", "rgb", sigma_n_sq=sigma_n_sq)


def test_total_variation_and_image_gradients_match_jax():
    img = RGB[0]
    for reduction in ("sum", "mean", "none", None):
        want = _jit(jax_fn.total_variation, img, reduction=reduction)
        _close(fn.total_variation(torch.from_numpy(img), reduction), want)
    for got, want in zip(fn.image_gradients(torch.from_numpy(img)), _jit(jax_fn.image_gradients, img)):
        assert np.array_equal(_np(got), np.asarray(want))


@pytest.mark.parametrize("name,kwargs", [
    ("error_relative_global_dimensionless_synthesis", {"ratio": 2, "reduction": "none"}),
    ("error_relative_global_dimensionless_synthesis", {}),
    ("spectral_angle_mapper", {"reduction": "sum"}),
    ("spectral_angle_mapper", {"reduction": "none"}),
    ("root_mean_squared_error_using_sliding_window", {"return_rmse_map": True}),
    ("root_mean_squared_error_using_sliding_window", {"window_size": 7}),
    ("relative_average_spectral_error", {}),
], ids=["ergas-ratio2-none", "ergas", "sam-sum", "sam-none", "rmse-sw-map", "rmse-sw-7", "rase"])
def test_spectral_metrics_match_jax(jax_results, name, kwargs):
    _check(jax_results, f"{name}-{kwargs}", name, "spec", atol=MAP_ATOL, **kwargs)


@pytest.mark.parametrize("case", ["p1", "p2-two-resolutions", "single-band"])
def test_spectral_distortion_index_matches_jax(case):
    preds, target = SPEC
    kwargs = {}
    if case == "p2-two-resolutions":
        target, kwargs = target[:, :, ::2, ::2].copy(), {"p": 2, "reduction": "sum"}
    elif case == "single-band":
        preds, target = preds[:, :1], target[:, :1]
    got = fn.spectral_distortion_index(torch.from_numpy(preds), torch.from_numpy(target), **kwargs)
    want = _jit(jax_fn.spectral_distortion_index, preds, target, **kwargs)
    if case == "single-band":
        assert float(got) == float(want) == 0.0
    _close(got, want)


def test_input_errors_raise_what_jax_raises():
    """Each bad input raises the JAX package's exception type in both."""
    x4, x3, x5 = np.zeros((1, 1, 16, 16), np.float32), np.zeros((1, 16, 16), np.float32), VOL[0]
    cases = [
        ("structural_similarity_index_measure", (x4, np.zeros((1, 1, 16, 17), np.float32)), {}),
        ("structural_similarity_index_measure", (x3, x3), {}),
        ("structural_similarity_index_measure", (x4, x4), {"kernel_size": 10}),
        ("structural_similarity_index_measure", (x4, x4), {"sigma": -1.0}),
        ("structural_similarity_index_measure", (x4, x4), {"return_full_image": True,
                                                           "return_contrast_sensitivity": True}),
        ("structural_similarity_index_measure", (x5, x5), {"kernel_size": (11, 11)}),
        ("multiscale_structural_similarity_index_measure", (x4, x4), {"betas": (1, 2)}),
        ("multiscale_structural_similarity_index_measure", (x4, x4), {"normalize": "max"}),
        ("multiscale_structural_similarity_index_measure", (x4, x4), {}),
        ("universal_image_quality_index", (x4, x4.astype(np.int32)), {}),
        ("universal_image_quality_index", (x4, x4), {"kernel_size": (11,)}),
        ("peak_signal_noise_ratio", (x4, x4), {"dim": 1}),
        ("peak_signal_noise_ratio_with_blocked_effect", (RGB[0], RGB[0]), {}),
        ("visual_information_fidelity", (x4, x4), {}),
        ("total_variation", (x3,), {}),
        ("image_gradients", (x3,), {}),
        ("spectral_angle_mapper", (x4, x4), {}),
        ("error_relative_global_dimensionless_synthesis", (x3, x3), {}),
        ("root_mean_squared_error_using_sliding_window", (x4, x4), {"window_size": 0}),
        ("root_mean_squared_error_using_sliding_window", (x4, x4), {"window_size": 40}),
        ("spectral_distortion_index", (x4, x4), {"p": 0}),
        ("spectral_distortion_index", (np.zeros((2, 1, 8, 8), np.float32), x4), {}),
    ]
    for name, args, kwargs in cases:
        with pytest.raises(Exception) as want:
            getattr(jax_fn, name)(*(jnp.asarray(a) for a in args), **kwargs)
        with pytest.raises(want.type):
            getattr(fn, name)(*(torch.from_numpy(a) for a in args), **kwargs)


@pytest.mark.parametrize("name,kwargs", [
    ("structural_similarity_index_measure", {"data_range": 1.0}),
    ("peak_signal_noise_ratio", {"data_range": 1.0}),
])
def test_gradient_matches_jax_grad(name, kwargs):
    """Plain torch ops carry SSIM's and PSNR's autograd: ``torch.autograd.grad``
    with respect to the predictions equals ``jax.grad``."""
    preds, target = (x[:1] for x in RGB)
    p = torch.from_numpy(preds).requires_grad_(True)
    (got,) = torch.autograd.grad(getattr(fn, name)(p, torch.from_numpy(target), **kwargs), p)
    want = jax.jit(jax.grad(lambda x: getattr(jax_fn, name)(x, jnp.asarray(target), **kwargs)))(jnp.asarray(preds))
    scale = float(np.abs(np.asarray(want)).max())
    _close(got, want, rtol=RTOL, atol=RTOL * scale)
