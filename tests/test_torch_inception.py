"""The port's FID InceptionV3 (``tpumetrics_torch/image/_inception.py``) and
its converter, held against the JAX package on the CPU.

The same seeded uint8 images and ``random_inception_params`` go through the
JAX forward and the port's. The JAX network runs once, at one input shape,
for all six taps (a module-scoped call: its compile dominates). Tolerances:

- the port in float32 and in float64 against JAX in float32, at every tap,
  within ``FEATURE_RTOL`` = 1e-5 of the tap's largest magnitude: JAX's own
  float32 rounding through the 94 convolutions (measured below 6e-7), which
  the float64 forward shows is all the difference;
- the TF1 resize within 1e-5 of the values' scale (the same gather and lerp,
  float32 lerps in the same order: measured 0), the pools exactly;
- the parameter draws, the converter's round trip and the state-dict keys
  exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpumetrics.image import _inception as jax_inception
from tpumetrics.image import _inception_convert as jax_convert
from tpumetrics_torch.image import _inception
from tpumetrics_torch.image import _inception_convert

TAPS = ("64", "192", "768", "2048", "logits_unbiased", "logits")
FEATURE_RTOL = 1e-5
SEED = 5


@pytest.fixture(scope="module")
def params():
    return _inception.random_inception_params(SEED)


@pytest.fixture(scope="module")
def images():
    return np.random.default_rng(1).integers(0, 256, (2, 3, 40, 52), dtype=np.uint8)


@pytest.fixture(scope="module")
def jax_taps(params, images):
    """The JAX forward's six taps, float32, once for the module."""
    forward = jax.jit(jax_inception.inception_v3_features({k: jnp.asarray(v) for k, v in params.items()}, TAPS))
    return [np.asarray(t) for t in forward(jnp.asarray(images))]


def test_random_params_are_the_jax_draws_and_spec(params):
    want = jax_inception.random_inception_params(SEED)
    assert list(params) == list(want) == list(_inception.inception_param_spec())
    for k, v in want.items():
        assert params[k].dtype == v.dtype and np.array_equal(params[k], v), k
    assert _inception.inception_param_spec() == jax_inception.inception_param_spec()


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["float32", "float64"])
def test_six_taps_match_jax(params, images, jax_taps, dtype):
    tensors = {k: torch.from_numpy(v).to(dtype) for k, v in params.items()}
    x = torch.from_numpy(images)
    got = _inception.inception_v3_features(tensors, TAPS)(x if dtype == torch.float32 else x.to(dtype))
    for tap, ours, ref in zip(TAPS, got, jax_taps):
        assert ours.dtype == dtype and tuple(ours.shape) == ref.shape, tap
        scale = float(np.abs(ref).max())
        np.testing.assert_allclose(ours.numpy(), ref, rtol=0, atol=FEATURE_RTOL * scale, err_msg=tap)


def test_bfloat16_weights_run_only_the_convolutions_in_bfloat16(params, images, monkeypatch):
    """bfloat16 weights: a bfloat16 batch (the engine's cast of a float batch) runs every convolution in bfloat16
    and the rest in float32; a uint8 batch runs float32 convolutions over the rounded weights. The 64-d tap
    comes back float32 either way, within 2 % of the float32 forward's scale."""
    tensors = {k: torch.from_numpy(v).to(torch.bfloat16) for k, v in params.items()}
    seen = []
    conv2d = torch.nn.functional.conv2d

    def spy(x, w, *args, **kwargs):
        seen.append((x.dtype, w.dtype))
        out = conv2d(x, w, *args, **kwargs)
        seen.append(("out", out.dtype))
        return out

    monkeypatch.setattr(_inception.F, "conv2d", spy)
    pooled = []
    monkeypatch.setattr(_inception, "_global_avgpool", lambda x: pooled.append(x.dtype) or x.mean(dim=(2, 3)))
    full = _inception.inception_v3_features({k: torch.from_numpy(v) for k, v in params.items()}, ("64",))(
        torch.from_numpy(images))[0]
    for x, compute in ((torch.from_numpy(images).to(torch.bfloat16), torch.bfloat16),
                       (torch.from_numpy(images), torch.float32)):
        seen.clear()
        pooled.clear()
        (tap,) = _inception.inception_v3_features(tensors, ("64",))(x)
        assert tap.dtype == torch.float32 and pooled == [torch.float32]
        assert {d for d in seen if d[0] != "out"} == {(compute, compute)} and len(seen) == 6
        np.testing.assert_allclose(tap.numpy(), full.numpy(), rtol=0, atol=0.02 * float(full.abs().max()))


def test_module_carries_the_params_and_its_keys_are_the_file_keys(params, images, jax_taps):
    module = _inception.inception_module(params, "cpu", features=TAPS)
    assert list(module.state_dict()) == list(_inception.inception_param_spec())
    for k, v in module.state_dict().items():
        assert torch.equal(v, torch.from_numpy(params[k])), k
    got = module(torch.from_numpy(images))
    direct = _inception.inception_v3_features({k: torch.from_numpy(v) for k, v in params.items()}, TAPS)(
        torch.from_numpy(images))
    for a, b in zip(got, direct):
        assert torch.equal(a, b)
    # a truncated network: only the stem runs for the 64 tap
    (stem,) = _inception.inception_module(params, "cpu", features=(64,))(torch.from_numpy(images))
    assert torch.equal(stem, got[0])


@pytest.mark.parametrize("in_shape", [(31, 45), (299, 299), (512, 340), (150, 200)])
def test_tf1_resize_matches_jax(in_shape):
    x = np.random.default_rng(0).uniform(0, 255, (2, 3) + in_shape).astype(np.float32)
    want = np.asarray(jax_inception.tf1_bilinear_resize(jnp.asarray(x), (299, 299)))
    got = _inception.tf1_bilinear_resize(torch.from_numpy(x), (299, 299)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * 255)


def test_tf1_resize_is_not_half_pixel():
    x = torch.arange(4, dtype=torch.float32).reshape(1, 1, 1, 4)
    out = _inception.tf1_bilinear_resize(x, (1, 8))[0, 0, 0]
    assert out.tolist() == [0.0, 0.5, 1.0, 1.5, 2.0, 2.5, 3.0, 3.0]
    # uint8 input resizes in float32
    assert _inception.tf1_bilinear_resize(x.to(torch.uint8), (1, 8)).dtype == torch.float32


def test_pools_match_jax():
    x = np.random.default_rng(2).standard_normal((2, 5, 17, 12)).astype(np.float32)
    tx, jx = torch.from_numpy(x), jnp.asarray(x)
    np.testing.assert_array_equal(_inception._maxpool3(tx, 2).numpy(), np.asarray(jax_inception._maxpool3(jx, 2)))
    np.testing.assert_array_equal(_inception._maxpool3(tx, 1, 1).numpy(), np.asarray(jax_inception._maxpool3(jx, 1, 1)))
    np.testing.assert_allclose(_inception._avgpool3_no_pad_count(tx).numpy(),
                               np.asarray(jax_inception._avgpool3_no_pad_count(jx)), rtol=1e-6, atol=1e-6)
    # count_include_pad=False: a corner averages its four in-image pixels
    np.testing.assert_allclose(_inception._avgpool3_no_pad_count(tx)[0, 0, 0, 0], x[0, 0, :2, :2].mean(), rtol=1e-6)


def test_converter_round_trip_both_packages_read(params, tmp_path):
    module = _inception.inception_module(params, "cpu")
    state = {f"module.{k}": v for k, v in module.state_dict().items()}  # a prefixed torchvision-style dump
    state["module.AuxLogits.fc.weight"] = torch.zeros(3)  # an aux twin the suffix match must skip
    ours = _inception_convert.convert_state_dict(state)
    theirs = jax_convert.convert_state_dict(state)
    assert list(ours) == list(theirs)
    for k in ours:
        assert ours[k].dtype == np.float32 and np.array_equal(ours[k], params[k]) and np.array_equal(ours[k], theirs[k])
    path = tmp_path / "inception.npz"
    np.savez(path, **ours)
    loaded = _inception.load_inception_params(str(path))
    assert _inception.load_inception_params(str(path)) is loaded  # cached per (path, mtime)
    assert all(np.array_equal(loaded[k], jax_inception.load_inception_params(str(path))[k]) for k in loaded)
    with pytest.raises(KeyError, match="missing parameter"):
        _inception_convert.convert_state_dict({k: v for k, v in state.items() if "Mixed_7c" not in k})


def test_bad_params_and_taps_raise(params):
    with pytest.raises(ValueError, match="missing 472 entries"):
        _inception.check_inception_params({})
    bad = dict(params, **{"fc.bias": np.zeros(3, np.float32)})
    with pytest.raises(ValueError, match="fc.bias"):
        _inception.check_inception_params(bad)
    with pytest.raises(ValueError, match="feature must be one of"):
        _inception.inception_v3_features({k: torch.from_numpy(v) for k, v in params.items()}, ("1000",))
    with pytest.raises(ValueError, match="Expected"):
        _inception.inception_v3_features({k: torch.from_numpy(v) for k, v in params.items()})(torch.zeros(1, 1, 8, 8))


def test_extractor_without_weights_raises_with_the_recipe(monkeypatch):
    monkeypatch.delenv("TPUMETRICS_INCEPTION_WEIGHTS", raising=False)
    with pytest.raises(ModuleNotFoundError, match="tpumetrics_torch.image._inception_convert"):
        _inception.inception_feature_extractor(2048, device="cpu")
    with pytest.raises(ValueError, match="must be one of"):
        _inception.inception_feature_extractor(100, device="cpu")
