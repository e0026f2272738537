"""The port's LPIPS (functional and class), its AlexNet / VGG-16 /
SqueezeNet stacks and PerceptualPathLength, held against the JAX package on
the CPU.

Both packages take the same seeded numpy images and the same seeded conv
weights (``random_lpips_params``, the bundled trained heads). Tolerances:

- LPIPS distances against the JAX package run under ``jax.jit`` (its
  functional with each net, its class's whole update) within ``JIT_RTOL`` =
  1e-4: XLA fuses and reorders the float32 sums (its SqueezeNet sum was
  measured 3.1e-5 from float64, the port's 8e-8); the port within
  ``F64_RTOL`` = 1e-6 of its own float64 path; toy nets run eagerly in both
  packages within ``RTOL`` = 1e-5 relative (plus 1e-7);
- PPL's resize against ``jax.image.resize(..., "bilinear")`` (half-pixel,
  antialiased when it shrinks) within ``RESIZE_ATOL`` = 1e-5 on unit-scale
  images (measured below 1e-6), up- and down-scaled;
- PPL's inner step (interpolate, generate, resize, LPIPS over epsilon²) on
  the same numpy latents within ``PPL_RTOL`` = 1e-2: the two images differ
  by a 1e-4 step of unit-scale values, which float32 rounds (2^-24 of each
  value, and of ``t + 1e-4``) to some 6e-4 of itself per pixel in each
  package, doubled in the squared distance (measured 3e-3 apart); its
  discarding on the same distances within ``RTOL``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpumetrics.image as jax_image
from tpumetrics.functional.image import learned_perceptual_image_patch_similarity as jax_lpips
from tpumetrics.image import perceptual_path_length as jax_ppl
from tpumetrics_torch.backbones import registry, registry_stats
from tpumetrics_torch.functional.image import learned_perceptual_image_patch_similarity
from tpumetrics_torch.functional.image.lpips import lpips_head_weights
from tpumetrics_torch.image import LearnedPerceptualImagePatchSimilarity, PerceptualPathLength
from tpumetrics_torch.image import _backbones
from tpumetrics_torch.image import perceptual_path_length as ppl

RTOL, ATOL = 1e-5, 1e-7
JIT_RTOL, F64_RTOL = 1e-4, 1e-6
RESIZE_ATOL = 1e-5
PPL_RTOL = 1e-2
NETS = ("alex", "vgg", "squeeze")


@pytest.fixture(autouse=True)
def _clean_registry():
    registry._reset_backbones()
    yield
    registry._reset_backbones()


@pytest.fixture(scope="module")
def params():
    return {net: _backbones.random_lpips_params(net, 11) for net in NETS}


def _images(seed, shape=(3, 3, 48, 48)):
    rng = np.random.default_rng(seed)
    return rng.uniform(-1, 1, shape).astype(np.float32), rng.uniform(-1, 1, shape).astype(np.float32)


@pytest.fixture(scope="module")
def jax_per_image(params):
    """The JAX functional's per-image distances under one ``jax.jit`` a net, its backbone built directly, shared by
    the module's tests: fed ``_images``' default shape, each net compiles once."""
    from tpumetrics.image._backbones import lpips_backbone as jax_backbone

    jitted = {}

    def get(net):
        if net not in jitted:
            jnet = jax_backbone(net, [(jnp.asarray(w), jnp.asarray(bias)) for w, bias in params[net]])
            heads = lpips_head_weights(net)
            jitted[net] = jax.jit(lambda x, y: jax_lpips(x, y, jnet, heads, reduction="none"))
        return jitted[net]

    return get


def test_param_spec_fits_the_stacks_and_the_heads():
    for net in NETS:
        spec = _backbones.lpips_param_spec(net)
        drawn = _backbones.random_lpips_params(net, 0)
        assert [(w.shape, b.shape) for w, b in drawn] == spec
        x = torch.zeros(1, 3, 64, 64)
        feats = _backbones.lpips_backbone(net, _backbones.lpips_conv_params(drawn, "cpu"))(x)
        assert [f.shape[1] for f in feats] == _backbones.LPIPS_CHANNELS[net]
        assert [w.shape[0] for w in lpips_head_weights(net)] == _backbones.LPIPS_CHANNELS[net]
    with pytest.raises(ValueError, match="net_type"):
        _backbones.lpips_param_spec("resnet")


@pytest.mark.parametrize("net", NETS)
def test_functional_every_reduction_matches_jax(params, jax_per_image, net):
    """Each reduction of the port's functional against the JAX functional's per-image values (run under one
    ``jax.jit``, its backbone built directly: one compile a net) and the port's float64 path."""
    a, b = _images(1)
    heads = lpips_head_weights(net)
    per_image = np.asarray(jax_per_image(net)(a, b))
    net64 = _backbones.lpips_backbone(net, _backbones.lpips_conv_params(params[net], "cpu", torch.float64))
    exact = learned_perceptual_image_patch_similarity(torch.from_numpy(a).double(), torch.from_numpy(b).double(),
                                                      net64, [torch.from_numpy(w).double() for w in heads],
                                                      reduction="none").numpy()
    for reduction, want, want64 in (("none", per_image, exact), ("sum", per_image.sum(), exact.sum()),
                                    ("mean", per_image.mean(), exact.mean())):
        got = learned_perceptual_image_patch_similarity(torch.from_numpy(a), torch.from_numpy(b), net,
                                                        reduction=reduction, backbone_params=params[net])
        assert tuple(got.shape) == np.shape(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=JIT_RTOL, atol=ATOL, err_msg=reduction)
        np.testing.assert_allclose(got.numpy(), want64, rtol=F64_RTOL, err_msg=reduction)
    # one resident handle for the net, reused by every call
    (stats,) = registry_stats().values()
    assert stats["refs"] == 1 and stats["arch"] == f"lpips:{net}" and stats["dispatches"] == 6


def test_functional_callable_nets_weights_and_errors():
    a, b = _images(2, (2, 3, 16, 16))

    def toy(x):
        return [x[:, :, ::2, ::2], x.mean(dim=1, keepdim=True)]

    def jax_toy(x):
        return [x[:, :, ::2, ::2], x.mean(axis=1, keepdims=True)]

    weights = [np.array([0.5, 1.0, 2.0], np.float32), np.array([3.0], np.float32)]
    for lw in (None, weights):
        got = learned_perceptual_image_patch_similarity(torch.from_numpy(a), torch.from_numpy(b), toy, lw,
                                                        normalize=True, reduction="none")
        want = jax_lpips(jnp.asarray(a), jnp.asarray(b), jax_toy, lw, normalize=True, reduction="none")
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)
    x = torch.from_numpy(a)
    with pytest.raises(ValueError, match="reduction"):
        learned_perceptual_image_patch_similarity(x, x, toy, reduction="max")
    with pytest.raises(ModuleNotFoundError, match="backbone_params"):
        learned_perceptual_image_patch_similarity(x, x, "alex")
    with pytest.raises(ValueError, match="'alex', 'vgg', 'squeeze'"):
        learned_perceptual_image_patch_similarity(x, x, "resnet")
    with pytest.raises(ValueError, match="expects 5"):
        learned_perceptual_image_patch_similarity(x, x, "alex", backbone_params=[])


@pytest.mark.parametrize("net,reduction,normalize", [("alex", "mean", False), ("squeeze", "sum", True)])
def test_metric_class_matches_jax(params, net, reduction, normalize):
    kw = dict(net_type=net, reduction=reduction, normalize=normalize, backbone_params=params[net])
    metric = LearnedPerceptualImagePatchSimilarity(device="cpu", **kw)
    jmetric = jax_image.LearnedPerceptualImagePatchSimilarity(**kw)
    batches = []
    for seed in (3, 4):
        a, b = _images(seed, (2, 3, 64, 64))
        if normalize:
            a, b = (a + 1) / 2, (b + 1) / 2
        batches.append((a, b))
        metric.update(torch.from_numpy(a), torch.from_numpy(b))
        jmetric.update(jnp.asarray(a), jnp.asarray(b))
    for name in ("sum_scores", "total"):
        np.testing.assert_allclose(getattr(metric, name).numpy(), np.asarray(getattr(jmetric, name)), rtol=JIT_RTOL)
    np.testing.assert_allclose(metric.compute().numpy(), np.asarray(jmetric.compute()), rtol=JIT_RTOL)
    # and the port's float32 value within float32 rounding of its float64 path
    net64 = _backbones.lpips_backbone(net, _backbones.lpips_conv_params(params[net], "cpu", torch.float64))
    heads = [torch.from_numpy(w).double() for w in lpips_head_weights(net)]
    total = sum(learned_perceptual_image_patch_similarity(torch.from_numpy(a).double(), torch.from_numpy(b).double(),
                                                          net64, heads, normalize, reduction="sum")
                for a, b in batches)
    want64 = float(total) / (4 if reduction == "mean" else 1)
    np.testing.assert_allclose(float(metric.compute()), want64, rtol=F64_RTOL)
    assert metric._jit_loss.counts["eager"] == 2  # the CPU runs the update eagerly
    with pytest.raises(ValueError, match="reduction"):
        LearnedPerceptualImagePatchSimilarity(net_type=net, reduction="none", backbone_params=params[net], device="cpu")
    metric.release_backbones()
    jmetric.release_backbones()


def test_bf16_policy_within_its_gate(params):
    """bf16 is opt-in: LPIPS within max(0.01, 5 %) of float32 (the JAX package's gate)."""
    a, b = _images(5, (2, 3, 64, 64))

    def run(policy):
        m = LearnedPerceptualImagePatchSimilarity(net_type="alex", backbone_params=params["alex"],
                                                  backbone_dtype_policy=policy, device="cpu")
        m.update(torch.from_numpy(a), torch.from_numpy(b))
        return float(m.compute())

    full, low = run("float32"), run("bfloat16")
    assert abs(low - full) <= max(0.01, 0.05 * abs(full)) and low != full
    assert len(registry_stats()) == 2


@pytest.mark.parametrize("shape,size", [((2, 3, 256, 256), 64), ((1, 3, 100, 70), 64), ((1, 3, 16, 16), 64),
                                        ((1, 3, 65, 65), 64)])
def test_ppl_resize_matches_jax_image_resize(shape, size):
    x = np.random.default_rng(6).standard_normal(shape).astype(np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(x), shape[:2] + (size, size), "bilinear"))
    np.testing.assert_allclose(ppl._resize(torch.from_numpy(x), size).numpy(), want, rtol=0, atol=RESIZE_ATOL)


@pytest.mark.parametrize("n_in,n_out", [(256, 64), (100, 64), (16, 64), (65, 64)])
def test_chip_smoke_resize_weights_are_jax_image_resize(n_in, n_out):
    """The PPL oracle's resize in ``chip_smoke.py`` (weights written out, none of the port's functions) against
    ``jax.image.resize(..., "bilinear")``, up and down, within ``RESIZE_ATOL``."""
    import chip_smoke

    x = np.random.default_rng(8).standard_normal((1, 3, n_in, n_in)).astype(np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(x), (1, 3, n_out, n_out), "bilinear"))
    w = chip_smoke.resize_matrix64(n_in, n_out)
    np.testing.assert_allclose(np.einsum("oh,nchw,pw->ncop", w, x.astype(np.float64), w), want, rtol=0, atol=RESIZE_ATOL)


def test_chip_smoke_written_out_lpips_vgg_matches_jax(params, jax_per_image):
    """The PPL oracle's LPIPS-VGG in ``chip_smoke.py`` (written out in float64, none of the port's functions)
    against the JAX functional under ``jax.jit`` on the same weights and heads, within ``JIT_RTOL``; at
    ``_images``' shape, so that the jitted JAX VGG is the one the functional test compiled."""
    import chip_smoke

    a, b = (2 * x - 1 for x in _images(3))
    heads = lpips_head_weights("vgg")
    want = np.asarray(jax_per_image("vgg")(a, b))
    convs = [tuple(torch.from_numpy(np.asarray(x)).double() for x in wb) for wb in params["vgg"]]
    got = chip_smoke.vgg_lpips64(torch, torch.from_numpy(a).double(), torch.from_numpy(b).double(), convs,
                                 [torch.from_numpy(w).double() for w in heads])
    np.testing.assert_allclose(got.numpy(), want, rtol=JIT_RTOL)


def _generator(torch_side):
    """A smooth seeded generator from 32-d latents to (3, 48, 48) images, in either package."""
    w = (np.random.default_rng(7).standard_normal((32, 3 * 8 * 8)) / np.sqrt(32)).astype(np.float32)
    if torch_side:
        tw = torch.from_numpy(w)
        return lambda z: torch.tanh((z @ tw).reshape(-1, 3, 8, 8)).repeat_interleave(6, 2).repeat_interleave(6, 3)
    jw = jnp.asarray(w)
    return lambda z: jnp.repeat(jnp.repeat(jnp.tanh((z @ jw).reshape(-1, 3, 8, 8)), 6, axis=2), 6, axis=3)


def _toy_nets():
    """A small perceptual stack in either package (the nets themselves are held above)."""
    w = (np.random.default_rng(12).standard_normal((4, 3, 3, 3)) * 0.3).astype(np.float32)
    tw, jw = torch.from_numpy(w), jnp.asarray(w)

    def net(x):
        h = torch.tanh(torch.nn.functional.conv2d(x, tw, padding=1))
        return [h, h[:, :, ::2, ::2].mean(dim=1, keepdim=True)]

    def jnet(x):
        h = jnp.tanh(jax.lax.conv_general_dilated(x, jw, (1, 1), [(1, 1), (1, 1)],
                                                  dimension_numbers=("NCHW", "OIHW", "NCHW")))
        return [h, h[:, :, ::2, ::2].mean(axis=1, keepdims=True)]

    return net, jnet


@pytest.mark.parametrize("method", ["lerp", "slerp_unit"])
def test_ppl_inner_step_matches_jax_on_the_same_latents(method):
    rng = np.random.default_rng(8)
    z1, z2 = rng.standard_normal((4, 32)).astype(np.float32), rng.standard_normal((4, 32)).astype(np.float32)
    t = rng.uniform(size=(4, 1)).astype(np.float32)
    eps = 1e-4
    net, jnet = _toy_nets()
    got = ppl._ppl_step(_generator(True), *(torch.from_numpy(v) for v in (z1, z2, t)), eps, method, 32, net, None)

    @jax.jit
    def jax_step(z1, z2, t):  # the JAX inner step, as perceptual_path_length runs it
        gen = _generator(False)
        img1 = gen(jax_ppl._interpolate(z1, z2, t, method))
        img2 = gen(jax_ppl._interpolate(z1, z2, t + eps, method))
        img1, img2 = (jax.image.resize(i, (4, 3, 32, 32), "bilinear") for i in (img1, img2))
        return jax_lpips(img1, img2, jnet, None, reduction="none") / eps**2

    np.testing.assert_allclose(got.numpy(), np.asarray(jax_step(z1, z2, t)), rtol=PPL_RTOL)


@pytest.mark.parametrize("lower,upper", [(0.01, 0.99), (None, 0.9), (None, None)])
def test_ppl_discarding_matches_jax(lower, upper):
    """The whole function on both sides over a generator that ignores its
    latents and hands out one fixed image sequence: the same distances, the
    same discarding."""
    rng = np.random.default_rng(9)
    frames = rng.uniform(-1, 1, (24, 3, 16, 16)).astype(np.float32)

    def make(torch_side):
        state = {"i": 0}

        def gen(z):
            i = state["i"]
            state["i"] += z.shape[0]
            out = frames[np.arange(i, i + z.shape[0]) % len(frames)]
            return torch.from_numpy(out) if torch_side else jnp.asarray(out)

        return gen

    def net(x):
        return [x[:, :, ::2, ::2], x.tanh().mean(dim=1, keepdim=True)]

    def jnet(x):
        return [x[:, :, ::2, ::2], jnp.tanh(x).mean(axis=1, keepdims=True)]

    kw = dict(num_samples=20, batch_size=6, resize=None, lower_discard=lower, upper_discard=upper, latent_dim=8)
    got = ppl.perceptual_path_length(make(True), sim_net=net, key=torch.Generator().manual_seed(0), **kw)
    want = jax_ppl.perceptual_path_length(make(False), sim_net=jnet, **kw)
    for ours, theirs in zip(got, want):
        np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), rtol=RTOL, atol=ATOL)
    assert tuple(got[2].shape) == (20,)


def test_ppl_metric_latents_registry_and_errors(params):
    metric = PerceptualPathLength(num_samples=10, batch_size=4, sim_net="squeeze", backbone_params=params["squeeze"],
                                  latent_dim=32, resize=32, device="cpu")
    (handle,) = metric._backbone_handles
    with pytest.raises(RuntimeError, match="No generator"):
        metric.compute()
    metric.update(_generator(True))
    mean, std, dist = metric.compute()
    # the latents come from a generator seeded 0 on the metric's device: the functional with that key agrees
    again = ppl.perceptual_path_length(_generator(True), num_samples=10, batch_size=4, sim_net="squeeze",
                                       backbone_params=params["squeeze"], latent_dim=32, resize=32,
                                       key=torch.Generator().manual_seed(0))
    assert torch.equal(dist, again[2]) and dist.shape == (10,) and bool(torch.isfinite(mean))
    assert registry_stats()[handle.key]["refs"] == 1  # the functional reuses the metric's handle
    metric.release_backbones()
    with pytest.raises(ModuleNotFoundError, match="sim_net"):
        ppl.perceptual_path_length(_generator(True), key=torch.Generator())
    with pytest.raises(NotImplementedError, match="Conditional"):
        ppl.perceptual_path_length(_generator(True), conditional=True, sim_net=lambda x: [x],
                                   key=torch.Generator())
    with pytest.raises(ValueError, match="not supported"):
        ppl._interpolate(torch.zeros(1, 2), torch.ones(1, 2), 0.5, "cubic")
