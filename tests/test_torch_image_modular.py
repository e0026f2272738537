"""The port's image metric classes, held against the JAX package on the CPU.

Each class of ``tpumetrics_torch.image`` and its JAX counterpart take the
same three batches (made from a seed with numpy; ``2x3x64x64`` RGB,
``2x1x64x64`` grayscale for PSNR-B, ``2x8x32x32`` multispectral, D-lambda's
targets at half that resolution); then their states (names, dtypes, values)
and computed values are compared. The JAX side runs each metric's whole
stream under one ``jax.jit`` (its update has no host read), which compiles
in a second or less where its eager ops would take up to 9 s with a cold
compile cache. Tolerances, float32 against float32:

- float32 sums of per-image scores and the values: within ``RTOL`` = 1e-5
  relative (plus ``ATOL`` = 1e-6 absolute): the same arithmetic, the
  convolutions and sums in another order (measured below 2e-6);
- maps (full SSIM images, UQI under ``reduction="none"``) within
  ``MAP_ATOL`` = 1e-5: their border pixels' moments cancel;
- counts, and list states that hold the inputs, exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpumetrics
import tpumetrics.functional.image as jax_fn
import tpumetrics.image as jax_image
import tpumetrics_torch.image as image
from tpumetrics_torch import MetricCollection
from tpumetrics_torch.interop import export_state, load_state

RTOL, ATOL = 1e-5, 1e-6
MAP_ATOL = 1e-5
BETAS = (0.3, 0.3, 0.4)


def _pair(shape, seed, offset=0.0):
    rng = np.random.default_rng(seed)
    target = (rng.random(shape) + offset).astype(np.float32)
    preds = np.clip(target + 0.05 * rng.standard_normal(shape), offset, 1 + offset).astype(np.float32)
    return preds, target


BATCHES = {
    "rgb": [_pair((2, 3, 64, 64), 10 + i) for i in range(3)],
    "gray": [_pair((2, 1, 64, 64), 20 + i) for i in range(3)],
    "spec": [_pair((2, 8, 32, 32), 30 + i, offset=0.1) for i in range(3)],
}
# D-lambda: pan-sharpened images against multispectral inputs at half their resolution
BATCHES["pansharp"] = [(p, t[:, :, ::2, ::2].copy()) for p, t in BATCHES["spec"]]
BATCHES["img"] = [(p,) for p, _ in BATCHES["rgb"]]  # total variation takes one image batch

MODULAR = [
    ("StructuralSimilarityIndexMeasure", {}, "rgb"),
    ("StructuralSimilarityIndexMeasure", {"reduction": "none", "return_full_image": True, "data_range": 1.0}, "rgb"),
    ("StructuralSimilarityIndexMeasure", {"reduction": "sum", "return_contrast_sensitivity": True,
                                          "data_range": (0.0, 1.0)}, "rgb"),
    ("MultiScaleStructuralSimilarityIndexMeasure", {"betas": BETAS, "data_range": 1.0}, "rgb"),
    ("MultiScaleStructuralSimilarityIndexMeasure", {"betas": BETAS, "reduction": "none", "normalize": "simple"}, "rgb"),
    ("PeakSignalNoiseRatio", {}, "rgb"),
    ("PeakSignalNoiseRatio", {"data_range": (0.2, 0.8), "base": 2.0}, "rgb"),
    ("PeakSignalNoiseRatio", {"data_range": 1.0, "dim": (1, 2, 3), "reduction": "none"}, "rgb"),
    ("PeakSignalNoiseRatioWithBlockedEffect", {}, "gray"),
    ("UniversalImageQualityIndex", {}, "rgb"),
    ("UniversalImageQualityIndex", {"reduction": "none"}, "rgb"),
    ("VisualInformationFidelity", {}, "rgb"),
    ("TotalVariation", {}, "img"),
    ("TotalVariation", {"reduction": "mean"}, "img"),
    ("TotalVariation", {"reduction": "none"}, "img"),
    ("ErrorRelativeGlobalDimensionlessSynthesis", {"ratio": 4}, "spec"),
    ("SpectralAngleMapper", {}, "spec"),
    ("SpectralAngleMapper", {"reduction": "none"}, "spec"),
    ("RootMeanSquaredErrorUsingSlidingWindow", {"window_size": 8}, "spec"),
    ("RelativeAverageSpectralError", {}, "spec"),
    ("SpectralDistortionIndex", {}, "pansharp"),
    ("SpectralDistortionIndex", {"p": 2, "reduction": "sum"}, "spec"),
]


def _jax_run(make, batches):
    """A JAX metric (or collection) made by ``make`` after ``batches``: its
    states by name and its computed value, all under one ``jax.jit``."""

    def run(batches):
        m = make()
        for b in batches:
            m.update(*b)
        if isinstance(m, tpumetrics.MetricCollection):
            return {k: {s: getattr(v, s) for s in v._defaults} for k, v in m.items()}, m.compute()
        return {k: getattr(m, k) for k in m._defaults}, m.compute()

    states, value = jax.jit(run)([tuple(jnp.asarray(x) for x in b) for b in batches])
    return jax.tree_util.tree_map(np.asarray, states), jax.tree_util.tree_map(np.asarray, value)


def _port_run(metric, batches):
    for b in batches:
        metric.update(*(torch.from_numpy(x) for x in b))
    return metric


def _close(got, want, atol=ATOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.astype(np.float64), want.astype(np.float64), rtol=RTOL, atol=atol)


def _same_states(got, want):
    """Port states (``export_state``) against JAX ones: names, dtypes, values."""
    assert sorted(got) == sorted(want)
    for name, ref in want.items():
        val = got[name]
        if isinstance(ref, list):
            assert isinstance(val, list) and len(val) == len(ref), name
            for v, r in zip(val, ref):
                assert v.dtype == r.dtype, name
                _close(v, r, MAP_ATOL)
        else:
            assert val.dtype == ref.dtype, (name, val.dtype, ref.dtype)
            if np.issubdtype(ref.dtype, np.integer) or name in ("total", "numel", "total_images"):
                assert np.array_equal(val, ref), name
            else:
                _close(val, ref)


@pytest.mark.parametrize("name,kwargs,kind", MODULAR, ids=[f"{m[0]}-{m[1]}" for m in MODULAR])
def test_modular_metric_matches_jax(name, kwargs, kind):
    port = _port_run(getattr(image, name)(**kwargs, device="cpu"), BATCHES[kind])
    want_states, want_value = _jax_run(lambda: getattr(jax_image, name)(**kwargs), BATCHES[kind])
    _same_states(export_state(port), want_states)
    got = port.compute()
    if isinstance(want_value, tuple):
        for g, w in zip(got, want_value, strict=True):
            _close(g.numpy(), w, MAP_ATOL)
    else:
        _close(got.numpy(), want_value, MAP_ATOL if np.ndim(want_value) > 1 else ATOL)


def _stand_in_backbones(port):
    """Constructor arguments for the classes that run a backbone, whose pretrained weights are not bundled: a
    stand-in extractor or feature stack in the package's own tensors."""
    feats = (lambda x: x.reshape(x.shape[0], -1)[:, :4].float()) if port else (
        lambda x: jnp.asarray(x, jnp.float32).reshape(x.shape[0], -1)[:, :4])
    return {"FrechetInceptionDistance": {"feature": feats, "num_features": 4},
            "KernelInceptionDistance": {"feature": feats}, "InceptionScore": {"feature": feats},
            "MemorizationInformedFrechetInceptionDistance": {"feature": feats},
            "LearnedPerceptualImagePatchSimilarity": {"net_type": lambda x: [x]},
            "PerceptualPathLength": {"sim_net": lambda x: [x]}}


def test_class_attributes_and_state_reductions_equal_jax():
    """Each class's flags and plot bounds, and each default configuration's
    state names, default dtypes and ``dist_reduce_fx``, are the JAX class's
    (the backbone classes over stand-in backbones)."""
    port_kwargs, ref_kwargs = _stand_in_backbones(True), _stand_in_backbones(False)
    for name in image.__all__:
        cls, ref_cls = getattr(image, name), getattr(jax_image, name)
        for attr in ("higher_is_better", "is_differentiable", "full_state_update", "plot_lower_bound",
                     "plot_upper_bound"):
            assert getattr(cls, attr, None) == getattr(ref_cls, attr, None), (name, attr)
        port, ref = cls(device="cpu", **port_kwargs.get(name, {})), ref_cls(**ref_kwargs.get(name, {}))
        assert sorted(port._defaults) == sorted(ref._defaults), name
        for state, default in ref._defaults.items():
            mine = port._defaults[state]
            if isinstance(default, list):
                assert mine == [], (name, state)
            else:
                assert str(mine.dtype).split(".")[-1] == str(default.dtype), (name, state)
            mine_fx, ref_fx = port._reductions[state], ref._reductions[state]
            assert getattr(mine_fx, "__name__", mine_fx) == getattr(ref_fx, "__name__", ref_fx), (name, state)


def test_constructor_errors_raise_what_jax_raises():
    cases = [
        ("StructuralSimilarityIndexMeasure", {"reduction": "mean"}),
        ("MultiScaleStructuralSimilarityIndexMeasure", {"betas": (1, 2)}),
        ("MultiScaleStructuralSimilarityIndexMeasure", {"normalize": "max"}),
        ("MultiScaleStructuralSimilarityIndexMeasure", {"kernel_size": 11.0}),
        ("PeakSignalNoiseRatio", {"dim": 1}),
        ("PeakSignalNoiseRatioWithBlockedEffect", {"block_size": 0}),
        ("VisualInformationFidelity", {"sigma_n_sq": -1.0}),
        ("TotalVariation", {"reduction": "max"}),
        ("RootMeanSquaredErrorUsingSlidingWindow", {"window_size": 0}),
        ("RelativeAverageSpectralError", {"window_size": 1.5}),
        ("SpectralDistortionIndex", {"p": 0}),
        ("SpectralDistortionIndex", {"reduction": None}),
    ]
    for name, kwargs in cases:
        with pytest.raises(Exception) as want:
            getattr(jax_image, name)(**kwargs)
        with pytest.raises(want.type):
            getattr(image, name)(**kwargs, device="cpu")
    with pytest.warns(UserWarning, match="any effect"):
        image.PeakSignalNoiseRatio(reduction="sum", device="cpu")


def _restoration_members(pkg, **extra):
    return {
        "psnr": pkg.PeakSignalNoiseRatio(data_range=1.0, **extra),
        "ssim": pkg.StructuralSimilarityIndexMeasure(data_range=1.0, **extra),
        "ms_ssim": pkg.MultiScaleStructuralSimilarityIndexMeasure(data_range=1.0, betas=BETAS, **extra),
        "uqi": pkg.UniversalImageQualityIndex(**extra),
        "vif": pkg.VisualInformationFidelity(**extra),
    }


def test_restoration_collection_matches_the_jax_collection():
    """The restoration stream's RGB collection over three batches: every
    member's states and value equal the JAX collection's."""
    port = _port_run(MetricCollection(_restoration_members(image, device="cpu"), device="cpu"), BATCHES["rgb"])
    want_states, want_values = _jax_run(
        lambda: tpumetrics.MetricCollection(_restoration_members(jax_image), compute_groups=False), BATCHES["rgb"]
    )
    got_states = {name: export_state(m) for name, m in port.items()}
    assert sorted(got_states) == sorted(want_states)
    for name, states in want_states.items():
        _same_states(got_states[name], states)
    got_values = port.compute()
    assert sorted(got_values) == sorted(want_values)
    for name, value in want_values.items():
        _close(got_values[name].numpy(), value)


def test_fused_collection_matches_the_unfused_one_bit_for_bit():
    """Total variation, the RGB and Y collections of the restoration stream,
    and the pan-sharpening members with a SAM capacity copy, advance through the
    fused step (eager, the capture's stand-in, replays) bit for bit the
    unfused collections; the list-state leaders (ERGAS, RASE) stay eager,
    the buffered SAM copy fuses."""

    def buffered_sam():
        sam = image.SpectralAngleMapper(reduction="none", device="cpu")
        for state in ("preds", "target"):
            sam.set_state_capacity(state, 12, feature_shape=(8, 32, 32))
        load_state(sam, sam.init_state())
        return sam

    def buffered_tv():
        # TV registers a per-image list state even under reduction="sum", where it stays empty: held in a
        # MaskedBuffer it no longer keeps TV out of the fused step
        tv = image.TotalVariation(device="cpu")
        tv.set_state_capacity("score_list", 12)
        load_state(tv, tv.init_state())
        return tv

    makers = {
        "img": lambda: {"tv": buffered_tv(), "tv_list": image.TotalVariation(reduction="mean", device="cpu")},
        "rgb": lambda: _restoration_members(image, device="cpu"),
        "gray": lambda: {"psnr": image.PeakSignalNoiseRatio(data_range=1.0, device="cpu"),
                         "ssim": image.StructuralSimilarityIndexMeasure(data_range=1.0, device="cpu"),
                         "psnrb": image.PeakSignalNoiseRatioWithBlockedEffect(device="cpu")},
        "spec": lambda: {"ergas": image.ErrorRelativeGlobalDimensionlessSynthesis(ratio=4, device="cpu"),
                         "sam": image.SpectralAngleMapper(device="cpu"), "cap_sam": buffered_sam(),
                         "rase": image.RelativeAverageSpectralError(device="cpu"),
                         "rmse_sw": image.RootMeanSquaredErrorUsingSlidingWindow(window_size=8, device="cpu")},
    }
    for kind, make in makers.items():
        plain = MetricCollection(make(), device="cpu")
        fused = MetricCollection(make(), device="cpu", fused_update=True)
        b = BATCHES[kind]
        for batch in [b[0], b[1], b[0], b[2], b[1]]:
            args = tuple(torch.from_numpy(x) for x in batch)
            plain.update(*args)
            fused.update(*args)
            got, want = export_state(fused), export_state(plain)
            assert sorted(got) == sorted(want)
            for leader in want:
                for state, ref in want[leader].items():
                    val = got[leader][state]
                    refs, vals = (ref, val) if isinstance(ref, (list, tuple)) else ([ref], [val])
                    assert all(np.array_equal(v, r) for v, r in zip(vals, refs, strict=True)), (kind, leader, state)
        step = fused._fused_oo_step
        assert step.counts == {"eager": 1, "captured": 1, "replayed": 2, "unfused": 0}, kind
        if kind == "spec":
            assert sorted(step.leaders) == ["cap_sam", "rmse_sw", "sam"]  # ERGAS and RASE keep list states
        if kind == "img":
            assert step.leaders == ["tv"]  # the TV whose list state is a plain list stays eager
        for name, value in plain.compute().items():
            assert torch.equal(fused.compute()[name], value), (kind, name)


def test_sam_capacity_copy_equals_its_list_states():
    """A SAM under ``reduction="none"`` with its images in MaskedBuffers
    computes the same per-pixel angles as the one with list states."""
    listed = _port_run(image.SpectralAngleMapper(reduction="none", device="cpu"), BATCHES["spec"])
    sam = image.SpectralAngleMapper(reduction="none", device="cpu")
    for state in ("preds", "target"):
        sam.set_state_capacity(state, 8, feature_shape=(8, 32, 32))
    load_state(sam, sam.init_state())
    buffered = _port_run(sam, BATCHES["spec"])
    assert torch.equal(buffered.compute(), listed.compute())
    assert int(buffered.preds.buffer.count) == 6


@pytest.mark.parametrize("direction", ["jax-to-port", "port-to-jax"])
def test_states_round_trip_through_interop(direction):
    """A state made by one package, loaded into the other, continues there
    and computes the value of the whole stream (SSIM and PSNR with a tracked
    range)."""
    first, rest = BATCHES["rgb"][:1], BATCHES["rgb"][1:]
    for name in ("StructuralSimilarityIndexMeasure", "PeakSignalNoiseRatio"):
        whole = _port_run(getattr(image, name)(device="cpu"), BATCHES["rgb"]).compute()
        if direction == "jax-to-port":
            states, _ = _jax_run(getattr(jax_image, name), first)
            port = getattr(image, name)(device="cpu")
            load_state(port, states)
            port._update_count = 1
            _close(_port_run(port, rest).compute().numpy(), whole.numpy())
        else:
            states = export_state(_port_run(getattr(image, name)(device="cpu"), first))
            ref = getattr(jax_image, name)()
            for k, v in states.items():
                setattr(ref, k, jnp.asarray(v))
            ref._update_count = 1
            for b in rest:
                ref.update(*(jnp.asarray(x) for x in b))
            _close(np.asarray(ref.compute()), whole.numpy())


def test_fused_update_of_a_psnr_with_a_tracked_range_keeps_it_on_the_device():
    """PSNR's tracked min and max are device states that the fused step
    carries: no float() or item() in ``update``, the value the unfused one."""
    plain = image.PeakSignalNoiseRatio(device="cpu")
    fused = MetricCollection({"psnr": image.PeakSignalNoiseRatio(device="cpu")}, device="cpu", fused_update=True)
    for b in BATCHES["rgb"] * 2:
        plain.update(*(torch.from_numpy(x) for x in b))
        fused.update(*(torch.from_numpy(x) for x in b))
    assert fused._fused_oo_step.counts["replayed"] >= 1
    assert torch.equal(fused.compute()["psnr"], plain.compute())
    assert fused["psnr"].min_target.ndim == 0 and fused["psnr"].max_target.ndim == 0


def test_forward_returns_the_batch_value_and_accumulates():
    """``forward`` gives each batch's SSIM and leaves the stream's in the state."""
    port = image.StructuralSimilarityIndexMeasure(device="cpu")
    jax_ssim = jax.jit(jax_fn.structural_similarity_index_measure)
    for b in BATCHES["rgb"]:
        batch_value = port(*(torch.from_numpy(x) for x in b))
        _close(batch_value.numpy(), np.asarray(jax_ssim(*(jnp.asarray(x) for x in b))))
    _close(port.compute().numpy(), _jax_run(jax_image.StructuralSimilarityIndexMeasure, BATCHES["rgb"])[1])
