"""The port's SRMR, its IIR cascade's plain version, and PESQ and STOI,
held against the JAX package on the CPU.

The same numpy inputs, made from a seed, go through each JAX function or
class and its counterpart in ``tpumetrics_torch``. One input shape per JAX
function (8 kHz, 0.3 s, two waveforms), so that each compiles once.
Tolerances:

- the float64 filter design equals the JAX arrays exactly (a copy of it);
- the plain cascade equals a float32 numpy loop of the same steps bit for
  bit; the float32 steps and the JAX ``_biquad_cascade`` are within
  ``CASCADE_RTOL`` of the output's peak of the float64 reference
  (``biquad_cascade_reference``, scipy's ``lfilter``), the yardstick the
  card's kernel is held to; against the JAX ``_biquad_cascade`` (a ``lax.scan`` whose step XLA
  rounds differently, from the second sample on) within ``CASCADE_RTOL`` of
  the output's peak: 1e-4 for the gammatone bank and 2e-3 for the
  modulation bank, whose poles lie closer to the unit circle and carry a
  rounding difference further along T (measured 8e-6 and 2.5e-4);
- SRMR within ``SRMR_RTOL`` = 5e-4 relative of the JAX score (measured
  7e-5): the cascades above, and FFTs and a strided correlation summed in
  another order.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpumetrics.audio as jax_audio
import tpumetrics.functional.audio.srmr as jax_srmr
import tpumetrics_torch.audio as audio
from tpumetrics_torch import MetricCollection
from tpumetrics_torch.functional.audio import srmr
from tpumetrics_torch.functional.audio.pesq import perceptual_evaluation_speech_quality
from tpumetrics_torch.functional.audio.stoi import short_time_objective_intelligibility
from tpumetrics_torch.interop import export_state, load_state
from tpumetrics_torch.ops import biquad
from tpumetrics_torch.utils.imports import _PESQ_AVAILABLE, _PYSTOI_AVAILABLE

CASCADE_RTOL = {"gammatone": 1e-4, "modulation": 2e-3}
SRMR_RTOL = 5e-4
FS, T = 8000, 2400  # 0.3 s at 8 kHz; one 0.256 s window is 2048 samples


def _waves(seed=0, b=2, t=T):
    """Speech-like test signals: noise under a 4 Hz envelope."""
    rng = np.random.default_rng(seed)
    env = 1 + np.sin(2 * np.pi * 4 * np.arange(t) / FS)
    return (rng.standard_normal((b, t)) * env).astype(np.float32)


@pytest.mark.parametrize("fs", [8000, 16000])
def test_filter_design_equals_the_jax_arrays(fs):
    assert np.array_equal(srmr._erb_space(125.0, fs / 2, 23), jax_srmr._erb_space(125.0, fs / 2, 23))
    assert np.array_equal(srmr._erbs(125.0, fs, 23), jax_srmr._erbs(125.0, fs, 23))
    assert np.array_equal(srmr._gammatone_coefs(fs, 23, 125.0), jax_srmr._gammatone_coefs(fs, 23, 125.0))
    for max_cf in (30.0, 128.0):
        for got, want in zip(srmr._modulation_filterbank(4.0, max_cf, 8, float(fs), 2.0),
                             jax_srmr._modulation_filterbank(4.0, max_cf, 8, float(fs), 2.0)):
            assert np.array_equal(got, want)


def test_device_constants_are_the_jax_float32_arrays():
    const = srmr._constants(FS, 23, 125, 4, 128.0, "cpu")
    coefs = jax_srmr._gammatone_coefs(FS, 23, 125.0)
    a_rows = np.stack([coefs[:, (0, 1, 5)], coefs[:, (0, 2, 5)], coefs[:, (0, 3, 5)], coefs[:, (0, 4, 5)]])
    _, mfb, cutoffs = jax_srmr._modulation_filterbank(4.0, 128.0, 8, float(FS), 2.0)
    window = jnp.asarray(np.hamming(2048 + 2)[:2048], jnp.float32)
    want = {"as_": a_rows, "bs": np.broadcast_to(coefs[None, :, (6, 7, 8)], (4, 23, 3)), "gain": coefs[:, 9],
            "mb": mfb[:, 0], "ma": mfb[:, 1], "cutoffs": cutoffs, "erbs_asc": np.flipud(jax_srmr._erbs(125.0, FS, 23)),
            "window_sq": window**2}
    assert sorted(const) == sorted(want)
    for k, v in want.items():
        assert const[k].dtype == torch.float32
        assert np.array_equal(const[k].numpy(), np.asarray(jnp.asarray(v, jnp.float32))), k
    assert srmr._constants(FS, 23, 125, 4, 128.0, "cpu") is const  # made once per device and configuration


def _cascade_inputs(kind, seed=1):
    """``(x, b, a, clamp)`` of one call site at 8 kHz, two waveforms: the
    gammatone bank (46 lanes, 4 stages, clipped) or the modulation bank (368
    lanes, 1 stage)."""
    rng = np.random.default_rng(seed)
    const = srmr._constants(FS, 23, 125, 4, 128.0, "cpu")
    if kind == "gammatone":
        x = np.repeat(rng.uniform(-1, 1, (2, 1, T)), 23, axis=1).reshape(46, T).astype(np.float32)
        return x, const["as_"].repeat(1, 2, 1).numpy(), const["bs"].repeat(1, 2, 1).numpy(), True
    x = np.repeat(np.abs(rng.standard_normal((46, 1, T))) * 1e-3, 8, axis=1).reshape(368, T).astype(np.float32)
    return x, const["mb"].repeat(46, 1)[None].numpy(), const["ma"].repeat(46, 1)[None].numpy(), False


def _numpy_cascade(x, b, a, clamp):
    """The cascade as float32 numpy steps, each product, sum and difference rounded on its own."""
    b = (b / a[..., :1]).astype(np.float32)
    a = (a / a[..., :1]).astype(np.float32)
    s0 = np.zeros((b.shape[0], x.shape[0]), np.float32)
    s1 = np.zeros_like(s0)
    out = np.empty_like(x)
    for t in range(x.shape[1]):
        h = x[:, t]
        for i in range(b.shape[0]):
            y = b[i, :, 0] * h + s0[i]
            s0[i] = b[i, :, 1] * h - a[i, :, 1] * y + s1[i]
            s1[i] = b[i, :, 2] * h - a[i, :, 2] * y
            h = np.clip(y, -1, 1) if clamp else y
        out[:, t] = h
    return out


@functools.cache
def _jax_cascade(kind):
    x, b, a, clamp = _cascade_inputs(kind)
    return np.asarray(jax_srmr._biquad_cascade(jnp.asarray(x), jnp.asarray(b), jnp.asarray(a), clamp=clamp))


@functools.cache
def _numpy_steps(kind):
    return _numpy_cascade(*_cascade_inputs(kind))


@pytest.mark.parametrize("kind", ["gammatone", "modulation"])
def test_plain_cascade_is_the_float32_steps_and_matches_jax(kind):
    x, b, a, clamp = _cascade_inputs(kind)
    got = biquad.biquad_cascade(torch.from_numpy(x), torch.from_numpy(b), torch.from_numpy(a), clamp).numpy()
    assert np.array_equal(got, _numpy_steps(kind))
    want = _jax_cascade(kind)
    assert np.max(np.abs(got - want)) <= CASCADE_RTOL[kind] * np.max(np.abs(want))


@pytest.mark.parametrize("kind", ["gammatone", "modulation"])
def test_float64_reference_holds_the_float32_steps_and_jax(kind):
    """The yardstick of the card's kernel, the cascade in float64 on the
    host: the float32 numpy steps and the JAX scan lie within
    ``CASCADE_RTOL`` of its peak, and the plain loop's ``rel`` (which sets the
    kernel's tolerance, twice it plus 1e-6) is positive and below that."""
    x, b, a, clamp = _cascade_inputs(kind)
    ref = biquad.biquad_cascade_reference(torch.from_numpy(x), torch.from_numpy(b), torch.from_numpy(a), clamp)
    assert ref.dtype == np.float64 and ref.shape == x.shape
    steps = _numpy_steps(kind)
    peak = np.max(np.abs(ref))
    assert np.max(np.abs(steps - ref)) <= CASCADE_RTOL[kind] * peak
    assert np.max(np.abs(_jax_cascade(kind) - ref)) <= CASCADE_RTOL[kind] * peak
    rel_plain = biquad.relative_error(torch.from_numpy(steps), ref)
    assert 0 < rel_plain <= CASCADE_RTOL[kind]


def test_float64_reference_clips_between_stages_and_propagates_nan():
    """The reference follows the cascade's semantics: an impulse through one
    pole gives its powers exactly, the clip acts between the stages and not
    in a stage's recursion, and NaN passes it."""
    impulse = torch.tensor([[1.0, 0.0, 0.0, 0.0]])
    one_pole = (torch.tensor([[[1.0, 0.0, 0.0]]]), torch.tensor([[[1.0, -0.5, 0.0]]]))
    assert biquad.biquad_cascade_reference(impulse, *one_pole).tolist() == [[1.0, 0.5, 0.25, 0.125]]
    x = torch.tensor([[2.0, 0.0, 0.0, float("nan"), 0.0]])
    b = torch.tensor([[[1.0, 0.0, 0.0]], [[1.0, 0.0, 0.0]]])
    a = torch.tensor([[[1.0, -0.5, 0.0]], [[1.0, 0.0, 0.0]]])
    got = biquad.biquad_cascade_reference(x, b, a, clamp=True)
    assert got[0, :3].tolist() == [1.0, 1.0, 0.5] and np.isnan(got[0, 3:]).all()
    assert biquad.biquad_cascade_reference(x, b, a, clamp=False)[0, :3].tolist() == [2.0, 1.0, 0.5]


def test_relative_error_and_the_kernels_scratch():
    """``rel`` is the worst lane's max abs error over its peak, on the
    positions finite in both; a silent lane counts 0, or inf where the other
    is not silent there. The scratch: a 2-float carry per tile, lane and
    stage, and the ticket and one flag per tile and lane."""
    want = np.array([[1.0, -4.0, np.nan], [0.0, 0.0, 0.0], [2.0, 2.0, 2.0]])
    got = torch.tensor([[1.5, -4.0, 7.0], [0.0, 0.0, 0.0], [2.0, 2.0, float("inf")]])
    assert biquad.relative_error(got, want) == 0.125
    assert biquad.relative_error(torch.tensor([[0.0, 1e-30]]), np.zeros((1, 2))) == np.inf
    assert biquad.relative_error(torch.zeros(0, 4), np.zeros((0, 4))) == 0.0
    assert biquad.scratch_shapes(184, 128_000, 4, 4096) == (32, 2 * 32 * 184 * 4, 1 + 32 * 184)
    assert [biquad.scratch_shapes(3, t, 1, 4096)[0] for t in (1, 4095, 4096, 4097, 3 * 4096 + 5)] == [1, 1, 1, 2, 4]


def test_plain_cascade_clips_between_stages_keeps_the_recursion_and_propagates_nan():
    """With ``clamp`` a stage's output is clipped before the next stage, but
    its own recursion runs on the unclipped value; NaN passes the clip."""
    x = torch.tensor([[2.0, 0.0, 0.0, float("nan"), 0.0]])
    b = torch.tensor([[[1.0, 0.0, 0.0]], [[1.0, 0.0, 0.0]]])
    a = torch.tensor([[[1.0, -0.5, 0.0]], [[1.0, 0.0, 0.0]]])  # stage 1: y = x + 0.5 y[-1]; stage 2: identity
    got = biquad.biquad_cascade_plain(x, b, a, clamp=True)
    assert got[0, :3].tolist() == [1.0, 1.0, 0.5]  # stage 1 gives 2, 1, 0.5: clipped only where it leaves
    assert torch.isnan(got[0, 3:]).all()
    unclipped = biquad.biquad_cascade_plain(x, b, a, clamp=False)
    assert unclipped[0, :3].tolist() == [2.0, 1.0, 0.5]


def test_cascade_wrapper_checks_its_inputs():
    x = torch.zeros(3, 10)
    good = torch.zeros(1, 3, 3)
    good[..., 0] = 1
    with pytest.raises(ValueError, match="stages, 3, 3"):
        biquad.biquad_cascade(x, torch.zeros(1, 2, 3), torch.zeros(1, 2, 3))
    with pytest.raises(TypeError, match="float32"):
        biquad.biquad_cascade(x.double(), good, good)
    with pytest.raises(ValueError, match="at least 1 stage"):
        biquad.biquad_cascade_plain(x, torch.zeros(0, 3, 3), torch.zeros(0, 3, 3))
    # the kernel is built for SRMR's two cascades only, and the CPU path takes the same inputs
    for stages, clamp in ((1, True), (4, False), (2, True)):
        coef = good.expand(stages, 3, 3)
        with pytest.raises(ValueError, match="4 stages with clamp or 1 stage without"):
            biquad.biquad_cascade(x, coef, coef, clamp)
    with pytest.raises(ValueError, match="lanes, time"):
        biquad.biquad_cascade(torch.zeros(10), good, good)
    with pytest.raises(ValueError, match="cpu or cuda"):
        biquad.biquad_cascade(x.to("meta"), good.to("meta"), good.to("meta"))
    assert biquad.launches == 0  # the CPU path launches nothing
    # the float64 reference refuses what the wrapper refuses
    with pytest.raises(ValueError, match="stages, 3, 3"):
        biquad.biquad_cascade_reference(x, torch.zeros(1, 2, 3), torch.zeros(1, 2, 3))
    with pytest.raises(TypeError, match="float32"):
        biquad.biquad_cascade_reference(x.double(), good, good)
    with pytest.raises(ValueError, match="at least 1 stage"):
        biquad.biquad_cascade_reference(x, torch.zeros(0, 3, 3), torch.zeros(0, 3, 3))


def test_hilbert_envelope_and_energy_normalization_match_jax():
    x = _waves(2, t=1000)  # not a multiple of 16: the FFT length rounds up to 1008
    _closef(srmr._hilbert_env(torch.from_numpy(x)), jax_srmr._hilbert_env(jnp.asarray(x)), 1e-5)
    energy = np.abs(np.random.default_rng(3).standard_normal((2, 23, 8, 6))).astype(np.float32) ** 3
    _closef(srmr._normalize_energy(torch.from_numpy(energy)), jax_srmr._normalize_energy(jnp.asarray(energy)), 1e-6)


def _closef(got, want, rtol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * np.max(np.abs(want)))


@pytest.mark.parametrize("norm", [False, True])
def test_srmr_matches_jax(norm):
    x = _waves(4)
    got = srmr.speech_reverberation_modulation_energy_ratio(torch.from_numpy(x), FS, norm=norm)
    want = jax_srmr.speech_reverberation_modulation_energy_ratio(jnp.asarray(x), FS, norm=norm)
    assert got.dtype == torch.float32 and got.shape == (2,)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=SRMR_RTOL)


def test_srmr_shapes_and_integer_input():
    """A 1-D wave scores as ``(1,)``, leading axes are kept, and integer samples are scaled by their dtype's maximum."""
    x = _waves(5, b=2, t=2048)
    both = srmr.speech_reverberation_modulation_energy_ratio(torch.from_numpy(x), FS)
    one = srmr.speech_reverberation_modulation_energy_ratio(torch.from_numpy(x[0]), FS)
    assert one.shape == (1,) and torch.equal(one, both[:1])
    assert srmr.speech_reverberation_modulation_energy_ratio(torch.from_numpy(x).reshape(1, 2, -1), FS).shape == (1, 2)
    ints = torch.from_numpy(np.round(x / np.abs(x).max() * 32767).astype(np.int16))
    scaled = srmr.speech_reverberation_modulation_energy_ratio(ints.to(torch.float32) / 32767, FS)
    assert torch.equal(srmr.speech_reverberation_modulation_energy_ratio(ints, FS), scaled)


@pytest.mark.parametrize(
    "kwargs,error",
    [
        ({"fs": 0}, ValueError),
        ({"fs": 8000.0}, ValueError),
        ({"fs": FS, "n_cochlear_filters": 0}, ValueError),
        ({"fs": FS, "low_freq": -1}, ValueError),
        ({"fs": FS, "min_cf": 0}, ValueError),
        ({"fs": FS, "max_cf": -3}, ValueError),
        ({"fs": FS, "norm": 1}, ValueError),
        ({"fs": FS, "fast": True}, NotImplementedError),
    ],
)
def test_srmr_refuses_bad_arguments_as_the_jax_package_does(kwargs, error):
    x = torch.zeros(2048)
    with pytest.raises(error):
        srmr.speech_reverberation_modulation_energy_ratio(x, **kwargs)
    with pytest.raises(error):
        jax_srmr._srmr_arg_validate(**kwargs)
    with pytest.raises(error):
        audio.SpeechReverberationModulationEnergyRatio(**kwargs, device="cpu")


def test_srmr_refuses_an_input_shorter_than_one_window():
    with pytest.raises(ValueError, match="0.256 s analysis window"):
        srmr.speech_reverberation_modulation_energy_ratio(torch.zeros(2, 2047), FS)


def test_srmr_convolution_runs_in_full_float32_and_restores_the_callers_setting():
    """cuDNN takes float32 convolutions in TF32 by default: the windowed
    energies set IEEE float32 around the call and give the caller's setting back."""
    conv = torch.backends.cudnn.conv
    before = conv.fp32_precision
    seen = []
    real_conv1d = torch.nn.functional.conv1d

    def spy(*args, **kwargs):
        seen.append((conv.fp32_precision, torch.backends.mkldnn.conv.fp32_precision))
        return real_conv1d(*args, **kwargs)

    torch.nn.functional.conv1d = spy
    try:
        srmr.speech_reverberation_modulation_energy_ratio(torch.from_numpy(_waves(6, b=1, t=2048)), FS)
    finally:
        torch.nn.functional.conv1d = real_conv1d
    assert seen == [("ieee", "ieee")] and conv.fp32_precision == before


def test_srmr_class_matches_jax_and_fuses_bit_for_bit():
    """The modular metric against the JAX one over two batches; in a fused
    collection (eager, the capture's stand-in, a replay) its states equal the
    unfused ones bit for bit, and they load into the JAX metric."""
    x = _waves(4)
    port = audio.SpeechReverberationModulationEnergyRatio(FS, device="cpu")
    ref = jax_audio.SpeechReverberationModulationEnergyRatio(FS)
    plain = MetricCollection({"srmr": audio.SpeechReverberationModulationEnergyRatio(FS, device="cpu")}, device="cpu")
    fused = MetricCollection({"srmr": audio.SpeechReverberationModulationEnergyRatio(FS, device="cpu")}, device="cpu",
                             fused_update=True)
    for batch in (x, x[::-1].copy()):
        port.update(torch.from_numpy(batch))
        ref.update(jnp.asarray(batch))
    for batch in (x, x, x, x):
        plain.update(torch.from_numpy(batch))
        fused.update(torch.from_numpy(batch))
        got, want = export_state(fused)["srmr"], export_state(plain)["srmr"]
        assert all(np.array_equal(got[k], want[k]) for k in want)
    assert fused._fused_oo_step.counts == {"eager": 1, "captured": 1, "replayed": 1, "unfused": 0}
    np.testing.assert_allclose(float(port.compute()), float(ref.compute()), rtol=SRMR_RTOL)
    state = export_state(port)
    assert float(state["total"]) == 4.0 and state["sum_srmr"].dtype == np.float32
    again = audio.SpeechReverberationModulationEnergyRatio(FS, device="cpu")
    load_state(again, {k: np.asarray(getattr(ref, k)) for k in ref._defaults})
    again._update_count = 2
    np.testing.assert_allclose(float(again.compute()), float(ref.compute()), rtol=1e-7)


@pytest.mark.parametrize("which", ["pesq", "stoi"])
def test_pesq_and_stoi_need_their_host_packages(which):
    """Neither ``pesq`` nor ``pystoi`` is installed here: the function and the
    class raise ``ModuleNotFoundError``, as the JAX package's do."""
    available = _PESQ_AVAILABLE if which == "pesq" else _PYSTOI_AVAILABLE
    if available:
        pytest.skip(f"{which} is installed")
    x = torch.zeros(8000)
    with pytest.raises(ModuleNotFoundError, match="pesq" if which == "pesq" else "pystoi"):
        if which == "pesq":
            perceptual_evaluation_speech_quality(x, x, 8000, "nb")
        else:
            short_time_objective_intelligibility(x, x, 8000)
    with pytest.raises(ModuleNotFoundError):
        if which == "pesq":
            audio.PerceptualEvaluationSpeechQuality(8000, "nb", device="cpu")
        else:
            audio.ShortTimeObjectiveIntelligibility(8000, device="cpu")
