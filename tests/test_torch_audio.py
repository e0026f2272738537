"""The port's audio domain (SNR, SDR, PIT), held against the JAX package on the CPU.

The same numpy inputs, made from a seed, go through each JAX function or
class and its counterpart in ``tpumetrics_torch``. Tolerances:

- SNR, SI-SNR, SI-SDR, SA-SDR and C-SI-SNR within ``DB_ATOL`` = 1e-4 dB:
  the same float32 arithmetic, the sums over time taken in another order
  (the differences measured are below 3e-6 dB);
- SDR within ``SDR_ATOL`` = 1e-3 dB of the JAX function: both solve the
  float32 Toeplitz system by LU with partial pivoting, in different LAPACK
  builds (measured below 1e-4 dB at ``filter_length`` 512 and T=1000);
  against a float64 ``scipy.linalg.solve_toeplitz`` oracle within
  ``SDR_ORACLE_ATOL`` = 5e-3 dB (the float32 solve's own error);
- PIT's permutations equal, its best metric within ``DB_ATOL``; the
  modular states (float32 sums and counts) within ``DB_ATOL`` per sample.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpumetrics
import tpumetrics.audio as jax_audio
import tpumetrics.functional.audio as jax_fn
import tpumetrics_torch.audio as audio
import tpumetrics_torch.functional.audio as fn
from tpumetrics_torch import MetricCollection
from tpumetrics_torch.functional.audio import pit as pit_module
from tpumetrics_torch.interop import export_state, load_state
from tpumetrics_torch.metric import Metric

DB_ATOL = 1e-4
SDR_ATOL = 1e-3
SDR_ORACLE_ATOL = 5e-3
B, SPK, T = 4, 2, 1000


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _close(got, want, atol=DB_ATOL):
    got, want = _np(got).astype(np.float64), _np(want).astype(np.float64)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=atol)


def _signals(seed=0, spk=SPK, b=B, t=T, swap=False):
    """``(preds, target)`` float32 ``(b, spk, t)``: targets of unit power and
    estimates at about 10 dB; with ``swap`` the estimates' speakers reversed."""
    rng = np.random.default_rng(seed)
    target = rng.standard_normal((b, spk, t)).astype(np.float32)
    preds = (target + 0.3 * rng.standard_normal((b, spk, t))).astype(np.float32)
    return (preds[:, ::-1].copy() if swap else preds), target


SNR_CASES = [
    ("signal_noise_ratio", {}),
    ("signal_noise_ratio", {"zero_mean": True}),
    ("scale_invariant_signal_noise_ratio", {}),
    ("scale_invariant_signal_distortion_ratio", {}),
    ("scale_invariant_signal_distortion_ratio", {"zero_mean": True}),
    ("source_aggregated_signal_distortion_ratio", {}),
    ("source_aggregated_signal_distortion_ratio", {"scale_invariant": False}),
    ("source_aggregated_signal_distortion_ratio", {"zero_mean": True}),
]


@pytest.mark.parametrize("name,kwargs", SNR_CASES, ids=[f"{n}-{k}" for n, k in SNR_CASES])
def test_snr_family_matches_jax(name, kwargs):
    preds, target = _signals(1)
    got = getattr(fn, name)(torch.from_numpy(preds), torch.from_numpy(target), **kwargs)
    want = getattr(jax_fn, name)(jnp.asarray(preds), jnp.asarray(target), **kwargs)
    assert got.dtype == torch.float32
    _close(got, want)


@pytest.mark.parametrize("form", ["complex", "stacked"])
def test_complex_si_snr_matches_jax(form):
    rng = np.random.default_rng(2)
    spec = (rng.standard_normal((B, 9, 20)) + 1j * rng.standard_normal((B, 9, 20))).astype(np.complex64)
    noisy = (spec + 0.2 * (rng.standard_normal(spec.shape) + 1j * rng.standard_normal(spec.shape))).astype(np.complex64)
    if form == "stacked":
        spec, noisy = (np.stack([z.real, z.imag], -1) for z in (spec, noisy))
    got = fn.complex_scale_invariant_signal_noise_ratio(torch.from_numpy(noisy), torch.from_numpy(spec))
    want = jax_fn.complex_scale_invariant_signal_noise_ratio(jnp.asarray(noisy), jnp.asarray(spec))
    _close(got, want)


def test_complex_si_snr_refuses_a_real_input_without_its_last_axis_of_two():
    x = torch.zeros(2, 9, 20, 3)
    with pytest.raises(RuntimeError, match="frequency, time, 2"):
        fn.complex_scale_invariant_signal_noise_ratio(x, x)
    with pytest.raises(RuntimeError, match="frequency, time, 2"):
        fn.complex_scale_invariant_signal_noise_ratio(torch.zeros(9, 2), torch.zeros(9, 2))


@pytest.mark.parametrize("filter_length,zero_mean", [(64, False), (512, False), (512, True)])
def test_sdr_matches_jax(filter_length, zero_mean):
    preds, target = _signals(3)
    kw = {"filter_length": filter_length, "zero_mean": zero_mean}
    got = fn.signal_distortion_ratio(torch.from_numpy(preds), torch.from_numpy(target), **kw)
    want = jax_fn.signal_distortion_ratio(jnp.asarray(preds), jnp.asarray(target), **kw)
    assert got.dtype == torch.float32 and got.shape == (B, SPK)
    _close(got, want, SDR_ATOL)


def _sdr_oracle(preds, target, filter_length, load_diag=1e-6):
    """SDR in float64: FFT correlations and ``scipy.linalg.solve_toeplitz``
    (Levinson), with the metric's diagonal loading."""
    from scipy.linalg import solve_toeplitz

    p, t = preds.astype(np.float64), target.astype(np.float64)
    t = t / np.maximum(np.linalg.norm(t, axis=-1, keepdims=True), 1e-6)
    p = p / np.maximum(np.linalg.norm(p, axis=-1, keepdims=True), 1e-6)
    n_fft = 2 ** math.ceil(math.log2(2 * t.shape[-1] - 1))
    t_fft, p_fft = np.fft.rfft(t, n_fft), np.fft.rfft(p, n_fft)
    r0 = np.fft.irfft(np.abs(t_fft) ** 2, n_fft)[..., :filter_length]
    r0[..., 0] += load_diag
    b = np.fft.irfft(np.conj(t_fft) * p_fft, n_fft)[..., :filter_length]
    flat_r, flat_b = r0.reshape(-1, filter_length), b.reshape(-1, filter_length)
    coh = np.asarray([bb @ solve_toeplitz(rr, bb) for rr, bb in zip(flat_r, flat_b)]).reshape(t.shape[:-1])
    return 10 * np.log10(coh / (1 - coh))


def test_sdr_against_a_float64_toeplitz_oracle():
    preds, target = _signals(4)
    for filter_length in (64, 512):
        got = fn.signal_distortion_ratio(torch.from_numpy(preds), torch.from_numpy(target), filter_length=filter_length)
        _close(got, _sdr_oracle(preds, target, filter_length), SDR_ORACLE_ATOL)


def test_sdr_solves_in_float32_whatever_the_input_dtype():
    """The JAX package without ``jax_enable_x64`` casts to float32; so does the port, for float64 inputs too."""
    preds, target = _signals(5, b=2)
    as32 = fn.signal_distortion_ratio(torch.from_numpy(preds), torch.from_numpy(target), filter_length=128)
    as64 = fn.signal_distortion_ratio(torch.from_numpy(preds).double(), torch.from_numpy(target).double(), filter_length=128)
    assert as64.dtype == torch.float32 and torch.equal(as32, as64)


@pytest.mark.parametrize("spk", [2, 3])
@pytest.mark.parametrize("mode", ["speaker-wise", "permutation-wise"])
@pytest.mark.parametrize("eval_func", ["max", "min"])
def test_pit_matches_jax(spk, mode, eval_func):
    """2 speakers take the exhaustive search, 3 the Hungarian assignment on
    the host (speaker-wise); permutation-wise scores whole permutations with
    SA-SDR, as that mode expects a per-sample metric."""
    preds, target = _signals(6 + spk, spk=spk, swap=True)
    port_metric = fn.scale_invariant_signal_distortion_ratio if mode == "speaker-wise" else fn.source_aggregated_signal_distortion_ratio
    jax_metric = jax_fn.scale_invariant_signal_distortion_ratio if mode == "speaker-wise" else jax_fn.source_aggregated_signal_distortion_ratio
    got, got_perm = fn.permutation_invariant_training(torch.from_numpy(preds), torch.from_numpy(target), port_metric,
                                                      mode=mode, eval_func=eval_func)
    want, want_perm = jax_fn.permutation_invariant_training(jnp.asarray(preds), jnp.asarray(target), jax_metric,
                                                            mode=mode, eval_func=eval_func)
    _close(got, want)
    assert got_perm.dtype == torch.int64 and np.array_equal(got_perm.numpy(), np.asarray(want_perm))
    if eval_func == "max":  # the swapped speakers are recovered
        assert np.array_equal(got_perm.numpy(), np.tile(np.arange(spk)[::-1], (B, 1)))
    reordered = fn.pit_permutate(torch.from_numpy(preds), got_perm)
    assert np.array_equal(reordered.numpy(), np.asarray(jax_fn.pit_permutate(jnp.asarray(preds), want_perm)))


def test_exhaustive_and_hungarian_searches_agree_and_may_differ_only_on_ties():
    rng = np.random.default_rng(8)
    mtx = torch.from_numpy(rng.standard_normal((6, 4, 4)).astype(np.float32))
    for eval_func in ("max", "min"):
        m1, p1 = pit_module._find_best_perm_by_exhaustive_method(mtx, eval_func)
        m2, p2 = pit_module._find_best_perm_by_linear_sum_assignment(mtx, eval_func)
        assert torch.equal(p1, p2)
        _close(m1, m2, 1e-6)
    tied = torch.ones(2, 3, 3)  # every permutation scores the same
    (m1, p1), (m2, p2) = (pit_module._find_best_perm_by_exhaustive_method(tied, "max"),
                          pit_module._find_best_perm_by_linear_sum_assignment(tied, "max"))
    assert torch.equal(m1, m2) and sorted(p1[0].tolist()) == sorted(p2[0].tolist()) == [0, 1, 2]


def test_permutations_decoded_on_the_device_are_itertools_order():
    for spk in range(1, 7):
        decoded = pit_module._decode_permutations(spk, torch.device("cpu"))
        assert decoded.dtype == torch.int64 and np.array_equal(decoded.numpy(), pit_module._perm_array(spk))


def test_pit_under_capture_is_exhaustive_up_to_six_speakers(monkeypatch):
    """Where a CUDA graph is being captured, 3 speakers take the exhaustive
    search (no host read) and give the Hungarian result; more than 6 raise."""
    preds, target = _signals(9, spk=3, swap=True)
    p, t = torch.from_numpy(preds), torch.from_numpy(target)
    eager = fn.permutation_invariant_training(p, t, fn.scale_invariant_signal_distortion_ratio)
    monkeypatch.setattr(pit_module, "_is_capturing", lambda: True)
    monkeypatch.setattr(pit_module, "_ps_device", {})  # a capture decodes the permutations on the device
    monkeypatch.setattr(pit_module, "_find_best_perm_by_linear_sum_assignment", None)
    captured = fn.permutation_invariant_training(p, t, fn.scale_invariant_signal_distortion_ratio)
    assert torch.equal(captured[1], eager[1])
    _close(captured[0], eager[0], 1e-6)
    assert pit_module._ps_device == {}  # nothing made under capture is cached
    big = torch.zeros(1, 7, 16)
    with pytest.raises(ValueError, match="more than 6 speakers"):
        fn.permutation_invariant_training(big, big, fn.signal_noise_ratio)


def test_pit_refuses_bad_arguments():
    p = torch.zeros(2, 2, 8)
    with pytest.raises(RuntimeError, match="batch and speaker"):
        fn.permutation_invariant_training(p, torch.zeros(2, 3, 8), fn.signal_noise_ratio)
    with pytest.raises(ValueError, match="eval_func"):
        fn.permutation_invariant_training(p, p, fn.signal_noise_ratio, eval_func="mean")
    with pytest.raises(ValueError, match="mode"):
        fn.permutation_invariant_training(p, p, fn.signal_noise_ratio, mode="pairwise")
    with pytest.raises(ValueError, match="eval_func"):
        audio.PermutationInvariantTraining(fn.signal_noise_ratio, eval_func="mean", device="cpu")


MODULAR = [
    ("SignalNoiseRatio", {}, "pair"),
    ("ScaleInvariantSignalNoiseRatio", {}, "pair"),
    ("ScaleInvariantSignalDistortionRatio", {"zero_mean": True}, "pair"),
    ("SourceAggregatedSignalDistortionRatio", {}, "pair"),
    ("SignalDistortionRatio", {"filter_length": 128}, "pair"),
    ("ComplexScaleInvariantSignalNoiseRatio", {}, "spectra"),
    ("PermutationInvariantTraining", {"mode": "speaker-wise"}, "pit"),
]


def _modular(pkg, fpkg, name, kwargs, kind, device=None):
    extra = {} if device is None else {"device": device}
    if kind == "pit":
        return pkg.PermutationInvariantTraining(fpkg.scale_invariant_signal_distortion_ratio, **kwargs, **extra)
    return getattr(pkg, name)(**kwargs, **extra)


def _batches(kind, n=2):
    out = []
    for s in range(n):
        preds, target = _signals(20 + s, swap=s == 1)
        if kind == "spectra":
            preds, target = (x.reshape(B, SPK, 20, 25, 2) for x in (preds, target))
        out.append((preds, target))
    return out


@pytest.mark.parametrize("name,kwargs,kind", MODULAR, ids=[m[0] for m in MODULAR])
def test_modular_metrics_match_jax(name, kwargs, kind):
    port = _modular(audio, fn, name, kwargs, kind, device="cpu")
    ref = _modular(jax_audio, jax_fn, name, kwargs, kind)
    for preds, target in _batches(kind):
        port.update(torch.from_numpy(preds), torch.from_numpy(target))
        ref.update(jnp.asarray(preds), jnp.asarray(target))
    got, want = export_state(port), {k: np.asarray(getattr(ref, k)) for k in ref._defaults}
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert got[k].dtype == np.float32 and got[k].shape == v.shape == ()
        _close(got[k], v, DB_ATOL * float(want[next(iter(n for n in want if n in ("total", "num")))]))
    _close(port.compute(), ref.compute(), SDR_ATOL if name == "SignalDistortionRatio" else DB_ATOL)


def test_metric_base_kwargs_are_the_jax_set_and_device():
    assert Metric._BASE_KWARGS == tpumetrics.Metric._BASE_KWARGS | {"device"}


def test_pit_class_gives_base_kwargs_to_the_metric_and_the_rest_to_the_function():
    pit = audio.PermutationInvariantTraining(fn.scale_invariant_signal_distortion_ratio, device="cpu",
                                             compute_with_cache=False, zero_mean=True)
    assert pit.device.type == "cpu" and pit.compute_with_cache is False and pit.kwargs == {"zero_mean": True}
    assert pit._update_reads_host  # speaker-wise: 3 speakers or more read the host
    assert not audio.PermutationInvariantTraining(fn.source_aggregated_signal_distortion_ratio,
                                                  mode="permutation-wise", device="cpu")._update_reads_host
    preds, target = _signals(30, swap=True)
    pit.update(torch.from_numpy(preds), torch.from_numpy(target))
    want = jax_fn.permutation_invariant_training(jnp.asarray(preds), jnp.asarray(target),
                                                 jax_fn.scale_invariant_signal_distortion_ratio, zero_mean=True)[0]
    _close(pit.compute(), np.mean(np.asarray(want)))


def test_modular_argument_checks():
    with pytest.raises(ValueError, match="zero_mean"):
        audio.ScaleInvariantSignalDistortionRatio(zero_mean=1, device="cpu")
    with pytest.raises(ValueError, match="scale_invariant"):
        audio.SourceAggregatedSignalDistortionRatio(scale_invariant=None, device="cpu")
    with pytest.raises(ValueError, match="zero_mean"):
        audio.ComplexScaleInvariantSignalNoiseRatio(zero_mean="no", device="cpu")
    with pytest.raises(RuntimeError, match="spk, time"):
        fn.source_aggregated_signal_distortion_ratio(torch.zeros(8), torch.zeros(8))
    with pytest.raises(RuntimeError, match="same shape"):
        fn.signal_noise_ratio(torch.zeros(2, 8), torch.zeros(2, 9))


def test_sdr_stays_eager_in_a_fused_collection_only_on_a_card():
    """SDR's batched LU cannot be captured on a card; on the CPU nothing is captured and it fuses."""
    assert audio.SignalDistortionRatio(device="cpu")._update_reads_host is False


def test_fused_collection_matches_the_unfused_one_bit_for_bit():
    """SI-SNR, SNR, SA-SDR and SDR advance through the fused step (eager,
    the capture's stand-in, replays) bit for bit the unfused collection;
    speaker-wise PIT, which may read the host, stays eager."""

    def members():
        return {"si_snr": audio.ScaleInvariantSignalNoiseRatio(device="cpu"),
                "snr": audio.SignalNoiseRatio(device="cpu"),
                "sa_sdr": audio.SourceAggregatedSignalDistortionRatio(device="cpu"),
                "sdr": audio.SignalDistortionRatio(filter_length=64, device="cpu"),
                "pit": audio.PermutationInvariantTraining(fn.scale_invariant_signal_distortion_ratio, device="cpu")}

    plain = MetricCollection(members(), device="cpu")
    fused = MetricCollection(members(), device="cpu", fused_update=True)
    batches = _batches("pair")
    for preds, target in [batches[0], batches[1], batches[0], batches[1], batches[0]]:
        args = (torch.from_numpy(preds), torch.from_numpy(target))
        plain.update(*args)
        fused.update(*args)
        got, want = export_state(fused), export_state(plain)
        assert all(np.array_equal(got[k][s], want[k][s]) for k in want for s in want[k])
    step = fused._fused_oo_step
    assert sorted(step.leaders) == ["sa_sdr", "sdr", "si_snr", "snr"]
    assert step.counts == {"eager": 1, "captured": 1, "replayed": 2, "unfused": 0}
    for k, v in plain.compute().items():
        assert torch.equal(fused.compute()[k], v)


@pytest.mark.parametrize("direction", ["jax-to-port", "port-to-jax"])
def test_states_round_trip_through_interop(direction):
    """A state made by one package, loaded into the other, continues there
    and computes the value of the whole stream."""
    for name, kwargs, kind in MODULAR[::2]:
        port = _modular(audio, fn, name, kwargs, kind, device="cpu")
        ref = _modular(jax_audio, jax_fn, name, kwargs, kind)
        first, second = _batches(kind)
        if direction == "jax-to-port":
            ref.update(*map(jnp.asarray, first))
            load_state(port, {k: np.asarray(getattr(ref, k)) for k in ref._defaults})
        else:
            port.update(*map(torch.from_numpy, first))
            state = export_state(port)
            for k, v in state.items():
                setattr(ref, k, jnp.asarray(v))
            ref._update_count = 1
        port._update_count = 1
        port.update(*map(torch.from_numpy, second))
        ref.update(*map(jnp.asarray, second))
        _close(port.compute(), ref.compute(), SDR_ATOL if name == "SignalDistortionRatio" else DB_ATOL)
