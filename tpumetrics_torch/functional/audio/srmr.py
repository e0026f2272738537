"""Speech-to-reverberation modulation energy ratio (port of
``tpumetrics/functional/audio/srmr.py``; SRMRpy's "slow" path).

1. peak-normalise the waveform to [-1, 1];
2. a 23-channel gammatone (ERB) filterbank: four cascaded biquads a channel
   (Slaney's design), clipped to [-1, 1] between the stages;
3. the temporal envelope by an FFT Hilbert transform;
4. an 8-band second-order modulation filterbank (Q=2, 4..128 Hz);
5. Hamming-windowed energies (0.256 s windows every 0.064 s), optionally
   held within 30 dB of their peak;
6. the ERB bandwidth holding 90 % of the energy picks ``kstar``; the score is
   the low (bands 1-4) over the high (bands 5..kstar) modulation energy.

The filters are designed on the host in float64 (a copy of the JAX
package's design, so the coefficients are the same bits) and cached. Both
filterbanks run through :func:`tpumetrics_torch.ops.biquad.biquad_cascade`:
the hand-written kernel on a card (a chunked scan over time, deterministic,
within a stated tolerance of a float64 reference), a loop over time on the
CPU. The
constants an update needs (coefficients, the window, the bandwidths) are
copied to the device once per device and configuration, by the first call
there, which must be eager; later calls copy nothing from the host, so a
fused collection, whose first sighting of a batch is eager, captures them.
Scores are float32, as in the JAX package, whatever the input dtype.
"""

from __future__ import annotations

from functools import lru_cache
from math import ceil, pi
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from tpumetrics_torch.ops.biquad import biquad_cascade
from tpumetrics_torch.utils.compute import _ieee_float32

Tensor = torch.Tensor


# ------------------------------------------------------------- filter design
# (the JAX package's float64 numpy design, copied so the port imports none of it)


@lru_cache(maxsize=16)
def _erb_space(low_freq: float, high_freq: float, n: int) -> np.ndarray:
    """n ERB-spaced center frequencies, DESCENDING from just below
    ``high_freq`` to exactly ``low_freq`` (Slaney's ERBSpace)."""
    ear_q = 9.26449
    min_bw = 24.7
    return -(ear_q * min_bw) + np.exp(
        np.arange(1, n + 1) * (-np.log(high_freq + ear_q * min_bw) + np.log(low_freq + ear_q * min_bw)) / n
    ) * (high_freq + ear_q * min_bw)


@lru_cache(maxsize=16)
def _erbs(low_freq: float, fs: int, n_filters: int) -> np.ndarray:
    """Equivalent rectangular bandwidth per center frequency (descending)."""
    ear_q = 9.26449
    min_bw = 24.7
    cfs = _erb_space(low_freq, fs / 2, n_filters)
    return cfs / ear_q + min_bw


@lru_cache(maxsize=16)
def _gammatone_coefs(fs: int, n_filters: int, low_freq: float) -> np.ndarray:
    """Slaney gammatone filter coefficients, shape (N, 10):
    ``A0 A11 A12 A13 A14 A2 B0 B1 B2 gain`` (float64, host)."""
    t = 1.0 / fs
    cf = _erb_space(low_freq, fs / 2, n_filters)
    erb = _erbs(low_freq, fs, n_filters)
    b = 1.019 * 2 * pi * erb

    arg = 2 * cf * pi * t
    vec = np.exp(4j * cf * pi * t)

    a0 = t
    a2 = 0.0
    b0 = 1.0
    b1 = -2 * np.cos(arg) / np.exp(b * t)
    b2 = np.exp(-2 * b * t)

    rt_pos = np.sqrt(3 + 2**1.5)
    rt_neg = np.sqrt(3 - 2**1.5)
    common = -t / np.exp(b * t)

    a11 = common * (np.cos(arg) + rt_pos * np.sin(arg))
    a12 = common * (np.cos(arg) - rt_pos * np.sin(arg))
    a13 = common * (np.cos(arg) + rt_neg * np.sin(arg))
    a14 = common * (np.cos(arg) - rt_neg * np.sin(arg))

    gain_term = 2 * np.exp(-(b * t) + 2j * cf * pi * t) * t
    gain = np.abs(
        (-2 * vec * t + gain_term * (np.cos(arg) - rt_neg * np.sin(arg)))
        * (-2 * vec * t + gain_term * (np.cos(arg) + rt_neg * np.sin(arg)))
        * (-2 * vec * t + gain_term * (np.cos(arg) - rt_pos * np.sin(arg)))
        * (-2 * vec * t + gain_term * (np.cos(arg) + rt_pos * np.sin(arg)))
        / (-2 / np.exp(2 * b * t) - 2 * vec + 2 * (1 + vec) / np.exp(b * t)) ** 4
    )

    n = n_filters
    coefs = np.zeros((n, 10))
    coefs[:, 0] = a0
    coefs[:, 1] = a11
    coefs[:, 2] = a12
    coefs[:, 3] = a13
    coefs[:, 4] = a14
    coefs[:, 5] = a2
    coefs[:, 6] = b0
    coefs[:, 7] = b1
    coefs[:, 8] = b2
    coefs[:, 9] = gain
    return coefs


@lru_cache(maxsize=16)
def _modulation_filterbank(
    min_cf: float, max_cf: float, n: int, fs: float, q: float
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Second-order modulation band-pass bank: center frequencies (n,),
    filters (n, 2, 3) as [b; a] rows, left 3 dB cutoffs (n,); float64, host."""
    spacing = (max_cf / min_cf) ** (1.0 / (n - 1))
    cfs = min_cf * spacing ** np.arange(n)

    w0 = 2 * pi * cfs / fs
    w0t = np.tan(w0 / 2)
    b0 = w0t / q
    filters = np.zeros((n, 2, 3))
    filters[:, 0, 0] = b0
    filters[:, 0, 2] = -b0
    filters[:, 1, 0] = 1 + b0 + w0t**2
    filters[:, 1, 1] = 2 * w0t**2 - 2
    filters[:, 1, 2] = 1 - b0 + w0t**2

    left_cutoffs = cfs - (np.tan(w0 / 2) / q) * fs / (2 * pi)
    return cfs, filters, left_cutoffs


# ---------------------------------------------------- constants on the device


@lru_cache(maxsize=32)
def _device_constants(
    fs: int, n_filters: int, low_freq: float, min_cf: float, max_cf: float, device: torch.device
) -> Dict[str, Tensor]:
    """float32 copies on ``device`` of what an update needs: the gammatone
    numerators ``as_`` and denominators ``bs`` (4, N, 3) and gains (N,), the
    modulation filters ``mb``/``ma`` (8, 3) and left cutoffs (8,), the
    ascending ERBs (N,) and the squared window of the energies."""
    coefs = _gammatone_coefs(fs, n_filters, low_freq)
    a_rows = np.stack([coefs[:, (0, 1, 5)], coefs[:, (0, 2, 5)], coefs[:, (0, 3, 5)], coefs[:, (0, 4, 5)]])
    _, mfb, cutoffs = _modulation_filterbank(min_cf, max_cf, 8, float(fs), 2.0)
    w_length = ceil(0.256 * fs)
    host = {
        "as_": a_rows,  # A0 A1i A2: the numerators (Slaney's naming)
        "bs": np.broadcast_to(coefs[None, :, (6, 7, 8)], (4, n_filters, 3)),  # B0 B1 B2
        "gain": coefs[:, 9],
        "mb": mfb[:, 0, :],
        "ma": mfb[:, 1, :],
        "cutoffs": cutoffs,
        "erbs_asc": np.flipud(_erbs(low_freq, fs, n_filters)),
        "window": np.hamming(w_length + 2)[:w_length],
    }
    out = {k: torch.from_numpy(np.ascontiguousarray(v, np.float32)).to(device) for k, v in host.items()}
    out["window_sq"] = out.pop("window") ** 2  # squared in float32, as the JAX package does
    return out


def _constants(fs: int, n_filters: int, low_freq: float, min_cf: float, max_cf: float, device: torch.device):
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return _device_constants(fs, n_filters, float(low_freq), float(min_cf), float(max_cf), device)


# ----------------------------------------------------------------- filtering


def _erb_filterbank(wave: Tensor, const: Dict[str, Tensor]) -> Tensor:
    """(B, T) -> (B, N, T) through the 4-stage gammatone cascade."""
    num_batch, time = wave.shape
    n = const["gain"].shape[0]
    lanes = wave[:, None, :].expand(num_batch, n, time).reshape(num_batch * n, time)
    b_l = const["as_"].repeat(1, num_batch, 1)
    a_l = const["bs"].repeat(1, num_batch, 1)
    # clipped between the stages, as torchaudio lfilter's default between the reference's cascaded calls
    out = biquad_cascade(lanes, b_l, a_l, clamp=True).reshape(num_batch, n, time)
    return out / const["gain"].reshape(1, -1, 1)


def _hilbert_env(x: Tensor) -> Tensor:
    """|analytic signal| along the last axis, with the FFT length rounded up
    to a multiple of 16 as the reference does (the values depend on it)."""
    time = x.shape[-1]
    n = time if time % 16 == 0 else ceil(time / 16) * 16
    x_fft = torch.fft.fft(x, n=n, dim=-1)
    # the multiplier 1, 2, ..., 2, (1), 0, ..., 0, made on the device from its index (no copy from the host,
    # which a capture could not record)
    k = torch.arange(n, device=x.device)
    h = torch.where((k == 0) | ((k == n // 2) & (n % 2 == 0)), 1.0, torch.where(k < (n + 1) // 2, 2.0, 0.0))
    y = torch.fft.ifft(x_fft * h.to(torch.float32), dim=-1)
    return torch.abs(y[..., :time])


def _normalize_energy(energy: Tensor, drange: float = 30.0) -> Tensor:
    """Clamp energies into a 30 dB window under the peak of their mean over channels."""
    peak = torch.amax(torch.mean(energy, dim=1, keepdim=True), dim=(2, 3), keepdim=True)
    min_energy = peak * 10.0 ** (-drange / 10.0)
    return torch.minimum(torch.maximum(energy, min_energy), peak)


# ------------------------------------------------------------------ the metric


def speech_reverberation_modulation_energy_ratio(
    preds: Tensor,
    fs: int,
    n_cochlear_filters: int = 23,
    low_freq: float = 125,
    min_cf: float = 4,
    max_cf: Optional[float] = None,
    norm: bool = False,
    fast: bool = False,
) -> Tensor:
    """SRMR, a non-intrusive measure of speech quality and intelligibility.

    Args:
        preds: waveform, shape ``(..., time)``; integer samples are scaled by
            their dtype's maximum.
        fs: sampling rate (Hz).
        n_cochlear_filters: gammatone channels.
        low_freq: lowest gammatone center frequency.
        min_cf / max_cf: modulation filterbank range (``max_cf`` defaults to
            30 with ``norm`` else 128).
        norm: 30 dB modulation-energy normalization.
        fast: not supported (raises ``NotImplementedError``), as in the JAX
            package.

    With non-default ``min_cf``/``max_cf`` whose fifth modulation cutoff
    exceeds the 90 %-energy bandwidth, the band selection clamps to
    ``kstar=5``, as in the JAX package. An input shorter than one 0.256 s
    window raises ``ValueError`` (a shape check).

    Returns:
        float32 scores of shape ``preds.shape[:-1]``; a 1-D waveform gives
        shape ``(1,)``.

    Example:
        >>> import torch
        >>> from tpumetrics_torch.functional.audio import speech_reverberation_modulation_energy_ratio
        >>> g = torch.randn(2048, generator=torch.Generator().manual_seed(1))
        >>> speech_reverberation_modulation_energy_ratio(g, 8000).shape
        torch.Size([1])
    """
    _srmr_arg_validate(fs, n_cochlear_filters, low_freq, min_cf, max_cf, norm, fast)
    if not preds.is_floating_point():
        preds = preds.to(torch.float32) / float(torch.iinfo(preds.dtype).max)
    preds = preds.to(torch.float32)

    shape = preds.shape
    wave = preds.reshape(1, -1) if preds.ndim == 1 else preds.reshape(-1, shape[-1])
    num_batch, time = wave.shape
    mfs = float(fs)
    w_length = ceil(0.256 * mfs)
    w_inc = ceil(0.064 * mfs)
    if time < w_length:
        # the reference silently yields NaN here; fail fast instead so a running sum can't be poisoned
        raise ValueError(
            f"SRMR needs at least one full 0.256 s analysis window: got {time} samples"
            f" at fs={fs} ({time / fs:.3f} s), need >= {w_length}"
        )
    if max_cf is None:
        max_cf = 30.0 if norm else 128.0
    const = _constants(fs, n_cochlear_filters, low_freq, min_cf, max_cf, wave.device)

    # peak-normalise into [-1, 1] (only a wave that exceeds it)
    max_vals = torch.amax(torch.abs(wave), dim=-1, keepdim=True)
    wave = wave / torch.where(max_vals > 1, max_vals, 1.0)

    gt_env = _hilbert_env(_erb_filterbank(wave, const))  # (B, N, T)

    # modulation filterbank (8 bands, Q=2), lane (b, n, band)
    n_bands = const["mb"].shape[0]
    lanes = gt_env[:, :, None, :].expand(num_batch, n_cochlear_filters, n_bands, time).reshape(-1, time)
    b_l = const["mb"].repeat(num_batch * n_cochlear_filters, 1)[None]
    a_l = const["ma"].repeat(num_batch * n_cochlear_filters, 1)[None]
    mod_out = biquad_cascade(lanes, b_l, a_l).reshape(num_batch, n_cochlear_filters, n_bands, time)
    del lanes

    # windowed energy = sum_k (x[t+k] w[k])^2: a strided correlation of x^2 with w^2, in full float32
    num_frames = int(1 + (time - w_length) // w_inc)
    pad_t = max(ceil(time / w_inc) * w_inc - time, w_length - time)
    sq = torch.nn.functional.pad(mod_out, (0, pad_t)) ** 2
    del mod_out
    with _ieee_float32(torch.backends.cudnn.conv, torch.backends.mkldnn.conv):
        energy = torch.nn.functional.conv1d(
            sq.reshape(-1, 1, sq.shape[-1]), const["window_sq"].reshape(1, 1, w_length), stride=w_inc
        )
    del sq
    energy = energy.reshape(num_batch, n_cochlear_filters, n_bands, -1)[..., :num_frames]
    if norm:
        energy = _normalize_energy(energy)

    avg_energy = torch.mean(energy, dim=-1)  # (B, N, 8)
    total_energy = torch.sum(avg_energy.reshape(num_batch, -1), dim=-1)
    ac_energy = torch.sum(avg_energy, dim=2)  # (B, N)
    ac_perc = ac_energy * 100 / total_energy.reshape(-1, 1)
    ac_perc_cumsum = torch.cumsum(torch.flip(ac_perc, dims=(-1,)), dim=-1)
    # the first index over 90 % (0 when none is): argmax of the cast mask, which torch takes for no bool tensor
    k90perc_idx = torch.argmax((ac_perc_cumsum > 90).to(torch.int32), dim=-1)
    bw = const["erbs_asc"][k90perc_idx]  # (B,)

    # kstar in {5, .., 8}: how many of the left cutoffs 5..7 lie at or below bw
    kstar = 5 + torch.sum(const["cutoffs"][None, 5:8] <= bw[:, None], dim=-1)  # (B,)
    band_idx = torch.arange(n_bands, device=wave.device)
    num_energy = torch.sum(torch.where(band_idx[None, None, :] < 4, avg_energy, 0.0), dim=(1, 2))
    denom_mask = (band_idx[None, None, :] >= 4) & (band_idx[None, None, :] < kstar[:, None, None])
    denom_energy = torch.sum(torch.where(denom_mask, avg_energy, 0.0), dim=(1, 2))
    score = num_energy / denom_energy

    return score.reshape(shape[:-1]) if len(shape) > 1 else score.reshape((1,))


def _srmr_arg_validate(
    fs: int,
    n_cochlear_filters: int = 23,
    low_freq: float = 125,
    min_cf: float = 4,
    max_cf: Optional[float] = 128,
    norm: bool = False,
    fast: bool = False,
) -> None:
    """Argument validation (arguments only; no data is read)."""
    if not (isinstance(fs, int) and fs > 0):
        raise ValueError(f"Expected argument `fs` to be an int larger than 0, but got {fs}")
    if not (isinstance(n_cochlear_filters, int) and n_cochlear_filters > 0):
        raise ValueError(
            f"Expected argument `n_cochlear_filters` to be an int larger than 0, but got {n_cochlear_filters}"
        )
    if not (isinstance(low_freq, (float, int)) and low_freq > 0):
        raise ValueError(f"Expected argument `low_freq` to be a float larger than 0, but got {low_freq}")
    if not (isinstance(min_cf, (float, int)) and min_cf > 0):
        raise ValueError(f"Expected argument `min_cf` to be a float larger than 0, but got {min_cf}")
    if max_cf is not None and not ((isinstance(max_cf, (float, int))) and max_cf > 0):
        raise ValueError(f"Expected argument `max_cf` to be a float larger than 0, but got {max_cf}")
    if not isinstance(norm, bool):
        raise ValueError("Expected argument `norm` to be a bool value")
    if not isinstance(fast, bool):
        raise ValueError("Expected argument `fast` to be a bool value")
    if fast:
        raise NotImplementedError(
            "`fast=True` delegates to the gammatone package's FFT gammatonegram approximation in the"
            " reference, which its own docs call inconsistent with the SRMR toolbox; it is not"
            " implemented here. Use the default fast=False path."
        )
