"""Functional audio metrics of the port (counterpart of
``tpumetrics/functional/audio``)."""

from tpumetrics_torch.functional.audio.pesq import perceptual_evaluation_speech_quality
from tpumetrics_torch.functional.audio.pit import permutation_invariant_training, pit_permutate
from tpumetrics_torch.functional.audio.sdr import (
    scale_invariant_signal_distortion_ratio,
    signal_distortion_ratio,
    source_aggregated_signal_distortion_ratio,
)
from tpumetrics_torch.functional.audio.snr import (
    complex_scale_invariant_signal_noise_ratio,
    scale_invariant_signal_noise_ratio,
    signal_noise_ratio,
)
from tpumetrics_torch.functional.audio.srmr import speech_reverberation_modulation_energy_ratio
from tpumetrics_torch.functional.audio.stoi import short_time_objective_intelligibility

__all__ = [
    "complex_scale_invariant_signal_noise_ratio",
    "perceptual_evaluation_speech_quality",
    "permutation_invariant_training",
    "pit_permutate",
    "scale_invariant_signal_distortion_ratio",
    "scale_invariant_signal_noise_ratio",
    "short_time_objective_intelligibility",
    "signal_distortion_ratio",
    "signal_noise_ratio",
    "source_aggregated_signal_distortion_ratio",
    "speech_reverberation_modulation_energy_ratio",
]
