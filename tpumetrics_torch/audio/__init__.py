"""Audio metrics of the port (counterpart of ``tpumetrics/audio``).

PESQ and STOI run host-side packages and raise ``ModuleNotFoundError`` at
construction when the package is absent."""

from tpumetrics_torch.audio.pesq import PerceptualEvaluationSpeechQuality
from tpumetrics_torch.audio.pit import PermutationInvariantTraining
from tpumetrics_torch.audio.sdr import (
    ScaleInvariantSignalDistortionRatio,
    SignalDistortionRatio,
    SourceAggregatedSignalDistortionRatio,
)
from tpumetrics_torch.audio.snr import (
    ComplexScaleInvariantSignalNoiseRatio,
    ScaleInvariantSignalNoiseRatio,
    SignalNoiseRatio,
)
from tpumetrics_torch.audio.srmr import SpeechReverberationModulationEnergyRatio
from tpumetrics_torch.audio.stoi import ShortTimeObjectiveIntelligibility

__all__ = [
    "ComplexScaleInvariantSignalNoiseRatio",
    "PerceptualEvaluationSpeechQuality",
    "PermutationInvariantTraining",
    "ScaleInvariantSignalDistortionRatio",
    "ScaleInvariantSignalNoiseRatio",
    "ShortTimeObjectiveIntelligibility",
    "SignalDistortionRatio",
    "SignalNoiseRatio",
    "SourceAggregatedSignalDistortionRatio",
    "SpeechReverberationModulationEnergyRatio",
]
