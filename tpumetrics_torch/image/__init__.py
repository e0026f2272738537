"""Image metrics of the port (counterpart of ``tpumetrics/image``), the ones
without a backbone network: FID, KID, MiFID, IS, LPIPS and PPL wait for the
port of the backbones."""

from tpumetrics_torch.image.d_lambda import SpectralDistortionIndex
from tpumetrics_torch.image.ergas import ErrorRelativeGlobalDimensionlessSynthesis
from tpumetrics_torch.image.psnr import PeakSignalNoiseRatio
from tpumetrics_torch.image.psnrb import PeakSignalNoiseRatioWithBlockedEffect
from tpumetrics_torch.image.rase import RelativeAverageSpectralError
from tpumetrics_torch.image.rmse_sw import RootMeanSquaredErrorUsingSlidingWindow
from tpumetrics_torch.image.sam import SpectralAngleMapper
from tpumetrics_torch.image.ssim import (
    MultiScaleStructuralSimilarityIndexMeasure,
    StructuralSimilarityIndexMeasure,
)
from tpumetrics_torch.image.tv import TotalVariation
from tpumetrics_torch.image.uqi import UniversalImageQualityIndex
from tpumetrics_torch.image.vif import VisualInformationFidelity

__all__ = [
    "ErrorRelativeGlobalDimensionlessSynthesis",
    "MultiScaleStructuralSimilarityIndexMeasure",
    "PeakSignalNoiseRatio",
    "PeakSignalNoiseRatioWithBlockedEffect",
    "RelativeAverageSpectralError",
    "RootMeanSquaredErrorUsingSlidingWindow",
    "SpectralAngleMapper",
    "SpectralDistortionIndex",
    "StructuralSimilarityIndexMeasure",
    "TotalVariation",
    "UniversalImageQualityIndex",
    "VisualInformationFidelity",
]
