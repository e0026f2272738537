"""Image metrics of the port (counterpart of ``tpumetrics/image``); FID, KID,
MiFID, IS, LPIPS and PPL run their backbones through
``tpumetrics_torch.backbones``."""

from tpumetrics_torch.image.d_lambda import SpectralDistortionIndex
from tpumetrics_torch.image.ergas import ErrorRelativeGlobalDimensionlessSynthesis
from tpumetrics_torch.image.fid import FrechetInceptionDistance
from tpumetrics_torch.image.inception import InceptionScore
from tpumetrics_torch.image.kid import KernelInceptionDistance
from tpumetrics_torch.image.lpip import LearnedPerceptualImagePatchSimilarity
from tpumetrics_torch.image.mifid import MemorizationInformedFrechetInceptionDistance
from tpumetrics_torch.image.perceptual_path_length import PerceptualPathLength
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
    "FrechetInceptionDistance",
    "InceptionScore",
    "KernelInceptionDistance",
    "LearnedPerceptualImagePatchSimilarity",
    "MemorizationInformedFrechetInceptionDistance",
    "MultiScaleStructuralSimilarityIndexMeasure",
    "PeakSignalNoiseRatio",
    "PeakSignalNoiseRatioWithBlockedEffect",
    "PerceptualPathLength",
    "RelativeAverageSpectralError",
    "RootMeanSquaredErrorUsingSlidingWindow",
    "SpectralAngleMapper",
    "SpectralDistortionIndex",
    "StructuralSimilarityIndexMeasure",
    "TotalVariation",
    "UniversalImageQualityIndex",
    "VisualInformationFidelity",
]
