"""Functional image metrics of the port (counterpart of
``tpumetrics/functional/image``)."""

from tpumetrics_torch.functional.image.d_lambda import spectral_distortion_index
from tpumetrics_torch.functional.image.ergas import error_relative_global_dimensionless_synthesis
from tpumetrics_torch.functional.image.gradients import image_gradients
from tpumetrics_torch.functional.image.lpips import learned_perceptual_image_patch_similarity
from tpumetrics_torch.functional.image.psnr import peak_signal_noise_ratio
from tpumetrics_torch.functional.image.psnrb import peak_signal_noise_ratio_with_blocked_effect
from tpumetrics_torch.functional.image.rase import relative_average_spectral_error
from tpumetrics_torch.functional.image.rmse_sw import root_mean_squared_error_using_sliding_window
from tpumetrics_torch.functional.image.sam import spectral_angle_mapper
from tpumetrics_torch.functional.image.ssim import (
    multiscale_structural_similarity_index_measure,
    structural_similarity_index_measure,
)
from tpumetrics_torch.functional.image.tv import total_variation
from tpumetrics_torch.functional.image.uqi import universal_image_quality_index
from tpumetrics_torch.functional.image.vif import visual_information_fidelity

__all__ = [
    "error_relative_global_dimensionless_synthesis",
    "image_gradients",
    "learned_perceptual_image_patch_similarity",
    "multiscale_structural_similarity_index_measure",
    "peak_signal_noise_ratio",
    "peak_signal_noise_ratio_with_blocked_effect",
    "relative_average_spectral_error",
    "root_mean_squared_error_using_sliding_window",
    "spectral_angle_mapper",
    "spectral_distortion_index",
    "structural_similarity_index_measure",
    "total_variation",
    "universal_image_quality_index",
    "visual_information_fidelity",
]
