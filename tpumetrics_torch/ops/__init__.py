"""Hand-written CUDA kernels of the port, each with its plain torch version
beside it (counterpart of ``tpumetrics/ops``)."""

from tpumetrics_torch.ops.binned_confusion import binned_confusion_fused

__all__ = ["binned_confusion_fused"]
