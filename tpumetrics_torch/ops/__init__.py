"""Hand-written CUDA kernels of the port, each with its plain torch version
beside it (counterpart of ``tpumetrics/ops``)."""

from tpumetrics_torch.ops import biquad, binned_confusion, coco_match, token_nll
from tpumetrics_torch.ops.binned_confusion import binned_confusion_fused

#: each kernel's wrapper module by kernel name; a wrapper counts its eager
#: ``launches`` and the calls it recorded into CUDA graphs (``captured``)
COUNTED_KERNELS = {
    "binned_confusion": binned_confusion,
    "biquad_cascade": biquad,
    "coco_greedy_match": coco_match,
    "token_nll": token_nll,
}

__all__ = ["binned_confusion_fused"]
