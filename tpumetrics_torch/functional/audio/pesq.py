"""PESQ (port of ``tpumetrics/functional/audio/pesq.py``).

PESQ is the ITU-T P.862 C implementation of the ``pesq`` package, run on
the host: the inputs are copied to the host and the scores back, as in the
JAX package. Without the package it raises ``ModuleNotFoundError``.
"""

from __future__ import annotations

import numpy as np
import torch

from tpumetrics_torch.utils.checks import _check_same_shape
from tpumetrics_torch.utils.imports import _PESQ_AVAILABLE

Tensor = torch.Tensor

__doctest_skip__ = ["perceptual_evaluation_speech_quality"]


def perceptual_evaluation_speech_quality(
    preds: Tensor,
    target: Tensor,
    fs: int,
    mode: str,
    keep_same_device: bool = False,
    n_processes: int = 1,
) -> Tensor:
    """PESQ per sample (needs the ``pesq`` package; a host-side C
    implementation). The result is float32 on the inputs' device.

    Example:
        >>> import torch
        >>> from tpumetrics_torch.functional.audio import perceptual_evaluation_speech_quality
        >>> g = torch.randn(8000)
        >>> perceptual_evaluation_speech_quality(g, g, 8000, 'nb')  # doctest: +SKIP
        tensor(4.5...)
    """
    if not _PESQ_AVAILABLE:
        raise ModuleNotFoundError(
            "PESQ metric requires that pesq is installed. Either install as `pip install torchmetrics[audio]`"
            " or `pip install pesq`."
        )
    if fs not in (8000, 16000):
        raise ValueError(f"Expected argument `fs` to either be 8000 or 16000 but got {fs}")
    if mode not in ("wb", "nb"):
        raise ValueError(f"Expected argument `mode` to either be 'wb' or 'nb' but got {mode}")
    _check_same_shape(preds, target)

    import pesq as pesq_backend

    preds_np = preds.detach().cpu().numpy().astype(np.float32)
    target_np = target.detach().cpu().numpy().astype(np.float32)
    if preds_np.ndim == 1:
        pesq_val = np.asarray(pesq_backend.pesq(fs, target_np, preds_np, mode))
    else:
        preds_np = preds_np.reshape(-1, preds_np.shape[-1])
        target_np = target_np.reshape(-1, target_np.shape[-1])
        if n_processes == 1:
            pesq_val = np.asarray([pesq_backend.pesq(fs, t, p, mode) for t, p in zip(target_np, preds_np)])
        else:
            pesq_val = np.asarray(pesq_backend.pesq_batch(fs, target_np, preds_np, mode, n_processor=n_processes))
        pesq_val = pesq_val.reshape(preds.shape[:-1])
    return torch.from_numpy(np.asarray(pesq_val, np.float32)).to(preds.device)
