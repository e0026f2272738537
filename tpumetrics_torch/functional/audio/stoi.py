"""STOI (port of ``tpumetrics/functional/audio/stoi.py``).

STOI runs the ``pystoi`` implementation on the host: the inputs are copied
to the host and the scores back, as in the JAX package. Without the package
it raises ``ModuleNotFoundError``.
"""

from __future__ import annotations

import numpy as np
import torch

from tpumetrics_torch.utils.checks import _check_same_shape
from tpumetrics_torch.utils.imports import _PYSTOI_AVAILABLE

Tensor = torch.Tensor

__doctest_skip__ = ["short_time_objective_intelligibility"]


def short_time_objective_intelligibility(
    preds: Tensor, target: Tensor, fs: int, extended: bool = False, keep_same_device: bool = False
) -> Tensor:
    """STOI per sample (needs the ``pystoi`` package; host-side). The result
    is float32 on the inputs' device.

    Example:
        >>> import torch
        >>> from tpumetrics_torch.functional.audio import short_time_objective_intelligibility
        >>> g = torch.randn(8000)
        >>> float(short_time_objective_intelligibility(g, g, 8000)) > 0.99  # doctest: +SKIP
        True
    """
    if not _PYSTOI_AVAILABLE:
        raise ModuleNotFoundError(
            "ShortTimeObjectiveIntelligibility metric requires that `pystoi` is installed."
            " Either install as `pip install torchmetrics[audio]` or `pip install pystoi`."
        )
    _check_same_shape(preds, target)

    import pystoi

    preds_np = preds.detach().cpu().numpy().astype(np.float32)
    target_np = target.detach().cpu().numpy().astype(np.float32)
    if preds_np.ndim == 1:
        stoi_val = np.asarray(pystoi.stoi(target_np, preds_np, fs, extended=extended))
    else:
        preds_np = preds_np.reshape(-1, preds_np.shape[-1])
        target_np = target_np.reshape(-1, target_np.shape[-1])
        stoi_val = np.asarray(
            [pystoi.stoi(t, p, fs, extended=extended) for t, p in zip(target_np, preds_np)]
        ).reshape(preds.shape[:-1])
    return torch.from_numpy(np.asarray(stoi_val, np.float32)).to(preds.device)
