"""Detection input validation helpers (port of
``tpumetrics/detection/helpers.py``)."""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence, Union

import numpy as np
import torch

Tensor = torch.Tensor


def _as_tensor(x: Any, device: torch.device, dtype: Optional[torch.dtype] = None) -> Tensor:
    """``x`` as a tensor on ``device``: a tensor must already lie there (inputs
    are not moved implicitly, as ``Metric.update`` refuses them), anything
    else (numpy, lists) is copied there."""
    if isinstance(x, Tensor):
        if x.device != device:
            raise RuntimeError(f"Got a detection input on {x.device} but the metric's states live on {device}")
        return x if dtype is None else x.to(dtype)
    return torch.as_tensor(np.asarray(x), dtype=dtype, device=device)


def _fix_empty_tensors(boxes: Tensor) -> Tensor:
    """Empty tensors get a (0, 4) shape so downstream ops are well-defined
    (reference helpers.py:88-93)."""
    if boxes.numel() == 0 and boxes.ndim == 1:
        return boxes.reshape(0, 4)
    return boxes


def _input_validator(
    preds: Sequence[Dict[str, Tensor]],
    targets: Sequence[Dict[str, Tensor]],
    iou_type: Union[str, tuple] = "bbox",
    ignore_score: bool = False,
) -> None:
    """Validate the list-of-dict detection input format (reference helpers.py:22-85)."""
    if isinstance(iou_type, str):
        iou_type = (iou_type,)
    item_val_name = {"bbox": "boxes", "segm": "masks"}
    if any(t not in ("bbox", "segm") for t in iou_type):
        raise Exception(f"IOU type {iou_type} is not supported")

    if not isinstance(preds, Sequence):
        raise ValueError(f"Expected argument `preds` to be of type Sequence, but got {preds}")
    if not isinstance(targets, Sequence):
        raise ValueError(f"Expected argument `target` to be of type Sequence, but got {targets}")
    if len(preds) != len(targets):
        raise ValueError(
            f"Expected argument `preds` and `target` to have the same length, but got {len(preds)} and {len(targets)}"
        )

    for t in iou_type:
        name = item_val_name[t]
        if any(name not in p for p in preds):
            raise ValueError(f"Expected all dicts in `preds` to contain the `{name}` key")
        if any(name not in tgt for tgt in targets):
            raise ValueError(f"Expected all dicts in `target` to contain the `{name}` key")
    if not ignore_score and any("scores" not in p for p in preds):
        raise ValueError("Expected all dicts in `preds` to contain the `scores` key")
    if any("labels" not in p for p in preds):
        raise ValueError("Expected all dicts in `preds` to contain the `labels` key")
    if any("labels" not in tgt for tgt in targets):
        raise ValueError("Expected all dicts in `target` to contain the `labels` key")

    for i, item in enumerate(targets):
        name = item_val_name[iou_type[0]]
        if item[name].shape[0] != item["labels"].shape[0]:
            raise ValueError(
                f"Input '{name}' and labels of sample {i} in targets have a"
                f" different length (expected {item[name].shape[0]} labels, got {item['labels'].shape[0]})"
            )
    if ignore_score:
        return
    for i, item in enumerate(preds):
        name = item_val_name[iou_type[0]]
        if not (item[name].shape[0] == item["labels"].shape[0] == item["scores"].shape[0]):
            raise ValueError(
                f"Input '{name}', labels and scores of sample {i} in predictions have a"
                f" different length (expected {item[name].shape[0]} labels and scores,"
                f" got {item['labels'].shape[0]} labels and {item['scores'].shape[0]})"
            )
