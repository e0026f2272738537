"""Shared bases of the clustering metrics (port of
``tpumetrics/clustering/base.py``).

Both keep "cat" list states: int32 labels, and the intrinsic base float
data beside them. Declare a capacity with ``set_state_capacity`` and the
functional path (``init_state``) holds them in fixed-capacity
:class:`~tpumetrics_torch.buffers.MaskedBuffer` states; a metric whose live
states are such buffers (a loaded buffer state) appends to them in its
eager update too, with no host read, so a fused collection can capture it.
``compute()`` then takes the buffer's valid-row mask.
"""

from __future__ import annotations

from typing import Any, List, Optional, Tuple

import torch

from tpumetrics_torch.buffers import _BufferList
from tpumetrics_torch.metric import Metric
from tpumetrics_torch.utils.data import dim_zero_cat

Tensor = torch.Tensor


def _state_values_and_mask(state: Any) -> Tuple[Tensor, Optional[Tensor]]:
    """(values, valid-row mask) of a cat state: the mask is None for a list
    (every row valid) and the buffer's mask for a MaskedBuffer state."""
    if isinstance(state, _BufferList):
        return state.buffer.values, state.buffer.valid_mask()
    return dim_zero_cat(state), None


def _as_labels(x: Tensor) -> Tensor:
    """Integer labels as int32, the JAX package's label dtype; anything
    else unchanged, so ``compute()`` refuses it as the JAX package does."""
    return x if x.is_floating_point() or x.is_complex() else x.to(torch.int32)


class _LabelPairClusterMetric(Metric):
    """Base of the metrics fed (preds, target) cluster-label pairs.

    ``num_classes_preds``/``num_classes_target`` declare the class spaces:
    ``compute()`` then reads nothing on the host but the values the
    formulas need; without them the observed labels are relabelled.
    """

    is_differentiable: bool = True
    higher_is_better: Optional[bool] = True
    full_state_update: bool = False

    preds: List[Tensor]
    target: List[Tensor]

    def __init__(
        self,
        num_classes_preds: Optional[int] = None,
        num_classes_target: Optional[int] = None,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        self.num_classes_preds = num_classes_preds
        self.num_classes_target = num_classes_target
        self.add_state("preds", default=[], dist_reduce_fx="cat", feature_dtype=torch.int32)
        self.add_state("target", default=[], dist_reduce_fx="cat", feature_dtype=torch.int32)

    def update(self, preds: Tensor, target: Tensor) -> None:
        """Append a batch of predicted and ground-truth cluster labels."""
        self.preds.append(_as_labels(preds))
        self.target.append(_as_labels(target))

    def _catted(self) -> tuple:
        """(preds, target, valid_mask) of the accumulated labels; the mask
        is None unless the states are MaskedBuffers."""
        preds, mask = _state_values_and_mask(self.preds)
        target, _ = _state_values_and_mask(self.target)
        return preds, target, mask

    def _class_spaces(self) -> dict:
        return {"num_classes_preds": self.num_classes_preds, "num_classes_target": self.num_classes_target}


class _IntrinsicClusterMetric(Metric):
    """Base of the metrics fed (data, labels): embedded vectors and one
    clustering of them."""

    is_differentiable: bool = True
    higher_is_better: Optional[bool] = True
    full_state_update: bool = False

    data: List[Tensor]
    labels: List[Tensor]

    def __init__(self, num_labels: Optional[int] = None, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.num_labels = num_labels
        self.add_state("data", default=[], dist_reduce_fx="cat")
        self.add_state("labels", default=[], dist_reduce_fx="cat", feature_dtype=torch.int32)

    def update(self, data: Tensor, labels: Tensor) -> None:
        """Append a batch of embedded data points and their cluster labels."""
        self.data.append(data)
        self.labels.append(_as_labels(labels))

    def _catted(self) -> tuple:
        """(data, labels, valid_mask); see ``_LabelPairClusterMetric._catted``."""
        data, mask = _state_values_and_mask(self.data)
        labels, _ = _state_values_and_mask(self.labels)
        return data, labels, mask
