"""Modular F-beta / F1, binary, multiclass and multilabel, and the
``FBetaScore`` / ``F1Score`` task wrappers (port of
``tpumetrics/classification/f_beta.py``)."""

from __future__ import annotations

from typing import Any, Optional

import torch

from tpumetrics_torch.classification.base import _ClassificationTaskWrapper
from tpumetrics_torch.classification.stat_scores import (
    BinaryStatScores,
    MulticlassStatScores,
    MultilabelStatScores,
    _check_top_k,
)
from tpumetrics_torch.functional.classification.f_beta import _check_beta, _fbeta_reduce
from tpumetrics_torch.metric import Metric
from tpumetrics_torch.utils.checks import _check_task_size
from tpumetrics_torch.utils.enums import ClassificationTask


class BinaryFBetaScore(BinaryStatScores):
    """Binary F-beta.

    Example:
        >>> import torch
        >>> from tpumetrics_torch.classification import BinaryFBetaScore
        >>> metric = BinaryFBetaScore(beta=2.0, device='cpu')
        >>> metric.update(torch.tensor([0, 0, 1, 1, 0, 1]), torch.tensor([0, 1, 0, 1, 0, 1]))
        >>> round(float(metric.compute()), 4)
        0.6667
    """

    is_differentiable = False
    higher_is_better = True
    full_state_update: bool = False

    def __init__(
        self,
        beta: float,
        threshold: float = 0.5,
        multidim_average: str = "global",
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ) -> None:
        super().__init__(
            threshold=threshold,
            multidim_average=multidim_average,
            ignore_index=ignore_index,
            validate_args=validate_args,
            **kwargs,
        )
        if validate_args:
            _check_beta(beta)
        self.beta = beta

    def compute(self) -> torch.Tensor:
        tp, fp, tn, fn = self._final_state()
        return _fbeta_reduce(tp, fp, tn, fn, self.beta, average="binary", multidim_average=self.multidim_average)


class MulticlassFBetaScore(MulticlassStatScores):
    """Multiclass F-beta."""

    is_differentiable = False
    higher_is_better = True
    full_state_update: bool = False

    def __init__(
        self,
        beta: float,
        num_classes: int,
        top_k: int = 1,
        average: Optional[str] = "macro",
        multidim_average: str = "global",
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ) -> None:
        super().__init__(
            num_classes=num_classes,
            top_k=top_k,
            average=average,
            multidim_average=multidim_average,
            ignore_index=ignore_index,
            validate_args=validate_args,
            **kwargs,
        )
        if validate_args:
            _check_beta(beta)
        self.beta = beta

    def compute(self) -> torch.Tensor:
        tp, fp, tn, fn = self._final_state()
        return _fbeta_reduce(tp, fp, tn, fn, self.beta, average=self.average, multidim_average=self.multidim_average)


class MultilabelFBetaScore(MultilabelStatScores):
    """Multilabel F-beta."""

    is_differentiable = False
    higher_is_better = True
    full_state_update: bool = False

    def __init__(
        self,
        beta: float,
        num_labels: int,
        threshold: float = 0.5,
        average: Optional[str] = "macro",
        multidim_average: str = "global",
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ) -> None:
        super().__init__(
            num_labels=num_labels,
            threshold=threshold,
            average=average,
            multidim_average=multidim_average,
            ignore_index=ignore_index,
            validate_args=validate_args,
            **kwargs,
        )
        if validate_args:
            _check_beta(beta)
        self.beta = beta

    def compute(self) -> torch.Tensor:
        tp, fp, tn, fn = self._final_state()
        return _fbeta_reduce(
            tp, fp, tn, fn, self.beta, average=self.average, multidim_average=self.multidim_average, multilabel=True
        )


class BinaryF1Score(BinaryFBetaScore):
    """Binary F1 (beta=1).

    Example:
        >>> import torch
        >>> from tpumetrics_torch.classification import BinaryF1Score
        >>> metric = BinaryF1Score(device='cpu')
        >>> metric.update(torch.tensor([0, 0, 1, 1, 0, 1]), torch.tensor([0, 1, 0, 1, 0, 1]))
        >>> round(float(metric.compute()), 4)
        0.6667
    """

    def __init__(
        self,
        threshold: float = 0.5,
        multidim_average: str = "global",
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ) -> None:
        super().__init__(
            beta=1.0,
            threshold=threshold,
            multidim_average=multidim_average,
            ignore_index=ignore_index,
            validate_args=validate_args,
            **kwargs,
        )


class MulticlassF1Score(MulticlassFBetaScore):
    """Multiclass F1 (beta=1).

    Example:
        >>> import torch
        >>> from tpumetrics_torch.classification import MulticlassF1Score
        >>> metric = MulticlassF1Score(num_classes=3, device='cpu')
        >>> metric.update(torch.tensor([2, 1, 0, 1]), torch.tensor([2, 1, 0, 0]))
        >>> round(float(metric.compute()), 4)
        0.7778
    """

    def __init__(
        self,
        num_classes: int,
        top_k: int = 1,
        average: Optional[str] = "macro",
        multidim_average: str = "global",
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ) -> None:
        super().__init__(
            beta=1.0,
            num_classes=num_classes,
            top_k=top_k,
            average=average,
            multidim_average=multidim_average,
            ignore_index=ignore_index,
            validate_args=validate_args,
            **kwargs,
        )


class MultilabelF1Score(MultilabelFBetaScore):
    """Multilabel F1 (beta=1)."""

    def __init__(
        self,
        num_labels: int,
        threshold: float = 0.5,
        average: Optional[str] = "macro",
        multidim_average: str = "global",
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ) -> None:
        super().__init__(
            beta=1.0,
            num_labels=num_labels,
            threshold=threshold,
            average=average,
            multidim_average=multidim_average,
            ignore_index=ignore_index,
            validate_args=validate_args,
            **kwargs,
        )


class FBetaScore(_ClassificationTaskWrapper):
    """Task-string wrapper for F-beta; other keyword arguments (``device=``
    among them) go to the metric it returns.

    Example:
        >>> import torch
        >>> from tpumetrics_torch import FBetaScore
        >>> logits = torch.tensor([[2.0, 0.5, 0.1], [0.3, 2.1, 0.2], [0.2, 0.3, 2.2], [2.0, 0.1, 0.4]])
        >>> target = torch.tensor([0, 1, 2, 1])
        >>> metric = FBetaScore(task="multiclass", num_classes=3, beta=0.5, device='cpu')
        >>> metric.update(logits, target)
        >>> round(float(metric.compute()), 4)
        0.75
    """

    def __new__(  # type: ignore[misc]
        cls,
        task: str,
        beta: float = 1.0,
        threshold: float = 0.5,
        num_classes: Optional[int] = None,
        num_labels: Optional[int] = None,
        average: Optional[str] = "micro",
        multidim_average: str = "global",
        top_k: Optional[int] = 1,
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ) -> Metric:
        task = ClassificationTask.from_str(task)
        kwargs.update(
            {"multidim_average": multidim_average, "ignore_index": ignore_index, "validate_args": validate_args}
        )
        if task == ClassificationTask.BINARY:
            return BinaryFBetaScore(beta, threshold, **kwargs)
        if task == ClassificationTask.MULTICLASS:
            return MulticlassFBetaScore(
                beta, _check_task_size("num_classes", num_classes), _check_top_k(top_k), average, **kwargs
            )
        return MultilabelFBetaScore(beta, _check_task_size("num_labels", num_labels), threshold, average, **kwargs)


class F1Score(_ClassificationTaskWrapper):
    """Task-string wrapper for F1; other keyword arguments (``device=``
    among them) go to the metric it returns.

    Example:
        >>> import torch
        >>> from tpumetrics_torch import F1Score
        >>> logits = torch.tensor([[2.0, 0.5, 0.1], [0.3, 2.1, 0.2], [0.2, 0.3, 2.2], [2.0, 0.1, 0.4]])
        >>> target = torch.tensor([0, 1, 2, 1])
        >>> metric = F1Score(task="multiclass", num_classes=3, device='cpu')
        >>> metric.update(logits, target)
        >>> round(float(metric.compute()), 4)
        0.75
    """

    def __new__(  # type: ignore[misc]
        cls,
        task: str,
        threshold: float = 0.5,
        num_classes: Optional[int] = None,
        num_labels: Optional[int] = None,
        average: Optional[str] = "micro",
        multidim_average: str = "global",
        top_k: Optional[int] = 1,
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ) -> Metric:
        task = ClassificationTask.from_str(task)
        kwargs.update(
            {"multidim_average": multidim_average, "ignore_index": ignore_index, "validate_args": validate_args}
        )
        if task == ClassificationTask.BINARY:
            return BinaryF1Score(threshold, **kwargs)
        if task == ClassificationTask.MULTICLASS:
            return MulticlassF1Score(
                _check_task_size("num_classes", num_classes), _check_top_k(top_k), average, **kwargs
            )
        return MultilabelF1Score(_check_task_size("num_labels", num_labels), threshold, average, **kwargs)
