"""Enums driving task-string dispatch (counterpart of ``tpumetrics/utils/enums.py``)."""

from __future__ import annotations

from enum import Enum


class EnumStr(str, Enum):
    """Base class: case/sep-insensitive string enum with a helpful error message."""

    @staticmethod
    def _name() -> str:
        return "Task"

    @staticmethod
    def _normalize(value: str) -> str:
        return value.lower().replace("-", "_").replace(" ", "_")

    @classmethod
    def from_str(cls, value: str) -> "EnumStr":
        norm = cls._normalize(value)
        for member in cls:
            if cls._normalize(str(member.value)) == norm:
                return member
        valid = [str(m.value) for m in cls]
        raise ValueError(f"Invalid {cls._name()}: expected one of {valid}, but got {value}.")

    def __str__(self) -> str:
        return str(self.value)

    def __eq__(self, other: object) -> bool:
        if isinstance(other, str):
            return self._normalize(str(self.value)) == self._normalize(other)
        return Enum.__eq__(self, other)

    def __hash__(self) -> int:
        return hash(str(self.value))


class ClassificationTask(EnumStr):
    """Task vocabulary for the task-string classification wrappers."""

    @staticmethod
    def _name() -> str:
        return "Classification"

    BINARY = "binary"
    MULTICLASS = "multiclass"
    MULTILABEL = "multilabel"


class ClassificationTaskNoBinary(EnumStr):
    """Task vocabulary of the metrics without a binary form (exact match)."""

    @staticmethod
    def _name() -> str:
        return "Classification"

    MULTICLASS = "multiclass"
    MULTILABEL = "multilabel"


class ClassificationTaskNoMultilabel(EnumStr):
    """Task vocabulary of the metrics without a multilabel form (Cohen's kappa)."""

    @staticmethod
    def _name() -> str:
        return "Classification"

    BINARY = "binary"
    MULTICLASS = "multiclass"
