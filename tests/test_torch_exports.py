"""The port's public names held against the JAX package's.

Every ported package's ``__all__`` equals the JAX one (the top level and
``functional`` restricted to the ported domains), no exported name is a
module, the ``utilities`` alias serves the port's utils modules, and the
task dispatchers of ``functional.classification`` are the functions.
"""

import importlib
import importlib.util
import pkgutil
import sys
import types

import pytest
import torch

import tpumetrics
import tpumetrics_torch
import tpumetrics_torch.functional.classification as fc
import tpumetrics_torch.utils

DOMAINS = ["audio", "classification", "clustering", "nominal", "regression", "retrieval", "wrappers"]
FUNCTIONAL_DOMAINS = ["audio", "classification", "clustering", "nominal", "pairwise", "regression", "retrieval"]
PACKAGES = [*DOMAINS, *(f"functional.{d}" for d in FUNCTIONAL_DOMAINS), "utils"]
CORE = {"Metric", "CompositionalMetric", "MetricCollection", "MaskedBuffer", "__version__", "CatMetric", "MaxMetric",
        "MeanMetric", "MinMetric", "RunningMean", "RunningSum", "SumMetric"}


def _pair(name):
    return importlib.import_module(f"tpumetrics_torch.{name}"), importlib.import_module(f"tpumetrics.{name}")


@pytest.mark.parametrize("name", PACKAGES)
def test_package_all_equals_the_jax_one(name):
    port, ref = _pair(name)
    assert sorted(port.__all__) == sorted(ref.__all__)


def test_top_level_all_is_the_jax_top_level_restricted_to_the_ported_domains():
    ported = set(CORE)
    for name in DOMAINS:
        ported |= set(_pair(name)[1].__all__)
    want = [n for n in tpumetrics.__all__ if n in ported]
    assert tpumetrics_torch.__all__ == want
    assert set(tpumetrics_torch.__all__) <= set(tpumetrics.__all__)


def test_functional_all_is_the_jax_one_restricted_to_the_ported_domains():
    ported = set()
    for name in FUNCTIONAL_DOMAINS:
        ported |= set(_pair(f"functional.{name}")[1].__all__)
    jax_functional = importlib.import_module("tpumetrics.functional")
    port_functional = importlib.import_module("tpumetrics_torch.functional")
    assert sorted(port_functional.__all__) == sorted(n for n in jax_functional.__all__ if n in ported)


@pytest.mark.parametrize("name", ["", "functional", *PACKAGES])
def test_every_exported_name_resolves_and_is_no_module(name):
    port = importlib.import_module(f"tpumetrics_torch{'.' + name if name else ''}")
    for attr in port.__all__:
        assert hasattr(port, attr), attr
        assert not isinstance(getattr(port, attr), types.ModuleType), attr


def test_version_and_masked_buffer_at_the_top_level():
    from tpumetrics_torch.buffers import MaskedBuffer

    assert tpumetrics_torch.__version__ == tpumetrics.__version__
    assert tpumetrics_torch.MaskedBuffer is MaskedBuffer


def test_task_dispatchers_of_functional_classification_are_the_functions():
    """The dispatcher named like its module is the function: ``accuracy`` of
    a multiclass batch on the CPU gives 0.75 (the parent's package exported
    the module under that name and raised ``TypeError``)."""
    from tpumetrics_torch.functional.classification import accuracy, f1_score

    value = accuracy(torch.tensor([0, 1, 2, 1]), torch.tensor([0, 1, 1, 1]), task="multiclass", num_classes=3)
    assert float(value) == 0.75 and value.device.type == "cpu"
    assert float(f1_score(torch.tensor([0, 1]), torch.tensor([0, 1]), task="binary")) == 1.0
    assert fc.precision_recall_curve is importlib.import_module("tpumetrics_torch.functional").precision_recall_curve


# from the files, so that a utils module the alias misses fails here
UTILS_SUBMODULES = sorted(info.name for info in pkgutil.iter_modules(tpumetrics_torch.utils.__path__) if not info.ispkg)


def test_every_utils_submodule_is_aliased():
    utilities = importlib.import_module("tpumetrics_torch.utilities")
    assert set(UTILS_SUBMODULES) == set(utilities._SUBMODULES) and "data" in UTILS_SUBMODULES


@pytest.mark.parametrize("name", UTILS_SUBMODULES)
def test_utilities_submodule_is_the_utils_one(name):
    alias = importlib.import_module(f"tpumetrics_torch.utilities.{name}")
    assert alias is importlib.import_module(f"tpumetrics_torch.utils.{name}")
    assert getattr(importlib.import_module("tpumetrics_torch.utilities"), name) is alias
    assert importlib.util.find_spec(f"tpumetrics_torch.utilities.{name}") is not None


def test_utilities_finder_serves_the_alias_spec_under_its_own_name():
    """``find_spec`` consults ``sys.modules`` first; with the alias entry
    gone (as in a fresh process) the finder answers, under the alias name."""
    importlib.import_module("tpumetrics_torch.utilities")
    name = "tpumetrics_torch.utilities.data"
    alias = sys.modules.pop(name)
    try:
        spec = importlib.util.find_spec(name)
    finally:
        sys.modules[name] = alias
    assert spec is not None and spec.name == name and spec.loader is not None
    assert importlib.util.find_spec("tpumetrics_torch.utils.data").name == "tpumetrics_torch.utils.data"


def test_utils_helpers_new_to_the_port():
    from tpumetrics_torch.utils import rank_zero_debug, rank_zero_info, to_categorical

    assert to_categorical(torch.tensor([[0.1, 0.9], [0.8, 0.2]])).tolist() == [1, 0]
    assert rank_zero_debug is rank_zero_info
