"""The port's public names held against the JAX package's.

Every ported package's ``__all__`` equals the JAX one (the top level and
``functional`` restricted to the ported domains; ``image`` and
``functional.image`` whole, the backbone metrics included; ``text`` and
``functional.text`` less BERTScore and InfoLM, which wait for the port's
encoder modules; ``backbones``
less ``backbone_partition_rules``, which waits for the port of
``parallel/sharding.py``; ``telemetry`` and its ported modules less the names
of the parts still to port: lockstep, spans, SLOs, the admin server,
federation, timelines, the flight recorder and Perfetto traces), no
exported name is a
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

DOMAINS = [
    "audio", "classification", "clustering", "detection", "image", "monitoring", "nominal", "regression", "retrieval",
    "text", "wrappers",
]
FUNCTIONAL_DOMAINS = [
    "audio", "classification", "clustering", "detection", "image", "nominal", "pairwise", "regression", "retrieval",
    "text",
]
# the image metrics that run a backbone network (Inception, LPIPS's nets, a generator): all ported
WAITING_FOR_BACKBONES = set()
# the text metrics that run a transformer encoder: they wait for the port's own encoder modules
WAITING_FOR_ENCODERS = {"BERTScore", "InfoLM", "bert_score", "infolm"}
# the JAX backbone names the port lacks: the sharded weight placement waits for parallel/sharding.py
WAITING_FOR_SHARDING = {"backbone_partition_rules"}
# the JAX telemetry names whose modules are not ported yet: lockstep, spans, SLOs, the admin server,
# federation, timelines, the flight recorder and Perfetto traces
WAITING_FOR_TELEMETRY = {
    "AdminServer", "FlightRecorder", "LockstepViolation", "SloEngine", "SloRule", "configure",
    "disable_flight_recorder", "enable_flight_recorder", "end_span", "federate", "flight_dump", "flight_recorder",
    "local_snapshot", "lockstep_verification_enabled", "merge_snapshots", "normalize_schedule", "note_incident",
    "perfetto_trace", "record_span", "schedule_fingerprint", "serve", "should_verify", "slo", "span", "spans",
    "spans_jsonl", "start_admin_server", "start_span", "timeline", "verify_lockstep",
}
TELEMETRY = ["telemetry", "telemetry.instruments", "telemetry.ledger", "telemetry.sinks", "telemetry.export"]
PACKAGES = [*DOMAINS, *(f"functional.{d}" for d in FUNCTIONAL_DOMAINS), "utils"]
CORE = {"Metric", "CompositionalMetric", "MetricCollection", "MaskedBuffer", "__version__", "CatMetric", "MaxMetric",
        "MeanMetric", "MinMetric", "RunningMean", "RunningSum", "SumMetric"}


def _pair(name):
    return importlib.import_module(f"tpumetrics_torch.{name}"), importlib.import_module(f"tpumetrics.{name}")


def _ported(names):
    return set(names) - WAITING_FOR_BACKBONES - WAITING_FOR_ENCODERS


@pytest.mark.parametrize("name", PACKAGES)
def test_package_all_equals_the_jax_one(name):
    port, ref = _pair(name)
    assert sorted(port.__all__) == sorted(_ported(ref.__all__))


@pytest.mark.parametrize("name", TELEMETRY)
def test_telemetry_all_is_the_jax_one_less_the_waiting_names(name):
    port, ref = _pair(name)
    assert port.__all__ == [n for n in ref.__all__ if n not in WAITING_FOR_TELEMETRY]
    for attr in port.__all__:
        assert hasattr(port, attr), attr


def test_the_names_waiting_for_telemetry_are_the_jax_ones_the_port_lacks():
    jax_names = set().union(*(_pair(name)[1].__all__ for name in TELEMETRY))
    port_names = set().union(*(_pair(name)[0].__all__ for name in TELEMETRY))
    assert WAITING_FOR_TELEMETRY == jax_names - port_names
    assert not any(hasattr(_pair("telemetry")[0], n) for n in WAITING_FOR_TELEMETRY)


def test_the_names_waiting_for_the_backbones_are_the_jax_image_ones():
    """Each waiting name is a JAX image export that the port lacks, and the
    image packages lack nothing else: none waits now."""
    jax_image = set(_pair("image")[1].__all__) | set(_pair("functional.image")[1].__all__)
    port_image = set(_pair("image")[0].__all__) | set(_pair("functional.image")[0].__all__)
    assert WAITING_FOR_BACKBONES == jax_image - port_image
    assert not WAITING_FOR_BACKBONES & set(tpumetrics_torch.__all__)


def test_the_names_waiting_for_encoders_are_the_jax_text_ones_the_port_lacks():
    """BERTScore, InfoLM and their functions are the JAX text exports the
    port lacks, and no package of the port exports them."""
    jax_text = set(_pair("text")[1].__all__) | set(_pair("functional.text")[1].__all__)
    port_text = set(_pair("text")[0].__all__) | set(_pair("functional.text")[0].__all__)
    assert WAITING_FOR_ENCODERS == jax_text - port_text
    functional = importlib.import_module("tpumetrics_torch.functional")
    assert not WAITING_FOR_ENCODERS & (set(tpumetrics_torch.__all__) | set(functional.__all__))


def test_backbones_all_is_the_jax_one_less_the_sharded_placement():
    port, ref = _pair("backbones")
    assert port.__all__ == [n for n in ref.__all__ if n not in WAITING_FOR_SHARDING]
    assert WAITING_FOR_SHARDING == set(ref.__all__) - set(port.__all__)
    for attr in port.__all__:
        assert hasattr(port, attr) and not isinstance(getattr(port, attr), types.ModuleType), attr


def test_top_level_all_is_the_jax_top_level_restricted_to_the_ported_domains():
    ported = set(CORE)
    for name in DOMAINS:
        ported |= _ported(_pair(name)[1].__all__)
    want = [n for n in tpumetrics.__all__ if n in ported]
    assert tpumetrics_torch.__all__ == want
    assert set(tpumetrics_torch.__all__) <= set(tpumetrics.__all__)


def test_functional_all_is_the_jax_one_restricted_to_the_ported_domains():
    ported = set()
    for name in FUNCTIONAL_DOMAINS:
        ported |= _ported(_pair(f"functional.{name}")[1].__all__)
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
