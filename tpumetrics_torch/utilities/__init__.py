"""Migration alias: ``tpumetrics_torch.utilities`` is :mod:`tpumetrics_torch.utils`.

The JAX package's ``tpumetrics.utilities`` mirrors the import path of the
reference's utility surface; this is the port's copy of that alias, over
the port's own utils modules::

    >>> from tpumetrics_torch.utilities.data import dim_zero_cat
    >>> from tpumetrics_torch.utilities import rank_zero_warn, class_reduce

Every submodule here *is* the :mod:`tpumetrics_torch.utils` module of the
same name (the same object, registered in ``sys.modules``), so there is one
implementation under two names. The package itself re-exports
``tpumetrics_torch.utils.__all__``.
"""

import copy as _copy
import importlib as _importlib
import importlib.abc as _importlib_abc
import importlib.util as _importlib_util
import pkgutil as _pkgutil
import sys as _sys

import tpumetrics_torch.utils as _utils
from tpumetrics_torch.utils import *  # noqa: F401,F403
from tpumetrics_torch.utils import __all__ as __all__  # noqa: PLC0414

_SUBMODULES = tuple(info.name for info in _pkgutil.iter_modules(_utils.__path__) if not info.ispkg)

for _name in _SUBMODULES:
    _mod = _importlib.import_module(f"tpumetrics_torch.utils.{_name}")
    _sys.modules[f"{__name__}.{_name}"] = _mod
    globals()[_name] = _mod
del _name, _mod


class _UtilitiesAliasFinder(_importlib_abc.MetaPathFinder):
    """Resolve ``find_spec('tpumetrics_torch.utilities.<sub>')`` probes.

    ``importlib.util.find_spec`` looks in ``sys.modules`` before it imports
    the parent package, so a probe in a fresh process would otherwise find
    nothing (no ``<sub>.py`` exists under ``utilities/``). This finder
    answers with the spec of the ``tpumetrics_torch.utils`` submodule, under
    the requested name, with a loader made for that name (a file loader
    checks the name it executes).
    """

    _prefix = __name__ + "."

    def find_spec(self, fullname, path=None, target=None):
        if not fullname.startswith(self._prefix):
            return None
        sub = fullname[len(self._prefix) :]
        if sub not in _SUBMODULES:
            return None
        spec = _importlib_util.find_spec(f"tpumetrics_torch.utils.{sub}")
        if spec is None:
            return None
        alias_spec = _copy.copy(spec)
        alias_spec.name = fullname
        loader = getattr(spec, "loader", None)
        loader_path = getattr(loader, "path", None) or spec.origin
        if loader is not None and loader_path:
            try:
                alias_spec.loader = type(loader)(fullname, loader_path)
            except TypeError:
                pass  # a loader of another signature: keep the original
        return alias_spec


if not any(isinstance(f, _UtilitiesAliasFinder) for f in _sys.meta_path):
    _sys.meta_path.append(_UtilitiesAliasFinder())
