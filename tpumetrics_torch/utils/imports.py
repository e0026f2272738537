"""Availability flags for optional dependencies (counterpart of
``tpumetrics/utils/imports.py``).

The port's own copy: it imports nothing of the JAX package. Torch and numpy
are the core stack here; JAX is the optional extra, used only by the tests
that hold the port against the JAX package.
"""

from __future__ import annotations

import importlib.util
import shutil
import sys


def package_available(name: str) -> bool:
    """Whether ``name`` can be imported, found without importing it."""
    try:
        return importlib.util.find_spec(name) is not None
    except (ImportError, ModuleNotFoundError, ValueError):
        return False


_PYTHON_GREATER_EQUAL_3_10 = sys.version_info >= (3, 10)

# the reference stack of the parity tests (optional for the port)
_JAX_AVAILABLE = package_available("jax")

# optional scientific stack
_SCIPY_AVAILABLE = package_available("scipy")
_SKLEARN_AVAILABLE = package_available("sklearn")
_MATPLOTLIB_AVAILABLE = package_available("matplotlib")
_PANDAS_AVAILABLE = package_available("pandas")

# kernels and device tooling
_TRITON_AVAILABLE = package_available("triton")
_TORCHVISION_AVAILABLE = package_available("torchvision")
_TORCHAUDIO_AVAILABLE = package_available("torchaudio")

# text extras
_TRANSFORMERS_AVAILABLE = package_available("transformers")
_NLTK_AVAILABLE = package_available("nltk")
_REGEX_AVAILABLE = package_available("regex")
_TQDM_AVAILABLE = package_available("tqdm")
_SENTENCEPIECE_AVAILABLE = package_available("sentencepiece")

# image / detection and audio extras (host-side packages)
_PYCOCOTOOLS_AVAILABLE = package_available("pycocotools")
_PESQ_AVAILABLE = package_available("pesq")
_PYSTOI_AVAILABLE = package_available("pystoi")
_GAMMATONE_AVAILABLE = package_available("gammatone")

# LaTeX rendering for plots
_LATEX_AVAILABLE = shutil.which("latex") is not None
