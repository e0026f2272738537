"""Offline converter: FID InceptionV3 torch checkpoint -> ``.npz`` params
(port of ``tpumetrics/image/_inception_convert.py``, on the port's own
``_inception``).

The reference downloads torch-fidelity's ``pt_inception-2015-12-05-6726825d.pth``.
In an environment that has that file, run::

    python -m tpumetrics_torch.image._inception_convert pt_inception-2015-12-05-6726825d.pth inception.npz

and point ``FrechetInceptionDistance(feature=2048,
feature_extractor_weights_path="inception.npz")`` (or the
``TPUMETRICS_INCEPTION_WEIGHTS`` environment variable) at the result. Only
the parameter names the forward needs are kept; aux-classifier entries and
BN ``num_batches_tracked`` counters are dropped. The file is the JAX
package's format: either package reads it.
"""

from __future__ import annotations

import sys
from typing import Dict, Mapping

import numpy as np

from tpumetrics_torch.image._inception import check_inception_params, inception_param_spec


def convert_state_dict(state_dict: Mapping[str, "np.ndarray"]) -> Dict[str, np.ndarray]:
    """Select and validate the reference checkpoint's entries for the forward.

    Accepts tensors or numpy arrays as values; returns float32 numpy arrays
    keyed exactly as ``inception_param_spec()``.
    """
    spec = inception_param_spec()
    out: Dict[str, np.ndarray] = {}
    for key in spec:
        src = key
        if src not in state_dict:
            # torch-fidelity prefixes nothing, but torchvision-style dumps may
            # carry a leading "base." or module prefix: try a dot-boundary
            # suffix match, skipping aux-classifier twins (AuxLogits.fc.*)
            candidates = [k for k in state_dict if k.endswith("." + src) and ".AuxLogits." not in "." + k]
            if len(candidates) != 1:
                raise KeyError(
                    f"Checkpoint is missing parameter `{key}` (no unique suffix match);"
                    " expected a torch-fidelity FeatureExtractorInceptionV3 state_dict"
                )
            src = candidates[0]
        val = state_dict[src]
        if hasattr(val, "detach"):  # a tensor
            val = val.detach().cpu().float().numpy()
        out[key] = np.asarray(val, np.float32)
    check_inception_params(out)
    return out


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) != 2:
        print(__doc__)
        return 2
    src, dst = argv
    import torch

    state_dict = torch.load(src, map_location="cpu")
    if isinstance(state_dict, dict) and "state_dict" in state_dict:
        state_dict = state_dict["state_dict"]
    params = convert_state_dict(state_dict)
    np.savez(dst, **params)
    print(f"wrote {len(params)} arrays to {dst}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
