"""LearnedPerceptualImagePatchSimilarity (port of ``tpumetrics/image/lpip.py``)."""

from __future__ import annotations

from typing import Any, Callable, Optional, Sequence, Union

import torch

from tpumetrics_torch.functional.image.lpips import learned_perceptual_image_patch_similarity, resolve_lpips_net
from tpumetrics_torch.image.fid import _placement_token
from tpumetrics_torch.metric import Metric

Tensor = torch.Tensor


class LearnedPerceptualImagePatchSimilarity(Metric):
    """LPIPS accumulated over batches: sum/total scalar states.

    Args:
        net_type: ``"alex"``/``"vgg"``/``"squeeze"`` (pass the
            offline-converted conv weights as ``backbone_params``; the
            trained LPIPS linear heads ship with the package and are applied
            automatically) or a callable feature backbone (image -> list of
            feature maps).
        backbone_params: converted ``(weight, bias)`` conv pairs for a string
            ``net_type``: see :mod:`tpumetrics_torch.image._backbones` for
            the one-line torchvision conversion recipe.
        backbone_dtype_policy: ``"float32"`` (default) or ``"bfloat16"``
            (opt-in, the tensor cores; gated within max(0.01, 5 %) of float32).
        layer_weights: optional trained per-layer channel weights (defaults to
            the bundled heads for a string ``net_type``).
        reduction: ``mean`` or ``sum`` over accumulated images.
        normalize: inputs are [0,1] instead of [-1,1].

    The update (backbone, distances and the two sums) runs as one CUDA graph
    per batch signature on a card (``JitWithEagerFallback``).

    Example:
        >>> import torch
        >>> from tpumetrics_torch.image import LearnedPerceptualImagePatchSimilarity
        >>> def toy_net(x):
        ...     return [x[:, :, ::2, ::2], x.mean(dim=1, keepdim=True)]
        >>> lpips = LearnedPerceptualImagePatchSimilarity(net_type=toy_net, device="cpu")
        >>> g = torch.Generator().manual_seed(0)
        >>> img1 = torch.rand(4, 3, 16, 16, generator=g) * 2 - 1
        >>> img2 = torch.rand(4, 3, 16, 16, generator=g) * 2 - 1
        >>> lpips.update(img1, img2)
        >>> float(lpips.compute()) > 0
        True
    """

    is_differentiable: bool = True
    higher_is_better: bool = False
    full_state_update: bool = False
    plot_lower_bound: float = 0.0

    def __init__(
        self,
        net_type: Union[str, Callable] = "alex",
        reduction: str = "mean",
        normalize: bool = False,
        layer_weights: Optional[Sequence[Tensor]] = None,
        backbone_params: Optional[Sequence] = None,
        backbone_dtype_policy: str = "float32",
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        # a string net resolves through the process-global backbone registry:
        # this instance owns one refcounted handle to the shared resident
        # weights; release it via release_backbones()
        net_type, layer_weights = resolve_lpips_net(
            net_type, backbone_params, layer_weights,
            dtype_policy=backbone_dtype_policy, acquire=True, device=self.device,
        )
        self.net = net_type
        self.backbone_dtype_policy = backbone_dtype_policy
        self._backbone_handles = ()
        if hasattr(net_type, "key") and hasattr(net_type, "close"):
            self._backbone_handles = (net_type,)
            self.backbone_key = net_type.key
        valid_reduction = ("mean", "sum")
        if reduction not in valid_reduction:
            raise ValueError(f"Argument `reduction` must be one of {valid_reduction}, but got {reduction}")
        self.reduction = reduction
        if not isinstance(normalize, bool):
            raise ValueError(f"Argument `normalize` should be a bool but got {normalize}")
        self.normalize = normalize
        # on the device now: a captured update cannot copy them from the host
        self.layer_weights = (
            None if layer_weights is None else [torch.as_tensor(w, device=self.device) for w in layer_weights]
        )

        self._jit_loss = None  # built lazily; cached across updates
        self.add_state("sum_scores", torch.zeros(()), dist_reduce_fx="sum")
        self.add_state("total", torch.zeros(()), dist_reduce_fx="sum")

    def update(self, img1: Tensor, img2: Tensor) -> None:
        """Accumulate LPIPS sums."""
        if self._jit_loss is None:
            net, weights, normalize = self.net, self.layer_weights, self.normalize

            def step_fn(sum_scores, total, a, b):
                loss = learned_perceptual_image_patch_similarity(a, b, net, weights, normalize, reduction="sum")
                return sum_scores + loss, total + a.shape[0]

            from tpumetrics_torch.utils.jit_fallback import JitWithEagerFallback

            self._jit_loss = JitWithEagerFallback(step_fn, "The LPIPS backbone", key_fn=lambda: _placement_token(net))
        self.sum_scores, self.total = self._jit_loss(self.sum_scores, self.total, img1, img2)

    def compute(self) -> Tensor:
        """Reduced LPIPS."""
        if self.reduction == "mean":
            return self.sum_scores / self.total
        return self.sum_scores

    def __getstate__(self):
        state = super().__getstate__()
        state.pop("_jit_loss", None)  # holds CUDA graphs; rebuilt lazily
        return state

    def __setstate__(self, state):
        super().__setstate__(state)
        self._jit_loss = None
