"""Feature-robustness evaluation. Counterpart of
``segtran_tpu/tools/robustness.py`` (reference eval_robustness,
internal_util.py:197-343): run the model on the original and on perturbed
inputs (brightness / contrast / saturation jitter, a down or up resize
round trip, random noise), then report per-layer Pearson correlations
between the original and perturbed feature maps, the left/right-half
Pearson self-consistency and the std of each perturbed map.

The feature maps are the model's kept features under JAX's intermediates
paths (``nn/features.kept_features``). JAX draws each perturbation's factor
or noise with ``jax.random`` inside the perturbation; here the
perturbations take the factor or noise as an argument and
``draw_perturbation`` draws it from a ``torch.Generator`` seeded by
``seed``. The two streams differ (``jax.random`` cannot be reproduced in
PyTorch); given JAX's draw, each perturbation equals JAX's.
"""
from __future__ import annotations

from typing import Callable, Dict, Mapping, Optional, Sequence

import torch

from ..nn.features import drop_kept_features, kept_features
from ..ops.resize import resize_image_linear

_GRAY_W = (0.299, 0.587, 0.114)


def _pearson(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    a = a.reshape(-1).float()
    b = b.reshape(-1).float()
    a = a - a.mean()
    b = b - b.mean()
    denom = torch.sqrt((a * a).sum() * (b * b).sum()) + 1e-8
    return (a * b).sum() / denom


def lr_half_pearson(feat: torch.Tensor) -> torch.Tensor:
    """Pearson between the left and right halves of a [B, H, W, ...] map."""
    w = feat.shape[2]
    return _pearson(feat[:, :, : w // 2], feat[:, :, w - w // 2:])


def _gray(x: torch.Tensor) -> torch.Tensor:
    w = torch.tensor(_GRAY_W, dtype=x.dtype, device=x.device)
    return torch.tensordot(x, w, dims=([-1], [0]))[..., None]


def _resize_roundtrip(x: torch.Tensor, scale: float) -> torch.Tensor:
    """Resize by ``scale``, then back (antialiased where it shrinks): the
    reference's Resize((192,192)) / Resize((432,432)) relative to 288^2
    inputs (internal_util.py:210-212), at the input's own size."""
    h, w = x.shape[1:3]
    mid = (max(int(h * scale), 1), max(int(w * scale), 1))
    return resize_image_linear(resize_image_linear(x, mid), (h, w))


def brightness(x, factor):
    return (x * factor).clamp(0, 1)


def contrast(x, factor):
    mean = x.mean()
    return (mean + (x - mean) * factor).clamp(0, 1)


def saturation(x, factor):
    gray = _gray(x)
    return (gray + (x - gray) * factor).clamp(0, 1)


def resize_down(x, draw=None):
    return _resize_roundtrip(x, 2 / 3)


def resize_up(x, draw=None):
    return _resize_roundtrip(x, 1.5)


def noise(x, draw):
    """``draw``: standard normal noise of x's shape."""
    return x + 0.1 * draw


# the reference's roster (internal_util.py:206-213): x [B, H, W, 3] in
# [0, 1] and the perturbation's draw -> the perturbed batch
PERTURBATIONS: Dict[str, Callable] = {
    "brightness": brightness, "contrast": contrast, "saturation": saturation,
    "resize_down": resize_down, "resize_up": resize_up, "noise": noise}


def draw_perturbation(name: str, x: torch.Tensor, lo: float, hi: float,
                      gen: torch.Generator):
    """The draw ``PERTURBATIONS[name]`` takes: a factor U(lo, hi) for the
    jitters, standard normal noise of x's shape on x's device for
    ``noise``, None for the resizes (JAX's draws, from ``gen``)."""
    if name in ("brightness", "contrast", "saturation"):
        return float(lo + (hi - lo) * torch.rand((), generator=gen))
    if name == "noise":
        return torch.randn(x.shape, generator=gen).to(x.device, x.dtype)
    if name in PERTURBATIONS:
        return None
    raise KeyError(f"unknown perturbation {name!r}; known: "
                   f"{', '.join(PERTURBATIONS)}")


def _run(model, x, state=None):
    """(output, kept features) of one eval forward, with the model's
    ``keep_features`` on for it; ``state``: another state_dict to run the
    model's module with (``torch.func.functional_call``)."""
    keeps = hasattr(model, "keep_features")
    if keeps:
        model.keep_features = True
    try:
        with torch.no_grad():
            out = (model(x) if state is None else
                   torch.func.functional_call(model, state, (x,)))
        return out, kept_features(model)
    finally:
        if keeps:
            model.keep_features = False
        drop_kept_features(model)


def eval_robustness(model: torch.nn.Module, images: torch.Tensor,
                    perturbations: Sequence[str] = (
                        "brightness", "contrast", "saturation", "resize_down",
                        "resize_up", "noise"),
                    seed: int = 0, degrees=(0.7, 1.3),
                    ref_state_dict: Optional[Mapping] = None,
                    draws: Optional[Mapping] = None
                    ) -> Dict[str, Dict[str, float]]:
    """Returns {perturbation: {feature path: pearson, 'lr_pearson/<path>',
    'std/<path>', ..., 'output_pearson'}}, features of at least 3 dims, in
    the kept features' order. ``model`` is in eval mode on the images'
    device.

    ``ref_state_dict``: a second checkpoint's weights giving the CLEAN
    reference features (the reference's --robustcp refnet, test2d.py
    :634-638): cross-checkpoint feature stability instead of same-net
    perturbation stability. ``draws``: {perturbation: its draw} in place
    of ``draw_perturbation``'s (the tests pass JAX's)."""
    base_out, base_feats = _run(model, images, ref_state_dict)
    gen = torch.Generator().manual_seed(seed)
    results = {}
    for pert in perturbations:
        draw = (draws[pert] if draws is not None and pert in draws
                else draw_perturbation(pert, images, degrees[0], degrees[1],
                                       gen))
        out2, feats2 = _run(model, PERTURBATIONS[pert](images, draw))
        r = {}
        for name, f in base_feats.items():
            if name in feats2 and f.dim() >= 3:
                g = feats2[name]
                r[name] = float(_pearson(f, g))
                r[f"lr_pearson/{name}"] = float(lr_half_pearson(g))
                r[f"std/{name}"] = float(g.float().std(unbiased=False))
        r["output_pearson"] = float(_pearson(base_out, out2))
        results[pert] = r
    return results
