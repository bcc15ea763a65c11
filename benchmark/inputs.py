"""Every input of a run, made from ``--seed``: the weights, the fundus
frames, the BraTS volumes and the arrival schedule. Both sides, the
program and the reference, get the same tensors.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from .harness import seed_parts, torch_seed


def seeded_state(shapes, seed: int, device) -> dict:
    """{name: fp32 tensor on ``device``} for ``shapes`` {name: shape},
    drawn in one call from a generator on the device and scaled by fan-in:
    kernels N(0, 1/fan_in) (fan-in = the input channels times the kernel;
    a private group linear [M, F_in, F_out] takes F_in), attractors and
    position tables N(0, 1), norm scales 1 + 0.1 N, biases 0.1 N, running
    means 0.1 N and running variances 1 + 0.1 |N|."""
    g = torch.Generator(device=device).manual_seed(torch_seed(seed, 1))
    names = sorted(shapes)
    sizes = [math.prod(shapes[n]) for n in names]
    flat = torch.randn(sum(sizes), generator=g, device=device)
    out, off = {}, 0
    for name, size in zip(names, sizes):
        shape = tuple(shapes[name])
        v = flat[off:off + size].view(shape)
        off += size
        leaf = name.rsplit(".", 1)[-1]
        if leaf in ("attractors", "pos_embed", "vfeat_bias"):
            pass
        elif leaf == "running_mean":
            v = 0.1 * v
        elif leaf == "running_var":
            v = 1.0 + 0.1 * v.abs()
        elif len(shape) >= 2:
            fan_in = shape[1] if len(shape) == 3 else math.prod(shape[1:])
            v = v / math.sqrt(fan_in)
        elif leaf == "weight":
            v = 1.0 + 0.1 * v
        else:
            v = 0.1 * v
        out[name] = v.contiguous()
    return out


def model_shapes(model) -> dict:
    """{name: shape} of a module's floating parameters and buffers."""
    sd = model.state_dict()
    return {k: tuple(v.shape) for k, v in sd.items() if v.is_floating_point()}


def frames(n: int, size: int, seed: int, device) -> torch.Tensor:
    """[n, size, size, 3] float32 frames in [0, 1): a bright disc on a
    darker fundus-like field with seeded noise, so that the frames differ
    in content and not only in noise."""
    g = torch.Generator(device=device).manual_seed(torch_seed(seed, 2))
    ax = torch.linspace(-1, 1, size, device=device)
    y, x = torch.meshgrid(ax, ax, indexing="ij")
    centre = torch.rand((n, 2), generator=g, device=device) * 0.6 - 0.3
    r2 = ((y[None] - centre[:, 0, None, None]) ** 2
          + (x[None] - centre[:, 1, None, None]) ** 2)
    field = (r2 < 0.9).float() * 0.45
    disc = (r2 < 0.04).float() * 0.35 + (r2 < 0.01).float() * 0.15
    tint = torch.tensor([1.0, 0.6, 0.35], device=device)
    noise = torch.rand((n, size, size, 3), generator=g, device=device) * 0.1
    return ((field + disc)[..., None] * tint + noise).clamp(0, 1)


def volume(shape, seed: int, device) -> dict:
    """A 4-modality BraTS-like volume {'image' [H, W, D, 4] float32,
    'label' [H, W, D] uint8} (numpy): a zero background outside an
    ellipsoid head (so the nonzero mask drops tokens), seeded intensities
    inside, nested tumour labels around a seeded centre, with the
    enhancing tumour already 3 (as the BraTS loaders remap 4)."""
    g = torch.Generator(device=device).manual_seed(torch_seed(seed, 3))
    axes = [torch.linspace(-1, 1, n, device=device) for n in shape]
    x, y, z = torch.meshgrid(*axes, indexing="ij")
    head = (x / 0.8) ** 2 + (y / 0.85) ** 2 + (z / 0.9) ** 2 <= 1
    image = torch.rand(tuple(shape) + (4,), generator=g, device=device)
    image = image * head[..., None]
    c = torch.rand(3, generator=g, device=device) * 0.4 - 0.2
    r2 = (x - c[0]) ** 2 + (y - c[1]) ** 2 + (z - c[2]) ** 2
    label = torch.zeros(tuple(shape), dtype=torch.uint8, device=device)
    label[r2 < 0.09] = 2
    label[r2 < 0.04] = 1
    label[r2 < 0.01] = 3
    return {"image": image.cpu().numpy(), "label": label.cpu().numpy()}


def arrivals(rate: float, seconds: float, seed: int, shape_seed: int = 0):
    """Open-loop due times in [0, seconds): round(rate * seconds) requests
    whose gaps are one fixed set of exponential draws (``shape_seed``),
    scaled to span the window and put in an order drawn from ``seed``, so
    that every seed offers the same load in another order."""
    n = max(1, int(round(rate * seconds)))
    gaps = np.random.default_rng(shape_seed).exponential(1.0, n)
    gaps = gaps / gaps.sum() * seconds
    gaps = np.random.default_rng(seed_parts(seed)).permutation(gaps)
    return np.concatenate([[0.0], np.cumsum(gaps)[:-1]])


def rng(seed: int, salt: int) -> np.random.Generator:
    return np.random.default_rng(seed_parts(seed) + [salt])
