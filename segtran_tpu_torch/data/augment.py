"""On-device augmentation of the training step (counterpart of
``segtran_tpu/data/augment.py``; reference train_util.py:15-81 for 2-D,
datasets3d.py:497-508, 568-580, 611-665 for 3-D).

Each augmentation is split into its random draws (from an explicit
``torch.Generator``) and a deterministic transform that takes them, so a
test can feed the draws the JAX functions made.

2-D (``draw_2d``, then ``augment_batch_2d``): per sample, a crop-and-pad
zoom, left-right and up-down flips, a quarter turn (resized back for
non-square frames), an affine (rotate + shear), then the gray blend, the
colour jitter, the robustness jitter and the normalisation. The transforms
run on the whole batch at once on its device: one index gather does the
flips and turns, and a sample that skips a transform keeps its input
through a per-sample select, as the JAX package's vmapped
``augment_sample_2d`` does. Images resample bilinearly (reflect-101
outside the frame for the affine, zero for the zoom), masks nearest with
zero outside.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from ..ops.resize import resize_to

# ITU-R 601-2 luma (PIL/imgaug)
_GRAY_W = (0.299, 0.587, 0.114)


@dataclasses.dataclass(frozen=True)
class Aug2dConfig:
    """The 2-D augmentation recipe (reference train_util.py:33-81)."""
    randscale: float = 0.0         # crop-and-pad percent (--randscale)
    crop_pad_prob: float = 0.5
    fliplr_prob: float = 0.2
    flipud_prob: float = 0.2
    rot90_prob: float = 0.3
    # --affine: p=0.3 rotate(-45, 45) + shear(-16, 16)
    do_affine: bool = False
    affine_prob: float = 0.3
    affine_rotate_deg: float = 45.0
    affine_shear_deg: float = 16.0
    gray_alpha: float = 0.5
    colorjitter: bool = True
    # --robustaug / --robustaugdeg: extra jitters with a factor range
    robust_aug: Tuple[str, ...] = ()
    robust_aug_range: Tuple[float, float] = (0.5, 1.5)
    mean: Tuple[float, ...] = (0.5, 0.5, 0.5)
    std: Tuple[float, ...] = (0.5, 0.5, 0.5)


def _uniform(shape, lo, hi, generator):
    u = torch.rand(shape, generator=generator, device=generator.device)
    return u * (hi - lo) + lo


def draw_2d(batch: int, cfg: Aug2dConfig, generator: torch.Generator
            ) -> Dict[str, torch.Tensor]:
    """The random draws of one batch, on the generator's device, each with
    the batch as its first axis:

    * ``crop_pad`` bool, ``crop_pad_factor`` f in [-randscale, randscale)
      (the canvas scale is 1 + f);
    * ``flip_lr``, ``flip_ud`` bool; ``rot_k`` quarter turns in [0, 4);
    * ``affine`` bool, ``affine_deg`` [B, 2]: rotation and shear degrees;
    * ``jitter`` [B, 3]: brightness, contrast and saturation factors, one
      of them from [0.8, 1.2) or all three from [0.9, 1.1), the others 1
      (torchvision ColorJitter under RandomChoice);
    * ``robust`` [B, len(cfg.robust_aug)]: factors from the robust range.
    """
    g = generator
    u = lambda *shape: _uniform(shape, 0.0, 1.0, g)  # noqa: E731
    d = {"crop_pad": u(batch) < cfg.crop_pad_prob,
         "crop_pad_factor": _uniform((batch,), -cfg.randscale,
                                     cfg.randscale, g),
         "flip_lr": u(batch) < cfg.fliplr_prob,
         "flip_ud": u(batch) < cfg.flipud_prob}
    do_rot = u(batch) < cfg.rot90_prob
    k = torch.randint(1, 4, (batch,), generator=g, device=g.device)
    d["rot_k"] = torch.where(do_rot, k, torch.zeros_like(k))
    d["affine"] = (u(batch) < cfg.affine_prob) & cfg.do_affine
    d["affine_deg"] = (u(batch, 2) * 2 - 1) * torch.tensor(
        [cfg.affine_rotate_deg, cfg.affine_shear_deg], device=g.device)
    choice = torch.randint(0, 4, (batch, 1), generator=g, device=g.device)
    raw = u(batch, 3)
    one = torch.arange(3, device=g.device)[None]
    d["jitter"] = torch.where(
        choice == one, raw * 0.4 + 0.8,
        torch.where(choice == 3, raw * 0.2 + 0.9, torch.ones_like(raw)))
    lo, hi = cfg.robust_aug_range
    d["robust"] = _uniform((batch, len(cfg.robust_aug)), lo, hi, g)
    return d


def _gather(x: torch.Tensor, ys: torch.Tensor, xs: torch.Tensor):
    """x [B, H, W, C] at per-sample source pixels ys, xs (broadcasting to
    [B, H', W']) -> [B, H', W', C]."""
    b = torch.arange(x.shape[0], device=x.device)[:, None, None]
    return x[b, ys, xs]


def _bilinear(x, fy, fx):
    """x [B, H, W, C] at source coordinates fy, fx ([B, H', 1] / [B, 1,
    W'] or [B, H', W']) already inside the frame; the corner weights
    multiply as in the JAX package."""
    h, w = x.shape[1], x.shape[2]
    y0 = torch.floor(fy).long().clamp(0, h - 1)
    x0 = torch.floor(fx).long().clamp(0, w - 1)
    y1 = (y0 + 1).clamp(max=h - 1)
    x1 = (x0 + 1).clamp(max=w - 1)
    wy = (fy - y0)[..., None]
    wx = (fx - x0)[..., None]
    return (_gather(x, y0, x0) * (1 - wy) * (1 - wx)
            + _gather(x, y0, x1) * (1 - wy) * wx
            + _gather(x, y1, x0) * wy * (1 - wx)
            + _gather(x, y1, x1) * wy * wx)


def _select(do, new, old):
    return torch.where(do.reshape(-1, *([1] * (old.dim() - 1))), new, old)


def _crop_and_pad(images, masks, factor):
    """imgaug CropAndPad(percent=(-p, p), pad_cval=0) and the resize back:
    the frame sampled at centre-scaled coordinates (scale 1 + f), bilinear
    for images, nearest for masks, zero where the canvas leaves the
    frame."""
    h, w = images.shape[1], images.shape[2]
    scale = (1.0 + factor)[:, None]
    dev = images.device
    yy = (torch.arange(h, device=dev) - (h - 1) / 2.0) * scale + (h - 1) / 2.0
    xx = (torch.arange(w, device=dev) - (w - 1) / 2.0) * scale + (w - 1) / 2.0
    valid = (((yy >= -0.5) & (yy <= h - 0.5))[:, :, None]
             & ((xx >= -0.5) & (xx <= w - 0.5))[:, None, :])[..., None]
    gy, gx = yy.clamp(0, h - 1)[:, :, None], xx.clamp(0, w - 1)[:, None, :]
    img = _bilinear(images, gy, gx) * valid
    msk = _gather(masks, torch.round(gy).long(), torch.round(gx).long())
    return img, msk * valid


def _turn_index(k, h, w, dev):
    """Source row, column [B, H, W] of each output pixel after k quarter
    turns (jnp.rot90 in the HW plane). On a non-square frame an odd turn
    is followed by imgaug's keep_size resize back to [H, W]; for masks a
    cv2 INTER_NEAREST resize, src = floor(dst * src_size / dst_size)."""
    i = torch.arange(h, device=dev)[:, None].expand(h, w)
    j = torch.arange(w, device=dev)[None, :].expand(h, w)
    if h == w:
        ys = torch.stack([i, j, h - 1 - i, h - 1 - j])
        xs = torch.stack([j, w - 1 - i, w - 1 - j, i])
    else:
        ry = torch.clamp((torch.arange(h, device=dev) * w) // h,
                         max=w - 1)[:, None].expand(h, w)
        rx = torch.clamp((torch.arange(w, device=dev) * h) // w,
                         max=h - 1)[None, :].expand(h, w)
        ys = torch.stack([i, rx, h - 1 - i, h - 1 - rx])
        xs = torch.stack([j, w - 1 - ry, w - 1 - j, ry])
    return ys[k], xs[k]


def _flip_turn(images, masks, flip_lr, flip_ud, k):
    """Flips, then k quarter turns. Images of a non-square frame with an
    odd k are turned, then resized bilinearly back to [H, W] (imgaug's
    keep_size with Rot90; bilinear for its INTER_AREA where an axis
    shrinks, as the JAX package does)."""
    h, w = images.shape[1], images.shape[2]
    ys, xs = _turn_index(k, h, w, images.device)
    ud, lr = flip_ud[:, None, None], flip_lr[:, None, None]
    ys = torch.where(ud, h - 1 - ys, ys)
    xs = torch.where(lr, w - 1 - xs, xs)
    masks = _gather(masks, ys, xs)
    if h == w:
        return _gather(images, ys, xs), masks
    even = _gather(images, ys, xs)           # k 0 and 2 are exact here
    i = torch.arange(h, device=images.device)[None, :, None]
    j = torch.arange(w, device=images.device)[None, None, :]
    flipped = _gather(images, torch.where(ud, h - 1 - i, i),
                      torch.where(lr, w - 1 - j, j))
    turned = _select(k == 1, torch.rot90(flipped, 1, (1, 2)),
                     torch.rot90(flipped, 3, (1, 2)))
    return _select(k % 2 == 1, resize_to(turned, images), even), masks


def _reflect101(c, n: int):
    """Fold a coordinate into [0, n - 1] by mirroring about the edge pixel
    centres without repeating them (cv2 BORDER_REFLECT_101)."""
    if n == 1:
        return torch.zeros_like(c)
    p = 2.0 * (n - 1)
    c = torch.remainder(c, p)
    return torch.minimum(c, p - c)


def _affine(images, masks, deg):
    """iaa.Affine(rotate=r, shear=s, order=1, mode='reflect') about the
    frame centre (reference train_util.py:42-49): the forward matrix
    [[cos r, -sin(r+s)], [sin r, cos(r+s)]] in (x, y), inverted per
    sample; bilinear + reflect-101 for images, nearest + zero for masks."""
    h, w = images.shape[1], images.shape[2]
    dev = images.device
    r, s = torch.deg2rad(deg[:, 0]), torch.deg2rad(deg[:, 1])
    inv_det = 1.0 / torch.cos(s)
    m00 = (torch.cos(r + s) * inv_det)[:, None, None]
    m01 = (torch.sin(r + s) * inv_det)[:, None, None]
    m10 = (-torch.sin(r) * inv_det)[:, None, None]
    m11 = (torch.cos(r) * inv_det)[:, None, None]
    cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
    yy = torch.arange(h, dtype=torch.float32, device=dev)[:, None] - cy
    xx = torch.arange(w, dtype=torch.float32, device=dev)[None, :] - cx
    src_x = m00 * xx + m01 * yy + cx                     # [B, H, W]
    src_y = m10 * xx + m11 * yy + cy
    img = _bilinear(images, _reflect101(src_y, h), _reflect101(src_x, w))
    ny, nx = torch.round(src_y).long(), torch.round(src_x).long()
    valid = ((ny >= 0) & (ny < h) & (nx >= 0) & (nx < w))[..., None]
    msk = _gather(masks, ny.clamp(0, h - 1), nx.clamp(0, w - 1))
    return img, msk * valid.to(msk.dtype)


def _gray(x):
    """Luma [..., 1] of RGB [..., 3], the three products summed in order."""
    return (x[..., 0:1] * _GRAY_W[0] + x[..., 1:2] * _GRAY_W[1]
            + x[..., 2:3] * _GRAY_W[2])


def _per_sample(v, x):
    return v.reshape(-1, *([1] * (x.dim() - 1)))


def _color_jitter(images, factors):
    """Brightness (scale), contrast (blend with the sample's mean gray
    level), saturation (blend with the per-pixel gray of the brightened
    image), clipped to [0, 1] (torchvision semantics, as JAX computes
    them)."""
    out = images * _per_sample(factors[:, 0], images)
    gray = _gray(out)
    mean_gray = gray.mean((1, 2, 3), keepdim=True)
    out = mean_gray + (out - mean_gray) * _per_sample(factors[:, 1], out)
    out = gray + (out - gray) * _per_sample(factors[:, 2], out)
    return out.clamp(0.0, 1.0)


def augment_batch_2d(images: torch.Tensor, masks: torch.Tensor,
                     draws: Dict[str, torch.Tensor], cfg: Aug2dConfig,
                     mean: Optional[torch.Tensor] = None,
                     std: Optional[torch.Tensor] = None):
    """images [B, H, W, 3] float in [0, 1], masks [B, H, W, C] (n-hot),
    ``draws`` from ``draw_2d`` on their device -> (normalised images,
    masks). ``mean`` / ``std`` [C] apply one table to the batch, [B, C]
    one per sample (a multi-dataset batch); None takes cfg's."""
    if cfg.randscale > 0:
        img, msk = _crop_and_pad(images, masks, draws["crop_pad_factor"])
        images = _select(draws["crop_pad"], img, images)
        masks = _select(draws["crop_pad"], msk, masks)
    images, masks = _flip_turn(images, masks, draws["flip_lr"],
                               draws["flip_ud"], draws["rot_k"])
    if cfg.do_affine:
        img, msk = _affine(images, masks, draws["affine_deg"])
        images = _select(draws["affine"], img, images)
        masks = _select(draws["affine"], msk, masks)
    if cfg.gray_alpha > 0:
        images = (1 - cfg.gray_alpha) * images + cfg.gray_alpha * _gray(images)
    if cfg.colorjitter:
        images = _color_jitter(images, draws["jitter"])
    for i, kind in enumerate(cfg.robust_aug):
        f = _per_sample(draws["robust"][:, i], images)
        if kind == "brightness":
            images = (images * f).clamp(0.0, 1.0)
        elif kind == "contrast":
            mg = _gray(images).mean((1, 2, 3), keepdim=True)
            images = (mg + (images - mg) * f).clamp(0.0, 1.0)
        else:
            raise ValueError(f"unknown robust_aug {kind}")
    dev = images.device
    mean = torch.as_tensor(cfg.mean if mean is None else mean,
                           dtype=torch.float32, device=dev)
    std = torch.as_tensor(cfg.std if std is None else std,
                          dtype=torch.float32, device=dev)
    if mean.dim() == 2:
        mean, std = mean[:, None, None, :], std[:, None, None, :]
    return (images - mean) / std, masks


# ---------------- 3D ----------------

def rot_flip_draws(batch: int, generator=None
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per sample: quarter turns k in [0, 4), flip H, flip W (CPU tensors)."""
    k = torch.randint(0, 4, (batch,), generator=generator)
    flips = torch.rand((2, batch), generator=generator) < 0.5
    return k, flips[0], flips[1]


def rot_flip_3d(image: torch.Tensor, label: torch.Tensor, k: int,
                flip_h: bool, flip_w: bool):
    """RandomRotFlip of one sample: k quarter turns in the HW plane, then
    the flips. image [H, W, D, C]; label [H, W, D] raw."""
    image, label = torch.rot90(image, k, (0, 1)), torch.rot90(label, k, (0, 1))
    if flip_h:
        image, label = image.flip(0), label.flip(0)
    if flip_w:
        image, label = image.flip(1), label.flip(1)
    return image, label


def resized_crop_draw(scale: float, generator=None) -> float:
    """The batch's zoom factor, uniform in [1 - scale, 1 + scale)."""
    u = float(torch.rand((), generator=generator))
    return (1.0 - scale) + 2.0 * scale * u


def _lerp_axis(vol, axis, coords):
    n = vol.shape[axis]
    i0 = torch.floor(coords).long()
    i1 = torch.clamp(i0 + 1, max=n - 1)
    shape = [1] * vol.dim()
    shape[axis] = coords.shape[0]
    w = (coords - i0.float()).reshape(shape).to(vol.dtype)
    a, b = vol.index_select(axis, i0), vol.index_select(axis, i1)
    return a * (1.0 - w) + b * w


def resized_crop_3d(images: torch.Tensor, masks: torch.Tensor, f: float):
    """Batch-level RandomResizedCrop by the zoom factor ``f``: resample the
    centre window scaled by f (trilinear for images, nearest for masks),
    zero where the window leaves the volume. images, masks
    [B, H, W, D, C]."""
    h, w, d = images.shape[1:4]
    dev = images.device
    grids, valids = [], []
    for n in (h, w, d):
        c = (torch.arange(n, dtype=torch.float32, device=dev)
             - (n - 1) / 2.0) * f + (n - 1) / 2.0
        valids.append((c >= -0.5) & (c <= n - 0.5))
        grids.append(torch.clamp(c, 0, n - 1))
    valid = (valids[0][:, None, None] & valids[1][None, :, None]
             & valids[2][None, None, :])[None, ..., None]
    gy, gx, gz = grids
    img = _lerp_axis(_lerp_axis(_lerp_axis(images, 1, gy), 2, gx), 3, gz)
    iy, ix, iz = (torch.round(g).long() for g in grids)
    msk = masks.index_select(1, iy).index_select(2, ix).index_select(3, iz)
    return img * valid.to(img.dtype), msk * valid.to(msk.dtype)


def noise_draw(shape, sigma: float = 0.1, clip: float = 0.2, generator=None,
               device=None) -> torch.Tensor:
    """RandomNoise's additive noise: clip(sigma N(0, 1), -clip, clip)."""
    z = torch.randn(shape, generator=generator, device=device)
    return torch.clamp(sigma * z, -clip, clip)
