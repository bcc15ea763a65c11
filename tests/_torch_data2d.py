"""Shared pieces of the tests that hold the port's 2-D data path and
CLIs against the JAX package (tests/test_torch_{datasets2d,augment2d,
train2d_cli,test2d}.py): a REFUGE-layout PNG tree, and the augmentation
draws JAX makes from a key, in the port's form."""
import os

import jax
import numpy as np
import torch

# (name, H, W): three square crops and one non-square frame
FRAMES = [("n0001_80_101,202.png", 80, 80), ("n0002_80_11,22.png", 80, 80),
          ("g0003_80_5,6.png", 80, 80), ("n0004_90_30,40.png", 90, 70)]


def raw_mask(h, w, seed):
    """REFUGE grayscale: 255 background, 128 disc, 0 cup (nested
    ellipses)."""
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[:h, :w].astype(np.float32)
    cy, cx = h / 2 + rng.randint(-5, 5), w / 2 + rng.randint(-5, 5)
    r = ((yy - cy) / (h / 4)) ** 2 + ((xx - cx) / (w / 5)) ** 2
    m = np.full((h, w), 255, np.uint8)
    m[r < 1] = 128
    m[r < 0.3] = 0
    return m


def write_tree(root, frames=FRAMES):
    """images/ and masks/ of a REFUGE-layout dataset directory."""
    from PIL import Image
    os.makedirs(os.path.join(root, "images"))
    os.makedirs(os.path.join(root, "masks"))
    rng = np.random.RandomState(0)
    for i, (name, h, w) in enumerate(frames):
        Image.fromarray((rng.rand(h, w, 3) * 255).astype(np.uint8)).save(
            os.path.join(root, "images", name))
        Image.fromarray(raw_mask(h, w, i)).save(
            os.path.join(root, "masks", name))
    return root


def jax_draws(key, batch, cfg):
    """The draws JAX augment_batch_2d makes from ``key``, in the port's
    form."""
    d = {k: [] for k in ("crop_pad", "crop_pad_factor", "flip_lr", "flip_ud",
                         "rot_k", "affine", "affine_deg", "jitter",
                         "robust")}
    for sk in jax.random.split(key, batch):
        keys = jax.random.split(sk, 11)
        u = lambda k: float(jax.random.uniform(k, ()))  # noqa: E731
        d["crop_pad"].append(u(keys[0]) < cfg.crop_pad_prob)
        kf, _ = jax.random.split(keys[1])
        d["crop_pad_factor"].append(float(jax.random.uniform(
            kf, (), minval=-cfg.randscale, maxval=cfg.randscale)))
        d["flip_lr"].append(u(keys[2]) < cfg.fliplr_prob)
        d["flip_ud"].append(u(keys[3]) < cfg.flipud_prob)
        k = int(jax.random.randint(keys[5], (), 1, 4))
        d["rot_k"].append(k if u(keys[4]) < cfg.rot90_prob else 0)
        d["affine"].append(cfg.do_affine and u(keys[10]) < cfg.affine_prob)
        kr, ks = jax.random.split(keys[9])
        d["affine_deg"].append([
            float(jax.random.uniform(kr, (), minval=-cfg.affine_rotate_deg,
                                     maxval=cfg.affine_rotate_deg)),
            float(jax.random.uniform(ks, (), minval=-cfg.affine_shear_deg,
                                     maxval=cfg.affine_shear_deg))])
        kc, kb, kk, kss, _ = jax.random.split(keys[6], 5)
        choice = int(jax.random.randint(kc, (), 0, 4))
        fac = []
        for i, kx in enumerate((kb, kk, kss)):
            two = jax.random.uniform(kx, (), minval=0.8, maxval=1.2)
            one = jax.random.uniform(kx, (), minval=0.9, maxval=1.1)
            fac.append(float(two) if choice == i
                       else float(one) if choice == 3 else 1.0)
        d["jitter"].append(fac)
        lo, hi = cfg.robust_aug_range
        rk = (jax.random.split(keys[7], len(cfg.robust_aug))
              if cfg.robust_aug else [])
        d["robust"].append([float(jax.random.uniform(r, (), minval=lo,
                                                     maxval=hi))
                            for r in rk])
    out = {k: torch.tensor(v) for k, v in d.items()}
    out["robust"] = out["robust"].reshape(batch, len(cfg.robust_aug))
    return out
