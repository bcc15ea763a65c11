"""The port's batched 2-D augmentation held against the JAX package's
vmapped ``augment_sample_2d`` on the CPU.

The test re-derives each sample's draws from the keys JAX uses
(``augment_batch_2d`` splits the key per sample, ``augment_sample_2d``
splits each into 11) and feeds them to the port's ``augment_batch_2d``.
Each transform is turned on and off through its probability. Masks must
agree exactly; images to 1e-5 (fp32; XLA fuses the bilinear corner sums
and the jitter's products into other instruction sequences), except where
bilinear resampling sums in another order, 1e-4: the quarter turn of a
non-square frame, whose resize back runs through PyTorch's interpolate on
one side and jax.image.resize on the other, and the affine, whose source
coordinates come from float32 sin/cos that XLA and PyTorch round to other
last bits (measured 2.6e-5 after the 0.1 std normalisation).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_data2d import jax_draws
from _torch_parity import one_torch_thread  # noqa: F401

IMG_TOL = dict(rtol=0, atol=1e-5)
RESIZE_TOL = dict(rtol=0, atol=1e-4)
OFF = dict(randscale=0.0, fliplr_prob=0.0, flipud_prob=0.0, rot90_prob=0.0,
           gray_alpha=0.0, colorjitter=False)


def _batch(b, h, w, seed):
    from segtran_tpu.data.labelmaps import fundus_map_mask
    rng = np.random.RandomState(seed)
    images = rng.rand(b, h, w, 3).astype(np.float32)
    yy, xx = np.mgrid[:h, :w].astype(np.float32)
    raw = np.full((b, h, w, 1), 255, np.uint8)
    for i in range(b):
        r = (((yy - h / 2 - i) / (h / 4)) ** 2
             + ((xx - w / 2 + i) / (w / 5)) ** 2)
        raw[i, r < 1, 0] = 128
        raw[i, r < 0.3, 0] = 0
    return images, np.array(fundus_map_mask(jnp.asarray(raw)))


CASES = {
    "all off": {},
    "crop-pad always": dict(randscale=0.2, crop_pad_prob=1.0),
    "crop-pad some": dict(randscale=0.3, crop_pad_prob=0.5),
    "flips": dict(fliplr_prob=0.5, flipud_prob=0.5),
    "rot90": dict(rot90_prob=1.0),
    "rot90 some + flips": dict(rot90_prob=0.6, fliplr_prob=0.5,
                               flipud_prob=0.5),
    "affine": dict(do_affine=True, affine_prob=1.0),
    "affine some": dict(do_affine=True, affine_prob=0.5, rot90_prob=0.5),
    "gray": dict(gray_alpha=0.5),
    "jitter": dict(colorjitter=True),
    "robust": dict(robust_aug=("brightness", "contrast"),
                   robust_aug_range=(0.5, 1.5)),
    "recipe": dict(randscale=0.2, crop_pad_prob=0.5, fliplr_prob=0.2,
                   flipud_prob=0.2, rot90_prob=0.3, gray_alpha=0.5,
                   colorjitter=True),
}


def _run(kw, shape=(6, 32, 32), stats=None, seed=0):
    from segtran_tpu.data.augment import Aug2dConfig as JCfg
    from segtran_tpu.data.augment import augment_batch_2d as jaug
    from segtran_tpu_torch.data.augment import Aug2dConfig as TCfg
    from segtran_tpu_torch.data.augment import augment_batch_2d
    conf = {**OFF, **kw, "mean": (0.4, 0.3, 0.2), "std": (0.2, 0.15, 0.1)}
    jcfg, tcfg = JCfg(**conf), TCfg(**conf)
    images, masks = _batch(*shape, seed)
    key = jax.random.PRNGKey(seed + 10)
    mean = std = None
    if stats is not None:
        mean, std = stats
    want_img, want_msk = jaug(key, jnp.asarray(images), jnp.asarray(masks),
                              jcfg, mean, std)
    draws = jax_draws(key, shape[0], jcfg)
    got_img, got_msk = augment_batch_2d(
        torch.from_numpy(images), torch.from_numpy(masks), draws, tcfg,
        None if mean is None else torch.tensor(mean),
        None if std is None else torch.tensor(std))
    return (got_img.numpy(), np.asarray(want_img), got_msk.numpy(),
            np.asarray(want_msk), draws)


@pytest.mark.parametrize("case", sorted(CASES))
def test_augment_matches_jax(case):
    got, want, got_m, want_m, draws = _run(CASES[case])
    np.testing.assert_array_equal(got_m, want_m)
    np.testing.assert_allclose(
        got, want, **(RESIZE_TOL if "affine" in case else IMG_TOL))
    if case == "rot90":
        assert (draws["rot_k"] > 0).all()
    if case == "crop-pad some":
        assert 0 < int(draws["crop_pad"].sum()) < 6


def test_rot90_nonsquare_matches_jax():
    got, want, got_m, want_m, draws = _run(
        dict(rot90_prob=0.8, fliplr_prob=0.5), shape=(6, 24, 40), seed=2)
    assert set(draws["rot_k"].tolist()) >= {1, 3}
    np.testing.assert_array_equal(got_m, want_m)
    np.testing.assert_allclose(got, want, **RESIZE_TOL)
    even = (draws["rot_k"] % 2 == 0).numpy()
    np.testing.assert_allclose(got[even], want[even], **IMG_TOL)


@pytest.mark.parametrize("per_sample", [False, True])
def test_stats_tables_match_jax(per_sample):
    rng = np.random.RandomState(4)
    shape = (6, 3) if per_sample else (3,)
    mean = rng.uniform(0.2, 0.6, shape).astype(np.float32)
    std = rng.uniform(0.1, 0.3, shape).astype(np.float32)
    got, want, got_m, want_m, _ = _run(CASES["recipe"], stats=(mean, std))
    np.testing.assert_array_equal(got_m, want_m)
    np.testing.assert_allclose(got, want, **IMG_TOL)


def test_draws_follow_the_config():
    """draw_2d: the probabilities and ranges of the recipe, on the
    generator's device, repeatable from its seed."""
    from segtran_tpu_torch.data.augment import Aug2dConfig, draw_2d
    cfg = Aug2dConfig(randscale=0.2, do_affine=True,
                      robust_aug=("brightness",))
    d = draw_2d(4000, cfg, torch.Generator().manual_seed(0))
    again = draw_2d(4000, cfg, torch.Generator().manual_seed(0))
    assert all(torch.equal(d[k], again[k]) for k in d)
    assert abs(float(d["crop_pad"].float().mean()) - 0.5) < 0.05
    assert abs(float(d["flip_lr"].float().mean()) - 0.2) < 0.05
    assert abs(float((d["rot_k"] > 0).float().mean()) - 0.3) < 0.05
    assert set(d["rot_k"].tolist()) == {0, 1, 2, 3}
    assert abs(float(d["affine"].float().mean()) - 0.3) < 0.05
    assert d["crop_pad_factor"].abs().max() <= 0.2
    assert d["affine_deg"][:, 0].abs().max() <= 45
    assert d["affine_deg"][:, 1].abs().max() <= 16
    changed = (d["jitter"] != 1).sum(1)
    # one factor in [0.8, 1.2) (3 of 4 choices) or all three in [0.9, 1.1)
    assert set(changed.tolist()) == {1, 3}
    assert d["jitter"].min() >= 0.8 and d["jitter"].max() <= 1.2
    assert d["robust"].shape == (4000, 1)
    off = draw_2d(8, Aug2dConfig(), torch.Generator().manual_seed(1))
    assert not off["affine"].any()
