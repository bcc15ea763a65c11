"""The port's 2-D losses, vCDR and Dice metrics held against the JAX
package on the CPU (fp32, 1e-6), and the preset override rule."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_parity import one_torch_thread  # noqa: F401

TOL = dict(rtol=1e-6, atol=1e-6)


def _soft_masks(seed, b=3, h=24, w=20):
    """Soft 3-class fundus maps: a disc ellipse holding a cup ellipse,
    blurred; frame 1 has no cup, frame 2 neither cup nor disc."""
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[:h, :w].astype(np.float32)
    out = np.zeros((b, h, w, 3), np.float32)
    for i in range(b):
        r = ((yy - h / 2) / 7) ** 2 + ((xx - w / 2) / 6) ** 2
        disc = np.clip(1.5 - r, 0, 1) + 0.1 * rng.rand(h, w)
        cup = np.clip(1.2 - 3 * r, 0, 1) + 0.1 * rng.rand(h, w)
        if i >= 1:
            cup *= 0.4
        if i == 2:
            disc *= 0.4
        out[i, ..., 1], out[i, ..., 2] = disc, cup
        out[i, ..., 0] = 1 - np.maximum(disc, cup)
    return np.clip(out, 0, 1)


@pytest.mark.parametrize("running", [-1.0, 3.5])
def test_smooth_dice_loss_matches_jax(running):
    from segtran_tpu.ops.losses import smooth_dice_loss as jfn
    from segtran_tpu_torch.ops.losses import smooth_dice_loss
    rng = np.random.RandomState(1)
    score = rng.rand(4, 2, 10, 12).astype(np.float32)
    gt = (rng.rand(4, 2, 10, 12) > 0.6).astype(np.float32)
    want = jfn(jnp.asarray(score), jnp.asarray(gt), jnp.float32(running))
    got = smooth_dice_loss(torch.from_numpy(score), torch.from_numpy(gt),
                           torch.tensor(running))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


def test_smooth_dice_denominator_offset_has_no_gradient():
    """The offset's running part carries the gradient, not the batch's own
    denominator (JAX stop_gradient)."""
    from segtran_tpu_torch.ops.losses import smooth_dice_loss
    score = torch.rand(2, 16, requires_grad=True)
    gt = (torch.rand(2, 16) > 0.5).float()
    loss, _, _ = smooth_dice_loss(score, gt, torch.tensor(2.0))
    loss.backward()
    assert torch.isfinite(score.grad).all() and score.grad.abs().sum() > 0


def test_dice_loss_mix_matches_jax():
    from segtran_tpu.ops.losses import dice_loss_mix as jfn
    from segtran_tpu_torch.ops.losses import dice_loss_mix
    rng = np.random.RandomState(2)
    score = rng.rand(3, 8, 9, 2).astype(np.float32)
    gt = (rng.rand(3, 8, 9, 2) > 0.5).astype(np.float32)
    np.testing.assert_allclose(
        dice_loss_mix(torch.from_numpy(score), torch.from_numpy(gt)).numpy(),
        np.asarray(jfn(jnp.asarray(score), jnp.asarray(gt))), **TOL)


@pytest.mark.parametrize("name", ["calc_vcdr_batch", "calc_vcdr_eval"])
@pytest.mark.parametrize("thres", [0.5, 0.3])
def test_vcdr_matches_jax(name, thres):
    """Frame 0 has a cup and a disc, frame 1 a disc and no cup (eval: 0),
    frame 2 neither (eval: -1)."""
    from segtran_tpu.ops import losses as jl
    from segtran_tpu_torch.ops import losses as tl
    masks = _soft_masks(3)
    want = np.asarray(getattr(jl, name)(jnp.asarray(masks), thres))
    got = getattr(tl, name)(torch.from_numpy(masks), thres).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    if name == "calc_vcdr_eval" and thres == 0.5:
        assert got[1] == 0.0 and got[2] == -1.0 and 0 < got[0] < 1


def test_dice_score_matches_jax():
    from segtran_tpu.infer.metrics import dice_score as jfn
    from segtran_tpu_torch.infer.metrics import dice_score
    rng = np.random.RandomState(4)
    pred = rng.rand(2, 3, 11, 13).astype(np.float32)
    gt = (rng.rand(2, 3, 11, 13) > 0.5).astype(np.float32)
    np.testing.assert_allclose(
        dice_score(torch.from_numpy(pred), torch.from_numpy(gt)).numpy(),
        np.asarray(jfn(jnp.asarray(pred), jnp.asarray(gt))), **TOL)


@pytest.mark.parametrize("num_classes", [3, 2])
def test_batch_dice_per_class_matches_jax(num_classes):
    from segtran_tpu.infer.metrics import batch_dice_per_class as jfn
    from segtran_tpu_torch.infer.metrics import batch_dice_per_class
    rng = np.random.RandomState(5)
    hard = (rng.rand(4, 16, 12, num_classes) > 0.5).astype(np.float32)
    gt = (rng.rand(4, 16, 12, num_classes) > 0.4).astype(np.float32)
    gt[1, ..., 1:] = 0          # a class absent from a frame
    got = batch_dice_per_class(torch.from_numpy(hard), torch.from_numpy(gt),
                               num_classes).numpy()
    want = np.asarray(jfn(jnp.asarray(hard), jnp.asarray(gt), num_classes))
    assert got.shape == (4, num_classes - 1)
    np.testing.assert_allclose(got, want, **TOL)


def test_get_default_matches_jax():
    from segtran_tpu.configs.presets import get_default as jget
    from segtran_tpu_torch.configs.presets import get_default
    preset = {"lr": 2e-4, "decay": 1e-4}
    for args, key, unset in (({"lr": None}, "lr", None),
                             ({"lr": 1e-3}, "lr", None),
                             ({"lr": -1}, "lr", -1),
                             ({}, "decay", None),
                             ({"x": 3}, "x", None)):
        a, b = dict(args), dict(args)
        assert get_default(a, key, preset, unset) == jget(b, key, preset,
                                                          unset)
        assert a == b


def test_presets_2d_fields_match_jax():
    from segtran_tpu.configs.presets import TASK_SETTINGS as J
    from segtran_tpu_torch.configs.presets import TASK_SETTINGS as T
    for key in ("uncropped_size", "has_mask", "ds_weight", "num_classes",
                "bce_weight", "ds_class", "ds_names", "orig_input_size",
                "patch_size", "binarize"):
        assert T["fundus"][key] == J["fundus"][key], key
    for key in J["polyp"]:
        assert T["polyp"][key] == J["polyp"][key], key
