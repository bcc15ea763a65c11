"""The port's cli/prep_fundus.py held against the JAX package's on the
CPU: disc_crop, map_raw_fundus_label, center_from_mask and
largest_region_fill on synthetic frames; model mode's disc centroid (the
port's interpolate resize and checkpoint, JAX's cv2 resize and model, the
same converted eff-tiny weights) within 1 pixel; main's three modes over a
PNG tree, file names and crops as JAX's."""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from _torch_parity import jax_variables, jvars
from _torch_parity import one_torch_thread  # noqa: F401


def _frame(seed, h=200, w=256):
    """A fundus-like frame and its raw annotation (255 background, 128
    disc, 0 cup), the disc off centre, with a second small blob and a hole
    in the disc for the component cleanup to handle."""
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[:h, :w].astype(np.float32)
    cy, cx = rng.uniform(0.3, 0.7) * h, rng.uniform(0.25, 0.75) * w
    r = ((yy - cy) / (0.15 * h)) ** 2 + ((xx - cx) / (0.12 * w)) ** 2
    raw = np.full((h, w), 255, np.uint8)
    raw[r < 1] = 128
    raw[r < 0.3] = 0
    raw[5:9, 5:9] = 128                                  # a stray blob
    raw[int(cy), int(cx) + 3] = 255                      # a hole
    img = (np.stack([0.3 + 0.5 * (r < 1), 0.2 + 0.3 * (r < 0.3),
                     0.1 + 0 * r], -1) * 255
           + rng.randint(0, 20, (h, w, 3))).clip(0, 255).astype(np.uint8)
    return img, raw


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_helpers_match_jax(seed):
    from segtran_tpu.cli import prep_fundus as jp
    from segtran_tpu_torch.cli import prep_fundus as tp
    img, raw = _frame(seed)
    np.testing.assert_array_equal(tp.largest_region_fill(raw < 200),
                                  jp.largest_region_fill(raw < 200))
    assert tp.center_from_mask(raw) == jp.center_from_mask(raw)
    assert tp.center_from_mask(raw[..., None].repeat(3, -1)) == \
        jp.center_from_mask(raw[..., None].repeat(3, -1))
    np.testing.assert_array_equal(tp.map_raw_fundus_label(raw),
                                  jp.map_raw_fundus_label(raw))
    for roi, cx, cy in ((64, 100, 128), (64, 5, 3), (96, 190, 250),
                        (200, 100, 128)):
        crop, coord = tp.disc_crop(img, roi, cx, cy)
        jcrop, jcoord = jp.disc_crop(img, roi, cx, cy)
        assert coord == jcoord
        np.testing.assert_array_equal(crop, jcrop)
    assert not tp.largest_region_fill(np.zeros((5, 5), bool)).any()


def test_resize_matches_cv2_within_one():
    import cv2
    from segtran_tpu_torch.cli.prep_fundus import resize_uint8
    img, raw = _frame(3)
    got = resize_uint8(img, 128).astype(int)
    want = cv2.resize(img, (128, 128), interpolation=cv2.INTER_LINEAR)
    assert np.abs(got - want).max() <= 1
    np.testing.assert_array_equal(
        resize_uint8(raw, 128, "nearest"),
        cv2.resize(raw, (128, 128), interpolation=cv2.INTER_NEAREST))


ARGV = ["--bb", "eff-tiny", "--translayers", "1", "--attractors", "8",
        "--patchsize", "64", "--detsize", "128"]


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    """A port checkpoint of seeded, perturbed JAX weights, and the JAX
    model with them."""
    from segtran_tpu.configs.base import Segtran2dConfig as JCfg
    from segtran_tpu.models.segtran2d import Segtran2d as JModel
    from segtran_tpu_torch.cli import prep_fundus, test2d
    from segtran_tpu_torch.configs.base import Segtran2dConfig as TCfg
    from segtran_tpu_torch.configs.presets import TASK_SETTINGS
    from segtran_tpu_torch.convert import state_dict_from_jax
    from segtran_tpu_torch.train.checkpoint import save_checkpoint
    cpdir = str(tmp_path_factory.mktemp("prep_ckpt"))
    args = prep_fundus.build_argparser().parse_args(
        ["--images", "x", "--out", "y"] + ARGV)
    task = dict(TASK_SETTINGS["fundus"], patch_size=(64, 64))
    _, tcfg = test2d.build_model(args, task)
    jcfg = JCfg(**{f.name: getattr(tcfg, f.name)
                   for f in dataclasses.fields(TCfg) if f.name != "dtype"})
    jm = JModel(jcfg)
    params, bstats = jax_variables(jm, jnp.zeros((1, 64, 64, 3)), seed=9)
    save_checkpoint(cpdir, 4, state_dict_from_jax(params, bstats), tcfg)
    variables = jvars(params, bstats)

    @jax.jit
    def jax_fn(image):
        # JAX prep_fundus._build_model_fn's forward
        logits = jm.apply(variables, ((image - 0.5) / 0.25)[None])
        return jax.nn.sigmoid(logits[0])
    return cpdir, jax_fn


def test_center_from_model_matches_jax(checkpoint):
    import torch
    from segtran_tpu.cli import prep_fundus as jp
    from segtran_tpu_torch.cli import prep_fundus as tp
    cpdir, jax_fn = checkpoint
    args = tp.build_argparser().parse_args(
        ["--images", "x", "--out", "y", "--cpdir", cpdir, "--iter", "4"]
        + ARGV)
    model_fn = tp.build_model_fn(args, torch.device("cpu"))
    for seed in (4, 5):
        img, _ = _frame(seed)
        got = tp.center_from_model(model_fn, img, 128, torch.device("cpu"))
        want = jp.center_from_model(lambda im: np.asarray(jax_fn(im)), img,
                                    128)
        assert max(abs(got[0] - want[0]), abs(got[1] - want[1])) <= 1, \
            (got, want)


def _tree(root, n=2):
    from PIL import Image
    os.makedirs(os.path.join(root, "images"))
    os.makedirs(os.path.join(root, "masks"))
    for i in range(n):
        img, raw = _frame(10 + i)
        Image.fromarray(img).save(os.path.join(root, "images", f"f{i}.png"))
        Image.fromarray(raw).save(os.path.join(root, "masks", f"f{i}.bmp"))


@pytest.mark.parametrize("mode", ["mask", "center", "model"])
def test_main_matches_jax(tmp_path, checkpoint, mode):
    """main in each mode writes JAX's file names; the mask and center
    crops equal JAX's (center: images within 1, the resize's rounding),
    model mode's crop positions within 1 pixel."""
    from PIL import Image
    from segtran_tpu.cli import prep_fundus as jp
    from segtran_tpu_torch.cli import prep_fundus as tp
    _tree(str(tmp_path / "raw"))
    base = ["--images", str(tmp_path / "raw" / "images"), "--roi", "64",
            "--mode", mode] + ARGV
    if mode != "model":
        base += ["--masks", str(tmp_path / "raw" / "masks")]
    got = tp.main(base + ["--out", str(tmp_path / "port"), "--cpdir",
                          checkpoint[0], "--iter", "4", "--device", "cpu"])
    if mode == "model":
        monkey = pytest.MonkeyPatch()
        monkey.setattr(jp, "_build_model_fn", lambda args: (
            lambda im: np.asarray(checkpoint[1](im))))
        try:
            want = jp.main(base + ["--out", str(tmp_path / "jax"),
                                   "--cpdir", checkpoint[0], "--iter", "4"])
        finally:
            monkey.undo()
        for g, w in zip(got, want):
            gx, gy = (int(v) for v in g[:-4].split("_")[-1].split(","))
            wx, wy = (int(v) for v in w[:-4].split("_")[-1].split(","))
            assert abs(gx - wx) <= 1 and abs(gy - wy) <= 1, (g, w)
        return
    want = jp.main(base + ["--out", str(tmp_path / "jax")])
    assert got == want and len(got) == 2
    for sub in ("images", "masks"):
        for name in got:
            a = np.asarray(Image.open(tmp_path / "port" / sub / name), int)
            b = np.asarray(Image.open(tmp_path / "jax" / sub / name), int)
            assert a.shape == b.shape
            assert np.abs(a - b).max() <= (1 if (mode, sub) == (
                "center", "images") else 0)
