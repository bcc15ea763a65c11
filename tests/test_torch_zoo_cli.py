"""The zoo through the port's train2d / test2d / serve factories, held
against the JAX CLIs' factories on the CPU.

* the optimizer presets of every --net are JAX's;
* every --net of the zoo (and every --bb its factory takes) builds, at the
  CLIs' 288^2 patch, the parameter tree JAX's factory builds: names
  through ``convert.py`` and shapes, from ``jax.eval_shape`` (no weights
  are made on the JAX side); the resnet-hybrid nets fall back to resnet50
  with a message where --bb is not a resnet; TransUNet takes a square
  patch only;
* ``test2d.evaluate_checkpoint`` of an nnU-Net (REFUGE-layout PNG tree,
  64^2 frames, 32^2 patches) against JAX's on the same weights: per-class
  Dice and the vCDR error within 1e-3;
* ``test2d.main`` and ``serve``'s engine run a saved zoo checkpoint.
"""
import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_data2d import write_tree
from _torch_zoo import load_pair, state_dict_shapes_from_jax
from _torch_parity import one_torch_thread  # noqa: F401

# (--net, --bb): each zoo net, the encoders / backbones its factory takes
CASES = [("unet", "eff-b4"), ("unet", "resnet18"), ("unet", "resnet152"),
         ("unet-smp", "resnet34"), ("nestedunet", None), ("unet3plus", None),
         ("attunet", None), ("r2attunet", None), ("dunet", None),
         ("transunet", "resnet50"), ("setr", None),
         ("deeplabv3", "resnet101"), ("deeplabv3plus", "resnet50"),
         ("deeplab-smp", "resnet18"), ("deeplabv3", "resnet34"),
         ("pranet", None), ("nnunet", None)]


@pytest.mark.parametrize("net,bb", CASES)
def test_factory_builds_the_jax_tree(net, bb):
    from segtran_tpu.cli import train2d as jt2
    from segtran_tpu.configs.presets import TASK_SETTINGS
    from segtran_tpu_torch.cli import train2d
    argv = ["--net", net] + (["--bb", bb] if bb else [])
    jm, _ = jt2.build_model_and_config(jt2.build_argparser().parse_args(argv),
                                       dict(TASK_SETTINGS["fundus"]))
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 288, 288, 3)))
    args = train2d.build_argparser().parse_args(argv + ["--device", "cpu"])
    model, cfg = train2d.build_model_and_config(args,
                                                train2d.task_settings(args))
    assert cfg is None
    sd = model.state_dict()
    want = state_dict_shapes_from_jax(shapes["params"],
                                      shapes.get("batch_stats", {}), sd)
    assert want == {k: tuple(t.shape) for k, t in sd.items()}


def test_net_settings_match_jax():
    """The optimizer presets of every --net (lr, decay, clip) as JAX's:
    unet-like nets adamw 1e-3 without a clip, setr / transunet segtran's."""
    from segtran_tpu.configs.presets import NET_SETTINGS as J
    from segtran_tpu_torch.cli import train2d
    from segtran_tpu_torch.configs.presets import NET_SETTINGS
    assert NET_SETTINGS == J
    for net in train2d.NETS + ("deeplabv3",):
        args = train2d.build_argparser().parse_args(["--net", net])
        want = J.get(net, J["unet-like"])
        assert train2d.optimizer_settings(args) == (
            want["lr"], want["decay"], want["grad_clip"]), net


def test_resnet_hybrids_fall_back_to_resnet50(caplog):
    from segtran_tpu_torch.cli import train2d
    args = train2d.build_argparser().parse_args(
        ["--net", "deeplabv3plus", "--bb", "eff-b4", "--device", "cpu"])
    with caplog.at_level(logging.INFO, logger="segtran_tpu_torch.train2d"):
        model, _ = train2d.build_model_and_config(
            args, train2d.task_settings(args))
    assert "ignoring --bb eff-b4 and using resnet50" in caplog.text
    assert model.backbone.layer3[5].conv3.weight.shape[0] == 1024
    args = train2d.build_argparser().parse_args(
        ["--net", "transunet", "--patchsize", "288,320", "--device", "cpu"])
    with pytest.raises(ValueError, match="square --patchsize"):
        train2d.build_model_and_config(args, train2d.task_settings(args))


ARGV = ["--task", "fundus", "--ds", "train", "--split", "all", "--net",
        "nnunet", "--origsize", "64", "--patchsize", "32", "--bs", "3",
        "--vcdr"]


def test_evaluate_checkpoint_matches_jax(tmp_path):
    from segtran_tpu.cli import test2d as jt
    from segtran_tpu.cli.train2d import load_stats as jload_stats
    from segtran_tpu.configs.presets import TASK_SETTINGS
    from segtran_tpu.data.datasets2d import SegCrop as JSegCrop
    from segtran_tpu_torch.cli import test2d, train2d
    from segtran_tpu_torch.data.datasets2d import SegCrop
    root = write_tree(str(tmp_path / "train"))
    log = logging.getLogger("test2d-zoo-parity")
    kw = dict(split="all", out_size=(64, 64), uncropped_size=(2056, 2124))
    jargs = jt.build_argparser().parse_args(ARGV + ["--cpdir", "unused"])
    task = dict(TASK_SETTINGS["fundus"], orig_input_size=(64, 64),
                patch_size=(32, 32))
    jm, _ = jt.build_model(jargs, task)
    args = test2d.build_argparser().parse_args(
        ARGV + ["--cpdir", "unused", "--device", "cpu"])
    model, _ = test2d.build_model(args, train2d.task_settings(args))
    params, bstats = load_pair(jm, model, np.zeros((1, 32, 32, 3),
                                                   np.float32))
    mean, std = jload_stats(jargs, "train")
    want = jt.evaluate_checkpoint(jm, {"params": params}, JSegCrop(root, **kw),
                                  task, jargs, log, mean, std)
    got = test2d.evaluate_checkpoint(model.eval(), SegCrop(root, **kw),
                                     train2d.task_settings(args), args, log,
                                     mean, std, torch.device("cpu"))
    assert got.shape == want.shape == (3,)         # Dice 1, 2, vCDR error
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-3)


def test_test2d_and_serve_run_a_zoo_checkpoint(tmp_path):
    from segtran_tpu_torch.cli import serve, test2d, train2d
    from segtran_tpu_torch.train.checkpoint import save_checkpoint
    argv = ["--task", "fundus", "--net", "unet", "--bb", "resnet18",
            "--origsize", "64", "--patchsize", "32", "--device", "cpu"]
    args = test2d.build_argparser().parse_args(argv + ["--cpdir", "x"])
    model, cfg = test2d.build_model(args, train2d.task_settings(args))
    cpdir = str(tmp_path / "ck")
    save_checkpoint(cpdir, 3, model.state_dict(), cfg)
    write_tree(str(tmp_path / "data" / "fundus" / "train"))
    res = test2d.main(argv + ["--cpdir", cpdir, "--iters", "3", "--ds",
                              "train", "--dataroot", str(tmp_path / "data")])
    assert res[3].shape == (2,) and np.isfinite(res[3]).all()
    sargs = serve.build_argparser().parse_args(
        argv + ["--cpdir", cpdir, "--iter", "3", "--maxbatch", "2"])
    engine = serve.InferenceEngine(sargs, logging.getLogger("serve-zoo"))
    try:
        probs = engine.forward(np.random.RandomState(0).rand(
            2, 64, 64, 3).astype(np.float32))
    finally:
        engine.close()
    assert probs.shape == (2, 64, 64, 3)
    assert ((probs >= 0) & (probs <= 1)).all()
