"""The port's test2d CLI held against the JAX package's on the CPU.

* ``evaluate_checkpoint`` on a REFUGE-layout PNG tree (three 80^2 crops
  and a 90x70 frame, resized to 64^2, 32^2 patches, batches of 3 so the
  last is partial) with the same converted weights in both packages:
  per-class Dice and the vCDR error within 1e-3, the hard masks written
  by ``--outdir`` equal on at least 99.9% of pixels (a pixel can differ
  only where a probability sits at the 0.5 threshold, since the two
  forwards sum in other orders);
* ``main``: a missing ``--iters`` fails before the model is built;
  ``--outorigsize`` writes the preset's 2056x2124 frame; ``--nomask``
  predicts without Dice;
* every flag of a later slice raises NotImplementedError, the analysis
  flags pass the refusals; the model options build.
"""
import logging
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_data2d import write_tree
from _torch_parity import jax_variables
from _torch_parity import one_torch_thread  # noqa: F401

ARGV = ["--task", "fundus", "--ds", "train", "--split", "all", "--bb",
        "eff-tiny", "--translayers", "2", "--attractors", "8", "--origsize",
        "64", "--patchsize", "32", "--bs", "3", "--vcdr"]


@pytest.fixture(scope="module")
def weights():
    from segtran_tpu.cli import test2d as jt
    from segtran_tpu.configs.presets import TASK_SETTINGS
    jargs = jt.build_argparser().parse_args(ARGV + ["--cpdir", "unused"])
    task = dict(TASK_SETTINGS["fundus"], orig_input_size=(64, 64),
                patch_size=(32, 32))
    jm, _ = jt.build_model(jargs, task)
    params, bstats = jax_variables(jm, jnp.zeros((1, 32, 32, 3)), seed=7)
    return jm, task, params, bstats


def _pngs(d):
    from PIL import Image
    return {f: np.array(Image.open(os.path.join(d, f)))
            for f in sorted(os.listdir(d)) if f.endswith(".png")}


def test_evaluate_checkpoint_matches_jax(tmp_path, weights):
    from segtran_tpu.cli import test2d as jt
    from segtran_tpu.cli.train2d import load_stats as jload_stats
    from segtran_tpu.data.datasets2d import SegCrop as JSegCrop
    from segtran_tpu_torch.cli import test2d, train2d
    from segtran_tpu_torch.convert import state_dict_from_jax
    from segtran_tpu_torch.data.datasets2d import SegCrop
    jm, task, params, bstats = weights
    root = write_tree(str(tmp_path / "train"))
    log = logging.getLogger("test2d-parity")
    kw = dict(split="all", out_size=(64, 64), uncropped_size=(2056, 2124))
    jargs = jt.build_argparser().parse_args(
        ARGV + ["--cpdir", "unused", "--outdir", str(tmp_path / "jax")])
    mean, std = jload_stats(jargs, "train")
    want = jt.evaluate_checkpoint(
        jm, {"params": params, "batch_stats": bstats}, JSegCrop(root, **kw),
        task, jargs, log, mean, std)
    args = test2d.build_argparser().parse_args(
        ARGV + ["--cpdir", "unused", "--outdir", str(tmp_path / "port"),
                "--device", "cpu"])
    model, _ = test2d.build_model(args, train2d.task_settings(args))
    model.load_state_dict(state_dict_from_jax(params, bstats), strict=True)
    got = test2d.evaluate_checkpoint(model.eval(), SegCrop(root, **kw),
                                     train2d.task_settings(args), args, log,
                                     mean, std, torch.device("cpu"))
    assert got.shape == want.shape == (3,)         # Dice 1, 2, vCDR error
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-3)
    jp, tp = _pngs(tmp_path / "jax"), _pngs(tmp_path / "port")
    assert list(jp) == list(tp) and len(tp) == 4
    same = sum(int((jp[f] == tp[f]).sum()) for f in jp)
    total = sum(v.size for v in jp.values())
    assert same >= 0.999 * total, (same, total)
    assert os.path.isfile(tmp_path / "port" / "pred.zip")
    assert set(np.unique(np.concatenate([v.ravel() for v in tp.values()]))) \
        <= {0, 128, 255}


def _port_checkpoint(tmp_path, weights):
    from segtran_tpu_torch.cli import test2d, train2d
    from segtran_tpu_torch.convert import state_dict_from_jax
    from segtran_tpu_torch.train.checkpoint import save_checkpoint
    _, _, params, bstats = weights
    args = test2d.build_argparser().parse_args(
        ARGV + ["--cpdir", "unused", "--device", "cpu"])
    model, cfg = test2d.build_model(args, train2d.task_settings(args))
    model.load_state_dict(state_dict_from_jax(params, bstats), strict=True)
    cpdir = str(tmp_path / "ck")
    save_checkpoint(cpdir, 5, model.state_dict(), cfg)
    write_tree(str(tmp_path / "data" / "fundus" / "train"))
    return cpdir, ARGV + ["--cpdir", cpdir, "--dataroot",
                          str(tmp_path / "data"), "--device", "cpu"]


def test_missing_iteration_fails_before_the_model(tmp_path, weights,
                                                  monkeypatch):
    from segtran_tpu_torch.cli import test2d
    _, argv = _port_checkpoint(tmp_path, weights)
    monkeypatch.setattr(test2d, "build_model",
                        lambda *a: pytest.fail("model built"))
    with pytest.raises(FileNotFoundError, match="iter_999"):
        test2d.main(argv + ["--iters", "5,999"])


def test_outorigsize_writes_the_uncropped_frame(tmp_path, weights):
    """The prediction resized back to the crop's size and pasted at its
    crop position on the preset's 2056x2124 'train' frame, background
    255."""
    from segtran_tpu_torch.cli import test2d
    _, argv = _port_checkpoint(tmp_path, weights)
    out = str(tmp_path / "orig")
    res = test2d.main(argv + ["--iters", "5", "--outorigsize", "--outdir",
                              out, "--saveprobs"])
    assert list(res) == [5] and np.isfinite(res[5]).all()
    pngs = _pngs(out)
    assert len(pngs) == 4
    for name, im in pngs.items():
        assert im.shape == (2056, 2124), name
        assert im[-1, -1] == 255 and im[0, 0] == 255
    frame = pngs["n0004_90_30,40.png"]
    pasted = frame[30:120, 40:110]
    assert (frame[:30] == 255).all() and (frame[120:] == 255).all()
    assert pasted.shape == (90, 70)
    assert np.load(os.path.join(out, "n0004_90_30,40.png.probs.npy")).shape \
        == (64, 64, 3)


def test_nomask_predicts_without_dice(tmp_path, weights):
    from segtran_tpu_torch.cli import test2d
    _, argv = _port_checkpoint(tmp_path, weights)
    out = str(tmp_path / "pred")
    res = test2d.main(argv + ["--iters", "5", "--nomask", "--outdir", out])
    np.testing.assert_array_equal(res[5], np.zeros(2))
    assert len(_pngs(out)) == 4 and os.path.isfile(os.path.join(out,
                                                                "pred.zip"))


def test_parse_iters_matches_jax():
    from segtran_tpu.cli.test2d import parse_iters as jfn
    from segtran_tpu_torch.cli.test2d import parse_iters
    for spec in ("7000,8000", "40-200,40", "5"):
        assert parse_iters(spec) == jfn(spec)


@pytest.mark.parametrize("flags,item", [
    (["--vis", "rf"], None), (["--robust"], None),
    (["--robustcp", "x"], None), (["--savefeat", "2"], None),
    (["--removefrag"], None), (["--testinterp", "32"], None),
    (["--flop"], None), (["--savefeat", "4"], None),
    (["--testinterp", "0.5"], None), (["--scanblocks"], "Leave out")])
def test_later_slice_flags_raise(tmp_path, flags, item):
    """What a later slice still owns raises NotImplementedError naming it;
    the analysis flags (ROADMAP item 6c) are ported and pass the refusals
    (tests/test_torch_tools_cli.py runs them)."""
    from segtran_tpu_torch.cli import test2d
    argv = ["--device", "cpu", "--cpdir", str(tmp_path)] + flags
    if item is None:
        test2d._refuse_later_slices(test2d.build_argparser().parse_args(argv))
        return
    with pytest.raises(NotImplementedError, match=item):
        test2d.main(argv)


@pytest.mark.parametrize("flags", [
    ["--net", "unet-scratch", "--polyformer", "target"],
    ["--mince", "--nosqueeze", "--mincescales", "2,1", "--minceprops",
     "1,1"]])
def test_item5_flags_build(tmp_path, flags):
    """--net unet-scratch with --polyformer, and --mince, build as JAX's
    build_model builds them, in eval form."""
    from segtran_tpu_torch.cli import test2d, train2d
    from segtran_tpu_torch.nn.mince import CrossMinceAttFeatTrans
    args = test2d.build_argparser().parse_args(
        ["--bb", "eff-tiny", "--translayers", "1", "--attractors", "8",
         "--device", "cpu", "--cpdir", str(tmp_path)] + flags)
    test2d._refuse_later_slices(args)
    model, cfg = test2d.build_model(args, train2d.task_settings(args))
    if cfg is None:
        layer = model.polyformer.polyformer_layers[0].in_ator_trans
        assert layer.spec.tie_qk_scheme == "loose"
    else:
        assert all(isinstance(m, CrossMinceAttFeatTrans)
                   for m in model.voxel_fusion.translayers)
        assert cfg.hidden_dropout_prob == 0.0


@pytest.mark.parametrize("flags,field,value", [
    (["--nosqueeze", "--pos", "bias"], "pos_code_type", "bias"),
    (["--multihead"], "ablate_multihead", True),
    (["--nosqueeze"], "use_squeezed_transformer", False),
    (["--inbn"], "in_fpn_use_bn", True),
    (["--gbias"], "use_global_bias", True),
    (["--task", "oct"], "num_classes", 10)])
def test_ported_option_flags_build(tmp_path, flags, field, value):
    """test2d builds the model options of item 3 through train2d's
    factory, in eval form."""
    from segtran_tpu_torch.cli import test2d, train2d
    args = test2d.build_argparser().parse_args(
        ["--bb", "eff-tiny", "--translayers", "1", "--attractors", "8",
         "--device", "cpu", "--cpdir", str(tmp_path)] + flags)
    test2d._refuse_later_slices(args)
    _, cfg = test2d.build_model(args, train2d.task_settings(args))
    assert getattr(cfg, field) == value
    assert cfg.hidden_dropout_prob == 0.0


def test_needs_a_gpu_unless_cpu_is_asked(tmp_path, monkeypatch):
    from segtran_tpu_torch.cli import test2d
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA GPU"):
        test2d.main(["--cpdir", str(tmp_path)])
