"""The analysis flags of the port's CLIs on the CPU, against the JAX
package where it computes the same numbers:

* test2d ``main`` over a REFUGE-layout PNG tree (four frames at 64^2,
  32^2 patches, eff-tiny, two translayers) from a checkpoint of converted
  JAX weights: ``--flop`` logs the parameters and GFLOPs per image;
  ``--vis rf --vislayers 0`` writes rf_maps.npz and rf_in_fpn.png;
  ``--robust --robustaug brightness,noise`` and ``--robustcp`` give the
  robustness table; ``--savefeat 2 --removefrag`` writes
  pixel_features.npz of two frames;
* ``--removefrag`` (with ``--savefeat``) and ``--testinterp 32``: Dice
  (and the feature dump) against JAX's ``evaluate_checkpoint`` on the
  same frames and weights, within 1e-4;
* test3d ``--flop`` and train2d ``--profile`` (one step) log what JAX
  logs;
* no tools refusal is left in the CLIs; the multi-GPU ones still raise.
"""
import logging
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_data2d import write_tree
from _torch_parity import one_torch_thread  # noqa: F401
from _torch_volume import fast_variables

ARGV = ["--task", "fundus", "--ds", "train", "--split", "all", "--bb",
        "eff-tiny", "--translayers", "2", "--attractors", "8", "--origsize",
        "64", "--patchsize", "32", "--bs", "3"]


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """(JAX model, task, params, batch_stats, port argv): one checkpoint
    iter_5.pt of the converted weights and the PNG tree."""
    from segtran_tpu.cli import test2d as jt
    from segtran_tpu.configs.presets import TASK_SETTINGS
    from segtran_tpu_torch.cli import test2d, train2d
    from segtran_tpu_torch.convert import state_dict_from_jax
    from segtran_tpu_torch.train.checkpoint import save_checkpoint
    root = tmp_path_factory.mktemp("tools_cli")
    jargs = jt.build_argparser().parse_args(ARGV + ["--cpdir", "unused"])
    task = dict(TASK_SETTINGS["fundus"], orig_input_size=(64, 64),
                patch_size=(32, 32))
    jm, _ = jt.build_model(jargs, task)
    params, bstats = fast_variables(jm, jnp.zeros((1, 32, 32, 3)), seed=7)
    args = test2d.build_argparser().parse_args(
        ARGV + ["--cpdir", "unused", "--device", "cpu"])
    model, cfg = test2d.build_model(args, train2d.task_settings(args))
    model.load_state_dict(state_dict_from_jax(params, bstats), strict=True)
    cpdir = str(root / "ck")
    save_checkpoint(cpdir, 5, model.state_dict(), cfg)
    write_tree(str(root / "data" / "fundus" / "train"))
    argv = ARGV + ["--cpdir", cpdir, "--dataroot", str(root / "data"),
                   "--device", "cpu", "--iters", "5"]
    return jm, task, params, bstats, argv, root


def _log(setup):
    return open(os.path.join(setup[4][setup[4].index("--cpdir") + 1],
                             "eval_log.txt")).read()


def test_flop_logs_params_and_gflops(setup):
    from segtran_tpu_torch.cli import test2d
    res = test2d.main(setup[4] + ["--flop"])
    assert np.isfinite(res[5]).all()
    line = [ln for ln in _log(setup).splitlines() if "params:" in ln][-1]
    assert "GFLOPs/img" in line and "GB accessed" in line
    assert float(line.split("forward: ")[1].split()[0]) > 0


def test_vis_rf_writes_the_maps(setup, tmp_path):
    from PIL import Image
    from segtran_tpu_torch.cli import test2d
    out = str(tmp_path / "rf")
    res = test2d.main(setup[4] + ["--vis", "rf", "--vislayers", "0",
                                  "--outdir", out])
    assert list(res[5]) == ["in_fpn"] and res[5]["in_fpn"].shape == (32, 32)
    npz = np.load(os.path.join(out, "rf_maps.npz"))
    np.testing.assert_array_equal(npz["in_fpn"], res[5]["in_fpn"])
    png = np.array(Image.open(os.path.join(out, "rf_in_fpn.png")))
    assert png.shape == (32, 32) and png.max() == 255
    assert "mass within center quarter" in _log(setup)


@pytest.mark.parametrize("extra", [
    ["--robustaug", "brightness,noise"],
    ["--robustcp", None, "--robustaug", "contrast", "--robustsamples", "2"]],
    ids=["robustaug", "robustcp"])
def test_robust_gives_the_table(setup, extra):
    from segtran_tpu_torch.cli import test2d
    cpdir = setup[4][setup[4].index("--cpdir") + 1]
    extra = [os.path.join(cpdir, "iter_5") if e is None else e
             for e in extra]
    res = test2d.main(setup[4] + ["--robust"] + extra)[5]
    want = [t for t in extra[extra.index("--robustaug") + 1].split(",")]
    assert list(res) == want
    for vals in res.values():
        assert list(vals)[0] == "in_fpn_feat"
        assert "voxel_fusion/layer_1_vfeat" in vals
        assert list(vals)[-1] == "output_pearson"
        assert all(np.isfinite(v) for v in vals.values())
    if "--robustcp" in extra:
        # the same checkpoint: the clean features are the model's own
        assert -1 <= res["contrast"]["output_pearson"] <= 1


def _jax_eval(setup, flags, outdir):
    from segtran_tpu.cli import test2d as jt
    from segtran_tpu.cli.train2d import load_stats as jload_stats
    from segtran_tpu.data.datasets2d import SegCrop as JSegCrop
    from _torch_parity import jvars
    jm, task, params, bstats, _, root = setup
    jargs = jt.build_argparser().parse_args(
        ARGV + ["--cpdir", "unused", "--outdir", outdir] + flags)
    mean, std = jload_stats(jargs, "train")
    ds = JSegCrop(str(root / "data" / "fundus" / "train"), split="all",
                  out_size=(64, 64), uncropped_size=(2056, 2124))
    return jt.evaluate_checkpoint(jm, jvars(params, bstats), ds, task, jargs,
                                  logging.getLogger("jax-tools"), mean, std)


@pytest.mark.parametrize("flags", [
    ["--savefeat", "2", "--removefrag"], ["--testinterp", "32"]],
    ids=["savefeat_removefrag", "testinterp"])
def test_dice_matches_jax(setup, tmp_path, flags):
    from segtran_tpu_torch.cli import test2d
    want = _jax_eval(setup, flags, str(tmp_path / "jax"))
    got = test2d.main(setup[4] + flags + ["--outdir",
                                          str(tmp_path / "port")])[5]
    assert got.shape == want.shape == (2,)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    if "--savefeat" in flags:
        j = np.load(tmp_path / "jax" / "pixel_features.npz")
        t = np.load(tmp_path / "port" / "pixel_features.npz")
        assert t["features"].shape == j["features"].shape == (2 * 16, 448)
        np.testing.assert_array_equal(t["labels"], j["labels"])
        np.testing.assert_allclose(t["features"].astype(np.float32),
                                   j["features"].astype(np.float32),
                                   rtol=2e-3, atol=2e-3)   # float16 dumps
    if "--testinterp" in flags:
        # the null model scores from the ground truth alone
        assert (got > 0.8).all()


def test_removefrag_keeps_single_component_frames():
    """A prediction of one foreground component comes back unchanged."""
    from segtran_tpu_torch.cli import test2d
    hard = torch.zeros(2, 20, 20, 3)
    hard[..., 0] = 1
    hard[0, 5:12, 5:12, 1], hard[0, 5:12, 5:12, 0] = 1, 0
    hard[1, 2:4, 2:4, 1], hard[1, 2:4, 2:4, 0] = 1, 0
    hard[1, 10:16, 10:16, 2], hard[1, 10:16, 10:16, 0] = 1, 0
    hard[1, 18, 18, 1], hard[1, 18, 18, 0] = 1, 0
    out = test2d._remove_fragments(hard)
    assert torch.equal(out[0], hard[0])
    assert out[1, 18, 18, 1] == 0 and out[1, 18, 18, 0] == 1
    assert torch.equal(out[1, :17], hard[1, :17])


def test_test3d_flop(tmp_path, monkeypatch):
    from segtran_tpu_torch.cli import test3d
    monkeypatch.setattr(test3d, "make_dataset", lambda *a, **k: [])
    test3d.main(["--attractors", "8", "--cpdir", str(tmp_path), "--device",
                 "cpu", "--patchsize", "32,32,16", "--inputsize", "32,32,16",
                 "--flop"])
    log = open(tmp_path / "eval3d_log.txt").read()
    line = [ln for ln in log.splitlines() if "params:" in ln][0]
    assert "GFLOPs/patch" in line
    assert float(line.split("forward: ")[1].split()[0]) > 0


def test_train2d_profile_one_step(tmp_path):
    from segtran_tpu_torch.cli import train2d
    write_tree(str(tmp_path / "data" / "fundus" / "train"))
    ckpt = train2d.main([
        "--device", "cpu", "--task", "fundus", "--split", "all", "--bb",
        "eff-tiny", "--translayers", "1", "--attractors", "8", "--maxiter",
        "1", "--saveiter", "1", "--bs", "2", "--origsize", "64",
        "--patchsize", "32", "--dataroot", str(tmp_path / "data"),
        "--ckptdir", str(tmp_path / "model"), "--profile"])
    log = open(os.path.join(ckpt, "train2d_log.txt")).read()
    for what in ("params: ", "forward FLOPs: ", "forward FPS (bs=1): "):
        assert what in log, what
    assert os.path.isfile(os.path.join(ckpt, "iter_1.pt"))


def test_no_tools_refusal_is_left():
    import inspect
    from segtran_tpu_torch.cli import (serve, test2d, test3d, train2d,
                                       train3d)
    for mod in (serve, test2d, test3d, train2d, train3d):
        src = inspect.getsource(mod)
        assert "_TOOLS" not in src and "item 6c" not in src, mod.__name__
    # nor a multi-GPU one (ROADMAP item 6b is ported)
    for mod in (serve, test2d, test3d, train2d, train3d):
        src = inspect.getsource(mod)
        assert "_PARALLEL" not in src and "_MULTI_GPU" not in src
        assert "item 6b" not in src, mod.__name__
    train2d._refuse_later_slices(train2d.build_argparser().parse_args(
        ["--tp", "2"]))
    test3d._refuse_later_slices(test3d.build_argparser().parse_args(
        ["--cpdir", "x", "--spatialshard"]))
