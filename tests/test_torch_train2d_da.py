"""The port's DA train step held against JAX's make_full_step on the CPU
(tests/_torch_da.py), and the traps of the DA slice:

* --net segtran --adv mask --attnconsist on a non-square 32x64 frame
  (a 4x8 token grid; eff-tiny, 1 translayer, 8 attractors): two steps,
  loss, metrics, gradients, running statistics and parameters;
* --tunebn: no parameter moves, the running statistics do, as JAX's;
* the source pass leaves the net's running statistics as the target
  pass left them;
* JAX behaviour (c): with --remat the DA feature is the input FPN's
  output; without it the last translayer's tokens on the real grid;
* a DA run's checkpoint: train2d.main writes the net beside its
  discriminator; test2d.main evaluates the net's part (JAX's tolerant
  merge evaluates a fresh net from it); an unknown layout raises;
* --gradaccum with the DA losses, and --tunebn without --cp, raise."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_data2d import write_tree
from _torch_parity import jvars
from _torch_parity import one_torch_thread  # noqa: F401

SEG_ARGV = ["--task", "fundus", "--bb", "eff-tiny", "--translayers", "1",
            "--attractors", "8", "--adv", "mask", "--attnconsist",
            "--origsize", "32,64", "--patchsize", "32,64", "--bs", "2",
            "--dropout", "0", "--norematblocks", "--maxiter", "4",
            "--lrwarmup", "2", "--seed", "0"]
UNET = ["--task", "fundus", "--net", "unet-scratch", "--attractors", "8",
        "--origsize", "64", "--patchsize", "64", "--bs", "2", "--maxiter",
        "4", "--lrwarmup", "2", "--seed", "0"]


def _task(size):
    from segtran_tpu.configs.presets import TASK_SETTINGS
    return dict(TASK_SETTINGS["fundus"], orig_input_size=size,
                patch_size=size)


def test_segtran_adv_mask_attnconsist_step_matches_jax():
    from _torch_da import check_run, jax_run
    j = jax_run(SEG_ARGV, _task((32, 64)), (32, 64))
    assert {"attn_consist_loss", "domain_loss"} <= set(j["metrics"][0])
    check_run(SEG_ARGV, j)


def test_tunebn_step_matches_jax():
    """--tunebn: every parameter bit-identical after two steps, the
    running statistics moved as JAX moves them."""
    from _torch_da import check_run, jax_run
    argv = UNET + ["--polyformer", "source", "--tunebn"]
    j = jax_run(argv, _task((64, 64)), (64, 64))
    wrapped = check_run(argv, j)
    assert all(not p.requires_grad for p in wrapped.parameters())
    moved = [k for k, v in wrapped.state_dict().items()
             if k.endswith("running_mean")
             and not np.array_equal(v.numpy(), np.asarray(
                 _leaf(j["bstats"], k)))]
    assert moved


def _leaf(bstats, name):
    """The JAX batch_stats leaf of a port buffer name."""
    from segtran_tpu_torch.convert import state_dict_from_jax
    return state_dict_from_jax({}, bstats)[name]


def test_source_pass_keeps_the_target_statistics():
    """After a DA step the net's running statistics are those of a lone
    train-mode forward of the step's target batch."""
    import copy
    from segtran_tpu_torch.cli import train2d
    from segtran_tpu_torch.data.augment import draw_2d
    from _torch_da import raw_batch
    args = train2d.build_argparser().parse_args(
        UNET + ["--adv", "feat", "--device", "cpu"])
    task = train2d.task_settings(args)
    model, cfg = train2d.build_model_and_config(args, task)
    train2d.init_with_reference_schemes(model, cfg, seed=0)
    aux = train2d.build_aux_modules(args, task, cfg)
    wrapped = torch.nn.ModuleDict({"net": model, **aux})
    opt, clip = train2d.build_train_optimizer(wrapped, model, args)
    lone = copy.deepcopy(model)
    step = train2d.make_step(model, opt, args, task, torch.device("cpu"),
                             aux=aux, grad_clip=clip)
    batch = {k: torch.from_numpy(v) for k, v in raw_batch(64, 64).items()}
    mean, std = train2d.load_stats(args, "train")
    cfg_aug = train2d.aug_config(args, mean, std)
    gen = torch.Generator().manual_seed(1)
    draws, src = draw_2d(2, cfg_aug, gen), draw_2d(2, cfg_aug, gen)
    step(batch, draws=draws, src_draws=src)
    with torch.no_grad():
        lone.train()(step.augment(batch, draws)["image"])
    got, want = model.state_dict(), lone.state_dict()
    names = [k for k in want if "running" in k]
    assert names
    for k in names:
        torch.testing.assert_close(got[k], want[k], rtol=0, atol=0)


@pytest.mark.parametrize("remat", [False, True])
def test_da_feature_matches_jax(remat):
    """JAX behaviour (c): JAX sows the layer outputs only without --remat,
    so its _da_feature falls back to in_fpn_feat; the port's
    _da_feature takes the same tensor, on the real 8x16 grid."""
    from segtran_tpu.cli.train2d import _da_feature as jfeat
    from segtran_tpu_torch.cli.train2d import _da_feature
    from _torch_options import _pair
    jm, params, bstats, tm = _pair(remat=remat, size=(64, 128))
    x = np.random.RandomState(3).randn(2, 64, 128, 3).astype(np.float32)
    apply = jax.jit(lambda v, xx: jm.apply(v, xx, train=False,
                                           mutable=["intermediates"])[1])
    want = np.asarray(jfeat(apply(jvars(params, bstats), jnp.asarray(x))))
    tm.eval().keep_features = True
    with torch.no_grad():
        tm(torch.from_numpy(x))
    got = _da_feature(tm).numpy()
    assert got.shape == want.shape == (
        (2, 8, 16, tm.cfg.trans_in_dim) if remat
        else (2, 8, 16, tm.cfg.trans_out_dim))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_da_checkpoint_gives_its_net(tmp_path):
    """train2d.main with --adv writes the net beside its discriminator
    (sidecar 'modules'); test2d.main evaluates the net's part, not fresh
    weights; a state_dict with net. keys beside unknown ones raises,
    naming them. JAX's merge_params keeps every fresh leaf of a net tree
    given a DA tree (the reference-side fault the port does not copy)."""
    import json
    from segtran_tpu.train.checkpoint import merge_params
    from segtran_tpu_torch.cli import test2d, train2d
    from segtran_tpu_torch.train.checkpoint import (load_checkpoint,
                                                    net_state_dict)
    data = tmp_path / "data" / "fundus"
    write_tree(str(data / "train"))
    write_tree(str(data / "rim"))
    ckpt = train2d.main(["--device", "cpu", "--split", "all", "--adv",
                         "feat", "--sourceds", "rim", "--maxiter", "1",
                         "--saveiter", "1", "--logiter", "1",
                         "--dataroot", str(tmp_path / "data"),
                         "--ckptdir", str(tmp_path / "model")]
                        + UNET[:4] + ["--origsize", "64", "--patchsize",
                                      "64", "--bs", "2", "--attractors",
                                      "8"])
    sd = load_checkpoint(os.path.join(ckpt, "iter_1"))
    assert {k.split(".")[0] for k in sd} == {"net", "discriminator"}
    with open(os.path.join(ckpt, "iter_1.config.json")) as f:
        side = json.load(f)
    assert side["modules"] == ["discriminator", "net"]
    assert side["config"] is None
    log = open(os.path.join(ckpt, "train2d_log.txt")).read()
    assert "source-domain samples" in log
    res = test2d.main(["--device", "cpu", "--task", "fundus", "--ds",
                       "train", "--split", "all", "--net", "unet-scratch",
                       "--cpdir", ckpt, "--iters", "1", "--origsize", "64",
                       "--patchsize", "64", "--dataroot",
                       str(tmp_path / "data")])
    args = test2d.build_argparser().parse_args(
        ["--net", "unet-scratch", "--cpdir", ckpt, "--device", "cpu"])
    model, _ = test2d.build_model(args, train2d.task_settings(args))
    net = net_state_dict(sd)
    model.load_state_dict(net, strict=True)
    assert set(net) == set(model.state_dict())
    fresh = test2d.build_model(args, train2d.task_settings(args))[0]
    train2d.init_with_reference_schemes(fresh, None, seed=0)
    x = torch.rand(1, 64, 64, 3)
    with torch.no_grad():
        assert not torch.equal(model.eval()(x), fresh.eval()(x))
    assert np.isfinite(res[1]).all()
    with pytest.raises(ValueError, match="layout.*extra"):
        net_state_dict(dict(sd, **{"extra.weight": torch.zeros(1)}))
    jtree = {"inc": {"w": np.zeros(2)}}
    merged = merge_params(jtree, {"net": {"inc": {"w": np.ones(2)}},
                                  "discriminator": {}})
    np.testing.assert_array_equal(merged["inc"]["w"], np.zeros(2))


def test_refusals(tmp_path):
    from segtran_tpu_torch.cli import train2d
    with pytest.raises(SystemExit, match="--tunebn requires --cp"):
        train2d.main(["--device", "cpu", "--tunebn", "--ckptdir",
                      str(tmp_path)])
    with pytest.raises(ValueError, match="attnconsist"):
        train2d.main(["--device", "cpu", "--attnconsist", "--gradaccum",
                      "2", "--ckptdir", str(tmp_path)])
    args = train2d.build_argparser().parse_args(
        UNET + ["--adv", "mask", "--gradaccum", "2", "--device", "cpu"])
    task = train2d.task_settings(args)
    model, cfg = train2d.build_model_and_config(args, task)
    aux = train2d.build_aux_modules(args, task, cfg)
    with pytest.raises(ValueError, match="supervised path only"):
        train2d.make_step(model, None, args, task, torch.device("cpu"),
                          aux=aux)
