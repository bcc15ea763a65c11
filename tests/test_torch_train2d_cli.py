"""The port's train2d CLI held against the JAX package's on the CPU.

* Two steps built the CLI's way (``build_argparser`` ->
  ``build_model_and_config`` -> ``make_step``) of a tiny Segtran2d
  (eff-tiny, 2 translayers, 128^2 frames to 64^2 patches, batch 2, fp32,
  dropout and drop-connect 0) against JAX ``make_full_step`` on the same
  converted weights and raw batch, with JAX's augmentation draws: the
  augmented batch to 1e-5, the loss, step 1's clipped gradients and the
  parameters after BertAdam's second update to the constants of the 3-D
  train tests (tests/_torch_train3d.py);
* a two-dataset batch through the [D, C] normalisation tables;
* ``main`` on a PNG tree writes ``iter_2.pt`` and its sidecar, and
  ``--cp`` starts from it;
* without a process group ``--tp`` / ``--ndevices`` above the world size
  of 1 raise JAX's ValueErrors (``--ep`` alone passes, as JAX ignores it
  without ``--tp``), ``--scanblocks`` names ROADMAP's leave-out list; the
  model-option flags and item 5's (DA, Polyformer, mince) build what they
  name.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_data2d import jax_draws, raw_mask, write_tree
from _torch_parity import jax_variables, to_numpy
from _torch_train3d import GRAD_TOL, LOSS_RTOL, UPDATE_TOL, _fro_rel, _max_rel
from _torch_parity import one_torch_thread  # noqa: F401

ARGV = ["--task", "fundus", "--bb", "eff-tiny", "--translayers", "2",
        "--attractors", "8", "--origsize", "128", "--patchsize", "64",
        "--bs", "2", "--dropout", "0", "--maxiter", "4", "--lrwarmup", "2",
        "--norematblocks", "--seed", "0"]
# a gradient whose largest entry lies below this share of the model's
# largest is zero by structure (tests/test_torch_train2d.py)
NOISE = 1e-6


def _raw_batch(seed=5):
    rng = np.random.RandomState(seed)
    image = rng.rand(2, 128, 128, 3).astype(np.float32)
    mask = np.stack([raw_mask(128, 128, s) for s in (1, 2)])[..., None]
    return {"image": image, "mask": mask}


def _jax_preamble(jt2, key, batch, aug_cfg, patch, stats=None):
    """JAX make_full_step's augmentation (cli/train2d.py:510-535): the
    label map, augment_batch_2d with its key (per-sample tables through
    'ds_idx'), the resize to the patch size."""
    from segtran_tpu.data.augment import augment_batch_2d
    from segtran_tpu.data.labelmaps import fundus_map_mask
    from segtran_tpu.ops.resize import resize_linear
    mask = fundus_map_mask(jnp.asarray(batch["mask"]))
    mu = sd = None
    if stats is not None:
        mu = jnp.asarray(stats[0])[batch["ds_idx"]]
        sd = jnp.asarray(stats[1])[batch["ds_idx"]]
    image, mask = augment_batch_2d(key, jnp.asarray(batch["image"]), mask,
                                   aug_cfg, mu, sd)
    return np.asarray(resize_linear(image, patch)), np.asarray(mask)


def _jax_aug_cfg(jt2, jargs):
    from segtran_tpu.data.augment import Aug2dConfig
    mean, std = jt2.load_stats(jargs, "train")
    return Aug2dConfig(randscale=jargs.randscale, gray_alpha=jargs.gray_alpha,
                       mean=mean, std=std)


@pytest.fixture(scope="module")
def jax_steps():
    """JAX's two CLI steps: the draws and augmented batch of each, its
    loss, step 1's clipped gradients, the parameters after step 2.
    Drop-connect is patched out (the model passes its default rate)."""
    import optax
    import segtran_tpu.nn.backbones.efficientnet as jeff
    from segtran_tpu.cli import train2d as jt2
    from segtran_tpu.configs.presets import TASK_SETTINGS
    from segtran_tpu.train.trainer import build_optimizer, create_train_state
    mp = pytest.MonkeyPatch()
    mp.setattr(jeff, "_drop_connect", lambda x, rate, det, rng: x)
    try:
        jargs = jt2.build_argparser().parse_args(ARGV)
        task = dict(TASK_SETTINGS["fundus"], orig_input_size=(128, 128),
                    patch_size=(64, 64))
        jm, _ = jt2.build_model_and_config(jargs, task)
        params, bstats = jax_variables(jm, jnp.zeros((1, 64, 64, 3)), seed=3)
        keep = optax.GradientTransformation(
            lambda p: jax.tree_util.tree_map(jnp.zeros_like, p),
            lambda u, st, p=None: (u, u))
        # train()'s optimizer: the segtran preset, warmup min(2, 4 // 2) / 4
        tx = optax.chain(keep, build_optimizer(
            lr=2e-4, decay=1e-4, t_total=4, warmup_ratio=0.5, grad_clip=0.1))
        state = create_train_state(
            jax.tree_util.tree_map(jnp.asarray, params),
            jax.tree_util.tree_map(jnp.asarray, bstats), tx,
            jax.random.PRNGKey(1))
        aug_cfg = _jax_aug_cfg(jt2, jargs)
        step = jax.jit(jt2.make_full_step(jm, tx, task, jargs, aug_cfg,
                                          (64, 64)))
        batch = _raw_batch()
        out = dict(params=params, bstats=bstats, batch=batch, losses=[],
                   draws=[], augmented=[])
        for s in range(2):
            key = jax.random.fold_in(state.rng, s + 77)
            out["draws"].append(jax_draws(key, 2, aug_cfg))
            out["augmented"].append(_jax_preamble(jt2, key, batch, aug_cfg,
                                                  (64, 64)))
            state, metrics = step(state, {k: jnp.asarray(v)
                                          for k, v in batch.items()})
            out["losses"].append(float(metrics["loss"]))
            if s == 0:
                grads, _ = optax.clip_by_global_norm(0.1).update(
                    state.opt_state[0], None)
                out["grads"] = to_numpy(grads)
        out["after"] = to_numpy(state.params)
    finally:
        mp.undo()
    return out


def _port_step(j, ds_stats=None):
    from segtran_tpu_torch.cli import train2d
    from segtran_tpu_torch.convert import state_dict_from_jax
    from segtran_tpu_torch.train.trainer import build_optimizer
    args = train2d.build_argparser().parse_args(ARGV + ["--device", "cpu"])
    task = train2d.task_settings(args)
    model, cfg = train2d.build_model_and_config(args, task)
    assert not cfg.remat_blocks and cfg.hidden_dropout_prob == 0.0
    model.load_state_dict(state_dict_from_jax(j["params"], j["bstats"]),
                          strict=True)
    for blk in model.backbone._blocks:
        blk.drop_rate = 0.0
    lr, decay, clip = train2d.optimizer_settings(args)
    assert (lr, decay, clip) == (2e-4, 1e-4, 0.1)
    opt = build_optimizer(model, lr=lr, decay=decay, t_total=4,
                          warmup_ratio=0.5)
    step = train2d.make_step(model, opt, args, task, torch.device("cpu"),
                             ds_stats)
    return model, step, args


def test_cli_steps_match_jax(jax_steps):
    """The augmented batch to 1e-5 and masks exactly; the loss of each step
    to LOSS_RTOL; step 1's clipped gradients, each to GRAD_TOL of its
    largest entry (structurally zero ones held to NOISE); the parameters
    after step 2 by UPDATE_TOL."""
    from segtran_tpu_torch.convert import state_dict_from_jax
    j = jax_steps
    model, step, _ = _port_step(j)
    batch = {k: torch.from_numpy(v) for k, v in j["batch"].items()}
    named = dict(model.named_parameters())
    jgrads = {k: v.numpy() for k, v in state_dict_from_jax(j["grads"]).items()}
    gmax = max(np.abs(g).max() for g in jgrads.values())
    noise = {k for k, g in jgrads.items() if np.abs(g).max() < NOISE * gmax}
    assert len(noise) < 20
    for s in range(2):
        aug = step.augment(batch, j["draws"][s])
        want_img, want_mask = j["augmented"][s]
        np.testing.assert_array_equal(aug["mask"].numpy(), want_mask)
        np.testing.assert_allclose(aug["image"].numpy(), want_img, rtol=0,
                                   atol=1e-5)
        metrics = step(batch, j["draws"][s])
        np.testing.assert_allclose(float(metrics["loss"]), j["losses"][s],
                                   rtol=LOSS_RTOL)
        if s == 0:
            for name, want in jgrads.items():
                got = named[name].grad.numpy()
                if name in noise:
                    assert np.abs(got).max() < NOISE * gmax, name
                else:
                    assert _max_rel(got, want) < GRAD_TOL, name
    sd = model.state_dict()
    p0 = state_dict_from_jax(j["params"], j["bstats"])
    for name, want in state_dict_from_jax(j["after"]).items():
        got, want, d0 = sd[name].numpy(), want.numpy(), p0[name].numpy()
        if name in noise:
            assert np.abs(got - d0).max() < 1e-6, name
        else:
            assert _fro_rel(got - d0, want - d0) < UPDATE_TOL, name


def test_two_dataset_batch_takes_per_sample_tables(jax_steps):
    """A batch from two datasets: each sample normalised with its own
    dataset's [C] row of the [D, C] tables, as JAX's step indexes them by
    'ds_idx'."""
    from segtran_tpu.cli import train2d as jt2
    from segtran_tpu_torch.cli import train2d
    j = jax_steps
    _, step, args = _port_step(j, None)
    stats = [train2d.load_stats(args, n) for n in ("train", "test")]
    tables = (np.asarray([s[0] for s in stats], np.float32),
              np.asarray([s[1] for s in stats], np.float32))
    _, step, _ = _port_step(j, tables)
    batch = dict(j["batch"], ds_idx=np.array([1, 0], np.int32))
    jargs = jt2.build_argparser().parse_args(ARGV)
    aug_cfg = _jax_aug_cfg(jt2, jargs)
    key = jax.random.PRNGKey(9)
    want_img, want_mask = _jax_preamble(jt2, key, batch, aug_cfg, (64, 64),
                                        tables)
    got = step.augment({k: torch.from_numpy(v) for k, v in batch.items()},
                       jax_draws(key, 2, aug_cfg))
    np.testing.assert_array_equal(got["mask"].numpy(), want_mask)
    np.testing.assert_allclose(got["image"].numpy(), want_img, rtol=0,
                               atol=1e-5)
    single = step.augment({k: torch.from_numpy(v)
                           for k, v in j["batch"].items()},
                          jax_draws(key, 2, aug_cfg))
    # without 'ds_idx' the first dataset's table normalises every sample
    assert not np.allclose(single["image"].numpy()[0], want_img[0])


def test_main_writes_a_checkpoint_and_resumes(tmp_path):
    """main over a PNG tree on the CPU: 2 iterations write iter_2.pt and
    its sidecar; --cp starts a second run from it."""
    import json
    from segtran_tpu_torch.cli import train2d
    from segtran_tpu_torch.train.checkpoint import load_checkpoint
    write_tree(str(tmp_path / "data" / "fundus" / "train"))
    argv = ["--device", "cpu", "--task", "fundus", "--split", "all", "--bb",
            "eff-tiny", "--translayers", "1", "--attractors", "8",
            "--maxiter", "2", "--saveiter", "2", "--bs", "2", "--origsize",
            "64", "--patchsize", "32", "--dataroot", str(tmp_path / "data"),
            "--ckptdir", str(tmp_path / "model"), "--logiter", "1"]
    ckpt = train2d.main(argv)
    assert os.path.isfile(os.path.join(ckpt, "iter_2.pt"))
    with open(os.path.join(ckpt, "iter_2.config.json")) as f:
        side = json.load(f)
    assert side["iter_num"] == 2
    assert side["config"]["backbone_type"] == "eff-tiny"
    first = load_checkpoint(os.path.join(ckpt, "iter_2"))
    resumed = train2d.main(argv + ["--cp", os.path.join(ckpt, "iter_2.pt"),
                                   "--maxiter", "1", "--saveiter", "1",
                                   "--ckptdir", str(tmp_path / "again")])
    log = open(os.path.join(resumed, "train2d_log.txt")).read()
    assert "loaded checkpoint" in log
    second = load_checkpoint(os.path.join(resumed, "iter_1"))
    # one more step moved the loaded weights, not fresh ones
    name = "out_conv.weight"
    assert not torch.equal(first[name], second[name])
    fresh = train2d.build_model_and_config(
        train2d.build_argparser().parse_args(argv), train2d.task_settings(
            train2d.build_argparser().parse_args(argv)))[0].state_dict()
    assert (second[name] - first[name]).abs().max() < \
        (fresh[name] - first[name]).abs().max()


@pytest.mark.parametrize("flags,check", [
    (["--adv", "feat"], lambda p: p["aux"]["discriminator"].do_revgrad),
    (["--adv", "mask", "--sourceds", "rim", "--sourcebs", "3"],
     lambda p: p["args"].source_ds_name == "rim"
     and p["aux"]["discriminator"].model["1"].in_channels == 3),
    (["--adv", "feat", "--adda"],
     lambda p: not p["aux"]["discriminator"].do_revgrad),
    (["--reconweight", "0.1"],
     lambda p: p["aux"]["recon"].conv.in_channels == 448),
    (["--vcdr", "single"], lambda p: set(p["aux"]) == {"vcdr_estim"}),
    (["--contrastweight", "0.1"], lambda p: p["args"].contrast_loss_w == 0.1),
    (["--reffeatcp", "BANK"], lambda p: p["bank"][0].shape == (3, 30, 448)),
    (["--attnconsist"], lambda p: p["cfg"].use_attn_consist_loss),
    (["--attndiag", "10"], lambda p: p["cfg"].attn_diag),
    (["--net", "unet-scratch", "--polyformer", "source"],
     lambda p: p["model"].polyformer.polyformer_layers[0].in_ator_trans.spec
     .tie_qk_scheme == "shared" and p["opt"] is not None),
    (["--tunebn"], lambda p: p["opt"] is None),
    (["--mince", "--nosqueeze", "--mincescales", "2,1", "--minceprops",
      "1,1"], lambda p: p["cfg"].mince_scales == (2, 1))])
def test_item5_flags_build(tmp_path, flags, check):
    """Each flag of ROADMAP item 5, once refused, builds what train()
    runs: the model and config, the aux modules, the optimizer, the
    contrast bank."""
    from segtran_tpu_torch.cli import train2d
    bank = str(tmp_path / "bank.npz")
    rng = np.random.RandomState(0)
    np.savez(bank, features=rng.randn(90, 448).astype(np.float32),
             labels=np.repeat([0, 1, 2], 30))
    args = train2d.build_argparser().parse_args(
        ["--bb", "eff-tiny", "--translayers", "1", "--attractors", "8",
         "--numreffeat", "30", "--device", "cpu"]
        + [bank if f == "BANK" else f for f in flags])
    task = train2d.task_settings(args)
    model, cfg = train2d.build_model_and_config(args, task)
    aux = train2d.build_aux_modules(args, task, cfg)
    wrapped = torch.nn.ModuleDict({"net": model, **aux}) if len(aux) \
        else model
    opt, _ = train2d.build_train_optimizer(wrapped, model, args)
    parts = dict(args=args, model=model, cfg=cfg, aux=aux, opt=opt,
                 bank=(train2d.load_contrast_bank(args, task,
                                                  torch.device("cpu"))
                       if args.ref_feat_cp_path else None))
    assert check(parts)


@pytest.mark.parametrize("flags,item", [
    (["--tp", "4"], "--tp 4 must divide device count 1"),
    (["--ndevices", "4"], "--ndevices 4 does not equal the world size 1"),
    (["--net", "unet", "--ep"], None), (["--tp", "2"], "--tp 2 must divide"),
    (["--ep"], None), (["--ndevices", "2"], "the world size 1"),
    (["--net", "setr", "--profile"], None), (["--profile"], None),
    (["--scanblocks"], "Leave out")])
def test_later_slice_flags_raise(tmp_path, flags, item):
    """Multi-GPU is ported (tests/test_torch_parallel_*.py): without a
    process group the world size is 1, so --tp and --ndevices above it
    raise JAX's ValueErrors before the model is built; --ep alone passes
    (JAX ignores it without --tp); --profile (ROADMAP item 6c) passes the
    refusals (tests/test_torch_tools_cli.py runs it); --scanblocks is on
    ROADMAP's leave-out list and raises NotImplementedError naming it."""
    from segtran_tpu_torch.cli import train2d
    from segtran_tpu_torch.parallel.mesh import resolve_ndevices
    argv = ["--device", "cpu", "--ckptdir", str(tmp_path)] + flags
    if item is None:
        args = train2d.build_argparser().parse_args(argv)
        train2d._refuse_later_slices(args)
        assert resolve_ndevices(args.ndevices, args.tensor_parallel) == 1
        return
    err = NotImplementedError if item == "Leave out" else ValueError
    with pytest.raises(err, match=item):
        train2d.main(argv)


@pytest.mark.parametrize("flags,field,value", [
    (["--pos", "sinu"], "pos_code_type", "sinu"),
    (["--pos", "rand"], "pos_code_type", "rand"),
    (["--nosqueeze", "--pos", "bias", "--posr", "3"], "pos_bias_radius", 3),
    (["--multihead"], "ablate_multihead", True),
    (["--nosqueeze"], "use_squeezed_transformer", False),
    (["--inbn"], "in_fpn_use_bn", True),
    (["--gbias"], "use_global_bias", True),
    (["--outfpn", "34"], "out_fpn_layers", (3, 4)),
    (["--task", "oct"], "num_classes", 10)])
def test_ported_option_flags_build(flags, field, value):
    """The model options of item 3 build the model they name."""
    from segtran_tpu_torch.cli import train2d
    args = train2d.build_argparser().parse_args(
        ["--bb", "eff-tiny", "--translayers", "1", "--attractors", "8",
         "--device", "cpu"] + flags)
    model, cfg = train2d.build_model_and_config(
        args, train2d.task_settings(args))
    assert getattr(cfg, field) == value
    assert model.cfg is cfg


def test_needs_a_gpu_unless_cpu_is_asked(tmp_path, monkeypatch):
    from segtran_tpu_torch.cli import train2d
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA GPU"):
        train2d.main(["--ckptdir", str(tmp_path)])
    assert train2d.build_argparser().parse_args([]).device is None
