"""Shared pieces of the tests that hold the port's DA train step against
JAX ``make_full_step`` (tests/test_torch_train2d_da.py): one raw batch
with a source batch, the JAX state of a DA-wrapped run with its aux
modules, two jitted JAX steps with the draws each made, and the
comparison of loss, gradients, parameters and running statistics."""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from _torch_data2d import jax_draws, raw_mask
from _torch_parity import jax_variables, to_numpy
from _torch_train3d import (BACKBONE_GRAD_TOL, GRAD_TOL, LOSS_RTOL,
                            UPDATE_TOL, _fro_rel, _max_rel)

STATS_TOL = dict(rtol=1e-4, atol=2e-5)
# a gradient whose largest entry lies below this share of the run's
# largest is zero by structure (tests/test_torch_train2d.py)
NOISE = 1e-6


def raw_batch(h, w, bs=2, src_bs=2, seed=5):
    rng = np.random.RandomState(seed)
    return {"image": rng.rand(bs, h, w, 3).astype(np.float32),
            "mask": np.stack([raw_mask(h, w, s)
                              for s in range(1, bs + 1)])[..., None],
            "source_image": rng.rand(src_bs, h, w, 3).astype(np.float32)}


def jax_recon_head():
    """JAX train2d's ReconHead (cli/train2d.py:552-556, local to main)."""
    import flax.linen as fnn

    class ReconHead(fnn.Module):
        @fnn.compact
        def __call__(self, x):
            return fnn.Conv(3, (1, 1), name="conv")(x)
    return ReconHead()


def jax_run(argv, task, patch, steps=2, seed=3):
    """JAX train2d's DA run of ``argv``: the wrapped variables as JAX main
    builds them (seeded, norms perturbed), its optimizer with a leading
    transform that keeps the raw gradients, ``steps`` jitted
    make_full_step calls on one raw batch. Returns the initial variables,
    each step's draws (target, source, --negcontrast offsets) and loss,
    step 1's gradients (after the global clip where the run has one), the
    parameters after the last step and the running statistics after
    step 1."""
    import optax
    import segtran_tpu.nn.backbones.efficientnet as jeff
    from functools import partial
    from segtran_tpu.adapt.polyformer import polyformer_param_labels
    from segtran_tpu.cli import train2d as jt2
    from segtran_tpu.configs.presets import NET_SETTINGS
    from segtran_tpu.models.discriminator import Discriminator
    from segtran_tpu.train.bertadam import bert_adam
    from segtran_tpu.train.contrast import load_reference_features
    from segtran_tpu.train.trainer import build_optimizer, create_train_state
    import pytest
    mp = pytest.MonkeyPatch()
    mp.setattr(jeff, "_drop_connect", lambda x, rate, det, rng: x)
    try:
        a = jt2.build_argparser().parse_args(argv)
        jm, cfg = jt2.build_model_and_config(a, task)
        params, bstats = jax_variables(jm, jnp.zeros((1,) + patch + (3,)),
                                       seed=seed)
        net_set = NET_SETTINGS.get(a.net, NET_SETTINGS["unet-like"])
        lr = a.lr if a.lr > 0 else net_set["lr"]
        clip = a.grad_clip if a.grad_clip > 0 else net_set["grad_clip"]
        warmup = min(a.lr_warmup_steps, a.maxiter // 2) / a.maxiter
        disc = recon = None
        vcdr = {}
        wrapped_p, wrapped_b = {"net": params}, {"net": bstats}
        feat_ch = (task["num_classes"] if a.adversarial_mode == "mask"
                   else 64 if a.net == "unet-scratch" else cfg.trans_out_dim)
        if a.adversarial_mode:
            disc = Discriminator(num_classes=1, do_revgrad=not a.adda)
            p, b = jax_variables(disc, jnp.zeros((1, 64, 64, feat_ch)),
                                 seed=seed + 7)
            wrapped_p["discriminator"], wrapped_b["discriminator"] = p, b
        if a.recon_w > 0:
            recon = jax_recon_head()
            wrapped_p["recon"] = to_numpy(recon.init(
                jax.random.PRNGKey(seed + 8),
                jnp.zeros((1, 8, 8, feat_ch)))["params"])
        if a.vcdr_estim_scheme != "none":
            names = (("vc_estim", "vd_estim") if a.vcdr_estim_scheme == "sep"
                     else ("vcdr_estim",))
            for i, nm in enumerate(names):
                vcdr[nm] = Discriminator(num_classes=1, do_avgpool=True,
                                         do_revgrad=False)
                p, b = jax_variables(vcdr[nm], jnp.zeros((1, 64, 64, 3)),
                                     seed=seed + 9 + i)
                wrapped_p[nm], wrapped_b[nm] = p, b
        has_aux = len(wrapped_p) > 1
        if not has_aux:
            wrapped_p, wrapped_b = params, bstats
        keep = optax.GradientTransformation(
            lambda p: jax.tree_util.tree_map(jnp.zeros_like, p),
            lambda u, st, p=None: (u, u))
        if a.tune_bn_only:
            tx, clip = optax.set_to_zero(), 0
        elif a.polyformer_mode:
            opt_mode = (a.poly_source_opt if a.polyformer_mode == "source"
                        else a.poly_target_opt)
            tx = optax.multi_transform(
                {"normal": bert_adam(lr, warmup, a.maxiter, weight_decay=0.0),
                 "frozen": optax.set_to_zero()},
                partial(polyformer_param_labels, opt_mode=opt_mode,
                        batch_stats=bstats, bn_opt_scheme=a.bn_opt_scheme))
            clip = 0
        else:
            tx = build_optimizer(lr=lr, decay=1e-4, t_total=a.maxiter,
                                 warmup_ratio=warmup, grad_clip=clip)
        tx = optax.chain(keep, tx)
        bank = None
        if a.ref_feat_cp_path:
            bk, valid = load_reference_features(
                a.ref_feat_cp_path, a.num_ref_features, task["num_classes"],
                None, seed=a.seed)
            bw = np.asarray(task["bce_weight"], np.float32)
            bw = bw * (task["num_classes"] - 1) / bw.sum()
            bank = (jnp.asarray(bk), jnp.asarray(valid), jnp.asarray(bw))
        mean, std = jt2.load_stats(a, (a.ds_names or "train").split(",")[0])
        from segtran_tpu.data.augment import Aug2dConfig
        aug_cfg = Aug2dConfig(randscale=a.randscale, gray_alpha=a.gray_alpha,
                              mean=mean, std=std)
        src_stats = jt2.load_stats(a, a.source_ds_name) if disc else None
        state = create_train_state(
            jax.tree_util.tree_map(jnp.asarray, wrapped_p),
            jax.tree_util.tree_map(jnp.asarray, wrapped_b), tx,
            jax.random.PRNGKey(1))
        step = jax.jit(jt2.make_full_step(
            jm, tx, task, a, aug_cfg, patch, disc_model=disc,
            recon_model=recon, vcdr_models=vcdr or None,
            contrast_bank=bank, src_stats=src_stats))
        batch = raw_batch(*task["orig_input_size"])
        if disc is None:
            batch.pop("source_image")
        out = dict(params=wrapped_p, bstats=wrapped_b, batch=batch,
                   losses=[], draws=[], metrics=[], clip=clip, lr=lr,
                   aug_cfg=aug_cfg)
        k = task["num_classes"]
        for s in range(steps):
            key = jax.random.fold_in(state.rng, s + 77)
            draws = {"draws": jax_draws(key, 2, aug_cfg)}
            if disc is not None:
                draws["src_draws"] = jax_draws(jax.random.fold_in(key, 3),
                                               2, aug_cfg)
            if a.do_neg_contrast:
                draws["neg_offsets"] = torch.from_numpy(np.asarray(
                    jax.random.randint(jax.random.fold_in(key, 5), (k,),
                                       1, k)).astype(np.int64))
            out["draws"].append(draws)
            state, metrics = step(state, {kk: jnp.asarray(v)
                                          for kk, v in batch.items()})
            out["losses"].append(float(metrics["loss"]))
            out["metrics"].append({kk: float(v) for kk, v in metrics.items()
                                   if not kk.startswith("_preview")})
            if s == 0:
                grads = state.opt_state[0]
                if clip and clip > 0:
                    grads, _ = optax.clip_by_global_norm(clip).update(
                        grads, None)
                out["grads"] = to_numpy(grads)
                out["stats1"] = to_numpy(state.batch_stats)
        out["after"] = to_numpy(state.params)
    finally:
        mp.undo()
    return out


def port_run(argv, j):
    """The port's run of ``argv`` on JAX's converted variables: the model
    and aux modules, the optimizer and global clip train() builds, and the
    step make_step builds."""
    from segtran_tpu_torch.cli import train2d
    from segtran_tpu_torch.convert import state_dict_from_jax
    args = train2d.build_argparser().parse_args(argv + ["--device", "cpu"])
    task = train2d.task_settings(args)
    model, cfg = train2d.build_model_and_config(args, task)
    aux = train2d.build_aux_modules(args, task, cfg)
    wrapped = (torch.nn.ModuleDict({"net": model, **aux}) if len(aux)
               else model)
    wrapped.load_state_dict(state_dict_from_jax(j["params"], j["bstats"]),
                            strict=True)
    for blk in getattr(getattr(model, "backbone", None), "_blocks", ()):
        blk.drop_rate = 0.0
    opt, clip = train2d.build_train_optimizer(wrapped, model, args)
    assert clip == j["clip"] or (clip <= 0 and j["clip"] <= 0)
    bank = (train2d.load_contrast_bank(args, task, torch.device("cpu"))
            if args.ref_feat_cp_path else None)
    step = train2d.make_step(model, opt, args, task, torch.device("cpu"),
                             aux=aux, grad_clip=clip, contrast_bank=bank)
    return wrapped, step


def bn_chain(name):
    """The tensors whose fp32 train-mode gradients are ill-conditioned:
    the U-Net's convs and BatchNorms, and the discriminator and vCDR
    estimators' (5 stride-2 convs with BatchNorm over as few as 32
    values per channel). Rounding grows along their BatchNorm chains: the
    port's own U-Net gradients move by up to ~1e-2 of their largest entry
    against its fp64 ones, and as much under a 1e-7 relative change of
    its input; a gradient reversed through the discriminator into the
    U-Net's last block, or through the 'sep' estimators' ratio, moves as
    much. The whole steps hold these by relative Frobenius error
    (BACKBONE_GRAD_TOL, as tests/_torch_train3d.py holds the I3D
    backbone's; measured <= 0.015); tests/test_torch_unet_polyformer.py
    and tests/test_torch_revgrad_discriminator.py hold the modules'
    gradients to 1e-6 in fp64."""
    name = name[4:] if name.startswith("net.") else name
    return name.split(".")[0] in (
        "inc", "down1", "down2", "down3", "down4", "up1", "up2", "up3",
        "up4", "discriminator", "vcdr_estim", "vc_estim", "vd_estim")


def check_run(argv, j, steps=2, loose=bn_chain):
    """The port's steps against JAX's: each step's loss to LOSS_RTOL and
    its other metrics; step 1's gradients (each trained tensor to GRAD_TOL
    of its largest entry, those ``loose`` names (``bn_chain``) by
    relative Frobenius error BACKBONE_GRAD_TOL, structural zeros to NOISE;
    frozen tensors take none); the running statistics after step 1 to
    STATS_TOL; the
    parameters after the last step (moved ones by UPDATE_TOL, unmoved
    ones bit for bit, those with noise gradients by less than 0.1 lr).
Returns the port's wrapped model."""
    from segtran_tpu_torch.convert import state_dict_from_jax
    wrapped, step = port_run(argv, j)
    batch = {k: torch.from_numpy(v) for k, v in j["batch"].items()}
    named = dict(wrapped.named_parameters())
    jgrads = {k: v.numpy() for k, v in state_dict_from_jax(j["grads"]).items()}
    gmax = max(np.abs(g).max() for g in jgrads.values())
    noise = {k for k, g in jgrads.items() if np.abs(g).max() < NOISE * gmax}
    for s in range(steps):
        metrics = step(batch, **j["draws"][s])
        np.testing.assert_allclose(float(metrics["loss"]), j["losses"][s],
                                   rtol=LOSS_RTOL)
        for k, want in j["metrics"][s].items():
            np.testing.assert_allclose(float(metrics[k]), want, rtol=1e-4,
                                       atol=1e-6, err_msg=k)
        assert set(metrics) == set(j["metrics"][s]), (
            set(metrics) ^ set(j["metrics"][s]))
        if s == 0:
            for name, want in jgrads.items():
                p = named[name]
                if not p.requires_grad:
                    continue
                got = p.grad.numpy()
                if name in noise:
                    assert np.abs(got).max() < NOISE * gmax, name
                elif loose(name):
                    assert _fro_rel(got, want) < BACKBONE_GRAD_TOL, name
                else:
                    assert _max_rel(got, want) < GRAD_TOL, name
            sd = wrapped.state_dict()
            for name, want in state_dict_from_jax({}, j["stats1"]).items():
                np.testing.assert_allclose(sd[name].numpy(), want.numpy(),
                                           err_msg=name, **STATS_TOL)
    sd = wrapped.state_dict()
    p0 = state_dict_from_jax(j["params"], j["bstats"])
    for name, want in state_dict_from_jax(j["after"]).items():
        got, want, d0 = sd[name].numpy(), want.numpy(), p0[name].numpy()
        if np.array_equal(want, d0):
            np.testing.assert_array_equal(got, d0, err_msg=name)
        elif name in noise:
            # BertAdam normalises the noise: it moves by a share of lr
            # (JAX's own moves measured <= 0.043 lr; an update ~lr)
            assert np.abs(got - d0).max() < 0.1 * j["lr"], name
        else:
            assert _fro_rel(got - d0, want - d0) < UPDATE_TOL, name
    return wrapped
