"""Shared pieces of the tests that hold the port's 3-D train step
against the JAX package (tests/test_torch_train3d*.py): a tiny Segtran3d
(8 attractors, a 48x48x16 volume, fp32, ``--fused --dropout 0``) on the
same converted weights, JAX train3d's augmentation draws, loss and
optimizer, and the comparison of two whole steps."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import jax_variables, to_numpy

SHAPE = (48, 48, 16)
ARGV = ["--attractors", "8", "--patchsize", "48,48,16", "--inputsize",
        "48,48,16", "--fused", "--dropout", "0", "--maxiter", "4",
        "--lrwarmup", "2", "--seed", "0", "--device", "cpu"]
# Tolerances. fp32 on both sides; XLA:CPU and PyTorch sum in other
# orders. The loss and the BatchNorm statistics agree closely. The
# gradients of the I3D backbone do not: in training its BatchNorms
# normalise over as few as 18 values per channel (Mixed_5b/5c at this
# volume), some with batch variances near 1e-5 << eps, which amplifies
# rounding layer by layer (a 1e-7 relative change of the input moves the
# port's own deepest tap by ~1e-3 relative), so they are held to a
# relative Frobenius error; the rest of the model to 2e-3 of each
# tensor's largest entry. The step-2 update lr * m / (sqrt(v) + eps)
# normalises every entry, so entries with noise-sized gradients can
# differ by the whole step: updates are held by relative Frobenius error.
# Measured: backbone gradients 0.029 median, 0.057 max (the port against
# itself under a 1e-7 relative input perturbation: 0.005 median, 0.020
# max); the rest <= 1.1e-3; updates 0.045 median, 0.15 max.
LOSS_RTOL = 1e-5
GRAD_TOL = 2e-3          # max |diff| / max |jax grad|, outside the backbone
BACKBONE_GRAD_TOL = 0.15  # relative Frobenius error, the I3D backbone
UPDATE_TOL = 0.3         # relative Frobenius error of p(step 2) - p(0)
STATS_TOL = dict(rtol=1e-4, atol=2e-5)


def _jax_loss_fn():
    """JAX train3d's loss (cli/train3d.py:315-328) for the BraTS task."""
    from segtran_tpu.ops.losses import (dice_loss_indiv,
                                        weighted_bce_with_logits)
    bce = jnp.asarray((0.0, 3.0, 1.0, 1.75), jnp.float32)
    bce = (bce * 3 / jnp.sum(bce)).reshape((1, 1, 1, 1, 4))
    cw = jnp.ones(4).at[0].set(0.0)
    cw = cw / cw.sum()

    def loss_fn(logits, mask):
        probs = jax.nn.sigmoid(logits)
        ce = weighted_bce_with_logits(logits, mask, bce)
        dice = 0.0
        for c in range(1, 4):
            dice = dice + dice_loss_indiv(probs[..., c], mask[..., c]) * cw[c]
        loss = 0.5 * ce + 0.5 * dice
        return loss, {"loss": loss, "ce_loss": ce, "dice_loss": dice}
    return loss_fn


def _jax_augment(state_rng, step, image, label):
    """JAX train3d's per-step augmentation (cli/train3d.py:361-379) and
    the draws it made, in the port's form."""
    from segtran_tpu.data.augment import (random_resized_crop_3d,
                                          random_rot_flip_3d)
    from segtran_tpu.data.labelmaps3d import brats_map_label
    rng = jax.random.fold_in(state_rng, step + 31)
    k1, k2, _ = jax.random.split(rng, 3)
    keys = jax.random.split(k1, image.shape[0])
    img, lab = jax.vmap(random_rot_flip_3d)(keys, image, label)
    img, mask = random_resized_crop_3d(k2, img, brats_map_label(lab), 0.1)
    ks, fhs, fws = [], [], []
    for key in keys:
        a, b, c = jax.random.split(key, 3)
        ks.append(int(jax.random.randint(a, (), 0, 4)))
        fhs.append(bool(jax.random.uniform(b, ()) < 0.5))
        fws.append(bool(jax.random.uniform(c, ()) < 0.5))
    zoom = float(jax.random.uniform(k2, (), minval=0.9, maxval=1.1))
    return {"image": img, "mask": mask}, {"rot_flip": (ks, fhs, fws),
                                          "zoom": zoom}


def make_jax_side():
    """The tiny JAX Segtran3d, its perturbed variables, a batch of two
    volumes, JAX train3d's optimizer and loss, and one jitted function
    for a microbatch's (loss, gradients, new BatchNorm statistics)."""
    from segtran_tpu.configs.base import Segtran3dConfig as JCfg
    from segtran_tpu.models.segtran3d import Segtran3d as JModel
    from segtran_tpu.train.trainer import build_optimizer
    jcfg = JCfg(num_classes=4, num_attractors=8, orig_in_channels=4,
                hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0,
                use_fused_attention=True).derive(
                    translayer_compress_ratios=(1.0, 1.0))
    jm = JModel(jcfg)
    params, bstats = jax_variables(jm, jnp.zeros((1,) + SHAPE + (4,)),
                                   seed=5)
    rng = np.random.RandomState(6)
    image = rng.rand(2, *SHAPE, 4).astype(np.float32)
    label = rng.randint(0, 4, (2,) + SHAPE).astype(np.uint8)
    loss_fn = _jax_loss_fn()
    # train3d's optimizer: warmup min(2, 4 // 2) / 4
    tx = build_optimizer(lr=2e-4, decay=1e-4, t_total=4, warmup_ratio=0.5,
                         grad_clip=0.1)

    @jax.jit
    def loss_grads(p, batch_stats, image, mask):
        def loss(p):
            logits, new = jm.apply({"params": p, "batch_stats": batch_stats},
                                   image, train=True, mutable=["batch_stats"])
            return loss_fn(logits, mask)[0], new["batch_stats"]
        (value, new), g = jax.value_and_grad(loss, has_aux=True)(p)
        return value, g, new
    return dict(jm=jm, params=params, bstats=bstats, image=image,
                label=label, loss_fn=loss_fn, tx=tx, loss_grads=loss_grads)


def _port_model(argv, params, bstats):
    from segtran_tpu_torch.cli import train3d
    from segtran_tpu_torch.convert import state_dict_from_jax
    args = train3d.build_argparser().parse_args(argv)
    task = train3d.train_task_settings(args)
    model, cfg = train3d.build_model_and_config(args, task)
    model.load_state_dict(state_dict_from_jax(params, bstats), strict=True)
    return model, args, task


def _max_rel(got, want):
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _fro_rel(got, want):
    return float(np.linalg.norm(got - want)
                 / max(np.linalg.norm(want), 1e-30))


def _in_backbone(name):
    return name.startswith(("backbone.", "in_bridge_to3."))


def check_two_train_steps(case, jax_side, monkeypatch):
    """Steps 1 and 2 of the port's make_step against JAX: the loss of each
    step, the BatchNorm statistics and the parameters after step 2, and
    (batch 1) every clipped gradient of step 1. JAX runs
    make_train_step for batch 1 (a fresh trace: the flash case patches the
    threshold); for --gradaccum 2 on batch 2, make_train_step's
    accumulation (microbatch gradients summed / 2, BatchNorm statistics
    threaded) over the jitted microbatch gradient that its scan runs
    (tracing the scan itself takes minutes on the CPU)."""
    import optax
    from segtran_tpu.kernels import squeezed_attention as jsa
    from segtran_tpu.train.trainer import create_train_state, make_train_step
    from segtran_tpu_torch.cli import train3d
    from segtran_tpu_torch.convert import state_dict_from_jax
    from segtran_tpu_torch.kernels import squeezed_attention as tsa
    from segtran_tpu_torch.train.trainer import build_optimizer as t_opt

    j = jax_side
    ga = 2 if case == "gradaccum2" else 1
    image, label = j["image"][:ga], j["label"][:ga]
    argv = ARGV + ["--bs", str(ga)] + (["--gradaccum", "2"] if ga == 2
                                        else [])
    if case == "flash_bwd":
        # a test-time patch of both packages' threshold, read when the step
        # is traced / run: the 72-token volume takes the flash backward
        monkeypatch.setattr(jsa, "FLASH_BWD_MIN_N", 0)
        monkeypatch.setattr(tsa, "FLASH_BWD_MIN_N", 0)
    tsa.reset_launches()
    tx, loss_fn = j["tx"], j["loss_fn"]
    if ga == 1:
        # a pass-through stage first keeps each step's raw gradients in
        # the optimizer state, so JAX's own step gives them
        keep = optax.GradientTransformation(
            lambda p: jax.tree_util.tree_map(jnp.zeros_like, p),
            lambda u, st, p=None: (u, u))
        tx = optax.chain(keep, tx)
    state = create_train_state(
        jax.tree_util.tree_map(jnp.asarray, j["params"]),
        jax.tree_util.tree_map(jnp.asarray, j["bstats"]), tx,
        jax.random.PRNGKey(1))
    if ga == 1:
        base_step = jax.jit(make_train_step(j["jm"], tx, loss_fn))
    else:
        update = jax.jit(tx.update)

        def base_step(state, batch):
            gsum, bst, losses = None, state.batch_stats, []
            for i in range(ga):
                value, g, bst = j["loss_grads"](
                    state.params, bst, batch["image"][i:i + 1],
                    batch["mask"][i:i + 1])
                losses.append(value)
                gsum = g if gsum is None else jax.tree_util.tree_map(
                    jnp.add, gsum, g)
            grads = jax.tree_util.tree_map(lambda x: x / ga, gsum)
            upd, opt = update(grads, state.opt_state, state.params)
            return state.replace(
                step=state.step + 1, batch_stats=bst, opt_state=opt,
                params=optax.apply_updates(state.params, upd)), {
                    "loss": jnp.mean(jnp.stack(losses))}

    model, args, task = _port_model(argv, j["params"], j["bstats"])
    optimizer = t_opt(model, lr=2e-4, decay=1e-4, t_total=4,
                      warmup_ratio=0.5)
    step = train3d.make_step(model, optimizer, args, task,
                             torch.device("cpu"))
    named = dict(model.named_parameters())
    before = {k: v.clone() for k, v in model.state_dict().items()}
    batch = {"image": torch.from_numpy(image),
             "label": torch.from_numpy(label)}

    for s in range(2):
        aug, draws = _jax_augment(state.rng, s, jnp.asarray(image),
                                  jnp.asarray(label))
        ported = step.augment(batch, draws)
        np.testing.assert_allclose(ported["image"].numpy(),
                                   np.asarray(aug["image"]), atol=1e-6)
        np.testing.assert_array_equal(ported["mask"].numpy(),
                                      np.asarray(aug["mask"]))
        state, jmetrics = base_step(state, aug)
        if s == 0 and ga == 1:
            jgrads, _ = optax.clip_by_global_norm(0.1).update(
                state.opt_state[0], None)
        metrics = step(batch, draws)
        np.testing.assert_allclose(float(metrics["loss"]),
                                   float(jmetrics["loss"]), rtol=LOSS_RTOL)
        if s == 0 and ga == 1:
            # the clipped gradients the optimizer saw, every parameter
            for name, g in state_dict_from_jax(to_numpy(jgrads)).items():
                got, want = named[name].grad.numpy(), g.numpy()
                if name.endswith("feat_softaggr.feat2score.bias"):
                    # zero by symmetry (the mode softmax ignores a shared
                    # shift): rounding noise in both packages
                    assert np.abs(got).max() < 1e-8, name
                elif _in_backbone(name):
                    assert _fro_rel(got, want) < BACKBONE_GRAD_TOL, name
                else:
                    assert _max_rel(got, want) < GRAD_TOL, name

    sd = model.state_dict()
    p0 = state_dict_from_jax(j["params"], j["bstats"])
    for name, want in state_dict_from_jax(
            to_numpy(state.params), to_numpy(state.batch_stats)).items():
        got, want = sd[name].numpy(), want.numpy()
        if name.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(got, want, **STATS_TOL, err_msg=name)
        else:
            d0 = p0[name].numpy()
            if not name.endswith("feat_softaggr.feat2score.bias"):
                assert _fro_rel(got - d0, want - d0) < UPDATE_TOL, name
    # the training forward ran the flash wrappers' backward paths
    assert tsa.cross_attention_bwd_recompute.launches == (
        0 if case == "flash_bwd" else 2 * 2 * ga)
