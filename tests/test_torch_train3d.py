"""The port's 3-D training held against the JAX package on the CPU.

* two whole train steps of ``cli/train3d.make_step`` against JAX
  ``make_train_step`` with JAX train3d's augmentation draws, loss and
  BertAdam groups, on the recompute backward: the loss, every gradient,
  the BatchNorm running statistics and the parameters after step 2
  (``tests/_torch_train3d.py``; the flash-backward and ``--gradaccum 2``
  cases are in test_torch_train3d_flash.py / _accum.py);
* train-mode BatchNorm against flax's, BertAdam fed JAX's gradients, the
  losses, the init passes, the 3-D augmentation transforms given JAX's
  draws, the epoch order, the training flash gate.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import to_numpy
from _torch_train3d import ARGV, SHAPE, check_two_train_steps, make_jax_side
from _torch_parity import one_torch_thread  # noqa: F401


@pytest.fixture(scope="module")
def jax_side():
    return make_jax_side()


def test_two_train_steps_match_jax(jax_side, monkeypatch):
    check_two_train_steps("recompute_bwd", jax_side, monkeypatch)


def test_batch_norm_train_matches_flax():
    """ops/norm.batch_norm_train == flax nn.BatchNorm(momentum 0.99, eps
    1e-3) in training: output, gradients, and the running statistics
    (the biased batch variance), in fp32 and with a bf16 input."""
    import flax.linen as fnn
    from torch import nn
    from segtran_tpu_torch.ops.norm import batch_norm_train
    rng = np.random.RandomState(7)
    x = (rng.randn(3, 5, 4, 6, 6) * 2 + 1).astype(np.float32)   # NCDHW
    w = rng.rand(5).astype(np.float32) + 0.5
    b = rng.randn(5).astype(np.float32)
    rm, rv = rng.randn(5).astype(np.float32), rng.rand(5).astype(np.float32)
    gy = rng.randn(*x.shape).astype(np.float32)
    for jdt, tdt, tol in ((jnp.float32, torch.float32, 1e-5),
                          (jnp.bfloat16, torch.bfloat16, 1e-2)):
        bn = fnn.BatchNorm(use_running_average=False, momentum=0.99,
                           epsilon=1e-3, dtype=jdt)
        xj = jnp.asarray(x.transpose(0, 2, 3, 4, 1), jdt)          # NDHWC

        def f(xx, scale, bias):
            y, upd = bn.apply({"params": {"scale": scale, "bias": bias},
                               "batch_stats": {"mean": rm, "var": rv}}, xx,
                              mutable=["batch_stats"])
            return jnp.sum(y.astype(jnp.float32)
                           * gy.transpose(0, 2, 3, 4, 1)), (y, upd)
        (_, (yj, upd)), gj = jax.value_and_grad(f, argnums=(0, 1, 2),
                                                has_aux=True)(xj, w, b)
        mod = nn.Module()
        mod.weight = nn.Parameter(torch.from_numpy(w))
        mod.bias = nn.Parameter(torch.from_numpy(b))
        mod.register_buffer("running_mean", torch.from_numpy(rm.copy()))
        mod.register_buffer("running_var", torch.from_numpy(rv.copy()))
        mod.eps = 1e-3
        xt = torch.from_numpy(x).to(tdt).requires_grad_()
        yt = batch_norm_train(xt, mod, 0.99, tdt)
        assert yt.dtype == tdt
        (yt.float() * torch.from_numpy(gy)).sum().backward()
        np.testing.assert_allclose(
            yt.float().detach().numpy(),
            np.asarray(yj, np.float32).transpose(0, 4, 1, 2, 3),
            rtol=tol, atol=tol)
        for got, want in ((xt.grad.float().numpy(),
                           np.asarray(gj[0], np.float32).transpose(
                               0, 4, 1, 2, 3)),
                          (mod.weight.grad.numpy(), np.asarray(gj[1])),
                          (mod.bias.grad.numpy(), np.asarray(gj[2]))):
            np.testing.assert_allclose(got, want, rtol=tol, atol=tol)
        stats = upd["batch_stats"]
        np.testing.assert_allclose(mod.running_mean.numpy(),
                                   np.asarray(stats["mean"]), rtol=1e-6,
                                   atol=1e-6)
        np.testing.assert_allclose(mod.running_var.numpy(),
                                   np.asarray(stats["var"]), rtol=1e-6,
                                   atol=1e-6)


def test_train_forward_takes_the_trainable_flash_branch(monkeypatch):
    """With --fused --dropout 0 the training forward goes through
    fused_cross_attention_trainable, twice per translayer; with dropout
    it does not (JAX's gate)."""
    from segtran_tpu_torch.cli import train3d
    from segtran_tpu_torch.nn import attention
    from segtran_tpu_torch.nn.init import init_with_reference_schemes
    calls = []
    real = attention.fused_cross_attention_trainable
    monkeypatch.setattr(attention, "fused_cross_attention_trainable",
                        lambda *a: calls.append(1) or real(*a))
    x = torch.rand((1,) + SHAPE + (4,))
    for dropout, want in (("0", 2), ("0.1", 0)):
        calls.clear()
        args = train3d.build_argparser().parse_args(
            ARGV + ["--dropout", dropout])
        model, cfg = train3d.build_model_and_config(
            args, train3d.train_task_settings(args))
        init_with_reference_schemes(model, cfg, seed=0).train()
        model(x).sum().backward()
        assert len(calls) == want


def test_bertadam_matches_jax_over_three_steps():
    """The port's BertAdam groups + global clip fed JAX's gradients: the
    parameters after each of 3 steps equal optax's (the first update has
    lr 0; per-parameter and global clipping both engage)."""
    from torch import nn
    from segtran_tpu.train.trainer import build_optimizer
    from segtran_tpu_torch.train.trainer import (build_optimizer as t_opt,
                                                 clip_by_global_norm_)

    class M(nn.Module):
        def __init__(self, p):
            super().__init__()
            self.backbone = nn.Module()
            self.backbone.w = nn.Parameter(torch.from_numpy(p["backbone"]["w"]))
            self.head = nn.Module()
            self.head.w = nn.Parameter(torch.from_numpy(p["head"]["w"]))
            self.alphas = nn.Parameter(torch.from_numpy(p["alphas"]))

    rng = np.random.RandomState(0)
    params = {"backbone": {"w": rng.randn(5, 3).astype(np.float32)},
              "head": {"w": rng.randn(4).astype(np.float32)},
              "alphas": rng.randn(2).astype(np.float32)}
    tx = build_optimizer(lr=1e-2, decay=0.1, t_total=6, warmup_ratio=0.5,
                         grad_clip=0.1)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    opt_state = tx.init(jp)
    model = M(params)
    opt = t_opt(model, lr=1e-2, decay=0.1, t_total=6, warmup_ratio=0.5)
    for s in range(3):
        grads = jax.tree_util.tree_map(
            lambda p: rng.randn(*p.shape).astype(np.float32) * (0.01, 1.0,
                                                                0.05)[s],
            params)
        upd, opt_state = tx.update(jax.tree_util.tree_map(jnp.asarray, grads),
                                   opt_state, jp)
        jp = jax.tree_util.tree_map(lambda p, u: p + u, jp, upd)
        for (name, p), g in zip(
                [("backbone.w", model.backbone.w), ("head.w", model.head.w),
                 ("alphas", model.alphas)],
                [grads["backbone"]["w"], grads["head"]["w"],
                 grads["alphas"]]):
            p.grad = torch.from_numpy(g.copy())
        clip_by_global_norm_(model.parameters(), 0.1)
        opt.step()
        for got, want in ((model.backbone.w, jp["backbone"]["w"]),
                          (model.head.w, jp["head"]["w"]),
                          (model.alphas, jp["alphas"])):
            np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                       rtol=1e-6, atol=1e-7)
        if s == 0:  # lr 0 at the first step: nothing moved
            np.testing.assert_array_equal(model.alphas.detach().numpy(),
                                          params["alphas"])


def test_losses_match_jax():
    from segtran_tpu.ops import losses as jl
    from segtran_tpu_torch.ops import losses as tl
    rng = np.random.RandomState(1)
    logits = rng.randn(2, 6, 5, 4, 4).astype(np.float32) * 3
    mask = (rng.rand(2, 6, 5, 4, 4) > 0.6).astype(np.float32)
    pw = np.asarray([0.0, 1.5, 0.5, 1.0], np.float32).reshape(1, 1, 1, 1, 4)
    probs = 1 / (1 + np.exp(-logits))
    t = torch.from_numpy
    np.testing.assert_allclose(
        float(tl.dice_loss_indiv(t(probs[..., 1]), t(mask[..., 1]))),
        float(jl.dice_loss_indiv(probs[..., 1], mask[..., 1])), rtol=1e-6)
    for w in (None, pw):
        np.testing.assert_allclose(
            float(tl.weighted_bce_with_logits(
                t(logits), t(mask), None if w is None else t(w))),
            float(jl.weighted_bce_with_logits(logits, mask, w)), rtol=1e-6)


def test_init_passes_match_jax():
    """The identity biases on their own, and the whole post-init pass on a
    tiny Segtran3d: JAX's raw init converted, then the port's passes by
    module, equals JAX's params after its passes."""
    from segtran_tpu.configs.base import Segtran3dConfig as JCfg
    from segtran_tpu.models.segtran3d import Segtran3d as JModel
    from segtran_tpu.nn import init as jinit
    from segtran_tpu_torch.cli import train3d
    from segtran_tpu_torch.convert import state_dict_from_jax
    from segtran_tpu_torch.nn import init as tinit

    k = np.random.RandomState(2).randn(24, 16).astype(np.float32)
    np.testing.assert_allclose(
        tinit._idbias_qk(torch.from_numpy(k.T.copy()), 4, 10.0, 0.02).numpy(),
        np.asarray(jinit._idbias_qk(jnp.asarray(k), 4, 10.0, 0.02)).T,
        rtol=1e-6)
    np.testing.assert_allclose(
        tinit._idbias_v(torch.from_numpy(k.T.copy()), 8, 10.0, 0.02).numpy(),
        np.asarray(jinit._idbias_v(jnp.asarray(k), 8, 10.0, 0.02)).T,
        rtol=1e-6)

    jcfg = JCfg(num_classes=4, num_attractors=8, orig_in_channels=4,
                tie_qk_scheme="loose").derive(
                    translayer_compress_ratios=(1.0, 1.0))
    variables = jax.jit(JModel(jcfg).init)(jax.random.PRNGKey(0),
                                           jnp.zeros((1, 32, 32, 16, 4)))
    raw = to_numpy(variables["params"])
    after = to_numpy(jinit.apply_reference_init_schemes(
        variables["params"], variables["site_meta"]))
    args = train3d.build_argparser().parse_args(ARGV)
    model, cfg = train3d.build_model_and_config(
        args, train3d.train_task_settings(args))
    model, cfg = type(model)(dataclasses.replace(
        cfg, tie_qk_scheme="loose")), None
    model.load_state_dict(state_dict_from_jax(raw, to_numpy(
        variables["batch_stats"])), strict=True)
    tinit.apply_reference_init_schemes(model, 0.02, 10.0, 10.0)
    sd = model.state_dict()
    changed = 0
    for name, want in state_dict_from_jax(after).items():
        np.testing.assert_allclose(sd[name].numpy(), want.numpy(), rtol=1e-6,
                                   atol=1e-7, err_msg=name)
        changed += not np.array_equal(want.numpy(), state_dict_from_jax(
            raw)[name].numpy())
    # K of both cross-attentions (a copy of Q, then biased) and V of both
    # expansions moved
    assert changed == 4


def test_augment_transforms_match_jax_given_its_draws():
    from segtran_tpu.data import augment as ja
    from segtran_tpu_torch.data import augment as ta
    rng = np.random.RandomState(3)
    # square in H, W: JAX's rot90 switch needs every branch's shape equal
    image = rng.rand(12, 12, 6, 4).astype(np.float32)
    label = rng.randint(0, 4, (12, 12, 6)).astype(np.uint8)
    for seed in range(6):
        key = jax.random.PRNGKey(seed)
        want_i, want_l = ja.random_rot_flip_3d(key, jnp.asarray(image),
                                               jnp.asarray(label))
        a, b, c = jax.random.split(key, 3)
        got_i, got_l = ta.rot_flip_3d(
            torch.from_numpy(image), torch.from_numpy(label),
            int(jax.random.randint(a, (), 0, 4)),
            bool(jax.random.uniform(b, ()) < 0.5),
            bool(jax.random.uniform(c, ()) < 0.5))
        np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
        np.testing.assert_array_equal(got_l.numpy(), np.asarray(want_l))
    images = rng.rand(2, 12, 10, 6, 4).astype(np.float32)
    masks = (rng.rand(2, 12, 10, 6, 4) > 0.5).astype(np.float32)
    for seed in range(4):
        key = jax.random.PRNGKey(10 + seed)
        want_i, want_m = ja.random_resized_crop_3d(key, jnp.asarray(images),
                                                   jnp.asarray(masks), 0.2)
        f = float(jax.random.uniform(key, (), minval=0.8, maxval=1.2))
        got_i, got_m = ta.resized_crop_3d(torch.from_numpy(images),
                                          torch.from_numpy(masks), f)
        np.testing.assert_allclose(got_i.numpy(), np.asarray(want_i),
                                   atol=1e-6)
        np.testing.assert_array_equal(got_m.numpy(), np.asarray(want_m))
    noise = ta.noise_draw((1000,), sigma=0.1, clip=0.2,
                          generator=torch.Generator().manual_seed(0))
    assert float(noise.abs().max()) <= 0.2 + 1e-6
    assert 0.05 < float(noise.std()) < 0.15


def test_epoch_order_and_crops():
    """epoch_indices equals JAX's; a sample's crop depends only on (seed,
    epoch, index)."""
    from segtran_tpu.data.pipeline import epoch_indices as jidx
    from segtran_tpu_torch.data.datasets3d import pad_to_size, random_crop
    from segtran_tpu_torch.data.pipeline import epoch_indices as tidx
    for n, epoch, seed in ((10, 0, 0), (37, 3, 1337), (5, 1, 7)):
        np.testing.assert_array_equal(tidx(n, epoch, seed),
                                      jidx(n, epoch, seed))
    image = np.arange(10 * 8 * 4 * 2, dtype=np.float32).reshape(10, 8, 4, 2)
    crops = [random_crop(image, None, (6, 6, 6),
                         np.random.default_rng((1, 2, 3)))[0]
             for _ in range(2)]
    np.testing.assert_array_equal(crops[0], crops[1])
    assert crops[0].shape == (6, 6, 6, 2)
    padded, _ = pad_to_size(image, None, (12, 8, 6))
    assert padded.shape == (12, 8, 6, 2) and padded[0].sum() == 0
