"""The 3-D zoo nets through the port's train3d and test3d, held against
the JAX package on the CPU with the same seeded weights
(``tests/_torch_volume.fast_variables``):

* two train3d steps of ``--net vnet`` (VNet, group norm) and ``--net
  unet`` (Modified3DUNet) at a 32x32x16 BraTS crop, batch 2, given JAX
  train3d's augmentation draws: the loss of each step, every clipped
  gradient of step 1 and the parameters after step 2 (BertAdam's first
  update has lr 0 under warmup, so step 2 is the first that moves them),
  under ``tests/_torch_train3d.py``'s bounds, the gradients by relative
  Frobenius error as ``tests/_torch_da.py`` holds its norm chains: in
  fp32 they are ill-conditioned (measured at this crop, gradient by
  gradient: the port against JAX up to 3e-2 and 6e-2 of the largest
  entry for VNet and the U-Net, JAX against the port's fp64 as much,
  the port against itself under a 1e-7 relative change of its input
  1.4e-2; relative Frobenius error <= 0.0125). VNet's conv biases that
  feed a GroupNorm of one channel per group are zero by structure: their
  gradients are held to NOISE of the largest, their updates to 0.1 lr.
  The U-Net's whole-channel dropout (p 0.6) is off on both sides: the
  two packages cannot share its masks (tests/test_torch_unet3d.py holds
  the dropout itself);
* ``--net vnet|unet`` build in both CLIs; ``--attnconsist`` is ignored
  for them with a warning, as in JAX.

test3d against JAX's on these nets is in test_torch_test3d_zoo.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import to_numpy
from _torch_parity import one_torch_thread  # noqa: F401
from _torch_da import NOISE
from _torch_train3d import (BACKBONE_GRAD_TOL, LOSS_RTOL, UPDATE_TOL,
                            _fro_rel, _jax_augment, _jax_loss_fn)
from _torch_volume import fast_variables

SHAPE = (32, 32, 16)
ARGV = ["--patchsize", "32,32,16", "--inputsize", "32,32,16", "--maxiter",
        "4", "--lrwarmup", "2", "--seed", "0", "--bs", "2", "--device",
        "cpu"]


def _jax_net(net):
    from segtran_tpu.models.unet3d import Modified3DUNet
    from segtran_tpu.models.vnet import VNet
    if net == "vnet":
        return VNet(n_channels=4, num_classes=4, normalization="groupnorm")
    return Modified3DUNet(in_channels=4, num_classes=4)


def _port_net(net, params, extra=()):
    from segtran_tpu_torch.cli import train3d
    from segtran_tpu_torch.convert import state_dict_from_jax
    args = train3d.build_argparser().parse_args(ARGV + ["--net", net,
                                                        *extra])
    task = train3d.train_task_settings(args)
    model, cfg = train3d.build_model_and_config(args, task)
    assert cfg is None
    model.load_state_dict(state_dict_from_jax(params, None,
                                              model.state_dict()),
                          strict=True)
    return model, args, task


def _structural_zeros(model):
    """The conv biases whose gradient is zero by structure: those that
    feed a GroupNorm with one channel per group (VNet's 16-channel
    blocks at group norm), which removes each channel's mean."""
    from torch import nn
    zeros = set()
    for name, m in model.named_modules():
        if isinstance(m, nn.Sequential):
            for i in range(len(m) - 1):
                nxt = m[i + 1]
                if (isinstance(nxt, nn.GroupNorm)
                        and nxt.num_groups == nxt.num_channels
                        and getattr(m[i], "bias", None) is not None):
                    zeros.add(f"{name}.{i}.bias")
    return zeros


@pytest.mark.parametrize("net", ["vnet", "unet"])
def test_two_train3d_steps_match_jax(net, monkeypatch):
    import flax.linen as fnn
    import optax
    from segtran_tpu.train.trainer import (build_optimizer,
                                           create_train_state,
                                           make_train_step)
    from segtran_tpu_torch.cli import train3d
    from segtran_tpu_torch.convert import state_dict_from_jax
    from segtran_tpu_torch.train.trainer import build_optimizer as t_opt

    # no dropout on either side (JAX: every nn.Dropout deterministic)
    real = fnn.Dropout.__call__
    monkeypatch.setattr(fnn.Dropout, "__call__",
                        lambda self, x, deterministic=None, rng=None:
                        real(self, x, deterministic=True))
    jm = _jax_net(net)
    params, bstats = fast_variables(jm, jnp.zeros((1,) + SHAPE + (4,)),
                                    seed=5)
    assert not bstats
    rng = np.random.RandomState(6)
    image = rng.rand(2, *SHAPE, 4).astype(np.float32)
    label = rng.randint(0, 4, (2,) + SHAPE).astype(np.uint8)
    keep = optax.GradientTransformation(
        lambda p: jax.tree_util.tree_map(jnp.zeros_like, p),
        lambda u, st, p=None: (u, u))
    tx = optax.chain(keep, build_optimizer(lr=2e-4, decay=1e-4, t_total=4,
                                           warmup_ratio=0.5, grad_clip=0.1))
    state = create_train_state(jax.tree_util.tree_map(jnp.asarray, params),
                               {}, tx, jax.random.PRNGKey(1))
    base_step = jax.jit(make_train_step(jm, tx, _jax_loss_fn()))

    model, args, task = _port_net(net, params)
    if net == "unet":
        model.dropout.p = 0.0
    optimizer = t_opt(model, lr=2e-4, decay=1e-4, t_total=4,
                      warmup_ratio=0.5)
    step = train3d.make_step(model, optimizer, args, task,
                             torch.device("cpu"))
    named = dict(model.named_parameters())
    batch = {"image": torch.from_numpy(image),
             "label": torch.from_numpy(label)}
    for s in range(2):
        aug, draws = _jax_augment(state.rng, s, jnp.asarray(image),
                                  jnp.asarray(label))
        state, jmetrics = base_step(state, aug)
        metrics = step(batch, draws)
        np.testing.assert_allclose(float(metrics["loss"]),
                                   float(jmetrics["loss"]), rtol=LOSS_RTOL)
        if s == 0:
            jgrads, _ = optax.clip_by_global_norm(0.1).update(
                state.opt_state[0], None)
            grads = state_dict_from_jax(to_numpy(jgrads), None,
                                        model.state_dict())
            assert set(grads) == set(named)
            gmax = max(float(g.abs().max()) for g in grads.values())
            zeros = _structural_zeros(model)
            assert len(zeros) == (3 if net == "vnet" else 0)
            for name, g in grads.items():
                got, want = named[name].grad.numpy(), g.numpy()
                if name in zeros:
                    assert max(np.abs(got).max(), np.abs(want).max()) \
                        < NOISE * gmax, name
                else:
                    assert _fro_rel(got, want) < BACKBONE_GRAD_TOL, name
    sd = model.state_dict()
    p0 = state_dict_from_jax(params, None, sd)
    moved = 0
    for name, want in state_dict_from_jax(to_numpy(state.params), None,
                                          sd).items():
        got, want, d0 = sd[name].numpy(), want.numpy(), p0[name].numpy()
        if name in zeros:
            # Adam normalises noise: held as tests/_torch_da.py holds it
            assert max(np.abs(got - d0).max(), np.abs(want - d0).max()) \
                < 0.1 * 2e-4, name
        else:
            assert _fro_rel(got - d0, want - d0) < UPDATE_TOL, name
        moved += not np.array_equal(want, d0)
    assert moved == len(sd)


def test_zoo_nets_build_in_both_clis(caplog):
    from segtran_tpu_torch.cli import test3d, train3d
    for net, cls in (("vnet", "VNet"), ("unet", "Modified3DUNet")):
        args = test3d.build_argparser().parse_args(
            ["--net", net, "--cpdir", "unused", "--bf16"])
        model, cfg = test3d.build_model_and_config(
            args, test3d.task_settings(args))
        assert cfg is None and type(model).__name__ == cls
        assert model.dtype == torch.bfloat16
        args = train3d.build_argparser().parse_args(
            ARGV + ["--net", net, "--attnconsist"])
        with caplog.at_level("WARNING"):
            model, cfg = train3d.build_model_and_config(
                args, train3d.train_task_settings(args))
        assert cfg is None and type(model).__name__ == cls
        assert not args.use_attn_consist_loss
        assert "--attnconsist" in caplog.text
    # BraTS has 4 modalities and 4 classes; VNet takes group norm
    assert model.conv3d_c1_1.in_channels == 4
    args = test3d.build_argparser().parse_args(["--net", "vnet", "--cpdir",
                                                "unused"])
    vnet, _ = test3d.build_model_and_config(args, test3d.task_settings(args))
    assert type(vnet.block_one.conv[1]).__name__ == "GroupNorm"
    assert vnet.out_conv.out_channels == 4
