"""The port's VNet held against the JAX package on the CPU, with the same
seeded weights on both sides (tests/_torch_zoo.py), at a non-cubic
32x48x16 volume:

* eval logits for each normalisation (batchnorm, groupnorm at 16 filters,
  instancenorm, none), fp32 to 1e-4 of the largest magnitude; the
  transposed up convs go through ``convert``'s 5-D flip;
* train mode with BatchNorm in fp64: the logits and every running
  statistic, updated once, to 1e-6;
* whole-channel dropout: rate 0.5 per (sample, channel), scaled 2x, the
  same generator seed repeats the mask; inert in eval;
* an input whose depth is a multiple of 8 but not of 16 is refused by
  both packages (the port with a ValueError naming the shape).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_zoo import (assert_close, assert_stats_close, eval_outputs,
                        load_pair, train_outputs)
from _torch_parity import one_torch_thread  # noqa: F401

X = np.random.RandomState(0).randn(2, 32, 48, 16, 2).astype(np.float32)
X64_TOL = 1e-6


@pytest.mark.parametrize("norm", ["batchnorm", "groupnorm", "instancenorm",
                                  "none"])
def test_vnet_eval_logits_match_jax(norm):
    from segtran_tpu.models.vnet import VNet as J
    from segtran_tpu_torch.models.vnet import VNet as T
    jm = J(n_channels=2, num_classes=3, n_filters=16, normalization=norm)
    tm = T(n_channels=2, num_classes=3, n_filters=16, normalization=norm)
    params, bstats = load_pair(jm, tm, X)
    got, ref = eval_outputs(jm, params, bstats, tm, X)
    assert got[0].shape == (2, 32, 48, 16, 3)
    assert_close(got, ref)
    ups = [k for k in tm.state_dict() if k.endswith("_up.conv.0.weight")]
    assert len(ups) == 4
    assert tuple(tm.state_dict()["block_five_up.conv.0.weight"].shape) == (
        256, 128, 2, 2, 2)                                # [I, O, k, k, k]


def test_vnet_train_batchnorm_fp64_matches_jax():
    from segtran_tpu.models.vnet import VNet as J
    from segtran_tpu_torch.models.vnet import VNet as T
    jm = J(n_channels=2, num_classes=3, n_filters=8,
           normalization="batchnorm", dtype=jnp.float64)
    tm = T(n_channels=2, num_classes=3, n_filters=8,
           normalization="batchnorm", dtype=torch.float64)
    params, bstats = load_pair(jm, tm, X)
    got, ref, sd, new = train_outputs(jm, params, bstats, tm, X, x64=True)
    assert_close(got, ref, rel=X64_TOL)
    assert_stats_close(sd, new, rel=X64_TOL)
    # 21 convs in 9 blocks + 8 down/up convs, each with its BatchNorm
    assert len([k for k in sd if k.endswith("running_mean")]) == 29


def test_channel_dropout_whole_channels_and_repeatable():
    from segtran_tpu_torch.models.vnet import VNet
    net = VNet(n_channels=1, num_classes=2, n_filters=4, has_dropout=True)
    drop = net.dropout
    x = torch.ones(64, 32, 3, 4, 2)
    drop.generator = torch.Generator().manual_seed(0)
    drop.train()
    y = drop(x)
    per_channel = y.reshape(64, 32, -1)
    assert torch.equal(per_channel.min(-1).values, per_channel.max(-1).values)
    assert set(per_channel[..., 0].unique().tolist()) == {0.0, 2.0}
    kept = float((per_channel[..., 0] > 0).float().mean())
    assert 0.45 < kept < 0.55
    drop.generator = torch.Generator().manual_seed(0)
    assert torch.equal(drop(x), y)
    drop.eval()
    assert torch.equal(drop(x), x)


def test_vnet_refuses_depth_not_multiple_of_16():
    from segtran_tpu.models.vnet import VNet as J
    from segtran_tpu_torch.models.vnet import VNet as T
    x = np.zeros((1, 32, 32, 24, 1), np.float32)      # 24 % 8 == 0, % 16 != 0
    tm = T(n_channels=1, num_classes=2, n_filters=4)
    with pytest.raises(ValueError, match=r"\(1, 32, 32, 24, 1\)"):
        tm(torch.from_numpy(x))
    jm = J(n_channels=1, num_classes=2, n_filters=4)
    with pytest.raises((TypeError, ValueError)):
        jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.asarray(x))
