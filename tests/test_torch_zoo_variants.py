"""The three zoo variants that no CLI builds but the importer's models
take, held against the JAX package on the CPU with the same seeded
weights on both sides (tests/_torch_zoo.py), fp32 to 1e-4 of the largest
magnitude:

* SETR with the auxiliary-head shape as its decode head (``num_conv=2``:
  one conv3x3 + BN + ReLU, a 4x upsample, the classifier) at depth 2,
  width 96, 64x96, in eval and in training (outputs and running
  statistics);
* UNet++ with deep supervision (four heads on nodes (0, 1..4)), in eval
  and in training;
* U_Net and R2U_Net (``AttUNet(use_attention=False)``: no gates, no
  ``Att*`` parameters), in eval.
"""
import numpy as np
import pytest

from _torch_zoo import (assert_close, assert_stats_close, eval_outputs,
                        load_pair, train_outputs)
from _torch_parity import one_torch_thread  # noqa: F401

X = np.random.RandomState(0).randn(2, 32, 48, 3).astype(np.float32)


def _check(jm, tm, x, train=True):
    params, bstats = load_pair(jm, tm, x)
    got, ref = eval_outputs(jm, params, bstats, tm, x)
    assert_close(got, ref)
    if train:
        got, ref, sd, new = train_outputs(jm, params, bstats, tm, x)
        assert_close(got, ref)
        if bstats:
            assert_stats_close(sd, new)
    return got, tm.state_dict()


def test_setr_auxiliary_head_shape_matches_jax():
    from segtran_tpu.models.setr import SETR_PUP as J
    from segtran_tpu_torch.models.setr import SETR_PUP as T
    kw = dict(embed_dim=96, depth=2, num_heads=4, num_conv=2, drop_rate=0.0)
    x = np.random.RandomState(1).randn(2, 64, 96, 3).astype(np.float32)
    got, sd = _check(J(3, **kw), T(3, (64, 96), **kw), x)
    assert got[0].shape == (2, 64, 96, 3)
    assert sorted(k for k in sd if k.startswith("decode_head.conv")) == [
        "decode_head.conv_0.bias", "decode_head.conv_0.weight",
        "decode_head.conv_1.bias", "decode_head.conv_1.weight"]


def test_nested_unet_deep_supervision_matches_jax():
    from segtran_tpu.models.nested_unet import NestedUNet as J
    from segtran_tpu_torch.models.nested_unet import NestedUNet as T
    got, sd = _check(J(3, deep_supervision=True),
                     T(3, deep_supervision=True), X)
    assert [g.shape for g in got] == [(2, 32, 48, 3)] * 4
    assert "final.weight" not in sd and "final4.weight" in sd


@pytest.mark.parametrize("recurrent", [False, True])
def test_attunet_without_attention_matches_jax(recurrent):
    from segtran_tpu.models.att_unet import AttUNet as J
    from segtran_tpu_torch.models.att_unet import AttUNet as T
    got, sd = _check(J(3, use_attention=False, recurrent=recurrent),
                     T(3, recurrent=recurrent, use_attention=False), X,
                     train=False)
    assert got[0].shape == (2, 32, 48, 3)
    assert not any(k.startswith("Att") for k in sd)
