"""The attention U-Nets and the deformable U-Net held against the JAX
package on the CPU at a non-square input (32x48), with the same seeded
weights on both sides (tests/_torch_zoo.py):

* AttU-Net and R2AttU-Net (the recurrent block reuses ONE conv and
  BatchNorm for its t passes) in eval and training, fp32 to 1e-4;
* the deformable convolution alone (offsets and modulation from seeded
  convs, border clamps, padding 0 and 1), fp32 to 1e-4, and its
  gradients reaching the zero-initialised offset conv;
* DUNet in eval and training in fp64 to 1e-6: the reference's clamped
  sampling has a jump where a tap crosses the border, so with seeded
  (not zero) offset convs an fp32 rounding flips taps and the error grows
  through the eight deformable convs.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_zoo import (assert_close, assert_stats_close, eval_outputs,
                        load_pair, train_outputs)
from _torch_parity import one_torch_thread  # noqa: F401

X = np.random.RandomState(0).randn(2, 32, 48, 3).astype(np.float32)


@pytest.mark.parametrize("recurrent", [False, True])
def test_att_unet_matches_jax(recurrent):
    from segtran_tpu.models.att_unet import AttUNet as J
    from segtran_tpu_torch.models.att_unet import AttUNet as T
    jm, tm = J(3, recurrent=recurrent), T(3, recurrent=recurrent)
    params, bstats = load_pair(jm, tm, X)
    got, ref = eval_outputs(jm, params, bstats, tm, X)
    assert_close(got, ref)
    got, ref, sd, new = train_outputs(jm, params, bstats, tm, X)
    assert_close(got, ref)
    assert_stats_close(sd, new)


@pytest.mark.parametrize("padding,modulation", [(0, False), (1, True)])
def test_deform_conv_matches_jax(padding, modulation):
    from segtran_tpu.ops.deform_conv import DeformConv2d as J
    from segtran_tpu_torch.ops.deform_conv import DeformConv2d as T
    x = (3 * np.random.RandomState(1).randn(2, 12, 16, 5)).astype(np.float32)
    jm = J(7, 3, padding=padding, modulation=modulation, use_bias=True)
    tm = T(5, 7, 3, padding=padding, modulation=modulation, use_bias=True)
    params, bstats = load_pair(jm, tm, x)
    got, ref = eval_outputs(jm, params, bstats, tm, x)
    assert got[0].shape == (2, 12, 16, 7)
    assert_close(got, ref)


def test_deform_conv_gradients_reach_the_offsets():
    """From the reference's zero offsets, the offset conv's weight still
    gets a gradient (bilinear weights are differentiable in the offsets)."""
    from segtran_tpu_torch.ops.deform_conv import DeformConv2d
    torch.manual_seed(0)
    m = DeformConv2d(4, 6, 3, padding=1)
    assert not m.p_conv.weight.any()
    x = torch.randn(2, 10, 12, 4)
    m(x).square().sum().backward()
    assert m.p_conv.weight.grad.abs().max() > 0
    assert m.conv.weight.grad.abs().max() > 0


def test_dunet_matches_jax_fp64():
    from segtran_tpu.models.dunet import DUNetV1V2 as J
    from segtran_tpu_torch.models.dunet import DUNetV1V2 as T
    jm, tm = J(3, 3, dtype=jnp.float64), T(3, 3, dtype=torch.float64)
    params, bstats = load_pair(jm, tm, X)
    got, ref = eval_outputs(jm, params, bstats, tm, X, x64=True)
    assert np.abs(ref[0]).max() > 0.1
    assert_close(got, ref, rel=1e-6)
    got, ref, sd, new = train_outputs(jm, params, bstats, tm, X, x64=True)
    assert_close(got, ref, rel=1e-6)
    assert_stats_close(sd, new, rel=1e-6)
