"""The zoo's U-Nets held against the JAX package on the CPU, at a
non-square input (32x48, 64x96 for the ResNet encoder), with the same
seeded weights on both sides (tests/_torch_zoo.py): the U-Net on a
ResNet-18 encoder (SMP's decoder and pre-pool taps) and on eff-tiny, the
nested U-Net (align-corners upsamples), UNet 3+ (half-pixel resizes and
max pools across all five scales) and the nnU-Net-style Generic_UNet
(instance norm, transposed convs, deep supervision deepest last). Each in
eval and in training (outputs and running statistics; fp32 to 1e-4 of
the largest magnitude).
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
    return got


@pytest.mark.parametrize("encoder,train", [("resnet18", True),
                                           ("eff-tiny", False)])
def test_unet_smp_matches_jax(encoder, train):
    from segtran_tpu.models.unet_smp import UnetSMP as J
    from segtran_tpu_torch.models.unet_smp import UnetSMP as T
    x = np.random.RandomState(1).randn(2, 64, 96, 3).astype(np.float32)
    got = _check(J(3, encoder), T(3, encoder), x, train)
    assert got[0].shape == (2, 64, 96, 3)


def test_nested_unet_matches_jax():
    from segtran_tpu.models.nested_unet import NestedUNet as J
    from segtran_tpu_torch.models.nested_unet import NestedUNet as T
    _check(J(3), T(3), X)


def test_unet3plus_matches_jax():
    from segtran_tpu.models.unet_3plus import UNet3Plus as J
    from segtran_tpu_torch.models.unet_3plus import UNet3Plus as T
    _check(J(3), T(3), X)


@pytest.mark.parametrize("deep_supervision", [True, False])
def test_generic_unet_matches_jax(deep_supervision):
    from segtran_tpu.models.generic_unet import GenericUNet as J
    from segtran_tpu_torch.models.generic_unet import GenericUNet as T
    got = _check(J(3, deep_supervision=deep_supervision),
                 T(3, deep_supervision=deep_supervision), X,
                 train=deep_supervision)
    assert got[0].shape == (2, 32, 48, 3)
    if deep_supervision:
        assert [g.shape[1:3] for g in got] == [(32, 48), (16, 24), (8, 12),
                                               (4, 6)]
