"""The zoo's DeepLab and ViT-based nets held against the JAX
package on the CPU, with the same seeded weights on both sides
(tests/_torch_zoo.py):

* DeepLabV3 / V3+ on a dilated ResNet-18 (output stride 8, ASPP 12/24/36,
  half-pixel resizes) at 64x96 in eval (their ASPP dropout keeps training
  out: the masks cannot be shared with JAX);
* TransUNet at depth 2, width 96 (JAX's tests/test_zoo2.py sizes; square
  64x64: the zero-pad skip quirk assumes it) in eval, and its decoder
  block in training;
* SETR-PUP at depth 2, width 96 at 64x96 (24 patches + cls: the cls-token
  drop) in eval, and its up-head in training.

fp32 to 1e-4 of the largest magnitude, fp64 to 1e-6.
"""
import numpy as np
import pytest
import torch

from _torch_zoo import (assert_close, assert_stats_close, eval_outputs,
                        load_pair, train_outputs)
from _torch_parity import one_torch_thread  # noqa: F401

X = np.random.RandomState(0).randn(2, 64, 96, 3).astype(np.float32)
VIT = dict(hidden_dim=96, num_layers=2, num_heads=4, mlp_dim=192)


@pytest.mark.parametrize("net", ["DeepLabV3", "DeepLabV3Plus"])
def test_deeplab_matches_jax(net):
    import segtran_tpu.models.deeplab as J
    import segtran_tpu_torch.models.deeplab as T
    jm, tm = getattr(J, net)(3, "resnet18"), getattr(T, net)(3, "resnet18")
    params, bstats = load_pair(jm, tm, X)
    got, ref = eval_outputs(jm, params, bstats, tm, X)
    assert got[0].shape == (2, 64, 96, 3)
    assert_close(got, ref)


def test_transunet_matches_jax():
    from segtran_tpu.models.transunet import TransUNet as J
    from segtran_tpu_torch.models.transunet import TransUNet as T
    x = X[:, :, :64]
    jm, tm = J(3, **VIT), T(3, 64, **VIT)
    params, bstats = load_pair(jm, tm, x)
    got, ref = eval_outputs(jm, params, bstats, tm, x)
    assert got[0].shape == (2, 64, 64, 3)
    assert_close(got, ref)


def test_transunet_decoder_block_trains_as_jax():
    """A decoder block (align-corners 2x upsample, skip, 2x conv3x3 + BN +
    ReLU) in training: outputs and running statistics."""
    from segtran_tpu.models.transunet import _DecoderBlock as J
    from segtran_tpu_torch.models.transunet import DecoderBlock as T
    from segtran_tpu_torch.nn.convbn import nchw, nhwc
    # the 4x6 input and its 8x12 skip, packed in one NHWC array
    x = np.random.RandomState(3).randn(2, 8, 12, 24).astype(np.float32)
    jb = J(12)

    class JBlock:
        def init(self, rng, x, **kw):
            return jb.init(rng, x[:, ::2, ::2, :16], x[..., 16:], **kw)

        def apply(self, v, x, **kw):
            return jb.apply(v, x[:, ::2, ::2, :16], x[..., 16:], **kw)

    class Block(T):
        def forward(self, x):
            return nhwc(super().forward(
                nchw(x[:, ::2, ::2, :16], torch.float32),
                nchw(x[..., 16:], torch.float32)))
    jm, tm = JBlock(), Block(16, 8, 12)
    params, bstats = load_pair(jm, tm, x)
    got, ref, sd, new = train_outputs(jm, params, bstats, tm, x)
    assert got[0].shape == (2, 8, 12, 12)
    assert_close(got, ref)
    assert_stats_close(sd, new)


def test_setr_matches_jax():
    from segtran_tpu.models.setr import SETR_PUP as J
    from segtran_tpu_torch.models.setr import SETR_PUP as T
    kw = dict(embed_dim=96, depth=2, num_heads=4)
    jm, tm = J(3, **kw), T(3, (64, 96), **kw)
    params, bstats = load_pair(jm, tm, X)
    got, ref = eval_outputs(jm, params, bstats, tm, X)
    assert got[0].shape == (2, 64, 96, 3)
    assert_close(got, ref)


def test_setr_up_head_trains_as_jax():
    """The head in training on 24 tokens + cls of a 4x6 grid (25 % 48 != 0:
    the cls token is dropped), and in eval on 48 tokens of a 6x8 grid (a
    multiple of 48: every token is kept)."""
    from segtran_tpu.models.setr import SETRUpHead as J
    from segtran_tpu_torch.models.setr import SETRUpHead as T
    for n, grid, train in ((25, (4, 6), True), (48, (6, 8), False)):
        tokens = np.random.RandomState(n).randn(2, n, 32).astype(np.float32)
        jh = J(3)

        class JHead:
            def init(self, rng, t, **kw):
                return jh.init(rng, t, grid, **kw)

            def apply(self, v, t, train=False, **kw):
                return jh.apply(v, t, grid, train=train, **kw)

        class Head(T):
            def forward(self, t):
                return super().forward(t, grid).permute(0, 2, 3, 1)
        jm, tm = JHead(), Head(32, 3)
        params, bstats = load_pair(jm, tm, tokens)
        got, ref = eval_outputs(jm, params, bstats, tm, tokens)
        assert got[0].shape == (2, 16 * grid[0], 16 * grid[1], 3)
        assert_close(got, ref)
        if train:
            got, ref, sd, new = train_outputs(jm, params, bstats, tm, tokens)
            assert_close(got, ref)
            assert_stats_close(sd, new)
