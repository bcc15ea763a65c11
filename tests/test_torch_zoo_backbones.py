"""The 2-D zoo's backbones held against the JAX package on the CPU.

* ResNet (``nn/backbones/resnet.py``): resnet18 at 64x96 in eval and in
  training (logits of every level, the running statistics after the
  pass), resnet50 without the stem pool (``bb_feat_upsize``) and resnet18
  with SMP's pre-pool tap and torchvision's stride-to-dilation (layers 3
  and 4 at stride 8, each layer's first block at the previous dilation);
* EfficientNetV2-S (flax SAME pads from the runtime size) in eval and
  training;
* Res2Net-50-v1b in eval (its training is held in fp64 through PraNet,
  tests/test_torch_zoo_heads.py) and its two average pools;
* every variant's parameter tree at its published width against JAX's
  (``jax.eval_shape``: names through ``convert.py`` and shapes);
* ``nn/init.py``'s torch_conv_kernel_init / torch_conv_bias_init_for: the
  JAX functions' bound, PyTorch's own default conv init, which the zoo's
  convs keep.

fp32 outputs to 1e-4 of their largest magnitude, fp64 ones to 1e-6.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_zoo import (assert_close, assert_stats_close, eval_outputs,
                        load_pair, state_dict_shapes_from_jax,
                        train_outputs)
from _torch_parity import one_torch_thread  # noqa: F401

X = np.random.RandomState(0).randn(2, 64, 96, 3).astype(np.float32)


@pytest.mark.parametrize("kw,train", [
    (dict(variant="resnet18"), True),
    (dict(variant="resnet50", do_pool1=False), False),
    (dict(variant="resnet18", stem_prepool_tap=True,
          replace_stride_with_dilation=(False, True, True)), True)])
def test_resnet_matches_jax(kw, train):
    from segtran_tpu.nn.backbones.resnet import ResNetFeatures as J
    from segtran_tpu_torch.nn.backbones.resnet import ResNetFeatures as T
    jm, tm = J(**kw), T(**kw)
    params, bstats = load_pair(jm, tm, X)
    got, ref = eval_outputs(jm, params, bstats, tm, X)
    assert_close(got, ref)
    if kw.get("replace_stride_with_dilation"):
        assert [g.shape[1:3] for g in got] == [(32, 48), (16, 24), (8, 12),
                                               (8, 12), (8, 12)]
    if train:
        got, ref, sd, new = train_outputs(jm, params, bstats, tm, X)
        assert_close(got, ref)
        assert_stats_close(sd, new)


def test_effv2_matches_jax():
    from segtran_tpu.nn.backbones.efficientnetv2 import (
        EfficientNetV2Features as J)
    from segtran_tpu_torch.nn.backbones.efficientnetv2 import (
        EfficientNetV2Features as T)
    jm, tm = J("effv2s"), T("effv2s")
    params, bstats = load_pair(jm, tm, X)
    got, ref = eval_outputs(jm, params, bstats, tm, X)
    assert [g.shape[-1] for g in got] == [24, 48, 64, 160, 256]
    assert_close(got, ref)
    got, ref, sd, new = train_outputs(jm, params, bstats, tm, X)
    assert_close(got, ref)
    assert_stats_close(sd, new)


def test_res2net_matches_jax():
    """Eval mode; training in fp64 is held through PraNet
    (tests/test_torch_zoo_heads.py), whose backbone this is."""
    from segtran_tpu.nn.backbones.res2net import Res2NetFeatures as J
    from segtran_tpu_torch.nn.backbones.res2net import Res2NetFeatures as T
    jm, tm = J(), T()
    params, bstats = load_pair(jm, tm, X)
    got, ref = eval_outputs(jm, params, bstats, tm, X)
    assert_close(got, ref)


def test_res2net_avg_pool_semantics():
    """The v1b shortcut pool leaves the padding out of its count, the
    stage pool keeps it in (torch's default), as JAX's avg_pool2d."""
    from segtran_tpu.nn.backbones.res2net import avg_pool2d as jpool
    from segtran_tpu_torch.nn.backbones.res2net import avg_pool2d
    x = np.random.RandomState(2).randn(2, 7, 9, 5).astype(np.float32)
    for args in ((3, 2, 1, True), (3, 1, 1, True), (2, 2, 0, False)):
        ref = np.asarray(jpool(jnp.asarray(x), *args[:3],
                               count_include_pad=args[3]))
        got = avg_pool2d(torch.from_numpy(x).permute(0, 3, 1, 2), *args[:3],
                         count_include_pad=args[3]).permute(0, 2, 3, 1)
        np.testing.assert_allclose(got.numpy(), ref, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("family,variants", [
    ("resnet", ("resnet18", "resnet34", "resnet50", "resnet101",
                "resnet152")),
    ("effv2", ("effv2s", "effv2m", "effv2l")),
    ("res2net", ("res2net50", "res2net101"))])
def test_published_trees_match_jax(family, variants):
    """Each variant's parameters and statistics, names and shapes, at 288^2
    against JAX's tree (no weights are made)."""
    mods = {
        "resnet": ("segtran_tpu.nn.backbones.resnet", "ResNetFeatures",
                   "segtran_tpu_torch.nn.backbones.resnet"),
        "effv2": ("segtran_tpu.nn.backbones.efficientnetv2",
                  "EfficientNetV2Features",
                  "segtran_tpu_torch.nn.backbones.efficientnetv2"),
        "res2net": ("segtran_tpu.nn.backbones.res2net", "Res2NetFeatures",
                    "segtran_tpu_torch.nn.backbones.res2net")}[family]
    import importlib
    jcls = getattr(importlib.import_module(mods[0]), mods[1])
    tcls = getattr(importlib.import_module(mods[2]), mods[1])
    for v in variants:
        shapes = jax.eval_shape(jcls(variant=v).init, jax.random.PRNGKey(0),
                                jnp.zeros((1, 288, 288, 3)))
        tm = tcls(variant=v)
        sd = tm.state_dict()
        want = state_dict_shapes_from_jax(shapes["params"],
                                          shapes["batch_stats"], sd)
        assert want == {k: tuple(t.shape) for k, t in sd.items()}, v


def test_torch_conv_init_is_pytorch_default():
    """torch_conv_kernel_init / torch_conv_bias_init_for draw U(-b, b), b =
    1 / sqrt(fan in), as JAX's do for HWIO kernels; a fresh nn.Conv2d
    under the same seed draws the same numbers, and every conv of the zoo
    nets the CLIs build lies in its bound (the offset convs of the
    deformable U-Net at zero)."""
    from segtran_tpu.nn.init import torch_conv_kernel_init as jinit
    from segtran_tpu_torch.models.dunet import DUNetV1V2
    from segtran_tpu_torch.models.unet_smp import UnetSMP
    from segtran_tpu_torch.nn.init import (torch_conv_bias_init_for,
                                           torch_conv_kernel_init)
    shape = (16, 8, 3, 3)
    fan_in = 8 * 9
    j = np.asarray(jinit(jax.random.PRNGKey(0), (3, 3, 8, 16)))
    assert np.abs(j).max() <= 1 / np.sqrt(fan_in)
    gen = torch.Generator().manual_seed(7)
    w = torch_conv_kernel_init(shape, generator=gen)
    b = torch_conv_bias_init_for(fan_in)((16,), generator=gen)
    torch.manual_seed(7)
    conv = torch.nn.Conv2d(8, 16, 3)
    torch.testing.assert_close(w, conv.weight.detach())
    torch.testing.assert_close(b, conv.bias.detach())
    bound = 1 / np.sqrt(fan_in)
    assert abs(w).max() <= bound and abs(b).max() <= bound
    # U(-b, b) has standard deviation b / sqrt(3)
    big = torch_conv_kernel_init((256, 64, 3, 3))
    np.testing.assert_allclose(float(big.std()), 1 / np.sqrt(3 * 576),
                               rtol=0.02)
    for net in (UnetSMP(3, "resnet18"), DUNetV1V2(3, 3)):
        for name, m in net.named_modules():
            if isinstance(m, torch.nn.Conv2d):
                fan = m.weight[0].numel()
                assert m.weight.abs().max() <= 1 / np.sqrt(fan), name
                if name.endswith(("p_conv", "m_conv")):
                    assert not m.weight.any(), name
