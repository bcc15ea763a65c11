"""The port's modules held against the JAX modules on the CPU: the same
numpy inputs and the same weights (through state_dict_from_jax) go into
both. fp32 throughout unless a case says otherwise."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import jax_variables, jvars
from _torch_parity import one_torch_thread  # noqa: F401

TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(autouse=True)
def _inference():
    with torch.inference_mode():
        yield


def _load(module, params, bstats=None):
    from segtran_tpu_torch.convert import state_dict_from_jax
    module.load_state_dict(state_dict_from_jax(params, bstats), strict=True)
    return module.eval()


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_layer_norm(dtype):
    from segtran_tpu.ops.norm import layer_norm as jln
    from segtran_tpu_torch.ops.norm import LayerNorm
    jdt, tdt = ((jnp.float32, torch.float32) if dtype == "fp32"
                else (jnp.bfloat16, torch.bfloat16))
    rng = np.random.RandomState(0)
    # an offset row mean makes E[x^2] - mean^2 lose digits
    x = (rng.randn(4, 7, 96) * 2 + 3).astype(np.float32)
    params = {"scale": rng.rand(96).astype(np.float32) + 0.5,
              "bias": rng.randn(96).astype(np.float32)}
    ref = jln(jdt, epsilon=1e-12).apply({"params": params},
                                        jnp.asarray(x).astype(jdt))
    out = _load(LayerNorm(96, 1e-12, dtype=tdt), params)(
        torch.from_numpy(x).to(tdt))
    assert out.dtype == tdt
    ref = np.asarray(ref.astype(jnp.float32))
    out = out.float().numpy()
    if dtype == "fp32":
        np.testing.assert_allclose(out, ref, **TOL)
    else:
        # fp32 stats on both sides; the half-precision elementwise steps
        # round per op here and at excess precision in XLA on the CPU, so
        # outputs of magnitude ~4 differ by at most a few bf16 ulps
        np.testing.assert_allclose(out, ref, rtol=2e-2, atol=5e-2)


@pytest.mark.parametrize("size", [(32, 40), (7, 5)])
def test_resize_linear(size):
    from segtran_tpu.ops.resize import resize_linear as jr
    from segtran_tpu_torch.ops.resize import resize_linear as tr
    x = np.random.RandomState(1).randn(2, 12, 16, 3).astype(np.float32)
    ref = np.asarray(jr(jnp.asarray(x), size))
    out = tr(torch.from_numpy(x), size).numpy()
    assert out.shape == (2,) + size + (3,)
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("hw", [(100, 70), (64, 64)])
def test_sliding_window_2d(hw):
    """Window grid, centred padding, resize to the patch and back, sigmoid
    and overlap blending, with a pointwise linear map as the model."""
    from segtran_tpu.infer.sliding import sliding_window_2d as jsw
    from segtran_tpu_torch.infer.sliding import sliding_window_2d as tsw
    rng = np.random.RandomState(8)
    img = rng.rand(2, *hw, 3).astype(np.float32)
    w = rng.randn(3, 2).astype(np.float32)
    ref = jsw(lambda p: p @ jnp.asarray(w), jnp.asarray(img), (64, 64),
              (32, 32), num_classes=2)
    out = tsw(lambda p: p @ torch.from_numpy(w), torch.from_numpy(img),
              (64, 64), (32, 32), num_classes=2)
    assert out.shape == (2, *hw, 2)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-6)


def test_lsinu_position_code():
    from segtran_tpu.nn.poscode import SegtranPosEncoder as JEnc
    from segtran_tpu.nn.poscode import gen_all_indices as jidx
    from segtran_tpu_torch.nn.poscode import SegtranPosEncoder as TEnc
    from segtran_tpu_torch.nn.poscode import gen_all_indices as tidx
    xy = np.asarray(jidx((6, 5))).reshape(-1, 2).astype(np.float32) * 8
    assert np.array_equal(xy, tidx((6, 5)).reshape(-1, 2).numpy() * 8)
    pos = np.broadcast_to(xy[None], (2, 30, 2)).copy()
    jm = JEnc(pos_code_type="lsinu", pos_dim=2, pos_embed_dim=64)
    params, _ = jax_variables(jm, (6, 5), jnp.asarray(pos), seed=2)
    ref = np.asarray(jm.apply({"params": params}, (6, 5), jnp.asarray(pos)))
    tm = _load(TEnc("lsinu", 2, 64), params)
    out = tm((6, 5), torch.from_numpy(pos)).numpy()
    np.testing.assert_allclose(out, ref, **TOL)


def test_efficientnet_tiny_endpoints():
    from segtran_tpu.nn.backbones.efficientnet import (
        EfficientNetFeatures as JEff)
    from segtran_tpu_torch.nn.backbones.efficientnet import (
        EfficientNetFeatures as TEff)
    x = np.random.RandomState(3).randn(2, 64, 64, 3).astype(np.float32)
    jm = JEff(variant="eff-tiny", stem_stride=1)
    params, bstats = jax_variables(jm, jnp.zeros((1, 64, 64, 3)), seed=4)
    refs = jax.jit(jm.apply)(jvars(params, bstats), jnp.asarray(x))
    tm = _load(TEff("eff-tiny", stem_stride=1), params, bstats)
    outs = tm(torch.from_numpy(x))
    assert len(outs) == len(refs) == 5
    for o, r in zip(outs, refs):
        assert tuple(o.shape) == r.shape
        np.testing.assert_allclose(o.numpy(), np.asarray(r), **TOL)


@pytest.mark.parametrize("fused_epilogue", [False, True])
@pytest.mark.parametrize("reassociate", [True, False])
@pytest.mark.parametrize("mid_type", ["shared", "private"])
def test_squeezed_att_feat_trans(fused_epilogue, reassociate, mid_type):
    """Both cross-attentions, the q/k folds (reassociate), the V/W1
    push-through and, with the fused epilogue, the CPU path of the
    epilogue functions; the batch holds one all-zero sample so the global
    clamp test spans a padded batch as in serving."""
    from segtran_tpu.nn.attention import SqueezedAttFeatTrans as JSq
    from segtran_tpu.nn.attention import TransLayerSpec as JSpec
    from segtran_tpu_torch.nn.attention import SqueezedAttFeatTrans as TSq
    from segtran_tpu_torch.nn.attention import TransLayerSpec as TSpec
    kw = dict(in_feat_dim=64, feat_dim=32, num_modes=4, mid_type=mid_type,
              reassociate=reassociate, use_fused_epilogue=fused_epilogue)
    jm = JSq(JSpec(attention_probs_dropout_prob=0.0, hidden_dropout_prob=0.0,
                   **kw), num_attractors=12)
    x = np.random.RandomState(5).randn(3, 40, 64).astype(np.float32)
    x[2] = 0.0
    params, _ = jax_variables(jm, jnp.asarray(x[:1]), seed=6)
    ref = np.asarray(jm.apply({"params": params}, jnp.asarray(x)))
    tm = _load(TSq(TSpec(**kw), num_attractors=12), params)
    out = tm(torch.from_numpy(x)).numpy()
    assert out.shape == (3, 40, 32)
    np.testing.assert_allclose(out, ref, **TOL)


def test_global_clamp_spans_the_batch():
    """The clamp fires on every sample once any sample's score exceeds the
    clip -- not per sample."""
    from segtran_tpu_torch.nn.attention import _clamp_if_exceeds
    s = torch.tensor([[1.0, -900.0], [2.0, 3.0]])
    assert torch.equal(_clamp_if_exceeds(s, 500.0), s)
    s[1, 1] = 600.0
    out = _clamp_if_exceeds(s, 500.0)
    assert out[0, 1] == -500.0 and out[1, 1] == 500.0
