"""The mince transformer (``--mince``) held against the JAX package on the
CPU: its helpers (fracs_to_indices, scaled_shape, resize_flat_features),
the CrossMinceAttFeatTrans layer on converted weights (fp32, 1e-4), the
non-squeezed encoder's mince branch through a tiny eff-tiny Segtran2d
(with and without the per-scale position biases), JAX's squeezed
encoder under --mince without --nosqueeze, and no flash call from a
mince layer even with --fused."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_options import ATOL, RTOL, _eval_pair, _pair
from _torch_parity import jax_variables, jvars
from _torch_parity import one_torch_thread  # noqa: F401


def test_helpers_match_jax():
    from segtran_tpu.nn import mince as jm
    from segtran_tpu_torch.nn import mince as tm
    for dim, props in ((64, [1, 1]), (448, [1, 1, 1, 1]), (100, [0.3, 0.7]),
                       (63, [1, 1, 1]), (16, [0.4, 0.3, 0.2, 0.1])):
        assert tm.fracs_to_indices(dim, props) == jm.fracs_to_indices(
            dim, props)
    for shape, scale in (((8, 6), 2), ((9, 7), 3), ((36, 36, 4), 2)):
        assert tm.scaled_shape(shape, scale) == jm.scaled_shape(shape, scale)
    x = np.random.RandomState(0).randn(2, 4, 48, 16).astype(np.float32)
    for new in ((4, 3), (16, 12), (8, 6)):
        got = tm.resize_flat_features(torch.from_numpy(x), (8, 6), new)
        want = jm.resize_flat_features(jnp.asarray(x), (8, 6), new)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-6)


@pytest.mark.parametrize("scales,props,tie", [
    ((2, 1), (1.0, 1.0), "shared"), ((1, 2, 4), (0.5, 0.3, 0.2), "loose")])
def test_mince_layer_matches_jax(scales, props, tie):
    """The layer on JAX's converted weights, 8x6 tokens: outputs and their
    input gradient to 1e-4."""
    from segtran_tpu.nn.attention import TransLayerSpec as JSpec
    from segtran_tpu.nn.mince import CrossMinceAttFeatTrans as JMince
    from segtran_tpu_torch.convert import state_dict_from_jax
    from segtran_tpu_torch.nn.attention import TransLayerSpec
    from segtran_tpu_torch.nn.mince import CrossMinceAttFeatTrans
    kw = dict(in_feat_dim=64, feat_dim=64, num_modes=4, tie_qk_scheme=tie,
              attention_probs_dropout_prob=0.0, hidden_dropout_prob=0.0)
    jmod = JMince(JSpec(**kw), mince_scales=scales, mince_channel_props=props)
    x = np.random.RandomState(1).randn(2, 48, 64).astype(np.float32)
    params, _ = jax_variables(jmod, jnp.asarray(x), (8, 6), seed=2,
                              jit_init=False)

    def jf(xx):
        return jmod.apply(jvars(params, {}), xx, (8, 6), deterministic=True)
    want, vjp = jax.vjp(jf, jnp.asarray(x))
    ct = np.random.RandomState(3).randn(*want.shape).astype(np.float32)
    (want_g,) = vjp(jnp.asarray(ct))
    tmod = CrossMinceAttFeatTrans(TransLayerSpec(**kw), scales, props)
    tmod.load_state_dict(state_dict_from_jax(params), strict=True)
    xt = torch.from_numpy(x).requires_grad_()
    got = tmod.eval()(xt, (8, 6))
    got.backward(torch.from_numpy(ct))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=RTOL, atol=ATOL)
    g = xt.grad.numpy()
    assert np.abs(g - np.asarray(want_g)).max() < 1e-4 * np.abs(g).max()


@pytest.mark.parametrize("pos", ["lsinu", "bias"])
def test_mince_encoder_matches_jax(pos):
    """Segtran2d --nosqueeze --mince --mincescales 2,1 --minceprops 1,1
    (eff-tiny, 2 layers) on JAX's converted weights: eval logits, and
    with --pos bias the per-scale position biases of pos_code_layers."""
    from segtran_tpu_torch.nn.mince import CrossMinceAttFeatTrans
    kw = dict(use_squeezed_transformer=False, use_mince_transformer=True,
              mince_scales=(2, 1), mince_channel_props=(1.0, 1.0),
              pos_code_type=pos, pos_bias_radius=2)
    jm, params, bstats, tm = _pair(**kw)
    layers = tm.voxel_fusion.translayers
    assert all(isinstance(m, CrossMinceAttFeatTrans) for m in layers)
    assert hasattr(tm.voxel_fusion, "pos_code_layers") == (pos == "bias")
    x = np.random.RandomState(4).randn(2, 64, 64, 3).astype(np.float32)
    out, ref = _eval_pair(jm, params, bstats, tm, x)
    np.testing.assert_allclose(out, ref, rtol=RTOL, atol=ATOL)


def test_mince_without_nosqueeze_builds_the_squeezed_encoder():
    """As in JAX (nn/encoder.py:127-135), --mince with the squeezed
    encoder builds squeezed layers, and the logits agree."""
    from segtran_tpu_torch.nn.attention import SqueezedAttFeatTrans
    jm, params, bstats, tm = _pair(use_mince_transformer=True,
                                   mince_scales=(2, 1),
                                   mince_channel_props=(1.0, 1.0))
    assert all(isinstance(m, SqueezedAttFeatTrans)
               for m in tm.voxel_fusion.translayers)
    x = np.random.RandomState(5).randn(1, 64, 64, 3).astype(np.float32)
    out, ref = _eval_pair(jm, params, bstats, tm, x)
    np.testing.assert_allclose(out, ref, rtol=RTOL, atol=ATOL)


def test_mince_takes_no_flash_path(monkeypatch):
    """With --fused the mince layers still attend in PyTorch: no call of
    either flash function in an eval or a training forward (JAX's mince
    layer has no fused branch)."""
    import segtran_tpu_torch.nn.attention as att
    from segtran_tpu_torch.models.segtran2d import Segtran2d, init_segtran2d
    from _torch_options import _configs
    calls = []
    for name in ("fused_cross_attention", "fused_cross_attention_trainable"):
        fn = getattr(att, name)
        monkeypatch.setattr(att, name, lambda *a, _fn=fn, **k: (
            calls.append(1), _fn(*a, **k))[1])
    _, tcfg = _configs(use_squeezed_transformer=False,
                       use_mince_transformer=True, mince_scales=(2, 1),
                       mince_channel_props=(1.0, 1.0),
                       use_fused_attention=True)
    model = init_segtran2d(Segtran2d(tcfg), 0)
    x = torch.from_numpy(np.random.RandomState(6).randn(
        2, 64, 64, 3).astype(np.float32))
    with torch.inference_mode():
        assert torch.isfinite(model.eval()(x)).all()
    model.train()(x).sum().backward()
    assert calls == []
