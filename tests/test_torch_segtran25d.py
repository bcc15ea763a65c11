"""The port's Segtran25d held against the JAX package on the CPU with the
same converted weights (eff-tiny, 8 attractors, one translayer, a
32x32x8 volume, fp32): eval logits with depth groups of 1 and 2, the
stemconv, bridgeconv and dup3 bridges, the conv and interp depth unpools
and the no-out-FPN head; the train-mode forward (batch statistics) with
G = 1 and 2; and that the converted JAX parameters cover the port's,
the stem taking c*G channels."""
import numpy as np
import pytest

from _torch_volume import ATOL, RTOL, eval_pair, model_pair, train_pair
from _torch_parity import one_torch_thread  # noqa: F401

SIZE = (32, 32, 8)


def _pair(band=True, **kw):
    from segtran_tpu.configs.base import Segtran25dConfig as JCfg
    from segtran_tpu.models.segtran25d import Segtran25d as JModel
    from segtran_tpu_torch.configs.base import Segtran25dConfig as TCfg
    from segtran_tpu_torch.models.segtran25d import Segtran25d as TModel
    base = dict(backbone_type="eff-tiny", num_classes=3, num_attractors=8,
                orig_in_channels=4, hidden_dropout_prob=0.0,
                attention_probs_dropout_prob=0.0)
    base.update(kw)
    jcfg = JCfg(**base).derive(translayer_compress_ratios=(1.0, 1.0))
    tcfg = TCfg(**base).derive(translayer_compress_ratios=(1.0, 1.0))
    shape = (2,) + SIZE + (jcfg.orig_in_channels,)
    x = np.random.RandomState(1).rand(*shape).astype(np.float32)
    if band:
        x[1, :, :12] = 0.0       # a zero band: the nonzero mask drops tokens
    return model_pair(JModel, TModel, jcfg, tcfg, shape) + (x,)


@pytest.mark.parametrize("kw", [
    {},
    {"D_groupsize": 2},
    {"inchan_to3_scheme": "bridgeconv", "D_groupsize": 2},
    {"orig_in_channels": 1, "inchan_to3_scheme": "dup3"},
    {"out_fpn_upsampleD_scheme": "interp"},
    {"out_fpn_layers": (3, 4)},
], ids=["stemconv", "stemconv_g2", "bridgeconv_g2", "dup3", "interp_unpool",
        "no_out_fpn"])
def test_segtran25d_logits_match_jax(kw):
    jm, params, bstats, tm, x = _pair(**kw)
    out, ref = eval_pair(jm, params, bstats, tm, x)
    assert out.shape == ref.shape == x.shape[:4] + (3,)
    np.testing.assert_allclose(out, ref, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("group", [1, 2])
def test_segtran25d_train_forward_matches_jax(group, monkeypatch):
    """model.train(): the EfficientNet's BatchNorm on the folded batch's
    statistics, the running statistics moved the same way. Drop-connect
    draws from each package's own stream, so it is off on both sides (a
    test-time patch of the backbone JAX's Segtran25d builds); the port's
    drop-connect is held in tests/test_torch_train2d.py. No zero band
    here: slices that are zero throughout make the batch statistics of
    the deep layers ill-conditioned (the logits then move by ~1e-4 with
    the summation order alone); the eval tests have the band."""
    import functools
    import segtran_tpu.models.segtran25d as j25
    monkeypatch.setattr(j25, "EfficientNetFeatures", functools.partial(
        j25.EfficientNetFeatures, drop_connect_rate=0.0))
    jm, params, bstats, tm, x = _pair(band=False, D_groupsize=group)
    for blk in tm.backbone._blocks:
        blk.drop_rate = 0.0
    out, ref, sd, new = train_pair(jm, params, bstats, tm, x)
    np.testing.assert_allclose(out, ref, rtol=RTOL, atol=ATOL)
    from segtran_tpu_torch.convert import state_dict_from_jax
    for name, want in state_dict_from_jax({}, new).items():
        np.testing.assert_allclose(sd[name].numpy(), want.numpy(),
                                   rtol=1e-4, atol=1e-5, err_msg=name)


def test_segtran25d_parameters_load_by_name():
    """Every JAX leaf of a grouped stemconv model converts, the converted
    dict covers the port's parameters exactly, and the stem takes the
    c*G = 8 channels."""
    from segtran_tpu.configs.base import Segtran25dConfig as JCfg
    from segtran_tpu.models.segtran25d import Segtran25d as JModel
    from segtran_tpu_torch.configs.base import Segtran25dConfig as TCfg
    from segtran_tpu_torch.convert import state_dict_from_jax
    from segtran_tpu_torch.models.segtran25d import Segtran25d as TModel
    import jax.numpy as jnp
    from _torch_volume import fast_variables
    kw = dict(backbone_type="eff-tiny", num_attractors=8, D_groupsize=2)
    jm = JModel(JCfg(**kw).derive(translayer_compress_ratios=(1.0, 1.0)))
    params, bstats = fast_variables(jm, jnp.zeros((1,) + SIZE + (4,)))
    sd = state_dict_from_jax(params, bstats)
    tm = TModel(TCfg(**kw).derive(translayer_compress_ratios=(1.0, 1.0)))
    assert set(sd) == set(tm.state_dict())
    assert tuple(sd["backbone._conv_stem.weight"].shape)[1:] == (8, 3, 3)
    tm.load_state_dict(sd, strict=True)
