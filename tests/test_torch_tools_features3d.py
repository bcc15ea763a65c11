"""The features Segtran25d (eff-tiny, 32x32x8) and Segtran3d (I3D,
32x32x16) keep held against the JAX package's sown ``intermediates`` on
the CPU, with the same converted weights (fp32): the depth-pooled
``in_fpn_feat`` under JAX's path, alone, equal to 1e-4."""
from _torch_parity import one_torch_thread  # noqa: F401
from _torch_tools import assert_same_features, jax_intermediates, \
    port_features


def test_segtran25d_features_match_jax():
    from test_torch_segtran25d import _pair
    jm, params, bstats, tm, x = _pair()
    want = jax_intermediates(jm, params, bstats, x)
    assert list(want) == ["in_fpn_feat"] and want["in_fpn_feat"].ndim == 5
    assert_same_features(port_features(tm, x), want)


def test_segtran3d_features_match_jax():
    from segtran_tpu.models.segtran3d import Segtran3d as JModel
    from segtran_tpu_torch.models.segtran3d import Segtran3d as TModel
    from _torch_volume import model_pair
    from test_torch_segtran3d_options import _cfgs, _volume
    jcfg, tcfg = _cfgs(inchan_to3_scheme="avgto3")
    x = _volume(4)
    jm, params, bstats, tm = model_pair(JModel, TModel, jcfg, tcfg, x.shape)
    want = jax_intermediates(jm, params, bstats, x)
    assert list(want) == ["in_fpn_feat"] and want["in_fpn_feat"].ndim == 5
    assert_same_features(port_features(tm, x), want)
