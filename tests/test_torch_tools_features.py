"""The features the port's models keep (``nn/features.kept_features``)
held against the JAX package's sown ``intermediates`` on the CPU, with the
same converted weights (fp32): the same paths in the same order and the
same values (1e-4) for Segtran2d (eff-tiny, two translayers, 64^2, with
and without remat, and with --attnconsist's scores and --attndiag's 1-D
diagnostics) and the U-Net (before ``outc``, under a Polyformer); the 3-D
models in tests/test_torch_tools_features3d.py."""
import numpy as np
import pytest
import torch

from _torch_parity import one_torch_thread  # noqa: F401
from _torch_tools import (assert_same_features, jax_intermediates,
                          port_features, segtran2d_pair)


@pytest.mark.parametrize("kw", [
    {}, {"remat": True},
    {"use_attn_consist_loss": True, "attn_diag": True}],
    ids=["plain", "remat", "scores_and_diag"])
def test_segtran2d_features_match_jax(kw):
    jm, params, bstats, tm = segtran2d_pair(**kw)
    tcfg = tm.cfg
    x = np.random.RandomState(0).rand(2, 64, 64, 3).astype(np.float32)
    want = jax_intermediates(jm, params, bstats, x)
    got = port_features(tm, x)
    names = list(want)
    if kw.get("remat"):
        assert names == ["in_fpn_feat"]
    elif kw:
        assert names[:4] == [
            "in_fpn_feat",
            "voxel_fusion/translayers_0/in_ator_trans/attn_diag",
            "voxel_fusion/translayers_0/in_ator_trans/attention_scores",
            "voxel_fusion/translayers_0/ator_out_trans/attn_diag"]
        assert names[-1] == "voxel_fusion/layer_1_vfeat"
    else:
        assert names == ["in_fpn_feat", "voxel_fusion/layer_0_vfeat",
                         "voxel_fusion/layer_1_vfeat"]
    assert_same_features(got, want)
    if not kw.get("remat"):
        # the DA feature is the last layer's tokens on the grid, a view
        tm.keep_features = True
        with torch.no_grad():
            tm(torch.from_numpy(x))
        assert tm.last_layer_feat.shape == (2, 8, 8, tcfg.trans_out_dim)
        assert tm.last_layer_feat.untyped_storage().data_ptr() == \
            tm.voxel_fusion.layer_outputs[-1].untyped_storage().data_ptr()


def test_unet_features_match_jax():
    from test_torch_unet_polyformer import _unet_pair
    jm, params, bstats, tm = _unet_pair("target")
    x = np.random.RandomState(2).rand(2, 32, 32, 3).astype(np.float32)
    want = jax_intermediates(jm, params, bstats, x)
    assert list(want) == ["pre_outc_feat"]
    assert_same_features(port_features(tm, x), want)
